"""
Capsule entry point on one CUDA device.

Counterpart of ``aind_smartspim_destripe_tpu/run_capsule.py``, with the
same input conventions: ``acquisition.json`` (voxel resolution from the
first tile's scale transform), channel folders ``Ex_*_Em_*``,
``laser_tiles.json`` (side -> tile list), per-channel estimated flats
``estimated_flat_laser_{channel}*.tif`` and
``derivatives/DarkMaster_cropped.tif``; the same hardcoded production filter
parameters and ``processing.json`` provenance. Multi-host aware: with the
``DESTRIPE_COORDINATOR_ADDRESS`` / ``DESTRIPE_NUM_PROCESSES`` /
``DESTRIPE_PROCESS_ID`` variables set, the processes form a gloo process
group, each destripes a disjoint share of the tiles, and process 0 alone
writes the provenance.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from time import time
from typing import Tuple

from . import __version__, zarr_destriper
from .zarr_destriper import validate_capsule_inputs
from .utils import utils
from .utils.provenance import generate_data_processing

__all__ = ["PRODUCTION_PARAMETERS", "get_data_config", "get_resolution",
           "validate_capsule_inputs", "run"]


def get_data_config(
    data_folder: str,
    processing_manifest_path: str = "processing_manifest.json",
    data_description_path: str = "data_description.json",
) -> Tuple[dict, str]:
    """Read the processing manifest and the dataset name."""
    derivatives_dict = utils.read_json_as_dict(
        f"{data_folder}/{processing_manifest_path}"
    )
    data_description_dict = utils.read_json_as_dict(
        f"{data_folder}/{data_description_path}"
    )
    return derivatives_dict, data_description_dict["name"]


def get_resolution(acquisition_config: dict):
    """(x, y, z) micron resolution from the first tile's scale transform."""
    tile_transforms = acquisition_config["tiles"][0]["coordinate_transformations"]
    scale_transform = [
        x["scale"] for x in tile_transforms if x["type"] == "scale"
    ][0]
    return (
        float(scale_transform[0]),
        float(scale_transform[1]),
        float(scale_transform[2]),
    )


def _natsorted(paths):
    def key(p):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


PRODUCTION_PARAMETERS = {
    "no_cells_config": {
        "wavelet": "db3",
        "level": None,
        "sigma": 128,
        "max_threshold": 12,
    },
    "cells_config": {
        "wavelet": "db3",
        "level": None,
        "sigma": 64,
        "max_threshold": 3,
    },
    "retrospective": True,
}


def run(
    data_folder: str = "../data",
    results_folder: str = "../results",
    scratch_folder: str = "../scratch",
    devices=None,
):
    """Validate inputs and destripe every channel on the mesh ``devices``
    (None: every visible CUDA device; ``[torch.device("cpu")]`` runs on the
    CPU; several entries shard each batch over them, by planes or, above
    ``DESTRIPE_HALO_THRESHOLD_BYTES`` of f32 plane, by rows).
    ``scratch_folder`` is accepted for parity: the pipeline streams through
    memory. ``DESTRIPE_DUAL_BAND=1`` runs the dual-band mode, with
    ``DESTRIPE_DUAL_CROSSOVER`` and ``DESTRIPE_DUAL_THRESHOLD`` as its
    sigmoid width and centre when set."""
    from .parallel.distributed import initialize_distributed
    from .parallel.mesh import make_mesh

    make_mesh(devices)  # no card and no device named: raise before any IO
    process_index, process_count = initialize_distributed()
    if process_count > 1:
        print(f"Multi-host run: process {process_index}/{process_count}")

    data_folder = Path(os.path.abspath(data_folder))
    results_folder = Path(os.path.abspath(results_folder))
    Path(os.path.abspath(scratch_folder))

    missing_files = validate_capsule_inputs([f"{data_folder}/acquisition.json"])
    print(f"Data in folder: {list(data_folder.glob('*'))}")
    if len(missing_files):
        raise ValueError(
            f"We miss the following files in the capsule input: {missing_files}"
        )

    acquisition_path = data_folder.joinpath("acquisition.json")
    acquisition_dict = utils.read_json_as_dict(str(acquisition_path))
    if not len(acquisition_dict):
        raise ValueError(
            f"Not able to read acquisition metadata from {acquisition_path}"
        )

    voxel_resolution = get_resolution(acquisition_dict)
    derivatives_path = data_folder.joinpath("derivatives")
    print(f"Derivatives path data: {list(derivatives_path.glob('*'))}")

    channels = [
        folder.name
        for folder in data_folder.glob("Ex_*_Em_*")
        if os.path.isdir(folder)
    ]

    laser_tiles_path = data_folder.joinpath("laser_tiles.json")
    if not laser_tiles_path.exists():
        raise FileNotFoundError(f"Path {laser_tiles_path} does not exist!")
    laser_tiles = utils.read_json_as_dict(str(laser_tiles_path))
    print(f"Laser tiles: {laser_tiles}")

    if not len(channels):
        print(f"No channels to process in {data_folder}")
        return

    for channel_name in channels:
        estimated_channel_flats = _natsorted(
            data_folder.glob(f"estimated_flat_laser_{channel_name}*.tif")
        )
        if not len(estimated_channel_flats):
            raise FileNotFoundError(
                "Error while retrieving flats from the data folder "
                f"for channel {channel_name}"
            )

        parameters = {
            "input_path": data_folder.joinpath(channel_name),
            "output_path": str(results_folder),
            **PRODUCTION_PARAMETERS,
        }
        if os.environ.get("DESTRIPE_DUAL_BAND", "") == "1":
            parameters["dual_band"] = True
            if os.environ.get("DESTRIPE_DUAL_CROSSOVER"):
                parameters["crossover"] = float(
                    os.environ["DESTRIPE_DUAL_CROSSOVER"]
                )
            if os.environ.get("DESTRIPE_DUAL_THRESHOLD"):
                parameters["dual_threshold"] = float(
                    os.environ["DESTRIPE_DUAL_THRESHOLD"]
                )

        destriping_start_time = time()
        zarr_destriper.destripe_channel(
            zarr_dataset_path=data_folder,
            channel_name=channel_name,
            results_folder=results_folder,
            derivatives_path=derivatives_path,
            xyz_resolution=voxel_resolution,
            estimated_channel_flats=estimated_channel_flats,
            laser_tiles=laser_tiles,
            parameters=parameters,
            devices=devices,
        )
        destriping_end_time = time()

        if process_index == 0:
            path = generate_data_processing(
                channel_name=channel_name,
                destripe_version=__version__,
                destripe_config=parameters,
                start_time=destriping_start_time,
                end_time=destriping_end_time,
                output_directory=str(results_folder),
            )
            print(f"Provenance written: {path}")


if __name__ == "__main__":
    run()
