"""
Production Zarr destriping orchestrator on one CUDA device.

Counterpart of ``aind_smartspim_destripe_tpu/zarr_destriper.py``: the same
``destripe_channel`` / ``destripe_zarr`` / multiscale and metadata surface,
store layout and codecs (blosc-zstd, clevel 3), with the streaming device
pipeline of :mod:`.runtime.pipeline` and the windowed-mean pyramid of
:mod:`.ops.multiscale` on the same device. A multi-host run splits a
channel's tiles over its processes.
"""

from __future__ import annotations

import logging
import os
import re
from glob import glob
from pathlib import Path
from time import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .io import ngff
from .io.codec import ensure_native_codec
from .io.readers import imread
from .io.zarr import BloscCodec, ZarrArray, ZarrGroup, group, open_zarr
from .ops import flatfield as ffops
from .ops.filter import FilterConfig, build_plan, destripe_batch, f32_matmul
from .ops.multiscale import windowed_mean
from .parallel import distributed
from .parallel.mesh import one_device
from .runtime.pipeline import StreamingDestriper, resolve_device
from .runtime.tracing import device_trace
from .utils import utils
from .utils.utils import ResourceProfiler, read_json_as_dict  # noqa: F401

__all__ = [
    "read_json_as_dict",
    "get_microscope_flats",
    "pad_array_n_d",
    "extract_global_to_local",
    "execute_worker",
    "compute_pyramid",
    "write_ome_ngff_metadata",
    "compute_multiscale",
    "destripe_zarr",
    "destripe_channel",
    "validate_capsule_inputs",
]


def _natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def get_microscope_flats(
    channel_name: str, derivatives_folder
) -> Tuple[Optional[List[np.ndarray]], Optional[dict]]:
    """Load the per-hemisphere microscope flats ``FlatReal{wave}_*.tif`` and
    the tile-side config from ``metadata.json``."""
    derivatives_folder = Path(derivatives_folder)
    flatfield = None
    metadata_json = None

    waves = [p for p in str(channel_name).split("_") if p.isdigit()]
    metadata_json_path = derivatives_folder.joinpath("metadata.json")

    if metadata_json_path.exists() and len(waves):
        orig = utils.read_json_as_dict(str(metadata_json_path))
        curr_wave = int(waves[0])
        tile_config = orig.get("tile_config")
        if tile_config is None:
            raise ValueError("Please, verify metadata.json")

        metadata_json = {}
        for _step, value in tile_config.items():
            laser = value.get("Laser")
            if laser is None:
                raise KeyError("Please, check the data in metadata.json")
            if int(laser) != curr_wave:
                continue
            x_folder = value.get("X")
            y_folder = value.get("Y")
            brain_side = value.get("Side")
            if x_folder is None or y_folder is None or brain_side is None:
                raise KeyError("Please, check the data in metadata.json")
            metadata_json.setdefault(x_folder, {})[y_folder] = int(brain_side)

        paths = sorted(
            glob(f"{derivatives_folder}/FlatReal{curr_wave}_*.tif"),
            key=_natsort_key,
        )
        flatfield = [imread(g) for g in paths if os.path.exists(g)]
        if len(flatfield) != 2:
            raise ValueError(
                f"Error while reading the microscope flatfields: {flatfield}"
            )

    return flatfield, metadata_json


def pad_array_n_d(arr, dim: int = 5):
    """Left-pad with singleton axes up to ``dim`` (at most 5)."""
    if dim > 5:
        raise ValueError("Padding more than 5 dimensions is not supported.")
    while arr.ndim < dim:
        arr = arr[np.newaxis, ...]
    return arr


def extract_global_to_local(global_ids_with_cells, global_slices,
                            pad: int = 0):
    """Map global ZYX ids (rows of ``global_ids_with_cells``, extra columns
    kept) into the local frame of the chunk at ``global_slices``, keeping
    the ids inside it grown by ``pad``; kept for the cell-segmentation
    toolchain's API, the destripe flow does not use it."""
    starts = np.array([s.start - pad for s in global_slices])
    stops = np.array([s.stop + pad for s in global_slices])

    g = global_ids_with_cells
    keep = np.ones(len(g), dtype=bool)
    for d in range(3):
        keep &= (g[:, d] >= starts[d]) & (g[:, d] < stops[d])
    picked = g[keep].copy()
    picked[..., :3] = picked[..., :3] - starts - pad

    keep2 = np.ones(len(picked), dtype=bool)
    for d in range(3):
        keep2 &= ((picked[:, d] >= 0)
                  & (picked[:, d] <= (stops[d] - starts[d]) + pad))
    return picked[keep2]


def execute_worker(
    data: np.ndarray,
    output_slices: Tuple[slice, ...],
    output_destriped_zarr,
    cells_config: dict,
    no_cells_config: dict,
    shadow_correction: Optional[dict] = None,
    dataset_name: str = "",
    logger: Optional[logging.Logger] = None,
    microscope_high_int: float = 2500.0,
    device=None,
):
    """Destripe one in-memory Z block as one batched call on ``device`` (as
    in :func:`.parallel.mesh.one_device`; None is the card) and write it
    into ``output_destriped_zarr`` at ``output_slices``; returns what was
    written. For custom orchestration: the streaming pipeline of
    :mod:`.runtime.pipeline` is the production path.

    ``data``: (Z, H, W) planes, or a squeezable 4-D/5-D block; uint16
    planes go to the device as they are, other dtypes as float32.
    ``shadow_correction``: ``{"flatfield", "darkfield", "retrospective",
    "tile_config"}``; without ``retrospective`` the flat-field is the
    tile's hemisphere flat (:func:`.ops.flatfield.get_hemisphere_flatfield`
    on ``dataset_name``). With it the block is written as uint16 through
    the flat-field correction, fused into the last synthesis kernel;
    without it, as the float32 filtered planes (the store casts them)."""
    block = np.asarray(data)
    while block.ndim > 3:
        block = np.squeeze(block, axis=0)
    if block.dtype != np.uint16:
        block = block.astype(np.float32)
    dev = one_device(device)
    f32_matmul()
    h, w = block.shape[-2:]
    plan = build_plan(h, w, FilterConfig.from_dict(cells_config),
                      FilterConfig.from_dict(no_cells_config))
    epi = {}
    if shadow_correction is not None:
        flat = shadow_correction.get("flatfield")
        if not shadow_correction.get("retrospective"):
            flat = ffops.get_hemisphere_flatfield(
                input_tile_path=dataset_name.replace(".zarr", ""),
                tile_config=shadow_correction.get("tile_config"),
                flatfields=flat,
            )
        epi = dict(flat=np.asarray(flat, np.float32),
                   dark=np.asarray(shadow_correction.get("darkfield"),
                                   np.float32))
    x = torch.from_numpy(np.ascontiguousarray(block)).to(dev)
    with torch.inference_mode():
        out = destripe_batch(plan, x, microscope_high_int, **epi)
    out = out.cpu().numpy()
    while out.ndim < len(output_destriped_zarr.shape):
        out = out[np.newaxis]
    output_destriped_zarr[output_slices] = out
    if logger:
        logger.info(f"block {output_slices} destriped")
    return out


def validate_capsule_inputs(input_elements: List[str]) -> List[str]:
    """List the missing required inputs."""
    return [str(e) for e in input_elements if not Path(e).exists()]


def _windowed_mean_np(block: np.ndarray, factors, device) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(block)).to(device)
    return windowed_mean(t, factors=factors).cpu().numpy()


def compute_pyramid(data, n_lvls: int, scale_axis, chunks="auto",
                    device=None):
    """Successive windowed-mean reductions of an in-memory array on
    ``device`` (as in :func:`.parallel.mesh.one_device`). Returns the
    levels, level 0 first. ``chunks`` is accepted for signature parity."""
    dev = one_device(device)
    levels = [np.asarray(data)]
    factors = tuple(int(s) for s in scale_axis)
    for _ in range(max(0, n_lvls - 1)):
        levels.append(_windowed_mean_np(levels[-1], factors, dev))
    return levels


def write_ome_ngff_metadata(
    group: ZarrGroup,
    arr,
    image_name: str,
    n_lvls: int,
    scale_factors: tuple,
    voxel_size: tuple,
    channel_names: List[str] = None,
    channel_colors: List[int] = None,
    channel_minmax: List[Tuple[float, float]] = None,
    channel_startend: List[Tuple[float, float]] = None,
    metadata: dict = None,
):
    """OME-NGFF metadata on a tile group."""
    ngff.write_ome_ngff_metadata(
        group=group,
        shape=tuple(arr.shape),
        chunksize=tuple(arr.chunks),
        image_name=image_name,
        n_lvls=n_lvls,
        scale_factors=tuple(scale_factors),
        voxel_size=tuple(voxel_size),
        channel_names=channel_names,
        channel_colors=channel_colors,
        channel_minmax=channel_minmax,
        channel_startend=channel_startend,
        metadata=metadata,
    )


def compute_multiscale(
    output_zarr: ZarrArray,
    zarr_group: ZarrGroup,
    scale_factor,
    n_workers: int,
    voxel_size,
    image_name: str,
    n_levels: int = 3,
    threads_per_worker: int = 1,
    logger: Optional[logging.Logger] = None,
    device=None,
):
    """Write levels 1..n_levels-1 plus OME-NGFF metadata, downsampling
    slab by slab on ``device`` (as in
    :func:`.parallel.mesh.one_device`). ``n_workers`` and
    ``threads_per_worker`` are accepted for signature parity."""
    logger = logger or logging.getLogger(__name__)
    dev = one_device(device)
    start_time = time()

    # channel metadata follows TCZYX: pad the logical shape to 5-D first
    shape5 = (1,) * (5 - len(output_zarr.shape)) + tuple(output_zarr.shape)
    channel_minmax = [
        (float(np.iinfo(np.uint16).min), float(np.iinfo(np.uint16).max))
        for _ in range(shape5[1])
    ]
    channel_startend = [(0.0, 350.0) for _ in range(shape5[1])]

    write_ome_ngff_metadata(
        group=zarr_group,
        arr=output_zarr,
        image_name=image_name,
        n_lvls=n_levels,
        scale_factors=scale_factor,
        voxel_size=voxel_size,
        channel_names=[image_name],
        channel_colors=[0x690AFE],
        channel_minmax=channel_minmax,
        channel_startend=channel_startend,
        metadata=None,
    )

    factors = tuple(int(f) for f in scale_factor)
    prev = output_zarr
    for lvl in range(1, n_levels):
        zc = prev.chunks[2] if prev.ndim == 5 else prev.chunks[0]
        z_prev = prev.shape[-3]
        new_shape = prev.shape[:-3] + tuple(
            s // f for s, f in zip(prev.shape[-3:], factors)
        )
        template = (1, 1, 64, 128, 128)[-len(new_shape):]
        chunks = tuple(min(c, s) for c, s in zip(template, new_shape))
        dst = zarr_group.create_dataset(
            name=lvl,
            shape=new_shape,
            chunks=chunks,
            dtype=np.uint16,
            compressor=BloscCodec(cname="zstd", clevel=3),
            dimension_separator="/",
            overwrite=True,
        )
        slab = max(factors[0], (zc * 2 // factors[0]) * factors[0])
        z_end = (z_prev // factors[0]) * factors[0]
        for z0 in range(0, z_end, slab):
            z1 = min(z0 + slab, z_end)
            block = np.asarray(prev[..., z0:z1, :, :])
            dst[..., z0 // factors[0] : z1 // factors[0], :, :] = (
                _windowed_mean_np(block, factors, dev))
        logger.info(f"multiscale level {lvl}: {new_shape}")
        prev = dst

    logger.info(f"Time to write the multiscales: {time() - start_time:.2f}s")


def destripe_zarr(
    dataset_path,
    multiscale: str,
    output_destriped_zarr,
    prediction_chunksize: Tuple[int, ...],
    target_size_mb: int,
    n_workers: int,
    batch_size: int,
    super_chunksize: Tuple[int, ...],
    results_folder,
    derivatives_path,
    xyz_resolution,
    parameters: dict,
    flatfield=None,
    lazy_callback_fn: Optional[Callable] = None,
    devices=None,
):
    """Destripe one OME-Zarr tile end to end: stream -> device filter and
    shadow correction -> level-0 Zarr -> multiscale and metadata.

    ``prediction_chunksize[0]`` sets the streamed Z slab; ``n_workers`` caps
    IO threads (0: auto); ``target_size_mb``, ``super_chunksize`` and
    ``batch_size`` are accepted for parameter parity. ``devices``: the
    mesh, as in :func:`.runtime.pipeline.resolve_device` (None: every
    visible CUDA device). With more than one entry each batch is sharded
    over them: planes at or under ``DESTRIPE_HALO_THRESHOLD_BYTES`` over
    the plane axis, larger planes over the row axis (the row-sharded
    route, :mod:`.parallel.halo`). With None, planes under the threshold
    run on the first device alone (:func:`.runtime.pipeline.
    make_device_step`).

    ``parameters["dual_band"]`` (default False) switches from the per-plane
    classifier to the dual-band per-pixel blend, with optional
    ``crossover`` (sigmoid width, 100.0) and ``dual_threshold`` (centre;
    < 0 = per-plane Otsu)."""
    no_cells_config = parameters["no_cells_config"]
    cells_config = parameters["cells_config"]
    dual_band = bool(parameters.get("dual_band", False))
    dual_crossover = float(parameters.get("crossover", 100.0))
    dual_threshold = float(parameters.get("dual_threshold", -1.0))
    mesh = resolve_device(devices)
    device = mesh[0]

    co_cpus = int(utils.get_code_ocean_cpu_limit())
    if n_workers > co_cpus:
        raise ValueError(f"Provided workers {n_workers} > current workers {co_cpus}")

    logger = utils.create_logger(output_log_path=str(results_folder))
    logger.info(f"{20 * '='} GPU Large-Scale Zarr Destriping {20 * '='}")
    logger.info(f"Processing dataset {dataset_path} on {mesh}")
    logger.info(f"blosc-zstd codec backend: {ensure_native_codec()}")

    profiler = ResourceProfiler(interval=20).start()

    try:
        dataset = open_zarr(str(dataset_path))
        if isinstance(dataset, ZarrGroup):
            lazy_data = dataset[str(multiscale)]
        else:
            lazy_data = dataset
        if lazy_callback_fn is not None:
            lazy_data = lazy_callback_fn(lazy_data)
        original_dataset_shape = tuple(lazy_data.shape)
        logger.info(f"Lazy data shape: {original_dataset_shape}")

        # output layout: {parent}/{tile}.zarr/0
        output_destriped_zarr = Path(output_destriped_zarr)
        root_group = group(str(output_destriped_zarr.parent))
        dataset_name = output_destriped_zarr.name
        new_channel_group = root_group.create_group(dataset_name, overwrite=False)
        out_chunks = (1, 1, 64, 128, 128)[-len(original_dataset_shape) :]
        # reuse a compatible level-0 store so the resume journal can skip
        # committed slabs; otherwise start clean
        output_zarr = None
        if "0" in new_channel_group:
            existing = new_channel_group["0"]
            reencodable = getattr(existing.codec, "can_encode", True)
            if (
                tuple(existing.shape) == tuple(original_dataset_shape)
                and tuple(existing.chunks) == tuple(out_chunks)
                and existing.dtype == np.dtype(np.uint16)
                and reencodable
            ):
                output_zarr = existing
                logger.info("Reusing existing output zarr (resume mode)")
        if output_zarr is None:
            output_zarr = new_channel_group.create_dataset(
                name=0,
                shape=original_dataset_shape,
                chunks=out_chunks,
                dtype=np.uint16,
                compressor=BloscCodec(cname="zstd", clevel=3),
                dimension_separator="/",
                overwrite=True,
            )
        logger.info(f"Created zarr: {output_zarr}")

        # shadow-correction inputs
        darkfield = None
        tile_config = None
        derivatives_path = Path(derivatives_path) if derivatives_path else None
        if derivatives_path is not None and os.path.exists(derivatives_path):
            darkfield_path = str(derivatives_path.joinpath("DarkMaster_cropped.tif"))
            logger.info(f"Loading darkfield from path: {darkfield_path}")
            try:
                darkfield = imread(darkfield_path)
            except FileNotFoundError:
                raise FileNotFoundError(
                    "Please, provide the current dark from the microscope! "
                    f"Provided path: {darkfield_path}"
                )
            if flatfield is None:
                channel_name = output_destriped_zarr.parent.name
                flats, tile_config = get_microscope_flats(
                    channel_name=str(channel_name),
                    derivatives_folder=derivatives_path,
                )
                if flats is not None:
                    flatfield = ffops.normalize_image(flats).numpy()
            else:
                logger.info("Ignoring microscope flats...")

        h, w = original_dataset_shape[-2:]
        plan = build_plan(
            h,
            w,
            FilterConfig.from_dict(cells_config),
            FilterConfig.from_dict(no_cells_config),
        )

        per_tile_flat = None
        if flatfield is not None:
            flat_arr = np.asarray(flatfield, dtype=np.float32)
            if flat_arr.ndim == 3:
                # microscope flats: one per hemisphere; pick by tile name
                if tile_config is None:
                    raise ValueError(
                        "hemisphere flats provided without tile_config"
                    )
                per_tile_flat = np.asarray(
                    ffops.get_hemisphere_flatfield(
                        input_tile_path=dataset_name.replace(".zarr", ""),
                        tile_config=tile_config,
                        flatfields=list(flat_arr),
                    ),
                    dtype=np.float32,
                )
            else:
                per_tile_flat = flat_arr

        start_time = time()
        pipe = StreamingDestriper(
            input_array=lazy_data,
            output_array=output_zarr,
            plan=plan,
            flatfield=per_tile_flat,
            darkfield=np.asarray(darkfield, np.float32) if darkfield is not None else None,
            microscope_high_int=2500.0,
            slab=int(prediction_chunksize[0]) if prediction_chunksize else 64,
            io_threads=n_workers or 0,
            logger=logger,
            devices=devices,
            dual=dual_band,
            crossover=dual_crossover,
            dual_threshold=dual_threshold,
        )
        with device_trace(os.environ.get("DESTRIPE_TRACE_DIR")):
            stats = pipe.run()
        end_time = time()

        multiscale_start = time()
        compute_multiscale(
            output_zarr=output_zarr,
            zarr_group=new_channel_group,
            scale_factor=[2, 2, 2],
            n_workers=co_cpus,
            voxel_size=[
                xyz_resolution[-1],
                xyz_resolution[-2],
                xyz_resolution[-3],
            ],
            image_name=dataset_name,
            n_levels=3,
            logger=logger,
            device=device,
        )
        multiscale_end = time()

        logger.info(
            f"Processing destripe flatfield time: {end_time - start_time} seconds"
        )
        logger.info(
            f"Processing multiscale time: {multiscale_end - multiscale_start} seconds"
        )
        return stats
    finally:
        profiler.stop()
        if len(profiler.time_points):
            profiler.save_graphs(str(results_folder), "zarr_destriper")


def destripe_channel(
    zarr_dataset_path,
    derivatives_path,
    channel_name,
    results_folder,
    xyz_resolution,
    estimated_channel_flats,
    laser_tiles,
    parameters,
    devices=None,
):
    """Destripe every tile of a channel: pick the estimated flat by laser
    side, then run :func:`destripe_zarr` per tile on ``devices``. Returns
    {tile_name: PipelineStats} for the tiles this process owns: all of them
    in a single-process run, a disjoint round-robin share in a multi-host
    run (:func:`.parallel.distributed.assign_tiles`)."""
    zarr_dataset_path = Path(zarr_dataset_path)
    results_folder = Path(results_folder)
    channel_dataset = zarr_dataset_path.joinpath(channel_name)

    destriped_data_folder = results_folder.joinpath("destriped_data")
    utils.create_folder(str(destriped_data_folder))

    tiles = sorted(channel_dataset.glob("*.zarr"))
    if distributed.world_size() > 1:
        # each process streams only its own tiles' stores
        tiles = distributed.assign_tiles(tiles)

    stats = {}
    for tile_path in tiles:
        output_folder = destriped_data_folder.joinpath(
            f"{channel_name}/{tile_path.name}"
        )
        print(
            f"Processing {tile_path} - writing to: {output_folder} - "
            f"derivatives: {derivatives_path}"
        )

        flatfield_path = None
        for side, side_tiles in laser_tiles.items():
            tile_path_stem = tile_path.stem.rsplit(".", 1)[0]
            if tile_path_stem in side_tiles:
                flatfield_path = estimated_channel_flats[int(side)]
                break
        if flatfield_path is None:
            raise ValueError(f"Tile {tile_path} not found in {laser_tiles}")

        flatfield = imread(str(flatfield_path))
        print(f"Reading flatfield from {flatfield_path} - shape: {flatfield.shape}")

        stats[tile_path.name] = destripe_zarr(
            dataset_path=tile_path,
            multiscale="0",
            output_destriped_zarr=output_folder,
            prediction_chunksize=(64, 1600, 2000),
            target_size_mb=3072,
            n_workers=0,
            batch_size=1,
            super_chunksize=(384, 1600, 2000),
            results_folder=results_folder,
            derivatives_path=derivatives_path,
            xyz_resolution=xyz_resolution,
            parameters=parameters,
            flatfield=flatfield,
            lazy_callback_fn=None,
            devices=devices,
        )
    return stats
