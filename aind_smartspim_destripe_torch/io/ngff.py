"""
OME-NGFF (v0.4) multiscales + omero metadata writer.

Replicates the metadata structure the reference emits through ome-zarr-py
(zarr_destriper.py:410-674: `_compute_scales`, `_get_axes_5d`, `_build_ome`,
`write_ome_ngff_metadata`): 5-D TCZYX axes, per-level scale transforms equal to
voxel size x 2^level, and the omero render block (defaultZ = mid stack,
SmartSPIM window (0, 350)).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "get_axes_5d",
    "compute_scales",
    "build_omero",
    "write_ome_ngff_metadata",
]


def get_axes_5d(
    time_unit: str = "millisecond", space_unit: str = "micrometer"
) -> List[Dict]:
    """TCZYX axis list (reference zarr_destriper.py:507-528)."""
    return [
        {"name": "t", "type": "time", "unit": f"{time_unit}"},
        {"name": "c", "type": "channel"},
        {"name": "z", "type": "space", "unit": f"{space_unit}"},
        {"name": "y", "type": "space", "unit": f"{space_unit}"},
        {"name": "x", "type": "space", "unit": f"{space_unit}"},
    ]


def compute_scales(
    scale_num_levels: int,
    scale_factor: Tuple[float, float, float],
    pixelsizes: Tuple[float, float, float],
    chunks: Tuple[int, int, int, int, int],
    data_shape: Tuple[int, int, int, int, int],
    translation: Optional[List[float]] = None,
):
    """Per-level coordinate transforms + chunk options
    (reference zarr_destriper.py:410-504). ``pixelsizes`` is ZYX."""
    transforms = [
        [{"type": "scale", "scale": [1.0, 1.0, *map(float, pixelsizes)]}]
    ]
    if translation is not None:
        transforms[0].append({"type": "translation", "translation": translation})

    chunk_sizes = []
    lastz, lasty, lastx = data_shape[2], data_shape[3], data_shape[4]
    chunk_sizes.append(
        dict(
            chunks=(
                1,
                1,
                min(lastz, chunks[2]),
                min(lasty, chunks[3]),
                min(lastx, chunks[4]),
            )
        )
    )
    for _ in range(max(0, scale_num_levels - 1)):
        prev = transforms[-1][0]["scale"]
        transforms.append(
            [
                {
                    "type": "scale",
                    "scale": [
                        1.0,
                        1.0,
                        prev[2] * scale_factor[0],
                        prev[3] * scale_factor[1],
                        prev[4] * scale_factor[2],
                    ],
                }
            ]
        )
        if translation is not None:
            transforms[-1].append(
                {"type": "translation", "translation": translation}
            )
        lastz = int(np.ceil(lastz / scale_factor[0]))
        lasty = int(np.ceil(lasty / scale_factor[1]))
        lastx = int(np.ceil(lastx / scale_factor[2]))
        chunk_sizes.append(
            dict(
                chunks=(
                    1,
                    1,
                    min(lastz, chunks[2]),
                    min(lasty, chunks[3]),
                    min(lastx, chunks[4]),
                )
            )
        )
    return transforms, chunk_sizes


def build_omero(
    data_shape: Tuple[int, ...],
    image_name: str,
    channel_names: Optional[List[str]] = None,
    channel_colors: Optional[List[int]] = None,
    channel_minmax: Optional[List[Tuple[float, float]]] = None,
    channel_startend: Optional[List[Tuple[float, float]]] = None,
) -> Dict:
    """The "omero" render block (reference zarr_destriper.py:531-597)."""
    n_ch = data_shape[1]
    if channel_names is None:
        channel_names = [f"Channel:{image_name}:{i}" for i in range(n_ch)]
    if channel_colors is None:
        channel_colors = list(range(n_ch))
    if channel_minmax is None:
        channel_minmax = [(0.0, 1.0)] * n_ch
    if channel_startend is None:
        channel_startend = channel_minmax

    channels = [
        {
            "active": True,
            "coefficient": 1,
            "color": f"{channel_colors[i]:06x}",
            "family": "linear",
            "inverted": False,
            "label": channel_names[i],
            "window": {
                "end": float(channel_startend[i][1]),
                "max": float(channel_minmax[i][1]),
                "min": float(channel_minmax[i][0]),
                "start": float(channel_startend[i][0]),
            },
        }
        for i in range(n_ch)
    ]
    return {
        "id": 1,
        "name": image_name,
        "version": "0.4",
        "channels": channels,
        "rdefs": {
            "defaultT": 0,
            "defaultZ": int(data_shape[2]) // 2,
            "model": "color",
        },
    }


def _validate_transforms(ndim: int, transforms):
    for level in transforms:
        for t in level:
            if t["type"] == "scale" and len(t["scale"]) != ndim:
                raise ValueError("scale length != ndim")


def write_ome_ngff_metadata(
    group,
    shape: Tuple[int, ...],
    chunksize: Tuple[int, ...],
    image_name: str,
    n_lvls: int,
    scale_factors: tuple,
    voxel_size: tuple,
    channel_names: Optional[List[str]] = None,
    channel_colors: Optional[List[int]] = None,
    channel_minmax: Optional[List[Tuple[float, float]]] = None,
    channel_startend: Optional[List[Tuple[float, float]]] = None,
    metadata: Optional[dict] = None,
):
    """Write ``omero`` and ``multiscales`` attributes on a tile group
    (reference zarr_destriper.py:600-674). ``group`` is an io.zarr.ZarrGroup
    (anything with dict-like ``attrs``). ``shape``/``chunksize`` may be 3-D
    ZYX or 5-D TCZYX; the metadata itself is always written 5-D."""
    if metadata is None:
        metadata = {}
    if not 3 <= len(shape) <= 5:
        raise ValueError(f"expected 3-D..5-D shape, got {shape}")
    shape = (1,) * (5 - len(shape)) + tuple(shape)
    chunksize = (1,) * (5 - len(chunksize)) + tuple(chunksize)

    group.attrs["omero"] = build_omero(
        shape,
        image_name,
        channel_names=channel_names,
        channel_colors=channel_colors,
        channel_minmax=channel_minmax,
        channel_startend=channel_startend,
    )

    axes_5d = get_axes_5d()
    transforms, _ = compute_scales(
        n_lvls, scale_factors, voxel_size, chunksize, shape, None
    )
    _validate_transforms(len(shape), transforms)

    datasets = []
    for i in range(n_lvls):
        datasets.append(
            {"path": str(i), "coordinateTransformations": transforms[i]}
        )

    group.attrs["multiscales"] = [
        {
            "version": "0.4",
            "datasets": datasets,
            "axes": axes_5d,
            **metadata,
        }
    ]
