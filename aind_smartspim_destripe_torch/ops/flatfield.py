"""
Flat-field / dark-field shadow correction in torch.

Counterpart of ``aind_smartspim_destripe_tpu/ops/flatfield.py``, with the
same numerics: darkfield subtraction clamped at zero (``x <= dark -> 0``),
division by the flatfield, optional baseline subtraction, clip to
[0, 65535] and a truncating cast to uint16; flats normalise to [1, 2]
through a float16 rounding step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = [
    "sigmoid",
    "foreground_fraction",
    "normalize_image",
    "invert_image",
    "get_hemisphere_flatfield",
    "flatfield_correction",
    "to_uint16",
    "wrap_cast",
]


def to_uint16(y: torch.Tensor) -> torch.Tensor:
    """Truncating cast of values already clipped to [0, 65535]."""
    return y.to(torch.int32).to(torch.uint16)


def wrap_cast(y: torch.Tensor) -> torch.Tensor:
    """zarr-store modulo-2^16 uint16 cast, ``mod(trunc(y) as int32,
    65536)``: a float written into a uint16 store wraps, it does not
    saturate."""
    return torch.remainder(torch.trunc(y).to(torch.int32), 65536).to(
        torch.uint16)


def sigmoid(data: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + e^-x)``."""
    return 1 / (1 + torch.exp(-data))


def foreground_fraction(img: torch.Tensor, center: float,
                        crossover: float) -> torch.Tensor:
    """Sigmoid foreground fraction ``sigmoid((img - center) / crossover)``."""
    return sigmoid((img - center) / crossover)


def _host_tensor(images) -> torch.Tensor:
    """An array, or a list of arrays, as a CPU tensor; floats as float32
    (the JAX package's default float)."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(images)))
    return t.to(torch.float32) if torch.is_floating_point(t) else t


def invert_image(image) -> torch.Tensor:
    """``max - x`` in the input's dtype (integers subtract exactly)."""
    t = _host_tensor(image)
    if torch.is_floating_point(t):
        return t.max() - t
    wide = t.to(torch.int64)  # torch reduces no uint16
    return (wide.max() - wide).to(t.dtype)


def normalize_image(images) -> torch.Tensor:
    """Normalise image(s) into [1, 2] with a float16 rounding step. Accepts
    an array or a list of arrays; integer inputs subtract exactly and divide
    in float32, as the JAX package does."""
    t = _host_tensor(images)
    if not torch.is_floating_point(t):
        t = t.to(torch.int64)
    ratio = (t - t.min()) / (t.max() - t.min())
    return 1 + ratio.to(torch.float16)


def get_hemisphere_flatfield(
    input_tile_path: str,
    tile_config: dict,
    flatfields: List,
    zarr: Optional[bool] = True,
):
    """Pick the per-hemisphere flatfield for a tile from its X_Y name;
    raises KeyError when the tile is missing from the config."""
    if zarr:
        xy_folders = str(input_tile_path).split("_")
    else:
        xy_folders = str(input_tile_path).split("/")[-2].split("_")
    x_folder, y_folder = xy_folders[0], xy_folders[1]
    if tile_config.get(x_folder) is None:
        raise KeyError(
            f"Please, check the tile config while trying to reach: {x_folder}"
        )
    brain_side = tile_config[x_folder].get(y_folder)
    if brain_side is None:
        raise KeyError(
            f"Please, check the tile config while trying to reach: {y_folder}"
        )
    return flatfields[brain_side]


def flatfield_correction(
    image_tiles: torch.Tensor,
    flatfield: torch.Tensor,
    darkfield: torch.Tensor,
    baseline=None,
) -> torch.Tensor:
    """Shadow correction of (H, W) or (B, H, W) planes -> uint16. The
    darkfield is cropped to the image extent."""
    img = image_tiles
    h, w = img.shape[-2:]
    dark = darkfield[..., :h, :w]
    if tuple(dark.shape[-2:]) != (h, w):
        raise ValueError(
            "Please, check the shape of the darkfield. "
            f"Image: {tuple(img.shape)} - Darkfield: {tuple(dark.shape)}"
        )
    if tuple(flatfield.shape[-2:]) != (h, w):
        raise ValueError(
            "Please, check the shape of the flatfield."
            f"Image: {tuple(img.shape)} - Flatfield: {tuple(flatfield.shape)}"
        )
    img = img.to(torch.float32)
    dark = dark.to(torch.float32)
    img = torch.where(img <= dark, torch.zeros_like(img), img - dark)
    corrected = img / flatfield.to(torch.float32)
    if baseline is not None:
        baseline = torch.as_tensor(
            baseline, dtype=torch.float32, device=corrected.device)
        corrected = corrected - baseline.reshape(
            tuple(baseline.shape) + (1,) * (corrected.ndim - baseline.ndim)
        )
    return to_uint16(torch.clamp(corrected, 0, 65535))
