"""
Drop-in filtering API: numpy in, numpy out, the destripe step on a CUDA
device.

Counterpart of ``aind_smartspim_destripe_tpu/filtering.py`` (the reference
surface ``filter_stripes`` / ``log_space_fft_filtering`` /
``flatfield_correction`` and their helpers) with the same arguments. Each
function that runs on a device takes ``device``: None means the current
CUDA device and raises without one; ``device="cpu"`` runs the plain
PyTorch path.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .ops import fft_notch as _notch
from .ops import flatfield as _ff
from .ops.filter import log_space_fft_filtering as _log_space_fft_filtering
from .parallel.mesh import one_device

__all__ = [
    "sigmoid",
    "foreground_fraction",
    "get_foreground_background_mean",
    "notch",
    "gaussian_filter",
    "log_space_fft_filtering",
    "normalize_image",
    "invert_image",
    "get_hemisphere_flatfield",
    "flatfield_correction",
    "filter_stripes",
]


def sigmoid(data: np.ndarray):
    """1 / (1 + e^-x)."""
    return 1 / (1 + np.exp(-data))


def foreground_fraction(img: np.ndarray, center: float, crossover: float):
    """Sigmoid foreground fraction ``sigmoid((img - center) / crossover)``."""
    return sigmoid((img - center) / crossover)


def get_foreground_background_mean(
    img: np.ndarray, threshold_mask: Optional[float] = 0.3
) -> Tuple:
    """Foreground/background means and the cell mask from the float16
    sigmoid classifier (centre 400, crossover 20)."""
    cell_for = foreground_fraction(img.astype(np.float16), 400, 20)
    cell_for = np.where(cell_for > threshold_mask, 1.0, 0.0)

    foreground = img[cell_for == 1]
    background = img[cell_for == 0]
    foreground_mean = foreground.mean() if foreground.size else 0.0
    background_mean = background.mean() if background.size else 0.0
    return foreground_mean, background_mean, cell_for


def notch(n: int, sigma: float) -> np.ndarray:
    """1-D Gaussian notch ``1 - exp(-x^2 / (2 sigma^2))``."""
    return _notch.notch(n, sigma)


def gaussian_filter(shape: tuple, sigma: float) -> np.ndarray:
    """The notch broadcast over ``shape``."""
    return _notch.gaussian_filter(shape, sigma)


def log_space_fft_filtering(
    input_image: np.ndarray,
    wavelet: Optional[str] = "db3",
    level: Optional[int] = 0,
    sigma: Optional[int] = 64,
    max_threshold: Optional[int] = 4,
    device=None,
) -> np.ndarray:
    """Log-space wavelet-FFT destripe of one plane (or a batch of planes)
    with one configuration, on ``device``; float32 out."""
    return _log_space_fft_filtering(
        input_image, wavelet=wavelet, level=level, sigma=sigma,
        max_threshold=max_threshold, device=device,
    )


def normalize_image(images: List[np.ndarray]) -> np.ndarray:
    """Normalise to [1, 2] with a float16 rounding step (host)."""
    return _ff.normalize_image(images).numpy()


def invert_image(image: np.ndarray) -> np.ndarray:
    """``max - x`` (host)."""
    return _ff.invert_image(image).numpy()


def get_hemisphere_flatfield(
    input_tile_path: str,
    tile_config: dict,
    flatfields: List[np.ndarray],
    zarr: Optional[bool] = True,
) -> np.ndarray:
    """Hemisphere flat lookup by the tile's X_Y name."""
    return _ff.get_hemisphere_flatfield(input_tile_path, tile_config,
                                        flatfields, zarr)


def _on(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), device=device)


def flatfield_correction(
    image_tiles,
    flatfield: np.ndarray,
    darkfield: np.ndarray,
    baseline: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Shadow correction on ``device`` -> uint16 numpy."""
    dev = one_device(device)
    return _ff.flatfield_correction(
        _on(image_tiles, dev), _on(flatfield, dev), _on(darkfield, dev),
        baseline,
    ).cpu().numpy()


def filter_stripes(
    image: np.ndarray,
    input_tile_path: str = None,
    no_cells_config: dict = None,
    cells_config: dict = None,
    shadow_correction: Optional[dict] = None,
    microscope_high_int: Optional[int] = 2700,
    dual_band: Optional[dict] = None,
    device=None,
) -> np.ndarray:
    """Classify a plane (cells / no cells), destripe it with the matching
    configuration on ``device``, and optionally shadow-correct it.

    ``dual_band``: a dict (``{}`` for the defaults, optionally with
    ``crossover`` / ``threshold``) skips the classifier and blends both
    configurations per pixel instead: ``cells_config`` filters the
    foreground, ``no_cells_config`` the background."""
    no_cells_config = no_cells_config or {}
    cells_config = cells_config or {}
    dev = one_device(device)

    if dual_band is not None:
        from .ops.dual_band import dual_band_destripe_configs

        filtered_image = dual_band_destripe_configs(
            image,
            cells_config,
            no_cells_config,
            crossover=float(dual_band.get("crossover", 100.0)),
            threshold=float(dual_band.get("threshold", -1.0)),
            device=dev,
        )
    else:
        fore_mean, back_mean, _ = get_foreground_background_mean(image)
        if fore_mean > back_mean and fore_mean > microscope_high_int:
            config = cells_config
        else:
            config = no_cells_config
        filtered_image = log_space_fft_filtering(input_image=image,
                                                 device=dev, **config)

    if shadow_correction is not None:
        retrospective = shadow_correction.get("retrospective")
        flatfield = shadow_correction.get("flatfield")
        darkfield = shadow_correction.get("darkfield")
        tile_config = shadow_correction.get("tile_config")

        if not retrospective:
            # a bare tile name ("X_Y") carries the tile in itself, a plane
            # file path in its parent directory: infer which from the
            # separator instead of the reference's zarr=True default, which
            # parses a file path's folders as the tile
            p = str(input_tile_path)
            flatfield = get_hemisphere_flatfield(
                input_tile_path=input_tile_path,
                tile_config=tile_config,
                flatfields=flatfield,
                zarr=("/" not in p and os.sep not in p),
            )

        filtered_image = flatfield_correction(
            image_tiles=filtered_image,
            flatfield=flatfield,
            darkfield=darkfield,
            baseline=None,
            device=dev,
        )

    return filtered_image
