"""
Dual-band wavelet-FFT destripe.

Counterpart of ``aind_smartspim_destripe_tpu/ops/dual_band.py``. Every
plane is filtered with a foreground configuration (gentle sigma) and a
background one (aggressive sigma) from one shared decomposition
(:func:`.filter.destripe_batch` with ``dual=True``), then the two bands are
blended per pixel by a smoothed sigmoid foreground fraction centred on the
plane's Otsu threshold (or a fixed centre): :func:`.cuda_blend.
blend_smooth_mix`, the Hopper kernel for CUDA tensors and its plain twin
:func:`blend_bands` for CPU tensors, with the step's flat-field or wrap
epilogue fused into the blend's store.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime.tracing import span
from .cuda_blend import RADIUS, blend_bands, blend_smooth_mix
from .filter import (
    FilterConfig,
    build_plan,
    destripe_batch,
    device_constants,
    f32_matmul,
    normalize_flat_dark,
)
from .otsu import threshold_otsu_batch

__all__ = [
    "check_crossover",
    "blend_bands",
    "dual_band_destripe_batch",
    "dual_band_filtering",
    "dual_band_destripe_configs",
]


def check_crossover(crossover) -> None:
    """crossover = 0 makes the sigmoid 0/0 = NaN at the centre and a
    negative width silently swaps the bands: refuse both (and NaN)."""
    if not crossover > 0:
        raise ValueError(f"dual-band crossover must be > 0, got {crossover}")


def dual_band_destripe_batch(
    plan,
    images: torch.Tensor,
    crossover: float = 100.0,
    threshold: float = -1.0,
    smooth_radius: int = RADIUS,
    consts: Optional[dict] = None,
    flat=None,
    dark=None,
    wrap: bool = False,
) -> torch.Tensor:
    """Blend two destripe bands per pixel from one shared decomposition, on
    the device of ``images`` (B, H, W); returns (B, H, W) float32, or
    uint16 through the flat-field correction (``flat``/``dark``) or the
    zarr-store wrap cast (``wrap=True``), which the blend kernel fuses into
    its store.

    - ``plan``: a dual plan whose ``cells`` slot holds the foreground config
      and ``no_cells`` the background config (:func:`_dual_plan`);
    - ``threshold``: sigmoid centre; < 0 means the per-plane Otsu threshold
      of the raw planes;
    - ``crossover``: sigmoid width.

    Raw uint16 planes stay uint16 into the Otsu histogram and the blend
    kernel, which convert exactly as they read."""
    check_crossover(crossover)
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    x = images if images.dtype == torch.uint16 else images.to(torch.float32)
    flat, dark = normalize_flat_dark(plan.height, plan.width, flat, dark,
                                     x.device)
    both = destripe_batch(plan, images, -math.inf, consts, dual=True)
    if threshold < 0:
        with span("otsu.raw"):
            centers = threshold_otsu_batch(x)
    else:
        centers = torch.full((x.shape[0],), float(threshold),
                             dtype=torch.float32, device=x.device)
    with span("blend"):
        return blend_smooth_mix(x, both, None, centers, crossover,
                                smooth_radius, flat=flat, dark=dark,
                                wrap=wrap)


@lru_cache(maxsize=8)
def _dual_plan(h, w, wavelet, level, sigma_fore, sigma_back, max_threshold):
    """One plan carrying both bands: cells slot = foreground (gentle sigma),
    no_cells slot = background (aggressive sigma)."""
    return build_plan(
        h, w,
        FilterConfig(wavelet=wavelet, level=level, sigma=sigma_fore,
                     max_threshold=max_threshold),
        FilterConfig(wavelet=wavelet, level=level, sigma=sigma_back,
                     max_threshold=max_threshold),
    )


@lru_cache(maxsize=8)
def _plan_from_config_items(h, w, cells_items, no_cells_items):
    return build_plan(
        h, w,
        FilterConfig.from_dict(dict(cells_items)),
        FilterConfig.from_dict(dict(no_cells_items)),
    )


def _run_host(plan, img, crossover, threshold, device):
    """numpy planes in, float32 numpy out, on ``device`` (None: the current
    CUDA device; raises when there is none)."""
    from ..parallel.mesh import one_device

    dev = one_device(device)
    f32_matmul()
    if img.dtype != np.uint16:  # uint16 ships raw; the kernels read it
        img = img.astype(np.float32, copy=False)
    x = torch.as_tensor(np.ascontiguousarray(img), device=dev)
    with torch.inference_mode():
        consts = device_constants(plan, dev)
        return dual_band_destripe_batch(plan, x, crossover, threshold,
                                        consts=consts).cpu().numpy()


def dual_band_destripe_configs(
    images: np.ndarray,
    cells_config: dict,
    no_cells_config: dict,
    crossover: float = 100.0,
    threshold: float = -1.0,
    device=None,
) -> np.ndarray:
    """Dual-band destripe from the orchestrators' config-dict pair:
    ``cells_config`` is the foreground band, ``no_cells_config`` the
    background band (both must share wavelet and level). One plane or a
    (B, H, W) batch; float32 out."""
    img = np.asarray(images)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    h, w = img.shape[-2:]
    plan = _plan_from_config_items(
        h, w,
        tuple(sorted((cells_config or {}).items())),
        tuple(sorted((no_cells_config or {}).items())),
    )
    out = _run_host(plan, img, float(crossover), float(threshold), device)
    return out[0] if squeeze else out


def dual_band_filtering(
    input_image: np.ndarray,
    sigma: Tuple[float, float] = (256.0, 128.0),
    wavelet: str = "db3",
    level: Optional[int] = None,
    max_threshold: float = 12.0,
    crossover: float = 100.0,
    threshold: float = -1.0,
    device=None,
) -> np.ndarray:
    """Host convenience entry point: one plane or a (B, H, W) batch."""
    img = np.asarray(input_image)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[None]
    h, w = img.shape[-2:]
    plan = _dual_plan(h, w, wavelet, level, float(sigma[0]), float(sigma[1]),
                      float(max_threshold))
    out = _run_host(plan, img, float(crossover), float(threshold), device)
    return out[0] if squeeze else out
