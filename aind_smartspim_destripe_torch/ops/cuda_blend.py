"""
The dual-band blend: the wrapper of the Hopper kernel in ``csrc/blend.cu``
and its plain PyTorch twin.

Counterpart of ``aind_smartspim_destripe_tpu/ops/pallas_blend.py``
(``blend_smooth_mix``) and of the XLA formulation it replaces
(``ops/dual_band.py:blend_bands_xla`` with ``_smooth``). Per plane ``b``:

  frac   = 1 / (1 + exp(-(x - centers[b]) / crossover))
  smooth = the 17x17 edge-replicated box mean of frac (rows, then columns,
           each divided by 17)
  out    = fore * smooth + back * (1 - smooth)

:func:`blend_smooth_mix` dispatches on the device of ``x``: a CPU tensor
takes the plain twin :func:`blend_bands`, a CUDA tensor launches the kernel
or raises (radius 8 only; there is no size gate and no switch to the twin).
It counts its launches in ``blend_smooth_mix.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda_build import check, launch, on_cuda

__all__ = ["RADIUS", "blend_bands", "blend_smooth_mix", "KERNELS"]

RADIUS = 8


def _box(v: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Edge-replicated box mean of width 2r+1 along ``dim`` (-1 or -2): the
    taps summed from the left, then divided by the width, as the kernel
    does."""
    k = 2 * radius + 1
    n = v.shape[dim]
    edge = list(v.shape)
    edge[dim] = radius
    vp = torch.cat([v.narrow(dim, 0, 1).expand(edge), v,
                    v.narrow(dim, n - 1, 1).expand(edge)], dim=dim)
    s = vp.narrow(dim, 0, n)
    for t in range(1, k):
        s = s + vp.narrow(dim, t, n)
    return s / k


def blend_bands(x, fore, back, centers, crossover, smooth_radius=RADIUS):
    """Plain twin of :func:`blend_smooth_mix` on any device (the JAX
    package's ``blend_bands_xla``): x (B, H, W) uint16 or float, fore and
    back (B, H, W) float32, centers (B,) -> (B, H, W) float32."""
    x = x.to(torch.float32)
    frac = 1.0 / (1.0 + torch.exp(-(x - centers[:, None, None]) / crossover))
    if smooth_radius > 0:
        frac = _box(_box(frac, smooth_radius, -1), smooth_radius, -2)
    return fore * frac + back * (1.0 - frac)


def blend_smooth_mix(
    x: torch.Tensor,  # (B, H, W) uint16 or float32 planes
    fore: torch.Tensor,  # (B, H, W) f32 foreground band, or with back=None
    # the stacked (2B, H, W) band pair ([:B] foreground, [B:] background)
    back: Optional[torch.Tensor],  # (B, H, W) f32 background band, or None
    centers: torch.Tensor,  # (B,) f32 sigmoid centres
    crossover: float,
    smooth_radius: int = RADIUS,
) -> torch.Tensor:
    """The blended planes (B, H, W) float32. With ``back=None`` both bands
    are read from the stacked buffer in place: foreground plane ``b``,
    background plane ``b + B``."""
    B = x.shape[0]
    if back is None:
        if fore.shape[0] != 2 * B:
            raise ValueError(f"stacked band pair must hold 2B={2 * B} planes, "
                             f"got {fore.shape[0]}")
        fore, back = fore[:B], fore[B:]
    if not on_cuda(x):
        return blend_bands(x, fore, back, centers, crossover, smooth_radius)
    if smooth_radius != RADIUS:
        raise ValueError(f"the blend kernel smooths with radius {RADIUS}, "
                         f"got {smooth_radius}")
    _, H, W = x.shape
    dev = x.device
    check("x", x, (torch.uint16, torch.float32), dev)
    check("fore", fore, (torch.float32,), dev, (B, H, W))
    check("back", back, (torch.float32,), dev, (B, H, W))
    check("centers", centers, (torch.float32,), dev, (B,))
    out = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    launch("destripe_blend", dev, x.data_ptr(), int(x.dtype == torch.uint16),
           fore.data_ptr(), back.data_ptr(), centers.data_ptr(),
           out.data_ptr(), B, H, W, float(crossover), int(smooth_radius))
    blend_smooth_mix.launches += 1
    return out


KERNELS = (blend_smooth_mix,)
for _k in KERNELS:
    _k.launches = 0
