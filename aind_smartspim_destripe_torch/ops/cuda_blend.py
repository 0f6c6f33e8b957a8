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

followed, when asked, by the step's uint16 epilogue (the flat-field
correction or the zarr wrap cast), which the kernel fuses into its store,
and restricted to a range of rows (a row shard's, out of a window widened
by its neighbours' rows).

:func:`blend_smooth_mix` dispatches on the device of ``x``: a CPU tensor
takes the plain composition (:func:`blend_bands`, the row slice, then
``flatfield_correction`` or ``wrap_cast``), a CUDA tensor launches the
kernel or raises (radius 8 only; there is no size gate and no switch to the
twin). It counts its launches in ``blend_smooth_mix.launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda_build import check, launch, on_cuda
from .flatfield import flatfield_correction, wrap_cast

__all__ = ["RADIUS", "blend_bands", "blend_smooth_mix", "div17_mismatches",
           "KERNELS"]

RADIUS = 8
_MODES = {"bare": 0, "flat": 1, "wrap": 2}


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


def _fields(flat, dark, h, w):
    """``flatfield_correction``'s checks of the fields against the emitted
    (h, w) rows, with the darkfield cropped to them; returns (flat, dark)."""
    if (flat is None) != (dark is None):
        raise ValueError("flat and dark must be provided together "
                         "(pass dark=torch.zeros((1, 1)) for a zero "
                         "darkfield)")
    if flat is None:
        return None, None
    dark = dark[..., :h, :w]
    if tuple(dark.shape[-2:]) != (h, w):
        raise ValueError(
            "Please, check the shape of the darkfield. "
            f"Image: {(h, w)} - Darkfield: {tuple(dark.shape)}")
    if tuple(flat.shape[-2:]) != (h, w):
        raise ValueError(
            "Please, check the shape of the flatfield."
            f"Image: {(h, w)} - Flatfield: {tuple(flat.shape)}")
    return flat, dark


def blend_smooth_mix(
    x: torch.Tensor,  # (B, H, W) uint16 or float32 planes
    fore: torch.Tensor,  # (B, H, W) f32 foreground band, or with back=None
    # the stacked (2B, H, W) band pair ([:B] foreground, [B:] background)
    back: Optional[torch.Tensor],  # (B, H, W) f32 background band, or None
    centers: torch.Tensor,  # (B,) f32 sigmoid centres
    crossover: float,
    smooth_radius: int = RADIUS,
    flat: Optional[torch.Tensor] = None,  # (h, W) f32 flat-field
    dark: Optional[torch.Tensor] = None,  # (>= h, >= W) f32 darkfield
    wrap: bool = False,
    out_rows: Optional[Tuple[int, int]] = None,  # (first, count)
) -> torch.Tensor:
    """The blended planes (B, h, W): float32, or uint16 through the
    flat-field correction (``flat``/``dark``, the fields of the emitted
    rows; the darkfield is cropped to them) or the modulo-2^16 wrap cast
    (``wrap``). ``out_rows=(first, count)`` emits only rows ``[first, first
    + count)`` of the planes (h = count; the box smooth still sees every
    row of ``x``), else h = H. With ``back=None`` both bands are read from
    the stacked buffer in place: foreground plane ``b``, background plane
    ``b + B``."""
    B, H, W = x.shape
    if back is None:
        if fore.shape[0] != 2 * B:
            raise ValueError(f"stacked band pair must hold 2B={2 * B} planes, "
                             f"got {fore.shape[0]}")
        fore, back = fore[:B], fore[B:]
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    first, count = (0, H) if out_rows is None else map(int, out_rows)
    if first < 0 or count < 0 or first + count > H:
        raise ValueError(f"out_rows {tuple(out_rows)} outside the window of "
                         f"{H} rows")
    flat, dark = _fields(flat, dark, count, W)
    if not on_cuda(x):
        y = blend_bands(x, fore, back, centers, crossover, smooth_radius)
        if out_rows is not None:
            y = y[:, first:first + count].contiguous()
        if flat is not None:
            return flatfield_correction(y, flat, dark)
        return wrap_cast(y) if wrap else y
    if smooth_radius != RADIUS:
        raise ValueError(f"the blend kernel smooths with radius {RADIUS}, "
                         f"got {smooth_radius}")
    dev = x.device
    check("x", x, (torch.uint16, torch.float32), dev)
    check("fore", fore, (torch.float32,), dev, (B, H, W))
    check("back", back, (torch.float32,), dev, (B, H, W))
    check("centers", centers, (torch.float32,), dev, (B,))
    mode = "flat" if flat is not None else ("wrap" if wrap else "bare")
    if flat is not None:
        # the kernel reads one (count, W) field for every plane; a dark
        # larger than the rows is cropped (a copy)
        dark = dark.contiguous()
        check("flat", flat, (torch.float32,), dev, (count, W))
        check("dark", dark, (torch.float32,), dev, (count, W))
    out = torch.empty((B, count, W), device=dev, dtype=(
        torch.float32 if mode == "bare" else torch.uint16))
    if out.numel() == 0:
        return out
    launch("destripe_blend", dev, x.data_ptr(), int(x.dtype == torch.uint16),
           fore.data_ptr(), back.data_ptr(), centers.data_ptr(),
           out.data_ptr(), None if flat is None else flat.data_ptr(),
           None if dark is None else dark.data_ptr(), _MODES[mode], B, H, W,
           first, count, float(crossover), int(smooth_radius))
    blend_smooth_mix.launches += 1
    return out


def div17_mismatches(device, last: float = 17.0) -> Tuple[int, int]:
    """The kernel's division by 17 against IEEE division on every float32
    bit pattern from +0 to ``last``, on the card: (number of patterns whose
    quotients differ, the lowest such pattern or -1)."""
    device = torch.device(device)
    bits = torch.tensor([last], dtype=torch.float32).view(torch.int32)
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    first_bad = torch.full((1,), -1, dtype=torch.int32, device=device)
    launch("destripe_div17_check", device, int(bits.item()), bad.data_ptr(),
           first_bad.data_ptr())
    fb = int(first_bad.item()) & 0xFFFFFFFF
    return int(bad.item()), (-1 if fb == 0xFFFFFFFF else fb)


KERNELS = (blend_smooth_mix,)
for _k in KERNELS:
    _k.launches = 0
