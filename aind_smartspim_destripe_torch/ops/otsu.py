"""
Otsu threshold in torch, matching skimage.filters.threshold_otsu (256 bins).

Counterpart of ``aind_smartspim_destripe_tpu/ops/otsu.py``. The bin index
is ``floor((x - lo) / safe_span * 256)`` clipped to [0, 255], operation for
operation as in the JAX package. Raw uint16 planes are binned as they are
(the kernel converts exactly as it reads), so no float copy of the batch is
made. The counts come from
:func:`.cuda_hist.histogram256_batch`: the Hopper kernel for CUDA tensors
(integer atomics), ``torch.bincount`` for CPU tensors; never from a matrix
product, so they are exact at any plane size.
"""

from __future__ import annotations

import torch

from .cuda_hist import histogram256_batch

__all__ = [
    "histogram_fixed_bins",
    "otsu_from_counts",
    "threshold_otsu",
    "threshold_otsu_batch",
]


def _cumsum(x):
    """Float32 running sums along dim 1, accumulated in float64 and rounded
    per element: what torch's CPU cumsum does for float32, bit for bit. On
    the card torch's scan runs in an order chosen by the tensor's shape, so
    a float32 scan gave a plane another Otsu bin in a batch of one than in
    a batch of 64; the float64 scan rounds to the same float32 values in
    any order but for ties closer than ~1e-16 relative."""
    return torch.cumsum(x.to(torch.float64), dim=1).to(torch.float32)


def _otsu_tail(counts, centers, lo, hi):
    """Inter-class-variance argmax over per-plane histograms (B, nbins)."""
    weight1 = _cumsum(counts)
    weight2 = _cumsum(counts.flip(1)).flip(1)
    mean1 = _cumsum(counts * centers) / weight1.clamp_min(1e-30)
    mean2 = (
        _cumsum((counts * centers).flip(1))
        / weight2.flip(1).clamp_min(1e-30)
    ).flip(1)
    variance12 = (
        weight1[:, :-1] * weight2[:, 1:] * (mean1[:, :-1] - mean2[:, 1:]) ** 2
    )
    idx = torch.argmax(variance12, dim=1)
    th = torch.gather(centers, 1, idx[:, None])[:, 0]
    return torch.where(hi > lo, th, lo)


def _safe(span):
    return torch.where(span > 0, span, torch.ones_like(span))


def _u16_range(x: torch.Tensor, dims):
    """Per-plane (min, max) of uint16 planes as float32, reduced on the
    integers: XOR 0x8000 maps the unsigned order onto int16's, so the
    reduction needs neither unsigned support nor a 4-byte copy."""
    s = x.view(torch.int16) ^ -32768
    return tuple(r.to(torch.float32) + 32768.0
                 for r in (s.amin(dim=dims), s.amax(dim=dims)))


def histogram_fixed_bins(x: torch.Tensor, nbins: int = 256):
    """Histogram of ``x`` (flattened) over [min, max] with ``nbins`` equal
    bins, the right-most bin closed. Returns (counts float32, centers)."""
    flat = x.reshape(-1)
    lo = flat.min()
    hi = flat.max()
    span = hi - lo
    counts = histogram256_batch(flat[None], lo[None], _safe(span)[None],
                                nbins=nbins)[0].to(torch.float32)
    edges = lo + span * torch.arange(
        nbins + 1, dtype=x.dtype, device=x.device) / nbins
    centers = (edges[:-1] + edges[1:]) / 2.0
    return counts, centers


def threshold_otsu(x: torch.Tensor, nbins: int = 256) -> torch.Tensor:
    """Scalar Otsu threshold (bin center maximising the inter-class
    variance); a constant input returns the constant."""
    return threshold_otsu_batch(x.reshape(1, -1), nbins)[0]


def threshold_otsu_batch(
    x: torch.Tensor,
    nbins: int = 256,
    square: bool = False,
    abs_range=None,
) -> torch.Tensor:
    """Per-plane Otsu thresholds of a (B, ...) batch, each plane binned over
    its own [min, max] as :func:`threshold_otsu` does.

    ``square=True`` thresholds ``x**2``, squared inside the histogram (never
    stored). Its bin range is the square of the per-plane ``(min|x|,
    max|x|)``, which equals ``min(x**2)`` and ``max(x**2)`` bit for bit
    (rounding is monotone); ``abs_range`` passes that pair in (each (B,)),
    as the analysis kernel K2 emits it while the band is in registers."""
    dims = tuple(range(1, x.ndim))
    if abs_range is not None and not square:
        raise ValueError("abs_range implies square=True semantics")
    raw16 = x.dtype == torch.uint16 and not square
    xs = x if torch.is_floating_point(x) or raw16 else x.to(torch.float32)
    if raw16:
        lo, hi = _u16_range(xs, dims)
    elif square:
        if abs_range is None:
            a = xs.abs()
            abs_range = (a.amin(dim=dims), a.amax(dim=dims))
            del a
        lo_a, hi_a = (t.to(torch.float32) for t in abs_range)
        lo, hi = lo_a * lo_a, hi_a * hi_a
    else:
        lo = xs.amin(dim=dims)
        hi = xs.amax(dim=dims)
    span = hi - lo
    counts = histogram256_batch(xs, lo, _safe(span), square=square,
                                nbins=nbins).to(torch.float32)
    steps = torch.arange(nbins + 1, dtype=lo.dtype, device=xs.device)
    # edges = lo + span * i / nbins, in the JAX package's order of operations
    edges = lo[:, None] + span[:, None] * steps[None, :] / nbins
    centers = (edges[:, :-1] + edges[:, 1:]) / 2.0
    return _otsu_tail(counts, centers, lo, hi)


def otsu_from_counts(
    counts: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, nbins: int = 256
) -> torch.Tensor:
    """Per-plane Otsu threshold from precomputed histograms (B, nbins) over
    equal bins spanning [lo, hi] (the tail the histogram kernel feeds)."""
    steps = torch.arange(
        nbins + 1, dtype=torch.float32, device=counts.device) / nbins
    span = hi - lo
    edges = lo[:, None] + span[:, None] * steps[None, :]
    centers = (edges[:, :-1] + edges[:, 1:]) / 2.0
    return _otsu_tail(counts, centers, lo, hi)
