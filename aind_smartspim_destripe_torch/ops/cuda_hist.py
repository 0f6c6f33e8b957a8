"""
Per-plane fixed-bin histograms for the Otsu threshold and the threshold's
tail: the wrappers of the Hopper kernels in ``csrc/hist.cu`` and their
plain PyTorch twins.

Counterpart of ``aind_smartspim_destripe_tpu/ops/pallas_hist.py`` (the
histogram) and of the tail of ``ops/otsu.py`` there. Each wrapper
dispatches on the device of its input: a CPU tensor takes the plain twin
(also callable directly as ``<name>_plain`` on any device), a CUDA tensor
launches the kernel or raises. Each counts its kernel launches in
``.launches``.

- ``histogram256_batch``: counts over (lo, span) ranges (``torch.bincount``
  in integers on the CPU);
- ``histogram256_range``: the same kernel over (lo, hi) ends, or over the
  squares of (min|x|, max|x|), the width formed and guarded in the kernel;
- ``abs_range_batch``: each plane's (min|x|, max|x|), zeroing the counts
  the histogram then adds to;
- ``otsu_tail``: the Otsu threshold from the counts, bit for bit the plain
  tail (float64 running sums rounded per element, torch's argmax order),
  its square root and repeats in the same launch.

On the card the Otsu of one band is three launches: the zero fill (or the
range pass), the histogram and the tail.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda_build import check, launch, on_cuda
from .cuda_build import sm_count as _sm_count

__all__ = [
    "abs_range_batch",
    "abs_range_batch_plain",
    "bin_index",
    "hist_blocks",
    "histogram256_batch",
    "histogram256_batch_plain",
    "histogram256_range",
    "histogram256_range_plain",
    "otsu_tail",
    "otsu_tail_plain",
    "KERNELS",
]

_THREADS = 256  # threads per block (csrc/hist.cu kThreads)
_PER_THREAD = 256  # values a thread counts, where the grid allows
_BLOCKS_PER_SM = 8  # the grid's least fill: blocks of all planes per SM
_MIN_PER_THREAD = 32  # no more blocks than give a thread this many values
_MAX_BINS = 256  # the kernel's striped copies hold 256 bins
_MAX_PLANES = 65535  # grid.y
# how the kernels read a plane's bin range (csrc/hist.cu RangeForm)
RANGE_SPAN, RANGE_ENDS, RANGE_ABS = 0, 1, 2


def hist_blocks(B: int, n_valid: int, sms: int) -> int:
    """Blocks per plane of the histogram's launch for B planes of
    ``n_valid`` values each on a card of ``sms`` SMs: about
    ``_PER_THREAD`` values per thread, and at least enough for the B
    planes to put ``_BLOCKS_PER_SM`` blocks on every SM (a single plane of
    a row shard fills the card) while a thread keeps ``_MIN_PER_THREAD``
    values; at least 1."""
    if B < 1 or sms < 1 or n_valid < 0:
        raise ValueError(f"hist_blocks needs B >= 1, sms >= 1 and n_valid >= "
                         f"0, got {B}, {sms}, {n_valid}")
    need = -(-n_valid // (_THREADS * _PER_THREAD))
    fill = -(-sms * _BLOCKS_PER_SM // B)
    work = -(-n_valid // (_THREADS * _MIN_PER_THREAD))
    return max(1, need, min(fill, work))


def bin_index(x, lo, span, nbins):
    """``floor((x - lo) / span * nbins)`` clipped to [0, nbins - 1] as int64,
    in the JAX package's order of operations; ``span`` is guarded (> 0)."""
    idx = torch.floor((x - lo) / span * nbins).to(torch.int64)
    return idx.clamp_(0, nbins - 1)


def _rows(x, row_bound):
    """The planes' first ``row_bound`` rows (all of them for None)."""
    if row_bound is None:
        return x
    if x.ndim != 3 or not 0 <= row_bound <= x.shape[1]:
        raise ValueError(f"row_bound {row_bound} needs (B, H, W) planes with "
                         f"0 <= row_bound <= H, got {tuple(x.shape)}")
    return x[:, :row_bound]


def _safe(span):
    """The histogram's bin width: ``span``, or 1 where it is not > 0."""
    return torch.where(span > 0, span, torch.ones_like(span))


def _ends(lo, hi, square):
    """The bin range's ends: squared with ``square`` (lo, hi are then
    min|x| and max|x|)."""
    return (lo * lo, hi * hi) if square else (lo, hi)


def histogram256_batch_plain(x, lo, span, square=False, nbins=256,
                             row_bound=None):
    """Plain twin of :func:`histogram256_batch`, on any device."""
    B = x.shape[0]
    x = _rows(x, row_bound)
    xs = x if torch.is_floating_point(x) else x.to(torch.float32)
    xs = xs.reshape(B, -1)
    if square:
        xs = xs * xs
    idx = bin_index(xs, lo[:, None], span[:, None], nbins)
    idx += torch.arange(B, device=x.device)[:, None] * nbins
    counts = torch.bincount(idx.reshape(-1), minlength=B * nbins)
    return counts.reshape(B, nbins).to(torch.int32)


def histogram256_batch(
    x: torch.Tensor,  # (B, ...) float32 or uint16
    lo: torch.Tensor,  # (B,) float32 bin range start per plane
    span: torch.Tensor,  # (B,) float32 bin range width per plane, > 0
    square: bool = False,
    nbins: int = 256,
    row_bound: Optional[int] = None,
) -> torch.Tensor:
    """Exact per-plane counts (B, nbins) int32 of ``x`` (or of ``x**2``,
    squared in the kernel, with ``square``) over ``nbins`` equal bins from
    ``lo`` over ``span``; values outside fall in the end bins. Input values
    must be finite.

    ``row_bound``: count only the first ``row_bound`` rows of each (B, H, W)
    plane (a row shard's own rows, without the rows that pad it to the mesh
    multiple). The counts stay integers, so that the partial histograms of
    a plane's row shards add up exactly; a caller converts them to float32
    once (the JAX kernel returns float32, exact only below 2**24 per bin)."""
    if not on_cuda(x):
        return histogram256_batch_plain(x, lo, span, square, nbins,
                                        row_bound)

    counts, launched = _launch_hist(x, lo, span, RANGE_SPAN, square, nbins,
                                    row_bound)
    histogram256_batch.launches += launched
    return counts


def _launch_hist(x, a, r, form, square, nbins, row_bound=None, out=None):
    """Launch the histogram kernel over ranges (a, r) of ``form`` into
    ``out`` (zeroed; a fresh zeroed tensor where None); returns the counts
    and whether it launched (not where no value is to be counted)."""
    B = x.shape[0]
    n = x.numel() // max(B, 1)
    dev = x.device
    if not 0 < nbins <= _MAX_BINS:
        raise ValueError(f"nbins {nbins} outside 1..{_MAX_BINS}")
    if B > _MAX_PLANES:
        raise ValueError(f"{B} planes exceed the kernel's grid "
                         f"({_MAX_PLANES})")
    check("x", x, (torch.float32, torch.uint16), dev)
    check("lo", a, (torch.float32,), dev, (B,))
    check("span" if form == RANGE_SPAN else "hi", r, (torch.float32,), dev,
          (B,))
    rows = 1 if row_bound is None else _rows(x, row_bound).shape[1]
    row_len = n if row_bound is None else n // max(x.shape[1], 1)
    n_valid = rows * row_len
    if out is None:
        out = torch.zeros((B, nbins), dtype=torch.int32, device=dev)
    else:
        check("out", out, (torch.int32,), dev, (B, nbins))
    if B == 0 or n_valid == 0:
        return out, False
    blocks = hist_blocks(B, n_valid, _sm_count(dev.index))
    launch(
        "destripe_hist", dev, x.data_ptr(), int(x.dtype == torch.uint16),
        a.data_ptr(), r.data_ptr(), form, out.data_ptr(), B, n, rows,
        row_len, nbins, int(square), blocks,
    )
    return out, True


def histogram256_range_plain(x, lo, hi, square=False, nbins=256, out=None):
    """Plain twin of :func:`histogram256_range`, on any device."""
    lo, hi = _ends(lo, hi, square)
    counts = histogram256_batch_plain(x, lo, _safe(hi - lo), square, nbins)
    return counts if out is None else out.add_(counts)


def histogram256_range(
    x: torch.Tensor,  # (B, ...) float32 or uint16
    lo: torch.Tensor,  # (B,) float32 range start (min|x| with square)
    hi: torch.Tensor,  # (B,) float32 range end (max|x| with square)
    square: bool = False,
    nbins: int = 256,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact per-plane counts (B, nbins) int32 of ``x`` over ``nbins`` equal
    bins from ``lo`` to ``hi``; with ``square``, of ``x**2`` from ``lo**2``
    to ``hi**2`` (``lo``, ``hi`` are then min|x| and max|x|, the range
    :func:`threshold_otsu_batch <.otsu.threshold_otsu_batch>` bins a
    squared band over). The width ``hi - lo`` and its guard (1 where it is
    not > 0) are formed in the kernel in the plain twin's float32
    operations. ``out``: zeroed (B, nbins) int32 counts to add to (from
    :func:`abs_range_batch`), else a fresh zeroed tensor."""
    if not on_cuda(x):
        return histogram256_range_plain(x, lo, hi, square, nbins, out)
    counts, launched = _launch_hist(
        x, lo, hi, RANGE_ABS if square else RANGE_ENDS, square, nbins,
        out=out)
    histogram256_range.launches += launched
    return counts


def abs_range_batch_plain(x, zero=None):
    """Plain twin of :func:`abs_range_batch`, on any device."""
    if zero is not None:
        zero.zero_()
    a = x.abs()
    dims = tuple(range(1, x.ndim))
    return a.amin(dim=dims), a.amax(dim=dims)


def abs_range_batch(x: torch.Tensor, zero: Optional[torch.Tensor] = None):
    """Per-plane (min|x|, max|x|) of a (B, ...) float32 batch, each (B,)
    float32, exact; the values must be finite. ``zero``: a (B, k) int32
    tensor the same launch fills with zeros (k <= 256: the counts the
    histogram adds to next), so that the squared band's Otsu launches no
    fill of its own. One block reduces each plane, which suits the small
    bands that need it (the dense levels')."""
    if not on_cuda(x):
        return abs_range_batch_plain(x, zero)
    B = x.shape[0]
    n = x.numel() // max(B, 1)
    dev = x.device
    check("x", x, (torch.float32,), dev)
    if B == 0 or n == 0:
        raise ValueError(f"abs_range_batch needs planes with values, got "
                         f"{tuple(x.shape)}")
    nz = 0
    if zero is not None:
        check("zero", zero, (torch.int32,), dev)
        if zero.ndim != 2 or zero.shape[0] != B or zero.shape[1] > _MAX_BINS:
            raise ValueError(f"zero: shape {tuple(zero.shape)} is not (B, k)"
                             f" with B = {B}, k <= {_MAX_BINS}")
        nz = zero.shape[1]
    rng = torch.empty((2, B), dtype=torch.float32, device=dev)
    launch("destripe_abs_range", dev, x.data_ptr(), rng[0].data_ptr(),
           rng[1].data_ptr(), zero.data_ptr() if nz else None, B, n, nz)
    abs_range_batch.launches += 1
    return rng[0], rng[1]


def _cumsum(x):
    """Float32 running sums along dim 1, accumulated in float64 and rounded
    per element: what torch's CPU cumsum does for float32, bit for bit. On
    the card torch's scan runs in an order chosen by the tensor's shape, so
    a float32 scan gave a plane another Otsu bin in a batch of one than in
    a batch of 64; the float64 scan rounds to the same float32 values in
    any order but for ties closer than ~1e-16 relative (the tail kernel
    keeps the CPU's order, so not even those differ)."""
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


def otsu_tail_plain(counts, lo, hi, square=False, sqrt=False, repeat=1):
    """Plain twin of :func:`otsu_tail`, on any device (the thresholds in
    the dtype of ``lo``)."""
    lo, hi = _ends(lo, hi, square)
    nbins = counts.shape[1]
    span = hi - lo
    steps = torch.arange(nbins + 1, dtype=lo.dtype, device=lo.device)
    # edges = lo + span * i / nbins, in the JAX package's order of operations
    edges = lo[:, None] + span[:, None] * steps[None, :] / nbins
    centers = (edges[:, :-1] + edges[:, 1:]) / 2.0
    th = _otsu_tail(counts.to(torch.float32), centers, lo, hi)
    if sqrt:
        th = torch.sqrt(th)
    return th.repeat(repeat) if repeat != 1 else th


def otsu_tail(
    counts: torch.Tensor,  # (B, nbins) int32 from histogram256_range
    lo: torch.Tensor,  # (B,) float32, the counts' range start
    hi: torch.Tensor,  # (B,) float32, the counts' range end
    square: bool = False,
    sqrt: bool = False,
    repeat: int = 1,
) -> torch.Tensor:
    """Per-plane Otsu thresholds (bin centres maximising the inter-class
    variance) from counts over ``nbins`` equal bins from ``lo`` to ``hi``
    (with ``square``, from ``lo**2`` to ``hi**2``, as
    :func:`histogram256_range` bins them); a plane whose range is empty
    returns its start. ``sqrt`` returns their square roots; ``repeat``
    lays them out ``repeat`` times, as ``Tensor.repeat`` does: (repeat *
    B,) float32. One launch, bit for bit the plain twin on the same device
    (the thresholds also the twin's on the CPU; the roots are IEEE's, as
    ``torch.sqrt`` on the card, where torch's CPU sqrt of float32 may be 1
    ulp off)."""
    if repeat < 1:
        raise ValueError(f"repeat {repeat} < 1")
    if not on_cuda(counts):
        return otsu_tail_plain(counts, lo, hi, square, sqrt, repeat)
    dev = counts.device
    check("counts", counts, (torch.int32,), dev)
    if counts.ndim != 2 or not 2 <= counts.shape[1] <= _MAX_BINS:
        raise ValueError(f"counts: shape {tuple(counts.shape)} is not (B, "
                         f"nbins) with 2 <= nbins <= {_MAX_BINS}")
    B, nbins = counts.shape
    check("lo", lo, (torch.float32,), dev, (B,))
    check("hi", hi, (torch.float32,), dev, (B,))
    out = torch.empty((repeat * B,), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    launch("destripe_otsu_tail", dev, counts.data_ptr(), lo.data_ptr(),
           hi.data_ptr(), RANGE_ABS if square else RANGE_ENDS,
           out.data_ptr(), B, nbins, int(sqrt), repeat)
    otsu_tail.launches += 1
    return out


KERNELS = (histogram256_batch, histogram256_range, abs_range_batch,
           otsu_tail)
for _k in KERNELS:
    _k.launches = 0
