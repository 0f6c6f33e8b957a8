"""
Per-plane fixed-bin histograms for the Otsu threshold: the wrapper of the
Hopper kernel in ``csrc/hist.cu`` and its plain PyTorch twin.

Counterpart of ``aind_smartspim_destripe_tpu/ops/pallas_hist.py``. The
wrapper dispatches on the device of its input: a CPU tensor takes the plain
twin (``torch.bincount`` in integers, also callable directly as
``histogram256_batch_plain`` on any device), a CUDA tensor launches the
kernel or raises. It counts its kernel launches in
``histogram256_batch.launches``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .cuda_build import check, launch, on_cuda

__all__ = [
    "bin_index",
    "hist_blocks",
    "histogram256_batch",
    "histogram256_batch_plain",
    "KERNELS",
]

_THREADS = 256  # threads per block (csrc/hist.cu kThreads)
_PER_THREAD = 256  # values a thread counts, where the grid allows
_BLOCKS_PER_SM = 8  # the grid's least fill: blocks of all planes per SM
_MIN_PER_THREAD = 32  # no more blocks than give a thread this many values
_MAX_BINS = 256  # the kernel's striped copies hold 256 bins
_MAX_PLANES = 65535  # grid.y


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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

    B = x.shape[0]
    n = x.numel() // max(B, 1)
    dev = x.device
    if not 0 < nbins <= _MAX_BINS:
        raise ValueError(f"nbins {nbins} outside 1..{_MAX_BINS}")
    if B > _MAX_PLANES:
        raise ValueError(f"{B} planes exceed the kernel's grid "
                         f"({_MAX_PLANES})")
    check("x", x, (torch.float32, torch.uint16), dev)
    check("lo", lo, (torch.float32,), dev, (B,))
    check("span", span, (torch.float32,), dev, (B,))
    rows = 1 if row_bound is None else _rows(x, row_bound).shape[1]
    row_len = n if row_bound is None else n // max(x.shape[1], 1)
    n_valid = rows * row_len
    counts = torch.zeros((B, nbins), dtype=torch.int32, device=dev)
    if B == 0 or n_valid == 0:
        return counts
    blocks = hist_blocks(B, n_valid, _sm_count(dev.index))
    launch(
        "destripe_hist", dev, x.data_ptr(), int(x.dtype == torch.uint16),
        lo.data_ptr(), span.data_ptr(), counts.data_ptr(), B, n, rows,
        row_len, nbins, int(square), blocks,
    )
    histogram256_batch.launches += 1
    return counts


KERNELS = (histogram256_batch,)
for _k in KERNELS:
    _k.launches = 0
