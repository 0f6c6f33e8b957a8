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

from typing import Optional

import torch

from .cuda_build import check, launch, on_cuda

__all__ = [
    "bin_index",
    "histogram256_batch",
    "histogram256_batch_plain",
    "KERNELS",
]

_THREADS = 256
_ELEMS_PER_THREAD = 16  # a block covers at least this many values per thread
_MAX_BLOCKS = 64  # blocks per plane
_MAX_BINS = 1024  # shared memory holds one copy of the bins per warp


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
    check("x", x, (torch.float32, torch.uint16), dev)
    check("lo", lo, (torch.float32,), dev, (B,))
    check("span", span, (torch.float32,), dev, (B,))
    rows = 1 if row_bound is None else _rows(x, row_bound).shape[1]
    row_len = n if row_bound is None else n // max(x.shape[1], 1)
    n_valid = rows * row_len
    counts = torch.zeros((B, nbins), dtype=torch.int32, device=dev)
    blocks = max(1, min(_MAX_BLOCKS,
                        -(-n_valid // (_THREADS * _ELEMS_PER_THREAD))))
    launch(
        "destripe_hist", dev, x.data_ptr(), int(x.dtype == torch.uint16),
        lo.data_ptr(), span.data_ptr(), counts.data_ptr(), B, n, rows,
        row_len, nbins, int(square), _THREADS, blocks,
    )
    histogram256_batch.launches += 1
    return counts


KERNELS = (histogram256_batch,)
for _k in KERNELS:
    _k.launches = 0
