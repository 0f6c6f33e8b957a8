"""
Blocked array writer: stream a (lazy) array into a Zarr array in large
sequential blocks, bounding scheduler/metadata overhead at TB scale.

Counterpart of ``aind_smartspim_destripe_tpu/io/blocked_writer.py`` (numpy
only), with the contract of the reference BlockedArrayWriter:
- ``expand_chunks``: grow a base chunk shape toward a byte target, either by
  doubling one dimension at a time ("cycle") or by integer multiples of the
  base chunk ("iso"); pick whichever of the last two candidates lands closer
  to the target.
- ``gen_slices``: tile an array shape with block-shaped slice tuples
  (tail blocks truncated).
- ``store``: copy block-by-block from any sliceable source into any
  sliceable destination (our ZarrArray, a numpy array, or a lazy wrapper),
  optionally fanning blocks across a thread pool (sources/destinations with
  disjoint regions are race-free, mirroring the reference's lock=False).
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Generator, Iterable, Tuple

import numpy as np

__all__ = ["expand_chunks", "BlockedArrayWriter"]


def _nbytes(shape: Tuple[int, ...], itemsize: int) -> int:
    if any(s <= 0 for s in shape):
        raise ValueError("shape must be > 0 in all dimensions")
    return int(np.prod(shape)) * itemsize


def _closer_to_target(shape1, shape2, target_bytes: int, itemsize: int):
    s1, s2 = _nbytes(shape1, itemsize), _nbytes(shape2, itemsize)
    return shape1 if abs(s1 - target_bytes) < abs(s2 - target_bytes) else shape2


def expand_chunks(
    chunks: Tuple[int, ...],
    data_shape: Tuple[int, ...],
    target_size: int,
    itemsize: int,
    mode: str = "iso",
) -> Tuple[int, ...]:
    """Grow ``chunks`` toward ``target_size`` bytes, capped at ``data_shape``
    (reference blocked_zarr_writer.py:51-119 semantics)."""
    if any(c < 1 for c in chunks):
        raise ValueError("chunks must be >= 1 for all dimensions")
    if any(s < 1 for s in data_shape):
        raise ValueError("data_shape must be >= 1 for all dimensions")
    if any(c > s for c, s in zip(chunks, data_shape)):
        raise ValueError("chunks cannot be larger than data_shape in any dimension")
    if target_size <= 0:
        raise ValueError("target_size must be > 0")
    if itemsize <= 0:
        raise ValueError("itemsize must be > 0")

    ndim = len(chunks)
    if mode == "cycle":
        current = list(chunks)
        prev = list(current)
        axis = 0
        while _nbytes(current, itemsize) < target_size:
            prev = list(current)
            d = axis % ndim
            current[d] = min(data_shape[d], current[d] * 2)
            axis += 1
            if all(c >= s for c, s in zip(current, data_shape)):
                break
        expanded = _closer_to_target(current, prev, target_size, itemsize)
    elif mode == "iso":
        current = tuple(chunks)
        prev = current
        factor = 2
        while _nbytes(current, itemsize) < target_size:
            prev = current
            current = tuple(
                min(s, c * factor) for c, s in zip(chunks, data_shape)
            )
            factor += 1
            if all(c >= s for c, s in zip(current, data_shape)):
                break
        expanded = _closer_to_target(current, prev, target_size, itemsize)
    else:
        raise ValueError(f"Invalid mode {mode}")

    return tuple(int(x) for x in expanded)


class BlockedArrayWriter:
    """Static helpers for block-sequential bulk copies."""

    @staticmethod
    def gen_slices(
        arr_shape: Tuple[int, ...], block_shape: Tuple[int, ...]
    ) -> Generator[Tuple[slice, ...], None, None]:
        if len(arr_shape) != len(block_shape):
            raise Exception("array shape and block shape have different lengths")
        starts = [range(0, s, b) for s, b in zip(arr_shape, block_shape)]
        for origin in itertools.product(*starts):
            yield tuple(
                slice(o, min(o + b, s))
                for o, b, s in zip(origin, block_shape, arr_shape)
            )

    @staticmethod
    def store(in_array, out_array, block_shape, n_threads: int = 0):
        """Copy ``in_array`` into ``out_array`` block by block. With
        ``n_threads > 1`` blocks are copied concurrently (disjoint regions)."""
        slices: Iterable = BlockedArrayWriter.gen_slices(
            tuple(in_array.shape), tuple(block_shape)
        )
        if n_threads and n_threads > 1:
            def copy(sl):
                out_array[sl] = np.asarray(in_array[sl])

            with ThreadPoolExecutor(max_workers=n_threads) as pool:
                list(pool.map(copy, list(slices)))
        else:
            for sl in slices:
                out_array[sl] = np.asarray(in_array[sl])

    @staticmethod
    def get_block_shape(arr, target_size_mb: int = 409600, mode: str = "cycle",
                        item_size: int = None):
        """Block shape for the last 3 dims of ``arr`` targeting
        ``target_size_mb`` (reference blocked_zarr_writer.py:209-236)."""
        chunks = tuple(arr.chunks[-3:]) if hasattr(arr, "chunks") else None
        if chunks is None:
            raise ValueError("array must expose .chunks")
        itemsize = item_size or getattr(arr, "itemsize", None) or np.dtype(arr.dtype).itemsize
        return expand_chunks(
            chunks, tuple(arr.shape[-3:]), target_size_mb * 1024**2, itemsize, mode
        )
