"""
Multiscale pyramid reduction: non-overlapping windowed mean on a device.

Counterpart of ``aind_smartspim_destripe_tpu/ops/multiscale.py``: the input
is cropped to extents divisible by the factors, averaged over
non-overlapping windows in float32, and cast back to the input dtype
(truncation for integers). :func:`windowed_mean_np` is its numpy twin
(float64 mean), the pyramid's oracle.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["windowed_mean", "windowed_mean_np"]


def windowed_mean(
    x: torch.Tensor,
    factors: Tuple[int, ...] = (2, 2, 2),
    preserve_dtype: bool = True,
) -> torch.Tensor:
    """Windowed mean over the trailing ``len(factors)`` axes (leading axes
    pass through), on the device of ``x``."""
    nf = len(factors)
    lead = tuple(x.shape[: x.ndim - nf])
    cropped = tuple((s // f) * f for s, f in zip(x.shape[x.ndim - nf:], factors))
    sl = (slice(None),) * len(lead) + tuple(slice(0, c) for c in cropped)
    xf = x[sl].to(torch.float32)
    split = list(lead)
    for c, f in zip(cropped, factors):
        split += [c // f, f]
    red = tuple(len(lead) + 2 * i + 1 for i in range(nf))
    y = xf.reshape(split).sum(dim=red) / float(np.prod(factors))
    if not preserve_dtype:
        return y
    if x.dtype == torch.uint16:
        return y.to(torch.int32).to(torch.uint16)
    return y.to(x.dtype)


def windowed_mean_np(x: np.ndarray, factors=(2, 2, 2),
                     preserve_dtype: bool = True) -> np.ndarray:
    """numpy twin of :func:`windowed_mean`: the mean in float64, cast back
    to ``x``'s dtype (truncation for integers) unless ``preserve_dtype`` is
    False."""
    nf = len(factors)
    lead = x.shape[: x.ndim - nf]
    cropped = tuple((s // f) * f for s, f in zip(x.shape[x.ndim - nf:], factors))
    x = x[(slice(None),) * len(lead) + tuple(slice(0, c) for c in cropped)]
    split = list(lead)
    for c, f in zip(cropped, factors):
        split += [c // f, f]
    red = tuple(len(lead) + 2 * i + 1 for i in range(nf))
    y = x.reshape(split).astype(np.float64).mean(axis=red)
    return y.astype(x.dtype) if preserve_dtype else y
