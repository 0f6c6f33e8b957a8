"""
Multiscale pyramid reduction: non-overlapping windowed mean on a device.

Counterpart of ``aind_smartspim_destripe_tpu/ops/multiscale.py``: the input
is cropped to extents divisible by the factors, averaged over
non-overlapping windows in float32, and cast back to the input dtype
(truncation for integers).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["windowed_mean"]


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
