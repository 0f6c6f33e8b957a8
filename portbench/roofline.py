"""
The least time one device step could take on the card, counted from the
step's shapes alone, whatever kernels implement it.

A step destripes a batch of ``B`` uint16 planes (H, W) to uint16 through the
flat-field correction. Its work is listed by role, level by level, each at
its least-work form:

- ``analysis``: log1p of the raw planes (level 0), then per level the x
  lowpass of every row (6 taps) and the y lowpass and highpass of its
  columns (6 taps each); only cA and cH are ever consumed;
- ``histogram``: the Otsu histogram of cH**2 (the square);
- ``median``: the masked row median (a selection: no arithmetic counted);
- ``notch``: per band row and configuration, a real FFT along the row, the
  gains and the inverse (5 n log2 n + n), not the dense product the port
  uses;
- ``synthesis``: only the correction goes through the synthesis (y: 3 taps
  from each of the two stacked halves, 3 at the coarsest level; x: the
  lowpass half, 3 taps), cropped to the level's input size, then exp and
  the flat-field division at level 0;
- ``blend`` (dual): the sigmoid (exp, add, reciprocal), the 17 x 17 box by
  running sums (an add and a subtract per pass) and its scale, the mix (a
  subtract and a multiply-add).

Comparisons, selections and integer work are not counted. Dual-band steps
filter every band with both configurations (2B notches and syntheses) and
blend them; the levels and the analysis are shared.

Bytes are the step's compulsory traffic only: its raw planes read once, the
flat-field and the dark frame read once, its output written once. Every
intermediate is left out, because a step that works a plane at a time keeps
each of them (a 1600 x 2000 plane's widest band is 3.2 MB) in the 50 MB L2.

The bound is ``max(bytes / 3.35 TB/s, operations / 67 TFLOP/s)``, the H100
SXM data sheet's HBM bandwidth and FP32 rate outside the tensor cores, over
the summed counts: a per-role maximum could exceed a kernel that fuses a
bandwidth-bound role with a compute-bound one.
"""

from __future__ import annotations

import math
from collections import OrderedDict

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "FLEN", "levels",
           "step_roles", "step_bound_s"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
FLEN = 6  # db3


def _coeff_len(n: int) -> int:
    return (n + FLEN - 1) // 2


def _max_level(n: int) -> int:
    if n < FLEN - 1:
        return 0
    return int(math.floor(math.log2(n / (FLEN - 1.0))))


def levels(height: int, width: int):
    """Per level, finest first: (input h, input w, band rows, band cols)."""
    out, h, w = [], height, width
    for _ in range(min(_max_level(height), _max_level(width))):
        lh, lw = _coeff_len(h), _coeff_len(w)
        out.append((h, w, lh, lw))
        h, w = lh, lw
    return out


def step_roles(batch: int, height: int, width: int, dual: bool = False):
    """{role: {"bytes": ..., "flops": ...}} of one step (floats)."""
    B, k = float(batch), 2.0 if dual else 1.0
    px = B * height * width
    roles = OrderedDict((r, {"bytes": 0.0, "flops": 0.0}) for r in (
        "analysis", "histogram", "median", "notch", "synthesis", "blend"))
    roles["analysis"]["bytes"] = 2.0 * px  # the raw uint16 planes, once
    roles["analysis"]["flops"] = px  # log1p
    lv = levels(height, width)
    for i, (h, w, lh, lw) in enumerate(lv):
        band = B * lh * lw
        roles["analysis"]["flops"] += B * (12.0 * h * lw + 24.0 * lh * lw)
        roles["histogram"]["flops"] += band
        roles["notch"]["flops"] += k * B * lh * (5.0 * lw * math.log2(lw) + lw)
        y_taps = 6.0 if i == len(lv) - 1 else 12.0
        roles["synthesis"]["flops"] += k * B * (y_taps * h * lw + 6.0 * h * w)
    roles["synthesis"]["flops"] += k * px + px  # exp, flat-field division
    # the flat-field and the dark frame once, the uint16 output once
    roles["synthesis"]["bytes"] = 2.0 * 4.0 * height * width + 2.0 * px
    if dual:
        roles["blend"]["flops"] = 11.0 * px
    return roles


def step_bound_s(batch: int, height: int, width: int, dual: bool = False):
    """(seconds, "bytes" or "operations"): the least time of one step."""
    roles = step_roles(batch, height, width, dual)
    t_bytes = sum(r["bytes"] for r in roles.values()) / HBM_BYTES_PER_S
    t_ops = sum(r["flops"] for r in roles.values()) / FP32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
