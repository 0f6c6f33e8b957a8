"""
The comparison that decides ``correct``.

Each sampled plane that the timed path produced (uint16, after the
flat-field correction) is held against the plain reference
(:mod:`portbench.reference.destripe_torch`) computed in float64 on the
run's device, one plane after another, from the same raw plane, flat-field
and dark frame. Two numbers are compared, each with the limit of the cell's
``limits/<cell>.json``:

- ``rms_lsb``: the largest root-mean-square difference of a plane, in
  counts of the uint16 output;
- ``max_lsb``: the largest absolute difference of any pixel, in counts.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .reference import destripe_torch as ref

__all__ = ["NUMBERS", "reference_plane", "plane_numbers", "compare",
           "load_limits"]

NUMBERS = ("rms_lsb", "max_lsb")
MISSING = 65536.0  # the reading of a plane that is absent or malformed


def reference_plane(config: dict, raw, flat, dark, prec="f64",
                    device="cpu"):
    """The reference's uint16 output for one raw plane of ``config``,
    computed on ``device``, as a host array."""
    cells, no_cells = config["cells_config"], config["no_cells_config"]
    if config.get("dual_band"):
        out = ref.destripe_plane_dual(
            raw, flat, dark, cells, no_cells,
            crossover=float(config["crossover"]),
            radius=int(config["smooth_radius"]), prec=prec, device=device)
    else:
        out = ref.destripe_plane(raw, flat, dark, cells, no_cells,
                                 float(config["microscope_high_int"]),
                                 prec=prec, device=device)
    return out.cpu().numpy()


def plane_numbers(got, want) -> dict:
    d = got.astype(np.int64) - want.astype(np.int64)
    return {"rms_lsb": float(np.sqrt(np.mean(d * d))),
            "max_lsb": float(np.abs(d).max())}


def compare(config: dict, items, flat, dark, prec: str = "f64",
            device="cpu"):
    """``items``: [(plane id, raw uint16 plane, output uint16 plane or None
    when the window never produced it)]. Returns (the worst of each number
    over the items, [(plane id, numbers)])."""
    flat, dark = (torch.as_tensor(a, device=device) for a in (flat, dark))

    def one(item):
        pid, raw, got = item
        if got is None or got.shape != raw.shape or got.dtype != np.uint16:
            return pid, {k: MISSING for k in NUMBERS}
        return pid, plane_numbers(got, reference_plane(config, raw, flat,
                                                       dark, prec, device))

    per_plane = [one(item) for item in items]
    worst = {k: max((v[k] for _, v in per_plane), default=MISSING)
             for k in NUMBERS}
    return worst, per_plane


def load_limits(root: Path, cell: str) -> dict:
    """{number: limit} of ``limits/<cell>.json``."""
    with open(Path(root) / "limits" / f"{cell}.json") as f:
        spec = json.load(f)
    return {k: float(spec[k]["limit"]) for k in NUMBERS}
