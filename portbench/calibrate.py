"""
Readings that set the limits of ``limits/<cell>.json``, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 101-112 \\
        --control-seeds 3 --seconds 2 --out <file.json>

For every seed it runs the cell as a benchmark run does (set-up, a short
window of ``--seconds``, the check against the float64 reference) and keeps
each sampled plane's numbers: the lower readings. For the first
``--control-seeds`` seeds it also holds the control, the reference itself
computed in TF32 (:mod:`portbench.reference.destripe_torch`,
``prec="tf32"``, on the run's device), put in the program's place on the
same sampled planes: the upper readings. It prints one JSON line per seed
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
# the checkout's root, not this folder, on the path: its module names
# would shadow the standard library's
sys.path[:1] = [os.path.dirname(_HERE)]

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.generator import sample_planes  # noqa: E402
from portbench.devtrace import Spans  # noqa: E402


def _seeds(text: str):
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def control_numbers(cell, seed, device):
    """The control's numbers on the planes a run of ``seed`` samples."""
    driver = harness.load_driver(cell.traffic)
    ctx = harness.Ctx(config=cell.config, traffic=cell.traffic, seed=seed,
                      device=torch.device(device), spans=Spans())
    st = driver.setup(ctx)
    grp, must = driver.groups(st)
    ids = sample_planes(seed, grp, int(cell.traffic["check_planes"]),
                        cell.traffic["data"], must)
    raws = [(pid, raw) for pid, raw, _ in driver.outputs(st, ids)]
    flat, dark = st.flat, st.dark
    driver.close(st)
    items = [(pid, raw, check.reference_plane(cell.config, raw, flat, dark,
                                              prec="tf32", device=device))
             for pid, raw in raws]
    return check.compare(cell.config, items, flat, dark, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(_seeds(args.seeds)):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed, args.seconds, False, dev,
                               time.perf_counter())
        row = {"seed": seed, "program": {k: v["value"] for k, v in
                                         res["check"].items()},
               "planes": res["planes_checked"],
               "per_plane": res.get("per_plane"),
               "run_s": time.perf_counter() - t0}
        if i < args.control_seeds:
            t1 = time.perf_counter()
            worst, per_plane = control_numbers(cell, seed, dev)
            row["control"] = worst
            row["control_per_plane"] = per_plane
            row["control_s"] = time.perf_counter() - t1
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload,
                   "card": torch.cuda.get_device_name(dev),
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
