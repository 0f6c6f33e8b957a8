#!/usr/bin/env python3
"""The capsule on one card against the capsule split over every card.

Run from the root of a checkout, on a host of two or more CUDA cards:

    python3 scripts/mesh_capsule.py [--seed N]

It builds the kernels and ``chip_smoke.py``'s synthetic capsule (one tile
of 128 x 1600 x 2000 uint16 planes with flats and dark, from the same
seed), makes every card's context once, then runs ``run_capsule.run``
single band and dual band, each three ways in the order A B C C B A:
``devices=None`` (the default: planes this size run on the first card),
``[cuda:0]``, and the plane split over every card (an explicit list). It
prints each run's MPix/s and the pipeline's read / compute / write
seconds (``chip_smoke.run_path``), then ``chip_smoke.phase_zmesh`` on
every card: the plane-sharded device step against one card's.
"""

import argparse
import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import subprocess

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("mesh_capsule: needs two or more CUDA cards", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_build
    from aind_smartspim_destripe_torch.ops import filter as tf

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    tf.f32_matmul()
    cuda_build.kernel_library()
    n = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n)]
    t0 = time.perf_counter()
    for d in cards:
        a = torch.ones((64, 64), device=d)
        torch.matmul(a, a)
        torch.cuda.synchronize(d)
    print(f"[env] {n} cards initialised in {time.perf_counter() - t0:.2f} s")

    dev = cards[0]
    work = ROOT / "build" / "mesh_capsule"
    shutil.rmtree(work, ignore_errors=True)
    vol, flats, dark = cs.synthetic_tile(dev, args.seed)
    data, _, _ = cs.build_capsule(work, vol, flats, dark)
    ways = {"default": None, "one": [dev], "mesh": cards}
    try:
        for mode, kernels in (("single", cs.SINGLE), ("dual", cs.PLANE)):
            if mode == "dual":
                os.environ["DESTRIPE_DUAL_BAND"] = "1"
            for i, way in enumerate(("default", "one", "mesh", "mesh",
                                     "one", "default")):
                results = work / f"results_{mode}_{way}_{i}"
                results.mkdir()
                cs.run_path(f"{mode}-{way}", data, results, kernels,
                            devices=ways[way])
                shutil.rmtree(results)
            os.environ.pop("DESTRIPE_DUAL_BAND", None)
        cfg = run_capsule.PRODUCTION_PARAMETERS
        plan = tf.build_plan(cs.SHAPE[1], cs.SHAPE[2],
                             tf.FilterConfig.from_dict(cfg["cells_config"]),
                             tf.FilterConfig.from_dict(cfg["no_cells_config"]))
        cs.phase_zmesh(plan, vol, flats[0], dark, dev, cards)
    finally:
        os.environ.pop("DESTRIPE_DUAL_BAND", None)
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
