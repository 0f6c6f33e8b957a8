#!/usr/bin/env python3
"""sha256 of the plane step's output on chip_smoke.py's smoke batch, for
the package of another checkout, so that two commits' steps can be held
bit for bit against each other on one card.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/step_hash.py --root DIR [--seed N] [--repeat N]

DIR holds the ``aind_smartspim_destripe_torch`` package to measure (for
example ``git archive`` of the parent commit, unpacked); it is put first
on the import path, and this checkout's chip_smoke.py builds the same
64-plane batch of 1600 x 2000 uint16 planes from the seed and runs its
``[step]`` and ``[step-dual]`` measurements (step_ms) with that package,
``--repeat`` times each (the step's time moves with the host's launch
time, so one reading does not give its spread), then the row-sharded
step on plane 0 of chip_smoke.py's 16384 x 18000 halo tile on a mesh of
two entries on ``cuda:0`` (halo_step, as chip_smoke.py's ``[step-halo]``
and ``[step-dual-halo]`` run it on one card), single band and then dual
band, ``--repeat`` times each, and prints the sha256 of each output. The
``[step] sha256``, ``[step-dual] sha256``, ``[step-halo] sha256`` and
``[step-dual-halo] sha256`` lines compare with chip_smoke.py's own; the
last line is the digests as JSON.
"""

import argparse
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("step_hash: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from aind_smartspim_destripe_torch.ops import filter as tf

    print(f"[step-hash] package {Path(tf.__file__).resolve().parents[2]}")
    tf.f32_matmul()
    dev = torch.device("cuda", 0)
    plan = smoke.tf_build_plan(*smoke.SHAPE[1:])
    vol, flats, dark = smoke.synthetic_tile(dev, args.seed)
    digests = {}
    for tag, dual in (("step", False), ("step-dual", True)):
        got = {smoke.step_ms(tag, plan, vol, flats[0], dark, dev, dual=dual,
                             seed=args.seed) for _ in range(args.repeat)}
        if len(got) != 1:
            raise AssertionError(f"[{tag}] output differs between runs")
        digests[tag] = got.pop()
    del vol, flats, dark
    hplan = smoke.tf_build_plan(*smoke.HALO_SHAPE[1:])
    vol, flats, dark = smoke.halo_tile(dev, args.seed)
    for tag, dual in (("halo", False), ("dual-halo", True)):
        got = set()
        for _ in range(args.repeat):
            out, _ = smoke.halo_step(tag, hplan, vol, flats[0], dark,
                                     [dev, dev], dual=dual)
            got.add(hashlib.sha256(np.ascontiguousarray(out).tobytes())
                    .hexdigest())
            del out
        if len(got) != 1:
            raise AssertionError(f"[step-{tag}] output differs between runs")
        digests[f"step-{tag}"] = got.pop()
        print(f"[step-{tag}] sha256 of the row-sharded step's output on "
              f"plane 0 of the halo tile: {digests[f'step-{tag}']}")
    print(json.dumps(digests))
    return 0


if __name__ == "__main__":
    sys.exit(main())
