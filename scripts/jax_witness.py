#!/usr/bin/env python3
"""A second witness for planes where the port's card and CPU outputs part:
the JAX package, on the CPU, on the same planes.

    JAX_PLATFORMS=cpu python3 scripts/jax_witness.py DIR/planes.npz

``planes.npz`` is what ``scripts/plane_stages.py --save DIR`` writes on a
machine with a card: the planes' uint16 input, the card's and the port's
CPU uint16 outputs, the flat-field and dark frame, and both sides' Otsu
thresholds per level (otsu of ch^2, coarsest tail first). For each plane
alone the script runs the JAX package's ``destripe_batch`` (the XLA
formulation, as off a TPU) with the same flat-field epilogue, recording
its Otsu thresholds, and prints per plane:

- the final output against the card's and against the port's CPU output
  (max LSB, share of pixels > 1 LSB, PSNR);
- per level, the three Otsu thresholds (card / port CPU / JAX), marking
  the levels where they disagree.

Needs JAX and the JAX package; the port's card is not needed. Nothing
here is imported by either package.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _dist(a, b):
    import numpy as np

    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
    return (f"max {int(d.max())} LSB, {(d > 1).mean():.2e} of pixels > 1 "
            f"LSB, PSNR {psnr:.1f} dB")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np

    from aind_smartspim_destripe_tpu import run_capsule
    from aind_smartspim_destripe_tpu.ops import filter as jf

    z = np.load(args.npz)
    planes = [int(p) for p in z["planes"]]
    images, card, cpu = z["images"], z["card"], z["cpu"]
    _, H, W = images.shape
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = jf.build_plan(H, W, jf.FilterConfig.from_dict(cfg["cells_config"]),
                         jf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = plan.constants()
    real = jf.threshold_otsu_batch
    seen = []

    def recorded(*a, **k):
        out = real(*a, **k)
        seen.append(np.asarray(out))
        return out

    jf.threshold_otsu_batch = recorded
    try:
        for i, p in enumerate(planes):
            seen.clear()
            got = np.asarray(jf.destripe_batch(
                plan, jnp.asarray(images[i:i + 1]), 2500.0, consts,
                flat=jnp.asarray(z["flat"]), dark=jnp.asarray(z["dark"])))[0]
            print(f"[jax] plane {p}: JAX vs card: {_dist(got, card[i])}; "
                  f"JAX vs port CPU: {_dist(got, cpu[i])}; card vs port "
                  f"CPU: {_dist(card[i], cpu[i])}")
            for lvl, t in enumerate(seen):
                a = float(z["otsu_card"][lvl][i])
                b = float(z["otsu_cpu"][lvl][i])
                c = float(np.ravel(t)[0])
                mark = "" if a == b == c else " *"
                print(f"  otsu(ch^2) tail {lvl}: card {a:.9g}, port CPU "
                      f"{b:.9g}, JAX {c:.9g}{mark}")
    finally:
        jf.threshold_otsu_batch = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
