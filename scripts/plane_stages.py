#!/usr/bin/env python3
"""Which stage of the port's step makes a plane on the card leave the CPU's
plain path?

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/plane_stages.py [--seed N] [--planes P ...]
        [--save DIR] [--device D] [--size H W]

(``--device cpu --size 160 200`` runs the same comparison on the CPU
against itself at a small size, which checks the script.)

The script builds the production plan for 1600 x 2000 planes, makes the
64 planes of ``chip_smoke.py``'s first step from the same seed (the
planes ``[check-every]`` holds against the CPU), and runs
``ops.filter.destripe_batch`` (flat-field epilogue) on all 64 on the card
and on the planes ``P`` alone on the CPU. It records every stage of both
runs (the dense levels' products, K1-K4, the classifier, the Otsu
thresholds, the notch tails) and prints, stage by stage in the order the
step runs them, how far each plane's card output lies from its CPU output:
the largest difference relative to the plane's largest value, the
classifier's choice and the Otsu thresholds on both sides, and for each
notch tail the coefficients that one side reads as stripes and the other
not. Then, per level, it runs the CPU path again with the card's Otsu
thresholds at that level only (``--swap``, on by default), and prints how
far each such output lies from the card's, so that the level whose
threshold makes the difference shows. Last it prints the final outputs'
distance (max LSB, share of pixels > 1 LSB, PSNR) per plane.

``--save DIR`` writes ``planes.npz`` there: the planes' uint16 input, the
card's and the CPU's uint16 outputs, and both sides' per-level
thresholds, for a witness on another machine (``scripts/jax_witness.py``
runs the JAX package on them).

Nothing here is imported by the package; it only reads it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

PLANES = (5, 7, 25, 48)


def _psnr(d):
    import numpy as np

    mse = float((d.astype(np.float64) ** 2).mean())
    return 10 * np.log10(65535.0**2 / mse) if mse else float("inf")


def _dist(a, b):
    import numpy as np

    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return (f"max {int(d.max())} LSB, {(d > 1).mean():.2e} of pixels > 1 "
            f"LSB, PSNR {_psnr(d):.1f} dB")


def _bin(t, ch):
    """The bin of 256 over [min ch^2, max ch^2] that threshold t (a bin
    center) stands for."""
    a = ch.abs()
    lo = float(a.min()) ** 2
    span = float(a.max()) ** 2 - lo
    return int((t - lo) / span * 256) if span > 0 else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--planes", type=int, nargs="+", default=PLANES)
    ap.add_argument("--save", default=None)
    ap.add_argument("--no-swap", dest="swap", action="store_false")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    dev, cpu = torch.device(args.device), torch.device("cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("plane_stages: no CUDA device", file=sys.stderr)
        return 2
    from batch_stages import SHAPE, Recorder, _volume

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_band, cuda_dense
    from aind_smartspim_destripe_torch.ops import cuda_notch
    from aind_smartspim_destripe_torch.ops import filter as tf

    planes = list(args.planes)
    H, W = args.size or SHAPE[1:]
    tf.f32_matmul()
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(H, W,
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = tf.device_constants(plan, dev)
    vol, flat, dark = _volume(dev, args.seed, H, W)

    rec = Recorder()
    rec.wrap(cuda_dense, "dense_matmul", name="matmul")
    for attr in ("an_x_lowpass_log1p", "an_y_pass", "syn_y_pass",
                 "syn_x_exp"):
        rec.wrap(cuda_band, attr)
    rec.wrap(tf, "classify_from_sums")
    real_otsu = rec.wrap(tf, "threshold_otsu_batch")
    rec.wrap(cuda_notch, "notch_delta")

    def run(x, fl, dk, cs):
        rec.calls, rec.on = [], True
        with torch.inference_mode():
            out = tf.destripe_batch(plan, x, 2500.0, cs, flat=fl, dark=dk)
        rec.on = False
        calls = [(n, tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                           for t in ins),
                  tuple(t.cpu() if isinstance(t, torch.Tensor) else t
                        for t in outs)) for n, ins, outs in rec.calls]
        return calls, out.cpu().numpy()

    card_calls, card_out = run(vol, flat, dark, consts)
    del consts
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    x_cpu = vol.cpu()[planes]
    fl_c, dk_c = flat.cpu(), dark.cpu()
    consts_c = tf.device_constants(plan, cpu)
    cpu_calls, cpu_out = run(x_cpu, fl_c, dk_c, consts_c)
    if [c[0] for c in card_calls] != [c[0] for c in cpu_calls]:
        raise AssertionError("the card and the CPU ran other stages")
    card_out = card_out[planes]
    idx = torch.tensor(planes)
    B = SHAPE[0]

    def mine(t):  # the card's planes P of a batch-carrying output
        if t.ndim and t.shape[0] == B:
            return t[idx]
        if t.ndim and t.shape[0] == 2 * B:  # not on this path
            return t[torch.cat([idx, idx + B])]
        return t

    print(f"[stages] planes {planes}: the card's {B}-plane step vs the CPU "
          f"plain path on these planes alone; per stage and plane the "
          f"largest |card - CPU| over the plane's largest |value|")
    thr = {"card": [], "cpu": []}
    level = 0
    for i, ((name, ins, outs), (_, ins_c, outs_c)) in enumerate(
            zip(card_calls, cpu_calls)):
        notes = []
        for t, t_c in zip(outs, outs_c):
            if not isinstance(t, torch.Tensor):
                continue
            t = mine(t)
            if t.shape != t_c.shape:
                notes.append(f"shapes {tuple(t.shape)} / {tuple(t_c.shape)}")
                continue
            if t.dtype == torch.bool or not t.is_floating_point():
                notes.append("differ on planes " + str(
                    [p for p, a, b in zip(planes, t, t_c)
                     if not torch.equal(a, b)]))
                continue
            rel = [((a.double() - b.double()).abs().max()
                    / b.double().abs().max().clamp_min(1e-300)).item()
                   for a, b in zip(t, t_c)]
            notes.append(" ".join(f"{r:.1e}" for r in rel))
        if name == "threshold_otsu_batch":
            t, t_c = mine(outs[0]), outs_c[0]
            thr["card"].append(t.numpy())
            thr["cpu"].append(t_c.numpy())
            ch, ch_c = mine(ins[0]), ins_c[0]
            # the CPU's Otsu on the card's band: equal to the card's
            # threshold when the two histograms and tails agree
            again = real_otsu(ch, square=True)
            notes.append("otsu(ch^2) card/CPU/CPU on the card's band, bin "
                         "card/CPU: " + ", ".join(
                             f"{p}: {a:.7g}/{b:.7g}/{c:.7g} "
                             f"{_bin(a, x)}/{_bin(b, y)}"
                             f"{'' if a == b else ' *'}"
                             for p, a, b, c, x, y in zip(
                                 planes, t.tolist(), t_c.tolist(),
                                 again.tolist(), ch, ch_c)))
            level += 1
        if name == "classify_from_sums":
            notes.append("cells card/CPU: " + ", ".join(
                f"{p}: {bool(a)}/{bool(b)}" for p, a, b in zip(
                    planes, mine(outs[0]).tolist(), outs_c[0].tolist())))
        if name == "notch_delta":
            ch, th = mine(ins[0]), mine(ins[1])
            ch_c, th_c = ins_c[0], ins_c[1]
            s = torch.sqrt(ch * ch) > th[:, None, None]
            s_c = torch.sqrt(ch_c * ch_c) > th_c[:, None, None]
            notes.append("stripes card/CPU/differ: " + ", ".join(
                f"{p}: {int(a.sum())}/{int(b.sum())}/{int((a != b).sum())}"
                for p, a, b in zip(planes, s, s_c)))
        print(f"  {i:3d} {name:22s} {'x'.join(map(str, outs[0].shape)):16s} "
              + "; ".join(notes))

    print("[output] per plane, card vs CPU: " + "; ".join(
        f"{p}: {_dist(a, b)}" for p, a, b in zip(planes, card_out, cpu_out)))

    if args.swap:
        # the CPU's step with the card's Otsu thresholds at one level
        real = tf.threshold_otsu_batch
        n_otsu = len(thr["card"])
        for lvl in range(n_otsu):
            seen = [0]

            def swapped(*a, _l=lvl, **k):
                out = real(*a, **k)
                if seen[0] == _l:
                    out = torch.from_numpy(thr["card"][_l]).to(out.device)
                seen[0] += 1
                return out

            tf.threshold_otsu_batch = swapped
            try:
                with torch.inference_mode():
                    got = tf.destripe_batch(plan, x_cpu, 2500.0, consts_c,
                                            flat=fl_c, dark=dk_c).numpy()
            finally:
                tf.threshold_otsu_batch = real
            if all(np.array_equal(a, b)
                   for a, b in zip(thr["card"][lvl], thr["cpu"][lvl])):
                continue
            print(f"[swap] the CPU with the card's Otsu thresholds of tail "
                  f"{lvl} (coarsest first), vs the card: " + "; ".join(
                      f"{p}: {_dist(a, b)}"
                      for p, a, b in zip(planes, card_out, got)))

    if args.save:
        out = Path(args.save)
        out.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            out / "planes.npz", planes=np.array(planes),
            images=x_cpu.numpy(), card=card_out, cpu=cpu_out,
            flat=fl_c.numpy(), dark=dk_c.numpy(),
            otsu_card=np.stack(thr["card"]), otsu_cpu=np.stack(thr["cpu"]))
        print(f"[save] {out / 'planes.npz'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
