#!/usr/bin/env python3
"""Which stage of the port's single-device step makes a plane's output
depend on the size of the batch it came in?

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/batch_stages.py [--seed N] [--device D] [--size H W]

(``--device cpu --size 160 200`` runs the same comparison on the CPU's
plain paths at a small size.)

The script builds the production plan for 1600 x 2000 planes, makes the
64 planes that ``chip_smoke.py`` makes from the same seed, and runs
``ops.filter.destripe_batch`` (flat-field epilogue) on all 64 and on their
first 16 and 32 alone. It records the output of every stage of the step
(the matrix products of the dense levels, the K1-K4 calls, the classifier,
the Otsu thresholds and the notch tails) and prints, stage by stage in the
order the step runs them, whether the first planes of the 64-plane batch
and the smaller batch agree bit for bit. For the first dense-level product
that differs it then multiplies the SAME inputs again: the 64-plane operand
against its first rows alone (one GEMM of M = B h rows folded from the
batch), then the same product as a batched GEMM of one (h, w) matrix per
plane, and per plane, each held against the product in float64 on the
host. Last it prints how far the final outputs of the two batch sizes lie
apart (LSB, pixels over 1 LSB, PSNR).

Nothing here is imported by the package; it only reads it.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPE = (64, 1600, 2000)
SMALL = (16, 32)


def _volume(dev, seed, H, W):
    """The first 64 planes of chip_smoke.py's synthetic tile (same seed),
    its flat-field and dark."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    Z = 128
    z = torch.arange(Z, device=dev)[:, None, None]
    base = torch.where(z % 4 == 1, 3000.0, 280.0)
    vol = base + torch.randn((Z, H, 1), generator=g, device=dev) * 50
    vol = vol + torch.randn((Z, H, W), generator=g, device=dev) * 8
    vol = vol.clamp_(0, 65535).to(torch.int32).to(torch.uint16)[:SHAPE[0]]
    yy = np.linspace(-1, 1, H, dtype=np.float32)[:, None]
    xx = np.linspace(-1, 1, W, dtype=np.float32)[None, :]
    flat = (1.0 + 0.3 * (xx * xx + yy * yy) / 2).astype(np.float32)
    dark = (3 + (np.arange(W) % 3)[None, :] * np.ones((H, 1))).astype(
        np.float32)
    return (vol.contiguous(), torch.from_numpy(flat).to(dev),
            torch.from_numpy(dark).to(dev))


class Recorder:
    """Wraps the step's stage functions and keeps (name, inputs, outputs)
    of every call, cloned."""

    def __init__(self):
        self.calls = []
        self.on = False

    def wrap(self, owner, attr, name=None):
        import functools

        import torch

        fn = getattr(owner, attr)

        @functools.wraps(fn)  # a wrapper's launch count goes along
        def rec(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.on:
                keep = lambda t: (t.clone() if isinstance(t, torch.Tensor)  # noqa: E731
                                  else t)
                outs = out if isinstance(out, tuple) else (out,)
                self.calls.append((name or attr, tuple(map(keep, args)),
                                   tuple(map(keep, outs))))
            return out

        setattr(owner, attr, rec)
        return fn


def _batch_first(t, other, b):
    """The first ``b`` planes of ``t`` when it carries a batch axis (its
    leading size differs from the smaller run's), else ``t``."""
    if t.ndim and t.shape[0] != other.shape[0]:
        return t[:b]
    return t


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=SHAPE[1:])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_stages: no CUDA device", file=sys.stderr)
        return 2
    H, W = args.size
    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_band, cuda_notch
    from aind_smartspim_destripe_torch.ops import filter as tf

    tf.f32_matmul()
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(H, W,
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = tf.constants_from_numpy(plan.constants(), dev)
    vol, flat, dark = _volume(dev, args.seed, H, W)
    print(f"[plan] {(H, W)}: {plan.n_levels} levels, banded levels "
          f"{sorted(int(k[4:]) for k in consts if k.startswith('band'))}, "
          f"ladder {plan.ladder}")

    rec = Recorder()
    matmul = rec.wrap(torch, "matmul")
    for attr in ("an_x_lowpass_log1p", "an_y_pass", "syn_y_pass",
                 "syn_x_exp"):
        rec.wrap(cuda_band, attr)
    rec.wrap(tf, "classify_from_sums")
    rec.wrap(tf, "threshold_otsu_batch")
    rec.wrap(cuda_notch, "notch_delta")
    runs = {}
    try:
        for b in (SHAPE[0],) + SMALL:
            rec.calls, rec.on = [], True
            with torch.inference_mode():
                out = tf.destripe_batch(plan, vol[:b], 2500.0, consts,
                                        flat=flat, dark=dark)
            rec.on = False
            runs[b] = (rec.calls, out.cpu().numpy())
    finally:
        torch.matmul = matmul

    big_calls, big_out = runs[SHAPE[0]]
    first_mm = {}
    for b in SMALL:
        calls, out = runs[b]
        if [c[0] for c in calls] != [c[0] for c in big_calls]:
            raise AssertionError("the two batch sizes ran other stages")
        print(f"[stages] first {b} planes of the {SHAPE[0]}-plane batch vs "
              f"a {b}-plane batch, stage by stage:")
        for i, ((name, ins, outs), (_, ins_b, outs_b)) in enumerate(
                zip(big_calls, calls)):
            notes = []
            for t, t_b in zip(outs, outs_b):
                if not isinstance(t, torch.Tensor):
                    continue
                t = _batch_first(t, t_b, b)
                if t.dtype == torch.bool or not t.is_floating_point():
                    n = int((t != t_b).sum())
                    notes.append(f"{n} of {t.numel()} differ")
                    continue
                d = (t - t_b).abs()
                notes.append(
                    "bit-equal" if torch.equal(t, t_b) else
                    f"max |diff| {d.max().item():.3e} on "
                    f"{int((d > 0).sum())} of {t.numel()}")
            shape = "x".join(map(str, outs[0].shape))
            if name == "matmul":
                a, op = ins
                shape = (f"{tuple(a.shape)} @ {tuple(op.shape)}")
                same_ins = all(
                    torch.equal(_batch_first(x, y, b), y)
                    for x, y in zip(ins, ins_b))
                notes.append("inputs bit-equal" if same_ins
                             else "inputs differ")
                if same_ins and notes[0] != "bit-equal":
                    first_mm.setdefault(b, i)
            print(f"  {i:3d} {name:22s} {shape:28s} {'; '.join(notes)}")
        d = np.abs(big_out[:b].astype(np.int64) - out.astype(np.int64))
        mse = float((d.astype(np.float64) ** 2).mean())
        psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
        print(f"[output] {b} vs {SHAPE[0]} planes: max {int(d.max())} LSB, "
              f"{int((d > 1).sum())} pixels > 1 LSB "
              f"({(d > 1).mean():.2e}), PSNR {psnr:.1f} dB")

    # the first product that differs on identical inputs, multiplied again
    for b, i in first_mm.items():
        _, (a, op), _ = big_calls[i]
        if a.ndim == 3:  # (B, h, w) @ (w, l): one GEMM of M = B h rows
            x = a
            prod = lambda xs: matmul(xs, op)  # noqa: E731
            bmm = lambda xs: torch.bmm(  # noqa: E731
                xs, op.expand(xs.shape[0], *op.shape))
            kind = "folded"
        else:  # (m, h) @ (B, h, l): a batched GEMM, one operand broadcast
            x = op
            prod = lambda xs: matmul(a, xs)  # noqa: E731
            bmm = lambda xs: torch.bmm(  # noqa: E731
                a.expand(xs.shape[0], *a.shape), xs)
            kind = "broadcast"
        ref = torch.matmul(*(t.double().cpu() for t in (
            (x[:b], op) if a.ndim == 3 else (a, x[:b]))))
        def rows(k):  # the folded GEMM's row count for k planes
            return f" (M={k * a.shape[-2]})" if a.ndim == 3 else ""

        forms = {
            f"{kind}, {SHAPE[0]} planes{rows(SHAPE[0])}, first {b}":
                lambda: prod(x)[:b],
            f"{kind}, {b} planes{rows(b)}": lambda: prod(x[:b].contiguous()),
            f"bmm, {SHAPE[0]} planes, first {b}": lambda: bmm(x)[:b],
            f"bmm, {b} planes": lambda: bmm(x[:b].contiguous()),
            "per plane": lambda: torch.stack(
                [prod(x[j]) for j in range(b)]),
        }
        got = {k: f() for k, f in forms.items()}
        base = next(iter(got.values()))
        print(f"[product] stage {i}: {tuple(a.shape)} @ {tuple(op.shape)} "
              f"on the same inputs ({b} planes compared):")
        for k, v in got.items():
            err = (v.double().cpu() - ref).abs().max().item()
            print(f"  {k:44s} bit-equal to the first: "
                  f"{torch.equal(v, base)}; max |err| vs float64 {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
