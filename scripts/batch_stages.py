#!/usr/bin/env python3
"""Which stage of the port's single-device step makes a plane's output
depend on the size of the batch it came in?

Run from the root of a checkout, on a machine with a CUDA card:

    python3 scripts/batch_stages.py [--seed N] [--device D] [--size H W]
        [--small B ...] [--offset O] [--cublas]

(``--device cpu --size 160 200`` runs the same comparison on the CPU's
plain paths at a small size; ``--small 1 --offset 1`` compares plane 1,
the first bright plane, run alone; ``--cublas`` runs the dense levels'
products through ``torch.matmul`` (cuBLAS on a card) instead of
``cuda_dense.dense_matmul``.)

The script builds the production plan for 1600 x 2000 planes, makes the
64 planes that ``chip_smoke.py`` makes from the same seed, and runs
``ops.filter.destripe_batch`` (flat-field epilogue) on all 64 and on the
planes ``offset`` to ``offset + B`` alone for each smaller B (default: the
first 16 and 32). It records the output of every stage of the step (the
matrix products of the dense levels, the K1-K4 calls, the classifier, the
Otsu thresholds and the notch tails) and prints, stage by stage in the
order the step runs them, whether those planes of the 64-plane batch and
the smaller batch agree bit for bit. For the first dense-level product
that differs it then multiplies the SAME inputs again: the 64-plane operand
against its rows of those planes alone (one GEMM of M = B h rows folded
from the batch), then the same product as a batched GEMM of one (h, w)
matrix per plane, per plane, as K sequential multiply-adds
(``torch.addcmul``, one per term of the sum), and, on a card, through
``dense_matmul`` and the same forms on the CPU; each is held against the product in float64 on the host
and against the others bit for bit. Last it prints how far the final
outputs of the two batch sizes lie apart (LSB, pixels over 1 LSB, PSNR),
and, on a card, how far each lies from the CPU's plain path on the same
planes.

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


def _batch_first(t, other, b, off=0):
    """Planes ``off`` to ``off + b`` of ``t`` when it carries a batch axis
    (its leading size differs from the smaller run's), else ``t``."""
    if t.ndim and t.shape[0] != other.shape[0]:
        return t[off:off + b]
    return t


def _sequential(a, op, folded):
    """The product as K sequential multiply-adds in float32, one
    ``addcmul`` per term: every entry sums its terms in k order."""
    import torch

    K = a.shape[-1]
    if folded:  # (B, h, K) @ (K, l)
        acc = torch.zeros(a.shape[:-1] + op.shape[-1:], dtype=a.dtype,
                          device=a.device)
        for k in range(K):
            acc = torch.addcmul(acc, a[..., k:k + 1], op[k:k + 1, :])
        return acc
    # (m, K) @ (B, K, l)
    acc = torch.zeros((op.shape[0], a.shape[0], op.shape[-1]),
                      dtype=a.dtype, device=a.device)
    for k in range(K):
        acc = torch.addcmul(acc, a[None, :, k:k + 1], op[:, k:k + 1, :])
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--size", type=int, nargs=2, default=SHAPE[1:])
    ap.add_argument("--small", type=int, nargs="+", default=SMALL)
    ap.add_argument("--offset", type=int, default=0)
    ap.add_argument("--cublas", action="store_true")
    args = ap.parse_args(argv)
    small, off = tuple(args.small), args.offset

    import numpy as np
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("batch_stages: no CUDA device", file=sys.stderr)
        return 2
    H, W = args.size
    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_band, cuda_dense
    from aind_smartspim_destripe_torch.ops import cuda_notch
    from aind_smartspim_destripe_torch.ops import filter as tf

    tf.f32_matmul()
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(H, W,
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = tf.device_constants(plan, dev)
    vol, flat, dark = _volume(dev, args.seed, H, W)
    print(f"[plan] {(H, W)}: {plan.n_levels} levels, banded levels "
          f"{sorted(int(k[4:]) for k in consts if k.startswith('band'))}, "
          f"ladder {plan.ladder}")

    rec = Recorder()
    matmul = torch.matmul
    dense = cuda_dense.dense_matmul
    if args.cublas:
        cuda_dense.dense_matmul = matmul
    rec.wrap(cuda_dense, "dense_matmul", name="matmul")
    for attr in ("an_x_lowpass_log1p", "an_y_pass", "syn_y_pass",
                 "syn_x_exp"):
        rec.wrap(cuda_band, attr)
    rec.wrap(tf, "classify_from_sums")
    rec.wrap(tf, "threshold_otsu_batch")
    rec.wrap(cuda_notch, "notch_delta")
    runs = {}
    try:
        for b in (SHAPE[0],) + small:
            rec.calls, rec.on = [], True
            x = vol if b == SHAPE[0] else vol[off:off + b]
            with torch.inference_mode():
                out = tf.destripe_batch(plan, x, 2500.0, consts,
                                        flat=flat, dark=dark)
            rec.on = False
            runs[b] = (rec.calls, out.cpu().numpy())
    finally:
        cuda_dense.dense_matmul = dense

    big_calls, big_out = runs[SHAPE[0]]
    first_mm = {}
    for b in small:
        calls, out = runs[b]
        if [c[0] for c in calls] != [c[0] for c in big_calls]:
            raise AssertionError("the two batch sizes ran other stages")
        print(f"[stages] planes {off}-{off + b - 1} of the {SHAPE[0]}-plane "
              f"batch vs a {b}-plane batch, stage by stage:")
        for i, ((name, ins, outs), (_, ins_b, outs_b)) in enumerate(
                zip(big_calls, calls)):
            notes = []
            for t, t_b in zip(outs, outs_b):
                if not isinstance(t, torch.Tensor):
                    continue
                t = _batch_first(t, t_b, b, off)
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
                    torch.equal(_batch_first(x, y, b, off), y)
                    for x, y in zip(ins, ins_b))
                notes.append("inputs bit-equal" if same_ins
                             else "inputs differ")
                if same_ins and notes[0] != "bit-equal":
                    first_mm.setdefault(b, i)
            print(f"  {i:3d} {name:22s} {shape:28s} {'; '.join(notes)}")
        outs = {f"{SHAPE[0]}-plane batch": big_out[off:off + b],
                f"{b}-plane batch": out}
        if dev.type == "cuda":  # the witness: the CPU's plain path
            with torch.inference_mode():
                cpu = tf.destripe_batch(plan, vol[off:off + b].cpu(), 2500.0,
                                        flat=flat.cpu(), dark=dark.cpu())
            outs["CPU plain path"] = cpu.numpy()
        names = list(outs)
        for i, k1 in enumerate(names):
            for k2 in names[i + 1:]:
                d = np.abs(outs[k1].astype(np.int64)
                           - outs[k2].astype(np.int64))
                mse = float((d.astype(np.float64) ** 2).mean())
                psnr = 10 * np.log10(65535.0**2 / mse) if mse else float(
                    "inf")
                print(f"[output] planes {off}-{off + b - 1}: {k1} vs {k2}: "
                      f"max {int(d.max())} LSB, {int((d > 1).sum())} pixels "
                      f"> 1 LSB ({(d > 1).mean():.2e}), PSNR {psnr:.1f} dB")

    # the first product that differs on identical inputs, multiplied again
    for b, i in first_mm.items():
        _, (a, op), _ = big_calls[i]
        sel = slice(off, off + b)
        folded = a.ndim == 3
        if folded:  # (B, h, w) @ (w, l): one GEMM of M = B h rows
            x = a
            prod = lambda xs, o=op: matmul(xs, o)  # noqa: E731
            bmm = lambda xs: torch.bmm(  # noqa: E731
                xs, op.expand(xs.shape[0], *op.shape))
            seq = lambda xs, o=op: _sequential(xs, o, True)  # noqa: E731
            kind = "folded"
        else:  # (m, h) @ (B, h, l): a batched GEMM, one operand broadcast
            x = op
            prod = lambda xs, m=a: matmul(m, xs)  # noqa: E731
            bmm = lambda xs: torch.bmm(  # noqa: E731
                a.expand(xs.shape[0], *a.shape), xs)
            seq = lambda xs, m=a: _sequential(m, xs, False)  # noqa: E731
            kind = "broadcast"
        ref = torch.matmul(*(t.double().cpu() for t in (
            (x[sel], op) if folded else (a, x[sel]))))
        def rows(k):  # the folded GEMM's row count for k planes
            return f" (M={k * a.shape[-2]})" if folded else ""

        part = x[sel].contiguous()
        forms = {
            f"{kind}, {SHAPE[0]} planes{rows(SHAPE[0])}, part":
                lambda: prod(x)[sel],
            f"{kind}, {b} planes{rows(b)}": lambda: prod(part),
            f"bmm, {SHAPE[0]} planes, part": lambda: bmm(x)[sel],
            f"bmm, {b} planes": lambda: bmm(part),
            "per plane": lambda: torch.stack(
                [prod(x[j]) for j in range(off, off + b)]),
            "sequential multiply-adds": lambda: seq(part),
        }
        if dev.type == "cuda":
            forms[f"dense_matmul, {SHAPE[0]} planes, part"] = (
                lambda: (dense(x, op) if folded else dense(a, x))[sel])
            forms[f"dense_matmul, {b} planes"] = (
                lambda: dense(part, op) if folded else dense(a, part))
        if dev.type == "cuda":
            a_c, op_c, x_c = a.cpu(), op.cpu(), x.cpu()
            part_c = x_c[sel].contiguous()
            if folded:
                forms[f"CPU folded, {SHAPE[0]} planes, part"] = (
                    lambda: matmul(x_c, op_c)[sel])
                forms[f"CPU folded, {b} planes"] = (
                    lambda: matmul(part_c, op_c))
                forms["CPU sequential multiply-adds"] = (
                    lambda: _sequential(part_c, op_c, True))
            else:
                forms[f"CPU broadcast, {SHAPE[0]} planes, part"] = (
                    lambda: matmul(a_c, x_c)[sel])
                forms[f"CPU broadcast, {b} planes"] = (
                    lambda: matmul(a_c, part_c))
                forms["CPU sequential multiply-adds"] = (
                    lambda: _sequential(a_c, part_c, False))
        got = {k: f().cpu() for k, f in forms.items()}
        print(f"[product] stage {i}: {tuple(a.shape)} @ {tuple(op.shape)} "
              f"on the same inputs (planes {off}-{off + b - 1} compared); "
              f"forms numbered, each with the forms it equals bit for bit:")
        keys = list(got)
        for n, (k, v) in enumerate(got.items()):
            err = (v.double() - ref).abs().max().item()
            same = [m for m, k2 in enumerate(keys)
                    if m != n and torch.equal(v, got[k2])]
            print(f"  {n} {k:40s} bit-equal to {same or 'none'}; max |err| "
                  f"vs float64 {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
