#!/usr/bin/env python3
"""Times of K2 (``an_y_pass``), K3 (``syn_y_pass``), K4 (``syn_x_exp``,
``syn_x_exp_chunked``), the row medians (``row_median_batch``,
``row_median_masked``), the Otsu histogram and the dual-band blend
(``blend_smooth_mix``) for the package of another checkout, so that two
commits' kernels can be timed in one call on one card.

Run from the root of a checkout, on a machine with one card:

    python3 scripts/kernel_ab.py [--root DIR] [--seed N] [--reps N]
                                 [--only REGEX]

DIR holds the ``aind_smartspim_destripe_torch`` package to measure (by
default this checkout's; for example ``git archive`` of the parent
commit, unpacked); it is put first on the import path, and the kernels
are timed with CUDA events (mean of ``--reps`` calls after 2 warm-ups) at
chip_smoke.py's shapes: K2 and K3 at levels 0 and 1 of a 64-plane batch
of 1600 x 2000 planes, and K3 in the dual form (128 corrections) at both
levels; K4 at levels 0 (flat-field epilogue, uint16; also
wrap and bare on the same inputs) and 1 (bare) of a 64-plane batch of
1600 x 2000 planes, in the dual form (128
corrections of 64 planes), at levels 0 (flat-field, uint16) and 1 (bare)
of a 4-plane batch of fused 16384 x 18000 planes as the stitched cell
calls it, and on the level-0 (flat-field) and level-1 (bare) row shards
of a 16384 x 18000 plane on two devices, each K4 line followed by its
byte bound (every input, output and field moved once at 3.35 TB/s) and
the share of it the call reaches; the unmasked
median on BaSiC's (12, 128, 128) stack with its axis moved last (as
``models.basic._median0`` passes it, any copy the wrapper makes
included), the same values contiguous, the level-0 and level-1 band
shapes and a 4-D stack; the blend bare, through the flat-field and
through the wrap epilogue on a 64-plane batch of 1600 x 2000 uint16
planes and the stacked band pair, the two epilogues alone on its float32
output, and the flat-field form on the level-0 window of a 16384 x 18000
plane's second row shard on two devices (a package whose blend fuses no
epilogue runs the step's composition: the blend, the crop, the
epilogue); then the Otsu histogram and the masked median at
every level of the plane step (levels 0 and 1 on the real bands of random
uint16 planes, levels 2-7 on random bands of their shapes; histogram of
the squared band over its range, median under the step's capped Otsu
thresholds), the histogram of the raw uint16 planes (the dual centres),
the median's dual form (two thresholds per plane, levels 0 and 1), and
both on the level-0 and level-1 cH shards of a 16384 x 18000 plane on two
devices (histogram with the route's row bound), each also summed over the
step's 8 levels. These calls are also timed as a CUDA graph of
``--reps`` calls (``graph``: the device's time without the host's launch
time, which bounds the small levels' back-to-back wrapper calls). Last,
the notch tail both ways, the dense ``notch_delta`` and, where the
package has it, the exact-rank ``notch_delta_lowrank`` (the masked
median included in each; also its plain twin and its two products alone,
``torch.matmul`` over every factor column), at level 0 of the 1600 x
2000 plan (B = 64, every 4th plane the cells operator), on bands of its
height and sigmas widened to 1236, 1484 and 1854 columns (2 max(r) / w
0.90, 0.75 and 0.60: where the two routes cross) and at levels 0 and 1
of the 16384 x 18000 plan (B = 4, one cells plane and three no-cells
ones), each with its FLOP count (2 h w^2 a plane dense, 4 h w r at the
plane's rank) and its bound at the FP32 peak; then the tail at the tile
plan's levels 0-3 and three widths between levels 3 and 2 (B = 64):
dense, exact-rank and, where the package has it, chirp-z
(``notch_delta_fft``), beside ``torch.fft``'s rfft and irfft of the band
as the library's yardstick (timed only). ``--only`` times
the calls whose name matches REGEX alone. Each line names the call and
its time; the last line is all of them as
JSON, with the card's name and power limit.
"""

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
HBM_BYTES_S = 3.35e12  # an H100 SXM's device memory, bytes a second


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_band as cb
    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

    if not cb.__file__.startswith(str(root)):
        raise RuntimeError(f"imported {cb.__file__}, not the package in "
                           f"{root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    def time_ms(fn):
        for _ in range(2):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    def graph_ms(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.reps):
                fn()
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        del graph
        return a.elapsed_time(b) / args.reps

    out = {}

    def record(key, fn):
        if not re.search(args.only, key):
            return None
        out[key] = time_ms(fn)
        print(f"[kernel-ab] {key}: {out[key]:.4f} ms")
        return out[key]

    def record_graph(key, fn):
        """Time ``fn`` both ways: back to back, and as a CUDA graph."""
        if record(key, fn) is None:
            return None, None
        out[f"{key} graph"] = graph_ms(fn)
        print(f"[kernel-ab] {key} graph: {out[f'{key} graph']:.4f} ms")
        return out[key], out[f"{key} graph"]

    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(1600, 2000,
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = tf.device_constants(plan, dev)
    n = plan.n_levels
    B, H, W = 64, 1600, 2000
    # K2 and K3 on inputs of the step's shapes; K3 also on 2B corrections
    h_in = H
    for lvl in (0, 1):
        bd = consts[f"band{lvl}"]
        a_y, s_y = consts["an_y"][lvl], consts["syn_y"][n - 1 - lvl]
        L, wc = plan.ladder[n - 1 - lvl]
        xk = torch.randn((B, h_in, wc), generator=g, device=dev)
        record(f"an_y_pass level {lvl}", lambda: cb.an_y_pass(
            xk, a_y, bd["k2_start"], bd["k2_lo"], bd["k2_hi"]))
        del xk
        for key, nb in (("", B), (" dual", 2 * B)):
            corr = torch.randn((nb, L, wc), generator=g, device=dev) * 0.01
            delta = torch.randn((nb, L, wc), generator=g, device=dev) * 0.01
            record(f"syn_y_pass{key} level {lvl}", lambda: cb.syn_y_pass(
                corr, delta, s_y, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]))
            del corr, delta
        h_in = L
    torch.cuda.empty_cache()

    def record_k4(key, fn, st, img, out_bytes, field_px):
        """Time a K4 call and print it beside its byte bound: st, the
        image planes, the output and the flat and dark fields (field_px
        float32 values each, None: no fields), each moved once at the
        card's 3.35 TB/s."""
        ms = record(key, fn)
        if ms is None:
            return
        nbytes = (st.numel() * 4 + out_bytes
                  + (0 if img is None else img.numel() * img.element_size())
                  + (0 if field_px is None else 8 * field_px))
        out[f"{key} bound"] = nbytes / HBM_BYTES_S * 1e3
        print(f"[kernel-ab] {key} bound: {out[f'{key} bound']:.4f} ms "
              f"({nbytes / 1e9:.4f} GB), {100 * out[f'{key} bound'] / ms:.1f}%"
              " of it")

    x = torch.randint(0, 4000, (B, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    flat = 1.0 + 0.2 * torch.rand((H, W), generator=g, device=dev)
    dark = torch.full((H, W), 3.0, device=dev)
    for lvl in (0, 1):
        bd = consts[f"band{lvl}"]
        s_x = consts["syn_x_lo"][n - 1 - lvl]  # None: the kernel's band
        h = H if lvl == 0 else plan.ladder[n - 1][0]
        L_w = plan.ladder[n - 1 - lvl][1]
        w = W if lvl == 0 else plan.ladder[n - 1][1]
        st = torch.randn((B, h, L_w), generator=g, device=dev) * 0.01
        if lvl == 0:
            record_k4("syn_x_exp level 0", lambda: cb.syn_x_exp(
                st, x, s_x, bd["k4_start"], bd["k4_coef"], flat=flat,
                dark=dark), st, x, 2 * B * h * w, h * w)
            st2 = torch.randn((2 * B, h, L_w), generator=g,
                              device=dev) * 0.01
            record_k4("syn_x_exp dual", lambda: cb.syn_x_exp(
                st2, x, s_x, bd["k4_start"], bd["k4_coef"]), st2, x,
                4 * 2 * B * h * w, None)
            del st2
            # the same bytes without the flat-field epilogue, and without
            # the exp/log one: what the epilogue's instructions cost
            record_k4("syn_x_exp level 0 wrap", lambda: cb.syn_x_exp(
                st, x, s_x, bd["k4_start"], bd["k4_coef"], wrap=True), st,
                x, 2 * B * h * w, None)
            record_k4("syn_x_exp level 0 bare", lambda: cb.syn_x_exp(
                st, None, s_x, bd["k4_start"], bd["k4_coef"]), st, None,
                4 * B * h * w, None)
        else:
            record_k4("syn_x_exp level 1", lambda: cb.syn_x_exp(
                st, None, s_x, bd["k4_start"], bd["k4_coef"]), st, None,
                4 * B * h * w, None)
        del st
    del x, flat, dark, consts
    torch.cuda.empty_cache()

    # K4 on the fused 16384 x 18000 plane as the stitched cell calls it, 4
    # planes a batch: level 0 with the flat-field epilogue on uint16
    # planes, level 1 bare (the band forms from the taps, as the plan's)
    for lvl, (h, w) in enumerate(((16384, 18000), (8194, 9002))):
        bd = cb.band_level_forms_taps(h, w, "db3")
        start, coef = (torch.as_tensor(bd[k], device=dev)
                       for k in ("k4_start", "k4_coef"))
        st = torch.randn((4, h, tw.dwt_coeff_len(w, 6)), generator=g,
                         device=dev) * 0.01
        if lvl == 0:
            img = torch.randint(0, 4000, (4, h, w), generator=g, device=dev,
                                dtype=torch.int32).to(torch.uint16)
            kw = dict(flat=1.0 + 0.2 * torch.rand((h, w), generator=g,
                                                  device=dev),
                      dark=torch.full((h, w), 3.0, device=dev))
            record_k4("syn_x_exp fused level 0", lambda: cb.syn_x_exp(
                st, img, None, start, coef, **kw), st, img, 2 * 4 * h * w,
                h * w)
            del img, kw
        else:
            record_k4("syn_x_exp fused level 1", lambda: cb.syn_x_exp(
                st, None, None, start, coef), st, None, 4 * 4 * h * w, None)
        del st
        torch.cuda.empty_cache()

    # the row shards of a 16384 x 18000 plane on two devices
    for lvl, (rows, w) in enumerate(((8192, 18000), (4097, 9002))):
        L = tw.dwt_coeff_len(w, 6)
        start, coef = (torch.as_tensor(a, device=dev)
                       for a in _k4_taps_band(L, w, "db3"))
        st = torch.randn((1, rows, L), generator=g, device=dev) * 0.01
        kw, img = {}, None
        if lvl == 0:
            img = torch.randint(0, 4000, (1, rows, w), generator=g,
                                device=dev, dtype=torch.int32).to(
                                    torch.uint16)
            kw = dict(flat=1.0 + 0.2 * torch.rand((rows, w), generator=g,
                                                  device=dev),
                      dark=torch.full((rows, w), 3.0, device=dev))
        record_k4(f"syn_x_exp_chunked level {lvl}",
                  lambda: cb.syn_x_exp_chunked(st, img, None, start, coef,
                                               **kw), st, img,
                  (2 if lvl == 0 else 4) * rows * w,
                  rows * w if lvl == 0 else None)
        del st, img, kw
    torch.cuda.empty_cache()

    stack = torch.randn((12, 128, 128), generator=g, device=dev) * 0.3
    record("row_median_batch path (movedim view)",
           lambda: tf._row_median(stack.movedim(0, -1)))
    moved = stack.movedim(0, -1)
    k = 6
    record("kthvalue path (movedim view)", lambda: (torch.kthvalue(
        moved, k, -1, keepdim=True).values + torch.kthvalue(
            moved, k + 1, -1, keepdim=True).values) * 0.5)
    flat_stack = moved.contiguous()
    record("row_median_batch path contiguous",
           lambda: tf._row_median(flat_stack))
    for key, shape in (("level 0", (64, 802, 1002)),
                       ("level 1", (64, 403, 503)),
                       ("4d", (2, 64, 802, 1002))):
        xm = torch.randn(shape, generator=g, device=dev) * 0.3
        record(f"row_median_batch {key}",
               lambda: tf._row_median(xm))
        del xm
    del stack, moved, flat_stack
    torch.cuda.empty_cache()
    blend_calls(record_graph, dev, g)
    tail_calls(out, record_graph, plan, dev, g)
    notch_calls(out, record, dev, g)
    chirp_calls(out, record, dev, g)
    print(json.dumps({"card": smi, "root": str(root), "ms": out}))
    return 0


def blend_calls(record_graph, dev, g):
    """The dual-band blend in its three modes (bare float32, flat-field
    and wrap into uint16) on a 64-plane batch of 1600 x 2000 uint16 planes
    and the stacked (128, 1600, 2000) band pair, the flat-field and wrap
    epilogues alone on its float32 output, and the flat-field mode on the
    level-0 window of the row-sharded route's second shard of a 16384 x
    18000 plane on two devices (8200 window rows, the shard's 8192 emitted
    from row 8). A package whose blend takes no epilogue (one that fuses
    none) runs the same function as the step composed it: the bare blend,
    then ``flatfield_correction`` or ``wrap_cast`` (and, on the window, the
    crop to the shard's rows and ``.contiguous()``)."""
    import inspect

    import torch

    from aind_smartspim_destripe_torch.ops import cuda_blend as tbl
    from aind_smartspim_destripe_torch.ops.flatfield import (
        flatfield_correction,
        wrap_cast,
    )
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    fused = "flat" in inspect.signature(tbl.blend_smooth_mix).parameters

    def blend(x, both, centers, flat=None, dark=None, wrap=False,
              out_rows=None):
        if fused:
            return tbl.blend_smooth_mix(x, both, None, centers, 100.0,
                                        flat=flat, dark=dark, wrap=wrap,
                                        out_rows=out_rows)
        y = tbl.blend_smooth_mix(x, both, None, centers, 100.0)
        if out_rows is not None:
            y = y[:, out_rows[0]:out_rows[0] + out_rows[1]]
        if flat is not None:
            y = flatfield_correction(y, flat, dark)
        elif wrap:
            y = wrap_cast(y)
        return y.contiguous()

    for key, (B, H, W, first, count) in (
            ("", (64, 1600, 2000, 0, 1600)),
            (" halo", (1, 8200, 18000, 8, 8192))):
        x = torch.randint(0, 4000, (B, H, W), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint16)
        both = torch.randn((2 * B, H, W), generator=g, device=dev) * 300 + 500
        centers = threshold_otsu_batch(x)
        flat = 1.0 + 0.2 * torch.rand((count, W), generator=g, device=dev)
        dark = torch.full((count, W), 3.0, device=dev)
        rows = None if key == "" else (first, count)
        if key == "":
            record_graph("blend bare", lambda: blend(x, both, centers))
            record_graph("blend wrap",
                         lambda: blend(x, both, centers, wrap=True))
            y = tbl.blend_bands(x, both[:B], both[B:], centers, 100.0)
            record_graph("epilogue flat alone",
                         lambda: flatfield_correction(y, flat, dark))
            record_graph("epilogue wrap alone", lambda: wrap_cast(y))
            del y
        record_graph(f"blend{key} flat", lambda: blend(
            x, both, centers, flat=flat, dark=dark, out_rows=rows))
        del x, both, centers, flat, dark
        torch.cuda.empty_cache()


def tail_calls(out, record_graph, plan, dev, g):
    """The histogram and the masked median at every level of the plane
    step, in the dual form, on raw uint16 planes and on halo shards; the
    whole Otsu of a level as the step calls it (the |x| range from K2 at
    the banded levels, the threshold's square root; dual: repeated twice),
    and, where the package has the tail kernel, the tail alone at B = 64
    and 128 and its plain twin on the card; sums over the step's levels
    recorded as ``... per step``."""
    import inspect

    import torch

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_band as cb
    from aind_smartspim_destripe_torch.ops import cuda_hist as th
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    caps = (plan.cells.max_threshold, plan.no_cells.max_threshold)
    fused = "sqrt" in inspect.signature(threshold_otsu_batch).parameters

    def otsu_level(ch, abs_range, repeat):
        """The level's Otsu as the step runs it (the parent: the square
        root and the repeat as torch operations)."""
        if fused:
            return threshold_otsu_batch(ch, square=True, abs_range=abs_range,
                                        sqrt=True, repeat=repeat)
        t = torch.sqrt(threshold_otsu_batch(ch, square=True,
                                            abs_range=abs_range))
        return t.repeat(repeat) if repeat != 1 else t

    def inputs(ch, k_out=1):
        """The step's histogram range and capped Otsu thresholds (per
        plane alternating caps; k_out = 2: the cells caps, then the
        no-cells ones)."""
        B = ch.shape[0]
        a = ch.abs()
        lo = a.amin(dim=(1, 2)) ** 2
        span = a.amax(dim=(1, 2)) ** 2 - lo
        span = torch.where(span > 0, span, torch.ones_like(span))
        otsu = torch.sqrt(threshold_otsu_batch(ch, square=True))
        idx = torch.arange(k_out * B, device=ch.device)
        sel = (idx >= B) if k_out == 2 else (idx % 2 == 1)
        cap = torch.where(sel, caps[1], caps[0]).to(torch.float32)
        return lo, span, torch.minimum(cap, otsu.repeat(k_out))

    sums = {}

    def add(key, times):
        ms, gms = times
        if ms is not None:
            sums.setdefault(key, [0.0, 0.0])
            sums[key][0] += ms
            sums[key][1] += gms

    B, H, W = 64, 1600, 2000
    n = plan.n_levels
    consts = tf.device_constants(plan, dev)
    x = torch.randint(0, 4000, (B, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    xi = x.to(torch.int32)
    lo16 = xi.amin(dim=(1, 2)).to(torch.float32)
    span16 = xi.amax(dim=(1, 2)).to(torch.float32) - lo16
    del xi
    record_graph("histogram256_batch raw uint16",
                 lambda: th.histogram256_batch(x, lo16, span16))
    src = x
    for lvl in range(n):
        if lvl < 2:  # the real bands of the banded levels
            bd = consts[f"band{lvl}"]
            k1 = cb.an_x_lowpass_log1p(src, consts["an_x_lo"][lvl],
                                       bd["k1_start"], bd["k1_coef"],
                                       log1p=lvl == 0)
            src, ch, _ = cb.an_y_pass(k1, consts["an_y"][lvl],
                                      bd["k2_start"], bd["k2_lo"],
                                      bd["k2_hi"])
            del k1
        else:
            h, w = plan.ladder[n - 1 - lvl]
            ch = torch.randn((B, h, w), generator=g, device=dev) * 0.5
        lo, span, thr = inputs(ch)
        add("histogram256_batch", record_graph(
            f"histogram256_batch level {lvl}",
            lambda: th.histogram256_batch(ch, lo, span, square=True)))
        a = ch.abs()
        rng = (a.amin(dim=(1, 2)), a.amax(dim=(1, 2))) if lvl < 2 else None
        del a
        add("otsu", record_graph(f"otsu level {lvl}",
                                 lambda: otsu_level(ch, rng, 1)))
        add("otsu dual", record_graph(f"otsu dual level {lvl}",
                                      lambda: otsu_level(ch, rng, 2)))
        if hasattr(th, "otsu_tail"):
            for b in (64, 128):
                c2 = ch if b == B else torch.cat([ch] * (b // B))
                a2 = c2.abs()
                lo_a, hi_a = a2.amin(dim=(1, 2)), a2.amax(dim=(1, 2))
                del a2
                counts = th.histogram256_range(c2, lo_a, hi_a, square=True)
                add(f"otsu_tail B={b}", record_graph(
                    f"otsu_tail B={b} level {lvl}",
                    lambda: th.otsu_tail(counts, lo_a, hi_a, square=True,
                                         sqrt=True)))
                if b == B:
                    add("otsu_tail_plain", record_graph(
                        f"otsu_tail_plain level {lvl}",
                        lambda: th.otsu_tail_plain(counts, lo_a, hi_a, True,
                                                   True)))
                del c2
        add("row_median_masked", record_graph(
            f"row_median_masked level {lvl}",
            lambda: tn.row_median_masked(ch, thr)))
        _, _, thr2 = inputs(ch, 2)
        add("row_median_masked dual", record_graph(
            f"row_median_masked dual level {lvl}",
            lambda: tn.row_median_masked(ch, thr2)))
        del ch
    for key, (ms, gms) in sums.items():
        out[f"{key} per step"], out[f"{key} per step graph"] = ms, gms
        print(f"[kernel-ab] {key} per step (sum over {n} levels): "
              f"{ms:.4f} ms, graph {gms:.4f} ms")
    del x, src, consts
    torch.cuda.empty_cache()

    # the level-0 and level-1 cH shards of a 16384 x 18000 plane on two
    # devices: the largest shard's rows, the fewest valid ones as its bound
    cfg = run_capsule.PRODUCTION_PARAMETERS
    hplan = tf.build_plan(16384, 18000,
                          tf.FilterConfig.from_dict(cfg["cells_config"]),
                          tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    for lvl in (0, 1):
        h_b, w_b = hplan.ladder[hplan.n_levels - 1 - lvl]
        rows, bound = -(-h_b // 2), h_b // 2
        ch = torch.randn((1, rows, w_b), generator=g, device=dev) * 0.5
        lo, span, thr = inputs(ch[:, :bound])
        record_graph(f"histogram256_batch row bound level {lvl}",
                     lambda: th.histogram256_batch(ch, lo, span, square=True,
                                                   row_bound=bound))
        record_graph(f"row_median_masked halo level {lvl}",
                     lambda: tn.row_median_masked(ch, thr))
        del ch
    torch.cuda.empty_cache()


FP32_PEAK = 67e12  # FLOP/s of one H100 SXM outside the tensor cores


def notch_calls(out, record, dev, g):
    """The dense and the exact-rank notch tail at the tile plan's level 0,
    at three wider bands of its height and sigmas (the crossover), and at
    the fused plane's levels 0 and 1, each with its FLOP count and bound
    (``<key> flop``, ``<key> bound``)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import fft_notch as fn
    from aind_smartspim_destripe_torch.ops import filter as tf

    cfg = run_capsule.PRODUCTION_PARAMETERS
    pair = (tf.FilterConfig.from_dict(cfg["cells_config"]),
            tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    lowrank = hasattr(tn, "notch_delta_lowrank")
    shapes = []
    for tag, hw, lvl, B in (("tile level 0", (1600, 2000), 0, 64),
                            ("stitched level 0", (16384, 18000), 0, 4),
                            ("stitched level 1", (16384, 18000), 1, 4)):
        plan = tf.build_plan(*hw, *pair)
        i = plan.n_levels - 1 - lvl
        shapes.append((tag, *plan.ladder[i], plan.notch_sigmas()[i], B))
        if tag == "tile level 0":  # its rank (556) on wider bands
            shapes += [(f"tile level 0 at w {w}", shapes[0][1], w,
                        shapes[0][3], B) for w in (1236, 1484, 1854)]
    for tag, h, w, sigmas, B in shapes:
        ch = torch.randn((B, h, w), generator=g, device=dev) * 0.3
        thr = torch.rand(B, generator=g, device=dev) * 0.3 + 0.3
        sel = (torch.arange(B, device=dev) % 4 != 0).to(torch.int32)
        cells = B // 4
        cat = fn.notch_cat(w, sigmas, dev)  # numpy up to the host gate
        cat = torch.as_tensor(np.ascontiguousarray(cat) if isinstance(
            cat, np.ndarray) else cat, device=dev)
        calls = [("notch_delta", 2.0 * B * h * w * w,
                  lambda: tn.notch_delta(ch, thr, sel, cat))]
        if lowrank:
            p, ds, ranks = fn.notch_factors(w, sigmas)
            p, ds = (torch.as_tensor(a, device=dev) for a in (p, ds))
            flop = 4.0 * h * w * (cells * ranks[0] + (B - cells) * ranks[1])
            rp = p.shape[1]
            ds_sel = ds.view(2, rp, w)[sel.long()]
            calls += [
                ("notch_delta_lowrank", flop,
                 lambda: tn.notch_delta_lowrank(ch, thr, sel, p, ds, ranks)),
                ("notch_delta_lowrank_plain", flop,
                 lambda: tn.notch_delta_lowrank_plain(ch, thr, sel, p, ds,
                                                      ranks)),
                ("notch factors, two torch.matmul", 4.0 * B * h * w * rp,
                 lambda: torch.matmul(torch.matmul(ch, p), ds_sel))]
        for name, flop, fn_ in calls:
            key = f"{name} {tag}"
            ms = record(key, fn_)
            if ms is None:
                continue
            out[f"{key} flop"] = flop
            out[f"{key} bound"] = flop / FP32_PEAK * 1e3
            print(f"[kernel-ab] {key}: {flop:.4e} FLOP, bound "
                  f"{out[f'{key} bound']:.4f} ms, {flop / ms / 1e9:.2f} "
                  f"TFLOP/s")
        del ch, cat, calls
        if lowrank:
            del p, ds, ds_sel
        torch.cuda.empty_cache()


def chirp_calls(out, record, dev, g):
    """The notch tail at the tile plan's levels 0-3 (B = 64, alternating
    configurations; levels 0 and 1 also in the dual form, 128 outputs)
    and on bands of level 2's height at widths 160, 192 and 224 (sigmas
    scaled from level 3's with the width): the dense ``notch_delta``, the
    exact-rank ``notch_delta_lowrank`` and, where the package has it, the
    chirp-z ``notch_delta_fft`` (the masked median included in each), and
    as the library's yardstick ``torch.fft.rfft`` / ``irfft`` of the band
    with one configuration's packed gains between (timed only)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import fft_notch as fn
    from aind_smartspim_destripe_torch.ops import filter as tf

    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(1600, 2000,
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    n, B = plan.n_levels, 64
    shapes = []
    for lvl in (0, 1, 2, 3):
        i = n - 1 - lvl
        for k in ((1, 2) if lvl < 2 else (1,)):
            shapes.append((f"tile level {lvl}" + (" dual" if k == 2 else ""),
                           *plan.ladder[i], plan.notch_sigmas()[i], k))
    (h2, _), (s3c, s3n) = plan.ladder[n - 3], plan.notch_sigmas()[n - 4]
    w3 = plan.ladder[n - 4][1]
    shapes += [(f"level 2 rows at w {w}", h2, w,
                (s3c * w / w3, s3n * w / w3), 1) for w in (160, 192, 224)]
    chirp = hasattr(tn, "notch_delta_fft")
    for tag, h, w, sigmas, k in shapes:
        n_out = k * B
        ch = torch.randn((B, h, w), generator=g, device=dev) * 0.3
        thr = torch.rand(n_out, generator=g, device=dev) * 0.3 + 0.3
        idx = torch.arange(n_out, device=dev)
        sel = ((idx >= B) if k == 2 else (idx % 2 == 1)).to(torch.int32)
        cat = torch.as_tensor(np.ascontiguousarray(fn.notch_cat(w, sigmas)),
                              device=dev)
        f = fn.notch_factors(w, sigmas)
        p, ds = (torch.as_tensor(a, device=dev) for a in (f.p, f.ds))
        a, b = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in fn._packed_gains(w, fn.notch(w, sigmas[1])))
        band = ch.repeat(k, 1, 1)

        def library():
            spec = torch.fft.rfft(band)
            return torch.fft.irfft(torch.complex(a * spec.real,
                                                 b * spec.imag), n=w)

        calls = [("notch_delta", lambda: tn.notch_delta(ch, thr, sel, cat)),
                 ("notch_delta_lowrank", lambda: tn.notch_delta_lowrank(
                     ch, thr, sel, p, ds, f.ranks)),
                 ("torch.fft rfft-gains-irfft", library)]
        if chirp:
            rec = fn.notch_chirp(w, sigmas)
            rec = rec._replace(**{
                name: torch.as_tensor(v, device=dev)
                for name, v in rec._asdict().items() if name != "k"})
            calls.append(("notch_delta_fft",
                          lambda: tn.notch_delta_fft(ch, thr, sel, rec)))
            out[f"chirp M {tag}"] = rec.twiddle.shape[0]
        for name, fn_ in calls:
            record(f"{name} {tag}", fn_)
        del ch, cat, p, ds, band, calls
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
