#!/usr/bin/env python3
"""Smoke run of the PyTorch / H100 port (aind_smartspim_destripe_torch) on
one NVIDIA GPU.

Run from the root of a checkout, on a machine with one card:

    python3 chip_smoke.py [--seed N]

Phases, each printing its lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the TF32 flags, the blosc-zstd codec backend, and the time to make
   every visible card's context (once, so the timed runs below start warm);
2. the build of the CUDA kernels from ``aind_smartspim_destripe_torch/csrc``,
   with each kernel's registers and spilled bytes (and the shared memory of
   the shared GEMM tile's, K2's, K3's, K4's, the row medians', the
   histogram's, the Otsu tail's and range pass's and the blend's
   instances, which must spill nothing);
3. each kernel of the destripe step against its plain PyTorch twin on the
   card, on the same inputs, at the step's shapes for a 64-plane batch of
   1600x2000 planes: the banded DWT passes K1-K4 at levels 0 and 1, and the
   Otsu histogram, masked row median and notch tail at every level (on the
   real level-0 and level-1 bands); then the dual-band forms: the Otsu
   histogram of the blend centres on the raw uint16 planes, the blend's
   division by 17 against IEEE division on every float32 from +0 to 17.0,
   the blend kernel on uint16 planes and the stacked (128, 1600, 2000)
   band pair, bare and with each fused epilogue (flat-field, wrap; each
   bit-equal to the bare kernel followed by the epilogue), K4
   wrapped at level 0 (128 corrections, 64 planes), K3 on 128 corrections
   at levels 0 and 1, and the wrapped median
   and notch at every level with 128 thresholds and operator choices (the
   production caps per half): max error against the stated tolerance, the
   kernel's, the twin's and (where one PyTorch call computes the same
   function) that call's time (CUDA events), and the bound from the bytes
   and operations of the call; the histogram's and the masked median's
   times and bounds summed over the 8 levels of a step (the median's also
   over the dual step's); K2's, K3's and K4's lines (``an_y_pass``,
   ``syn_y_pass``, ``syn_x_exp``, and ``syn_x_exp_chunked`` in step 6)
   also hold the kernel bit for bit against its k-order witness
   (``cuda_band.an_y_pass_ordered``, ``syn_y_pass_ordered``,
   ``syn_x_exp_ordered``; K2's bands and their |cH| range); then
   ``[kernels] row_median_batch``, the unmasked median through
   ``ops.filter._row_median(x)`` on its main path's call
   (BaSiC's darkfield medians in flat estimation: the (12, 128, 128) stack
   with its axis moved last, as ``models.basic._median0`` passes it, which
   the kernel must read without a copy), the same values contiguous, the
   plane path's level-0 (even n) and level-1 (odd n) band shapes, a 1-D row
   and a 4-D stack past grid.y's 65535 rows, exactly against its twin, with
   ``torch.kthvalue`` of the middle ranks on the same tensor as the library
   call; then
   ``dense_matmul``, the dense levels' fixed-order product, on the four
   products of every dense level (2-7) against ``torch.matmul`` (its twin
   and the library call), each also bit-equal for one plane alone and in
   the batch, per level and summed over a step, and on the four level-2
   products of a 2000 x 16000 plane (K = 4003 for its x analysis). The
   notch tail's lines also time its GEMM launch alone (its median
   excluded) and ``torch.matmul`` of the same per-plane product alone;
4. the port's main paths: a synthetic capsule (one channel, one tile of
   128 x 1600 x 2000 uint16 planes with dark and flats, in the layout of
   tests/test_run_capsule_e2e.py) through ``run_capsule.run()`` on the card
   with 64-plane device batches, single band and then dual band
   (``DESTRIPE_DUAL_BAND=1``), the launch counts reset just before each run
   and read just after it; every kernel of the path must have launched,
   pyramid levels 1-2 must exist and agree with level 0, and one stored
   chunk must decode to the data read back (the runs take
   ``devices=None``: planes this size run on one card;
   ``scripts/mesh_capsule.py`` holds that against a split over every
   card); then each device step alone on one resident 64-plane batch
   (CUDA events, peak device memory) and the sha256 of its output, which
   ``scripts/step_hash.py`` computes for another commit's package;
5. four sampled planes of each run's level 0 against the port's plain path
   on the CPU, within 1 LSB outside a stated flip budget and at
   PSNR >= 100 dB; then ``[check-every]``: every plane of the single-band
   run's first 64-plane step against the same path, four planes per CPU
   call: the step's decisions exactly (the classifier's choice, and each
   level's Otsu threshold against the CPU's Otsu of the card's band) and
   each plane at PSNR >= 100 dB against the CPU's path with the card's
   thresholds; it also prints each plane's max LSB, share of pixels > 1
   LSB and PSNR against the CPU's path with its own thresholds, and the
   levels where those differ (an Otsu near-tie, PERF.md);
6. the multi-device routes on the mesh (every visible card when there are
   two or more, else two entries on ``cuda:0``; printed on the ``[halo]``
   line): ``[zmesh]`` the plane-sharded step at 64 x 1600 x 2000 against
   the single-device step (bit-equal on the entries' own batches, and
   within the flip budget on the whole batch; both against the CPU plain
   path on four sampled planes); ``[mesh-helpers]``
   ``parallel.mesh.sharded_destripe_step`` (flat-field and wrap) on the
   same batch and mesh, bit-equal to the fused step of ``[zmesh]``, its
   [min, max] equal to the float32 step's, its sampled planes against the
   CPU plain path, then ``sharded_destripe_step_2d`` on two 32-plane tiles
   over a 2 x len(mesh) mesh (each tile bit-equal to the 1-D helper with
   its own flat), ``global_minmax`` and ``sharded_normalize_image``, each
   step's launches (every kernel of the single-band path), time and host
   syncs; ``[execute-worker]`` ``zarr_destriper.execute_worker`` on planes
   64-127 as one block, written into a store at z 64:128 and decoded back
   bit-equal to the single-device step (retrospective flat, the same
   planes as float32, the hemisphere flat); ``[wavelets]`` ``wavedec2`` /
   ``waverec2`` (blocked and dense), the convolution forms and the
   Y-sharded level on log(1 + x) of the 64-plane batch against the CPU
   twin, the product forms and a perfect reconstruction;
   ``[halo-kernels]`` the row-sharded route's
   kernel calls against their twins at the route's level-0 and level-1
   shard shapes of a 16384 x 18000 plane (K1 and K4 on row shards, the
   per-plane notch product with each operator choice, the histogram with a
   row bound, the masked median of the shard, and the dual route's blend
   on the level-0 window of the second shard, emitting the shard's rows
   through the fused flat-field epilogue); ``[lowrank-kernels]`` the
   exact-rank notch tail (``cuda_notch.notch_delta_lowrank``) against its
   twin at the same plane's levels 0 (9002 columns) and 1 (4503) on a
   batch of 4 (one cells plane, three no-cells), the single-device plane
   path's notch at that size, bound by its 4 h w r operations a plane at
   the plane's rank; ``[slice-halo]``
   ``run_capsule.run`` on a tile of 4 x 16384 x 18000 uint16 planes with
   flats and dark, on the mesh, through the row-sharded route (the plane
   alone passes ``DESTRIPE_HALO_THRESHOLD_BYTES``); ``[step-halo]`` /
   ``[step-dual-halo]`` the row-sharded step alone on one resident plane
   and the sha256 of its output (``scripts/step_hash.py`` computes the
   single-band one for another commit's package), and ``[check-halo]`` /
   ``[check-dual-halo]`` its output against the
   single-device plane path on the card, within 1 LSB outside the flip
   budget at PSNR >= 100 dB (``[plane-halo]`` / ``[plane-dual-halo]``:
   that plane path's launches in its one step, the counts reset just
   before it; every level runs the exact-rank notch, none the dense one);
   ``[check-banded]`` the same plane through
   the row-sharded step with the dense-x gate forced to 64 columns (the
   banded/spectral x tier at every level that wide) against the dense
   tier, under 1e-3 of pixels > 1 LSB at >= 90 dB; ``[step-banded]`` one
   4096 x 20480 plane, at the default gate, through the row-sharded step
   (its time, peak memory and launches, and its stripes cut).

Between 5 and 6, the other entry points, each with the launch counts reset
just before it and read just after it: ``[facade]`` ``filtering.filter_stripes``
on one plane at a time (production configurations, prospective hemisphere
flats) on the card against the same call on the CPU, each plane within the
budget of step 5; ``[batch]`` and ``[batch-dual]``
the CLI's ``batch`` mode in-process on a tree of 40 uint16 TIFF planes
(24 + 16 in two subdirectories, so the last 16-plane batch is a tail of 8)
and a sidecar ``.txt``: the mirrored tree, the copied sidecar, two sampled
planes against the CPU plain path, seconds and MPix/s; ``[flat-estimation]``
``slide_flat_estimation`` on a 4 x 3 grid of tiles, 2 slides, with a known
smooth flat and dark and the production BaSiC knobs (destripe and fit seconds, the
fit's host syncs, the unified flat's correlation with the truth, the card's
fit against the same fit on the CPU); ``[multihost]`` two
``python -m aind_smartspim_destripe_torch capsule`` processes joined over
gloo on this machine, both on the card, on a channel of four 16-plane tiles:
disjoint ownership covering every tile, levels 0-2 of each tile, one
provenance write, one sampled plane per tile against the CPU plain path,
wall time.

The line before the last is the kernels' JSON record, the one before it
the steps' sha256, the every-plane check and the banded step; the last
line is
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero; so does a host without CUDA, before any result is printed.
Z is cut to 128 planes (two slabs) only to keep the run short, and to 4
planes for the row-sharded tile (the fewest that give pyramid level 2 a
plane).
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Tolerances of kernel vs plain twin on the card. f32 outputs: both sum the
# same products in f32 in another order (the twin's GEMM adds exact zeros
# besides), so they agree to a few ulps of the operands: 1e-5 of the
# largest operand magnitude (for the notch delta, a difference of two terms
# of the band's size, of the band's). uint16 outputs: 1 LSB (a value on a
# rounding boundary). Classifier sums, histogram counts and medians: exact.
F32_RTOL = 1e-5
U16_LSB = 1
EXACT = ("histogram256_batch", "row_median_masked", "row_median_batch",
         "otsu_tail", "abs_range_batch")
# Sampled planes against the plain path on the CPU: a coefficient on a
# threshold can fall on the other side of it (Otsu bin or stripe mask), and
# the pixels it reconstructs then move by more than 1 LSB. Budget: 1e-4 of
# the sampled pixels (0 measured), and PSNR >= 100 dB over all of them,
# which bounds how far any pixel may move.
FLIP_BUDGET = 1e-4
PSNR_MIN = 100.0
# The banded/spectral x tier against the dense one on the same plane: it
# sums the x passes and the notch in other orders (blocked windows, the
# band form, an FFT), so coefficients on an Otsu bin edge or the stripe
# threshold may flip; the JAX package's gate for it (__graft_entry__.py).
BANDED_FLIPS = 1e-3
BANDED_PSNR = 90.0
SHAPE = (128, 1600, 2000)
# The smallest production-routed row-sharded plane: above 1 GiB of f32 (so
# the row route is taken) and under the dense-x gate of 20067 columns.
HALO_SHAPE = (4, 16384, 18000)
# A plane at the dense-x gate (20067 columns by default): the row-sharded
# route runs its finest level through the banded/spectral x tier.
BANDED_SHAPE = (1, 4096, 20480)
# A plane whose level-2 dense products run K in the thousands (level 2's
# input is 503 x 4003): dense_matmul at long K.
LONG_K_SHAPE = (2000, 16000)
BATCH = 64
SAMPLED = (0, 1, 64, 127)
EVERY_CHUNK = 4  # planes per CPU call of [check-every]
ZSAMPLED = (0, 1, 17, 50)  # of the [zmesh] batch: planes of both classes
# the wavelet API against its CPU twin, of the input's largest magnitude:
# one level, and a full wavedec2 / waverec2 (the CPU tests' tolerances)
LEVEL_TOL = 1e-5
FULL_TOL = 1e-4
CROSSOVER = 100.0
# The bound of a call: the larger of its bytes (each input read once, each
# output written once) over the card's memory rate and its arithmetic over
# the FP32 CUDA-core peak (NVIDIA H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
CSRC = "aind_smartspim_destripe_torch/csrc/"
TPU = "aind_smartspim_destripe_tpu/ops/"  # the JAX package's kernels
SOURCE = {
    "an_x_lowpass_log1p": CSRC + "band.cu",
    "an_y_pass": CSRC + "band.cu",
    "syn_y_pass": CSRC + "band.cu",
    "syn_x_exp": CSRC + "band.cu",
    "histogram256_batch": CSRC + "hist.cu",
    "row_median_masked": CSRC + "notch.cu",
    "notch_delta": CSRC + "notch.cu",
    "blend_smooth_mix": CSRC + "blend.cu",
    "an_x_lowpass_chunked": CSRC + "band.cu",
    "syn_x_exp_chunked": CSRC + "band.cu",
    "notch_select_chunked": CSRC + "notch.cu",
    "row_median_batch": CSRC + "notch.cu",
    "dense_matmul": CSRC + "dense.cu",
    "otsu_tail": CSRC + "hist.cu",
    "abs_range_batch": CSRC + "hist.cu",
    "notch_delta_lowrank": CSRC + "notch.cu",
    "notch_delta_fft": CSRC + "notch.cu",
}
REPLACES = {
    "an_x_lowpass_log1p": TPU + "pallas_band.py:178",
    "an_y_pass": TPU + "pallas_band.py:301",
    "syn_y_pass": TPU + "pallas_band.py:415",
    "syn_x_exp": TPU + "pallas_band.py:525",
    "histogram256_batch": TPU + "pallas_hist.py:111",
    "row_median_masked": TPU + "pallas_median.py:163",
    "notch_delta": TPU + "pallas_notch.py:89",
    "blend_smooth_mix": TPU + "pallas_blend.py:61",
    "an_x_lowpass_chunked": TPU + "pallas_band.py:727",
    "syn_x_exp_chunked": TPU + "pallas_band.py:771",
    "notch_select_chunked": TPU + "pallas_notch.py:244",
    "row_median_batch": TPU + "pallas_median.py:123",
    # no Pallas kernel: the dense levels' einsums, which XLA runs
    "dense_matmul": TPU + "filter.py:892",
    # no Pallas kernel: the Otsu threshold's tail after the histogram, and
    # the |x| range of a band no analysis kernel gave it, which XLA fuses
    "otsu_tail": TPU + "otsu.py:67",
    "abs_range_batch": TPU + "otsu.py:67",
    # the same notch tail, from the factors of the operator minus the
    # identity where their rank is small against the width
    "notch_delta_lowrank": TPU + "pallas_notch.py:89",
    # the same notch tail, by chirp-z transforms at the tile's wide levels
    "notch_delta_fft": TPU + "pallas_notch.py:89",
}
# the wrapper that launches each kernel, where its name differs
WRAPPER = {"notch_select_chunked": "notch_select"}
# the wrappers whose launches a kernel's row sums: the histogram over (lo,
# span) ranges (the row-sharded Otsu) and over (lo, hi) ends (the plane
# step's)
LAUNCHED_BY = {"histogram256_batch": ("histogram256_batch",
                                      "histogram256_range")}
# the kernels of the single-band path, and of the plane paths (the blend)
SINGLE = tuple(REPLACES)[:7] + ("dense_matmul", "otsu_tail",
                                "abs_range_batch", "notch_delta_fft")
PLANE = SINGLE + ("blend_smooth_mix",)
# the kernels of the row-sharded route (the small bands' tail included)
HALO = ("an_x_lowpass_chunked", "syn_x_exp_chunked", "notch_select_chunked",
        "histogram256_batch", "row_median_masked")
# row_median_batch: its main path's call (flat estimation: BaSiC's
# darkfield medians over a slide's 12 tiles at working size 128, even n,
# on the (12, 128, 128) stack with its axis moved last, as
# models.basic._median0 passes it), the same values contiguous, the plane
# path's level-0 (even n) and level-1 (odd n) band shapes, one row, and 128
# level-0 planes as a 4-D stack (102656 rows)
MEDIAN_SHAPES = {"path": (12, 128, 128), "path_contiguous": (128, 128, 12),
                 0: (64, 802, 1002), 1: (64, 403, 503), "1d": (2000,),
                 "4d": (2, 64, 802, 1002)}
# the file-batch tree: planes per subdirectory, and the sampled planes
BATCH_PLANES = (24, 16)
BATCH_SAMPLED = (0, 1, 24, 39)  # both subdirectories, the tail batch
# flat estimation: columns x rows of tiles, two slides; the production
# BaSiC knobs (tests/test_basic_model.py:145-151) at working size 128
FLAT_GRID = (4, 3)
BASIC_KNOBS = dict(get_darkfield=True, smoothness_flatfield=1.0,
                   smoothness_darkfield=20.0, sort_intensity=True,
                   max_reweight_iterations=35)
# the multi-host channel: four tiles of 16 planes, two per laser side
MH_TILES = ("471300_461360", "471320_461360", "471340_461360",
            "471360_461360")
MH_Z = 16
# the wrapped forms, and the histogram of the blend centres (raw uint16)
DUAL = ("syn_y_pass", "syn_x_exp", "histogram256_batch",
        "row_median_masked", "notch_delta", "notch_delta_fft")
# the plane path at HALO_SHAPE: its notch runs from the factors at every
# level, one cells plane and three no-cells ones a batch
PLANE_WIDE = ("an_x_lowpass_log1p", "an_y_pass", "syn_y_pass", "syn_x_exp",
              "histogram256_batch", "row_median_masked", "notch_delta_lowrank")
LOWRANK_SEL = (0, 1, 1, 1)


def _time_ms(fn, reps=10):
    """Mean milliseconds per call over ``reps`` calls after 2 warm-ups."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _err(got, want, exact=False, scale=None, modulo=False):
    """(max abs error, allowed) of a kernel output against its twin;
    ``scale``: the operands' largest magnitude (default: the twin's);
    ``modulo``: uint16 outputs of the wrap cast, whose 65535 and 0 are
    1 LSB apart."""
    import torch

    if want.dtype == torch.uint16:
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        if modulo:
            d = torch.minimum(d, 65536 - d)
        return float(d.max().item()), float(U16_LSB)
    err = (got - want).abs().max().item()
    if exact:
        return err, 0.0
    if scale is None:
        scale = want.abs().max().item()
    return err, F32_RTOL * max(1.0, scale)


def _nbytes(*ts):
    """Bytes of the tensors among ``ts`` (nested tuples walked)."""
    import torch

    n = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            n += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _bound(nbytes, ops):
    """(ms, 'bytes' or 'operations'): the least time for the call."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bit_equal(got, want):
    """Are ``got`` and ``want`` (tensors, or nested tuples of them, as K2
    returns its bands and their |cH| range) equal bit for bit?"""
    import torch

    if isinstance(got, (tuple, list)):
        return len(got) == len(want) and all(
            _bit_equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


def _compare(rec, name, lvl, kern, plain, scale=None, ins=(), ops=0.0,
             library=None, tag="kernels", extra=None, witness=None,
             witness_name="its k-order witness", modulo=False):
    """Hold one kernel call against its twin, time both (and ``library``,
    one PyTorch call computing the same function, where there is one, and
    each call of ``extra``, {key: call}, recorded as ``<key>_ms``), bound
    the call by the bytes of ``ins`` and of its outputs and by its
    ``ops``, print and record; raises on a disagreement, and, given a
    ``witness`` (the kernel's own order of operations as tensor code, or
    what a fused kernel must equal: ``witness_name`` says which), unless
    the kernel is bit-equal to it."""
    import torch

    got = kern()
    same = None
    if witness is not None:
        same = _bit_equal(got, witness())
        if not same:
            raise AssertionError(f"{name} level {lvl}: not bit-equal to "
                                 f"{witness_name}")
    want = plain()
    bound_ms, bound_by = _bound(_nbytes(ins, got), ops)
    if name == "an_x_lowpass_log1p" and isinstance(got, tuple):
        (got, gs), (want, ws) = got, want
        if not torch.equal(gs, ws):
            raise AssertionError("K1 classifier sums differ")
    if name == "an_y_pass":  # cA and cH, then the |cH| range
        for a, b in zip(got[2], want[2]):
            err, tol = _err(a, b)
            if err > tol:
                raise AssertionError(f"K2 |cH| range: {err} > {tol}")
        got = torch.cat([got[0], got[1]], dim=1)
        want = torch.cat([want[0], want[1]], dim=1)
    err, tol = _err(got, want, name in EXACT, scale, modulo)
    del want
    ms, plain_ms = _time_ms(kern), _time_ms(plain)
    library_ms = None if library is None else _time_ms(library)
    more = {f"{k}_ms": _time_ms(fn) for k, fn in (extra or {}).items()}
    ok = err <= tol
    lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
    print(f"[{tag}] {name} level {lvl} out {tuple(got.shape)} "
          f"{str(got.dtype).replace('torch.', '')}: max_abs_err "
          f"{err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib}, "
          f"bound {bound_ms:.3f} ms ({bound_by})"
          + "".join(f", {k} {v:.3f}" for k, v in more.items())
          + ("" if same is None else f"; bit-equal to {witness_name}"))
    if not ok:
        raise AssertionError(f"{name} level {lvl}: {err} > {tol}")
    rec[name][lvl] = dict(max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms,
                          bound_by=bound_by, shape=list(got.shape), **more)
    if same is not None:
        rec[name][lvl]["bit_equal_witness"] = same


def _per_step(recs, name, what):
    """One kernel's kernel, twin and bound times summed over the levels of
    a step (its records at integer levels), printed and returned."""
    levels = sorted(k for k in recs if isinstance(k, int))
    tot = {k: sum(recs[lvl][k] for lvl in levels)
           for k in ("ms", "plain_ms", "bound_ms")}
    tot["levels"] = len(levels)
    print(f"[kernels] {name} per {what} step ({len(levels)} levels): kernel "
          f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.3f} ms")
    return tot


def _tail_calls(ch, notch_cat, thr_cap, dual=False):
    """The histogram, median and notch calls of one level's tail on band
    ``ch`` (B planes), with the step's inputs: the Otsu bin range, the
    capped Otsu threshold and the per-plane operator choice; alternating
    per plane, or, with ``dual``, 2B outputs whose first half takes the
    cells cap and operator and whose second half the no-cells ones. Each
    entry: (kernel, plain twin, inputs, operations)."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_hist as th
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    B, h, w = ch.shape
    a = ch.abs()
    lo = a.amin(dim=(1, 2)) ** 2
    span = a.amax(dim=(1, 2)) ** 2 - lo
    span = torch.where(span > 0, span, torch.ones_like(span))
    del a
    otsu = torch.sqrt(threshold_otsu_batch(ch, square=True))
    n_out = 2 * B if dual else B
    idx = torch.arange(n_out, device=ch.device)
    sel = ((idx >= B) if dual else (idx % 2 == 1)).to(torch.int32)
    thr = torch.minimum(torch.where(sel == 0, thr_cap[0], thr_cap[1]),
                        otsu.repeat(n_out // B))
    calls = {
        "row_median_masked": (
            lambda: tn.row_median_masked(ch, thr),
            lambda: tn.row_median_masked_plain(ch, thr),
            (ch, thr), 4.0 * n_out * h * w, None),
        "notch_delta": (
            lambda: tn.notch_delta(ch, thr, sel, notch_cat),
            lambda: tn.notch_delta_plain(ch, thr, sel, notch_cat),
            (ch, thr, sel, notch_cat), 2.0 * n_out * h * w * w,
            _notch_parts(ch, thr, sel, notch_cat)),
    }
    if not dual:
        calls["histogram256_batch"] = (
            lambda: th.histogram256_batch(ch, lo, span, square=True),
            lambda: th.histogram256_batch_plain(ch, lo, span, square=True),
            (ch, lo, span), 5.0 * ch.numel(), None)
        lo_a, hi_a = th.abs_range_batch_plain(ch)
        counts = th.histogram256_range(ch, lo_a, hi_a, square=True)
        calls["abs_range_batch"] = (
            lambda: torch.stack(th.abs_range_batch(ch)),
            lambda: torch.stack(th.abs_range_batch_plain(ch)),
            (ch,), 2.0 * ch.numel(), None)
        # operations: a thread per bin forms its edges, centre and moment
        # (~10), the scans add 4 per bin, the variance ~8
        calls["otsu_tail"] = (
            lambda: th.otsu_tail(counts, lo_a, hi_a, square=True, sqrt=True),
            lambda: th.otsu_tail_plain(counts, lo_a, hi_a, True, True),
            (counts, lo_a, hi_a), 22.0 * counts.numel(), None)
    return calls


def _dense_bank(plan, consts, lvl, dev):
    """Level ``lvl``'s dense notch bank on ``dev``: the step's own, or,
    where the step routes the level to chirp-z, the bank it replaces (the
    dense tail is timed at every level; ``[fft-notch]`` times the chirp-z
    one beside it)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import fft_notch

    i = plan.n_levels - 1 - lvl
    entry = consts["notch_cat"][i]
    if not isinstance(entry, fft_notch.NotchChirp):
        return entry
    return torch.as_tensor(np.ascontiguousarray(fft_notch.notch_cat(
        plan.ladder[i][1], plan.notch_sigmas()[i])), device=dev)


def _chirp_ops(n_out, k, h, m):
    """The chirp-z tail's butterfly operations for n_out output planes of h
    rows, k per band plane: four complex FFTs of m points (5 m log2 m
    each) a pair of output rows (rows 2p and 2p + 1 of a plane; the two
    outputs of a band row for k = 2)."""
    import math

    pairs = n_out // 2 * h if k == 2 else n_out * ((h + 1) // 2)
    return pairs * 4 * 5.0 * m * math.log2(m)


def phase_fft_notch(plan, consts, dev, seed):
    """[fft-notch]: the chirp-z notch tail against its plain twin at the
    step's routed levels (the tile plan's 0, 1 and 2: B = 64 planes with
    alternating configurations, and the dual form's 128 outputs), with the
    Otsu thresholds under the production caps; timed beside the dense
    tail on the same band (``dense_ms``) and, as the library's yardstick,
    ``torch.fft.rfft`` / ``irfft`` of the band with the gains between;
    bound: the four FFTs' operations or the band's bytes. Then the kernel
    names one call launches under the profiler: the masked median and
    the chirp-z kernel, no library FFT or GEMM. Returns the single and the
    dual records and those names."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import fft_notch
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    g = torch.Generator(device=dev).manual_seed(seed + 29)
    n = plan.n_levels
    thr_cap = (plan.cells.max_threshold, plan.no_cells.max_threshold)
    routed = [lvl for lvl in range(n)
              if plan.notch_routes()[n - 1 - lvl] == "chirp"]
    if routed != [0, 1, 2]:
        raise AssertionError(f"fft-notch: the tile plan routes levels "
                             f"{routed} to chirp-z, not 0-2")
    single, dual = {"notch_delta_fft": {}}, {"notch_delta_fft": {}}
    for lvl in routed:
        i = n - 1 - lvl
        (h, w), sigmas = plan.ladder[i], plan.notch_sigmas()[i]
        rec = consts["notch_cat"][i]
        m = rec.twiddle.shape[0]
        ch = torch.randn((BATCH, h, w), generator=g, device=dev) * 0.5
        otsu = torch.sqrt(threshold_otsu_batch(ch, square=True))
        cat = _dense_bank(plan, consts, lvl, dev)
        # the no-cells configuration's packed gains, for the yardstick
        a, b = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                for v in fft_notch._packed_gains(
                    w, fft_notch.notch(w, sigmas[1])))
        for out, k in ((single, 1), (dual, 2)):
            n_out = k * BATCH
            idx = torch.arange(n_out, device=dev)
            sel = ((idx >= BATCH) if k == 2 else (idx % 2 == 1)).to(
                torch.int32)
            thr = torch.minimum(torch.where(sel == 0, thr_cap[0],
                                            thr_cap[1]), otsu.repeat(k))
            band = ch.repeat(k, 1, 1)

            def library():
                spec = torch.fft.rfft(band)
                return torch.fft.irfft(torch.complex(a * spec.real,
                                                     b * spec.imag), n=w)

            _compare(out, "notch_delta_fft", lvl,
                     lambda: tn.notch_delta_fft(ch, thr, sel, rec),
                     lambda: tn.notch_delta_fft_plain(ch, thr, sel, rec),
                     scale=ch.abs().max().item(),
                     ins=(ch, thr, sel, rec.chirp, rec.filters, rec.twiddle,
                          rec.gains),
                     ops=_chirp_ops(n_out, k, h, m), library=library,
                     tag="fft-notch",
                     extra={"dense": lambda: tn.notch_delta(ch, thr, sel,
                                                            cat)})
            del band
        del ch, otsu, cat
        torch.cuda.empty_cache()
    # the kernels of one call at level 0, by name
    i = n - 1
    (h, w) = plan.ladder[i]
    rec = consts["notch_cat"][i]
    ch = torch.randn((BATCH, h, w), generator=g, device=dev) * 0.5
    thr = torch.full((BATCH,), 0.8, device=dev)
    sel = (torch.arange(BATCH, device=dev) % 2).to(torch.int32)
    tn.notch_delta_fft(ch, thr, sel, rec)
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        tn.notch_delta_fft(ch, thr, sel, rec)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    print(f"[fft-notch] kernels of one call at level 0: {names}")
    ours = [nm for nm in names if re.search(
        r"notch_fft_kernel|row_median_masked_warp_kernel", nm)]
    if len(ours) != 2 or set(names) - set(ours):
        raise AssertionError(f"fft-notch: the call launched {names}, not "
                             f"the masked median and the chirp-z kernel "
                             f"alone")
    return single, dual, names


def _notch_parts(ch, thr, sel, notch_cat):
    """The notch tail's parts to time beside it: ``gemm``, its GEMM launch
    alone on the medians of the call (the mask, inpainting and delta
    fused), and ``product_alone``, ``torch.matmul`` of the output batch by
    the cells operator at the same per-plane shape, the product without
    mask, inpainting, delta or per-plane operator choice (no library call
    computes the whole function)."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops.cuda_build import launch

    B, h, w = ch.shape
    n_out = thr.shape[0]
    med = tn.row_median_masked(ch, thr)
    out = torch.empty((n_out, h, w), device=ch.device)
    v = tn.plan_notch_delta(n_out, h, w, ch.data_ptr() % 8,
                            notch_cat.data_ptr() % 8)
    band = ch.repeat(n_out // B, 1, 1)
    op = notch_cat[:, :w]

    def gemm():
        launch("destripe_notch", ch.device, ch.data_ptr(), med.data_ptr(),
               thr.data_ptr(), sel.data_ptr(), notch_cat.data_ptr(),
               out.data_ptr(), n_out, B, h, w, v)
        return out

    return {"gemm": gemm, "product_alone": lambda: torch.matmul(band, op)}


def _twin_consts(plan, dev):
    """The plane step's constants on ``dev`` (the band forms and notch
    operators the kernels read), with each banded level's dense operators,
    which only the plain twins read and the card's constants leave None,
    from the constants off the card."""
    from aind_smartspim_destripe_torch.ops import filter as tf

    consts = tf.device_constants(plan, dev)
    host = tf.device_constants(plan, "cpu")
    for key in ("an_y", "an_x_lo", "syn_y", "syn_x_lo"):
        consts[key] = tuple(a if a is not None else b.to(dev)
                            for a, b in zip(consts[key], host[key]))
    return consts


def phase_kernels(plan, consts, dev, seed):
    """Every kernel vs its plain twin at the step's shapes (B=64): K1-K4 at
    levels 0 and 1, the tail kernels at every level."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_band as cb
    from aind_smartspim_destripe_torch.ops.filter import _classifier_cut_f32

    g = torch.Generator(device=dev).manual_seed(seed)
    n = plan.n_levels
    cut = _classifier_cut_f32(400.0, 20.0, 0.3)
    thr_cap = (plan.cells.max_threshold, plan.no_cells.max_threshold)
    rec = {name: {} for name in REPLACES}
    B, H, W = BATCH, plan.height, plan.width
    x = torch.randint(0, 4000, (B, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    flat = 1.0 + 0.2 * torch.rand((H, W), generator=g, device=dev)
    dark = torch.full((H, W), 3.0, device=dev)
    src = x
    for lvl in (0, 1):
        bd = consts[f"band{lvl}"]
        a_x, a_y = consts["an_x_lo"][lvl], consts["an_y"][lvl]
        s_y, s_x = consts["syn_y"][n - 1 - lvl], consts["syn_x_lo"][n - 1 - lvl]
        log1p = lvl == 0
        kcut = cut if lvl == 0 else None
        K1 = bd["k1_coef"].shape[1]
        n_k1 = src.shape[0] * src.shape[1] * a_x.shape[0]
        _compare(rec, "an_x_lowpass_log1p", lvl,
                 lambda: cb.an_x_lowpass_log1p(src, a_x, bd["k1_start"],
                                               bd["k1_coef"], log1p, kcut),
                 lambda: cb.an_x_lowpass_log1p_plain(src, a_x, log1p, kcut),
                 ins=(src, bd["k1_start"], bd["k1_coef"]),
                 ops=2.0 * K1 * n_k1 + (3.0 if log1p else 0.0) * src.numel(),
                 library=None if log1p else (
                     lambda: torch.matmul(src, a_x.t())))
        k1 = cb.an_x_lowpass_log1p(src, a_x, bd["k1_start"], bd["k1_coef"],
                                   log1p)
        K2 = bd["k2_lo"].shape[1]
        _compare(rec, "an_y_pass", lvl,
                 lambda: cb.an_y_pass(k1, a_y, bd["k2_start"], bd["k2_lo"],
                                      bd["k2_hi"]),
                 lambda: cb.an_y_pass_plain(k1, a_y),
                 ins=(k1, bd["k2_start"], bd["k2_lo"], bd["k2_hi"]),
                 ops=4.0 * K2 * k1.shape[0] * (a_y.shape[0] // 2) * k1.shape[2],
                 library=lambda: torch.matmul(a_y, k1),
                 witness=lambda: cb.an_y_pass_ordered(
                     k1, bd["k2_start"], bd["k2_lo"], bd["k2_hi"]))
        ca, ch, _ = cb.an_y_pass(k1, a_y, bd["k2_start"], bd["k2_lo"],
                                 bd["k2_hi"])
        del k1
        for name, (kern, plain, ins, ops, extra) in _tail_calls(
                ch, _dense_bank(plan, consts, lvl, dev), thr_cap).items():
            _compare(rec, name, lvl, kern, plain,
                     scale=ch.abs().max().item(), ins=ins, ops=ops,
                     extra=extra if lvl < 2 else None)
        corr = torch.randn(ch.shape, generator=g, device=dev) * 0.01
        delta = torch.randn(ch.shape, generator=g, device=dev) * 0.01
        del ch
        up = torch.cat([corr, delta], dim=1)
        K3 = bd["k3_hi"].shape[1]
        _compare(rec, "syn_y_pass", lvl,
                 lambda: cb.syn_y_pass(corr, delta, s_y, bd["k3_start"],
                                       bd["k3_lo"], bd["k3_hi"]),
                 lambda: cb.syn_y_pass_plain(corr, delta, s_y),
                 ins=(corr, delta, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]),
                 ops=4.0 * K3 * B * s_y.shape[0] * corr.shape[2],
                 library=lambda: torch.matmul(s_y, up),
                 witness=lambda: cb.syn_y_pass_ordered(
                     corr, delta, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]))
        del up
        st = cb.syn_y_pass(corr, delta, s_y, bd["k3_start"], bd["k3_lo"],
                           bd["k3_hi"])
        epi = dict(flat=flat, dark=dark) if lvl == 0 else {}
        img = x if lvl == 0 else None
        K4 = bd["k4_coef"].shape[1]
        n_k4 = B * st.shape[1] * s_x.shape[0]
        _compare(rec, "syn_x_exp", lvl,
                 lambda: cb.syn_x_exp(st, img, s_x, bd["k4_start"],
                                      bd["k4_coef"], **epi),
                 lambda: cb.syn_x_exp_plain(st, img, s_x, **epi),
                 ins=(st, img, bd["k4_start"], bd["k4_coef"], *epi.values()),
                 ops=(2.0 * K4 + (8.0 if img is not None else 0.0)) * n_k4,
                 library=None if img is not None else (
                     lambda: torch.matmul(st, s_x.t())),
                 witness=lambda: cb.syn_x_exp_ordered(
                     st, img, bd["k4_start"], bd["k4_coef"], **epi))
        src = ca
        del corr, delta, st
    # the tail at the deeper (dense) levels, on bands of their shapes
    for lvl in range(2, n):
        h, w = plan.ladder[n - 1 - lvl]
        ch = torch.randn((B, h, w), generator=g, device=dev) * 0.5
        for name, (kern, plain, ins, ops, _) in _tail_calls(
                ch, _dense_bank(plan, consts, lvl, dev), thr_cap).items():
            _compare(rec, name, lvl, kern, plain, scale=ch.abs().max().item(),
                     ins=ins, ops=ops)
    torch.cuda.synchronize()
    return rec


def phase_dual_kernels(plan, consts, dev, seed):
    """The dual-band forms vs their twins at the dual step's shapes (B=64):
    the centres' histogram of the raw uint16 planes, the blend on those
    planes and the stacked (2B, H, W) pair, K4 wrapped
    at level 0 (2B corrections, B raw planes), K3 on 2B corrections at
    levels 0 and 1, and the wrapped median and
    notch at every level (2B thresholds and operator choices with the
    production caps per half; the real level-0 and level-1 bands)."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_band as cb
    from aind_smartspim_destripe_torch.ops import cuda_blend as tbl
    from aind_smartspim_destripe_torch.ops import cuda_hist as th
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    g = torch.Generator(device=dev).manual_seed(seed + 7)
    n = plan.n_levels
    thr_cap = (plan.cells.max_threshold, plan.no_cells.max_threshold)
    rec = {name: {} for name in REPLACES}
    B, H, W = BATCH, plan.height, plan.width
    x = torch.randint(0, 4000, (B, H, W), generator=g, device=dev,
                      dtype=torch.int32).to(torch.uint16)
    both = torch.randn((2 * B, H, W), generator=g, device=dev) * 300 + 500
    centers = threshold_otsu_batch(x)
    # the blend centres' histogram: raw uint16 planes, binned as read
    xi = x.to(torch.int32)  # CUDA reduces no uint16
    lo = xi.amin(dim=(1, 2)).to(torch.float32)
    span = xi.amax(dim=(1, 2)).to(torch.float32) - lo
    del xi
    _compare(rec, "histogram256_batch", 0,
             lambda: th.histogram256_batch(x, lo, span),
             lambda: th.histogram256_batch_plain(x, lo, span),
             ins=(x, lo, span), ops=4.0 * x.numel())
    # the blend's division by 17 against IEEE division, every float from
    # +0 to 17.0, then the blend bare and with each fused epilogue
    bad, first_bad = tbl.div17_mismatches(dev)
    n_bits = int(torch.tensor([17.0]).view(torch.int32).item()) + 1
    print(f"[kernels] blend_smooth_mix div17: {bad} of {n_bits} float32 bit "
          f"patterns from +0 to 17.0 differ from IEEE division"
          + ("" if bad == 0 else f" (first 0x{first_bad:08x})"))
    if bad:
        raise AssertionError("the blend's division by 17 is not IEEE's")
    rec["div17"] = dict(patterns=n_bits, mismatches=bad)
    _blend_modes(rec, 0, x, both, centers, *_fields_of(seed + 13, dev, H, W),
                 tag="kernels")
    del both
    torch.cuda.empty_cache()

    bd = consts["band0"]
    s_x = consts["syn_x_lo"][n - 1]
    st = torch.randn((2 * B, H, s_x.shape[1]), generator=g, device=dev) * 0.01
    K4 = bd["k4_coef"].shape[1]
    _compare(rec, "syn_x_exp", 0,
             lambda: cb.syn_x_exp(st, x, s_x, bd["k4_start"], bd["k4_coef"]),
             lambda: cb.syn_x_exp_plain(st, x, s_x),
             ins=(st, x, bd["k4_start"], bd["k4_coef"]),
             ops=(2.0 * K4 + 8.0) * 2 * B * H * W,
             witness=lambda: cb.syn_x_exp_ordered(st, x, bd["k4_start"],
                                                  bd["k4_coef"]))
    del st
    torch.cuda.empty_cache()
    # K3 on the 2B corrections of the dual step, levels 0 and 1
    for lvl in (0, 1):
        bd = consts[f"band{lvl}"]
        s_y = consts["syn_y"][n - 1 - lvl]
        shape = (2 * B,) + plan.ladder[n - 1 - lvl]
        corr = torch.randn(shape, generator=g, device=dev) * 0.01
        delta = torch.randn(shape, generator=g, device=dev) * 0.01
        up = torch.cat([corr, delta], dim=1)
        K3 = bd["k3_hi"].shape[1]
        _compare(rec, "syn_y_pass", lvl,
                 lambda: cb.syn_y_pass(corr, delta, s_y, bd["k3_start"],
                                       bd["k3_lo"], bd["k3_hi"]),
                 lambda: cb.syn_y_pass_plain(corr, delta, s_y),
                 ins=(corr, delta, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]),
                 ops=4.0 * K3 * 2 * B * s_y.shape[0] * shape[2],
                 library=lambda: torch.matmul(s_y, up),
                 witness=lambda: cb.syn_y_pass_ordered(
                     corr, delta, bd["k3_start"], bd["k3_lo"], bd["k3_hi"]))
        del corr, delta, up
        torch.cuda.empty_cache()

    src = x
    for lvl in range(n):
        if lvl < 2:  # the real bands of the banded levels
            bd = consts[f"band{lvl}"]
            k1 = cb.an_x_lowpass_log1p(src, consts["an_x_lo"][lvl],
                                       bd["k1_start"], bd["k1_coef"],
                                       log1p=lvl == 0)
            src, ch, _ = cb.an_y_pass(k1, consts["an_y"][lvl], bd["k2_start"],
                                      bd["k2_lo"], bd["k2_hi"])
            del k1
        else:
            h, w = plan.ladder[n - 1 - lvl]
            ch = torch.randn((B, h, w), generator=g, device=dev) * 0.5
        for name, (kern, plain, ins, ops, extra) in _tail_calls(
                ch, _dense_bank(plan, consts, lvl, dev), thr_cap,
                dual=True).items():
            _compare(rec, name, lvl, kern, plain, scale=ch.abs().max().item(),
                     ins=ins, ops=ops, extra=extra if lvl == 0 else None)
        del ch
    torch.cuda.synchronize()
    return rec


def _fields_of(seed, dev, h, w):
    """A flat-field and a darkfield of (h, w) rows, from ``seed``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    flat = 1.0 + 0.2 * torch.rand((h, w), generator=g, device=dev)
    return flat, torch.full((h, w), 3.0, device=dev)


def _blend_modes(rec, lvl, x, both, centers, flat, dark, tag,
                 out_rows=None, modes=("bare", "flat", "wrap")):
    """The blend in each of ``modes`` against its twin composition (the
    twin, the row slice, the epilogue) at the window ``x`` with the stacked
    band pair ``both``, emitting ``out_rows`` (None: every row). The bare
    form is recorded under ``lvl``, the others under ``lvl`` and the mode
    (``lvl`` alone when it is the only one): each fused form must be bit-equal
    to the bare kernel followed by the epilogue on the card."""
    from aind_smartspim_destripe_torch.ops import cuda_blend as tbl
    from aind_smartspim_destripe_torch.ops.flatfield import (
        flatfield_correction,
        wrap_cast,
    )

    B = x.shape[0]
    first, count = (0, x.shape[1]) if out_rows is None else out_rows
    epis = {"bare": ({}, lambda y: y, 45.0),
            "flat": (dict(flat=flat, dark=dark),
                     lambda y: flatfield_correction(y, flat, dark), 50.0),
            "wrap": (dict(wrap=True), wrap_cast, 47.0)}
    for mode in modes:
        kw, epi, ops = epis[mode]
        key = lvl if len(modes) == 1 or mode == "bare" else f"{lvl} {mode}"

        def kern(kw=kw):
            return tbl.blend_smooth_mix(x, both, None, centers, CROSSOVER,
                                        out_rows=out_rows, **kw)

        def plain(epi=epi):
            y = tbl.blend_bands(x, both[:B], both[B:], centers, CROSSOVER)
            return epi(y[:, first:first + count])

        def witness(epi=epi):
            return epi(tbl.blend_smooth_mix(x, both, None, centers,
                                            CROSSOVER, out_rows=out_rows))

        _compare(rec, "blend_smooth_mix", key, kern, plain,
                 scale=both.abs().max().item(),
                 ins=(x, both, centers, tuple(kw.values())[:2]
                      if mode == "flat" else ()),
                 ops=ops * B * count * x.shape[2], tag=tag,
                 witness=None if mode == "bare" else witness,
                 witness_name="the bare kernel and the epilogue",
                 modulo=mode == "wrap")


def phase_median(dev, seed):
    """``row_median_batch`` through ``ops.filter._row_median(x)``
    against its twin (the sort), exactly, at MEDIAN_SHAPES (``path``: the
    ``movedim`` view of the stack, as ``models.basic._median0`` passes it,
    timed with any copy the wrapper makes; it must make none); the library
    call is ``torch.kthvalue`` of the middle rank(s) on the same tensor,
    averaged for even n."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import filter as tf

    g = torch.Generator(device=dev).manual_seed(seed + 13)
    rec = {"row_median_batch": {}}
    for key, shape in MEDIAN_SHAPES.items():
        x = torch.randn(shape, generator=g, device=dev) * 0.3
        if key == "path":
            x = x.movedim(0, -1)
            tn.row_median_batch.copies = 0
            tf._row_median(x)
            if tn.row_median_batch.copies:
                raise AssertionError("the median copied BaSiC's stack")
        k1, k2 = (x.shape[-1] - 1) // 2, x.shape[-1] // 2

        def kthvalue():
            lo = torch.kthvalue(x, k1 + 1, -1, keepdim=True).values
            if k1 == k2:
                return lo
            return (lo + torch.kthvalue(x, k2 + 1, -1,
                                        keepdim=True).values) * 0.5

        _compare(rec, "row_median_batch", key,
                 lambda: tf._row_median(x),
                 lambda: tn.row_median_batch_plain(x),
                 ins=(x,), ops=float(x.numel()), library=kthvalue)
        del x
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rec


def _dense_products(rec, lvl_key, forms, dev):
    """``dense_matmul`` on each product of ``forms`` ({form: (a, b)}),
    against its twin (``torch.matmul``, also the library call): bit-equal
    for the batch's first plane alone (the fixed order), whether it equals
    cuBLAS's bits, and, where the wrapper plans 8-byte loads, the kernel
    launched directly at 4-byte loads (bit-equal, timed)."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_dense as td
    from aind_smartspim_destripe_torch.ops.cuda_build import launch

    for form, (p, q) in forms.items():
        key = f"{lvl_key} {form}"
        batch = next(t.shape[0] for t in (p, q) if t.ndim == 3)
        _compare(rec, "dense_matmul", key, lambda: td.dense_matmul(p, q),
                 lambda: td.dense_matmul_plain(p, q),
                 scale=p.abs().max().item() * q.abs().max().item()
                 * p.shape[-1], ins=(p, q),
                 ops=2.0 * batch * p.shape[-2] * q.shape[-1] * p.shape[-1],
                 library=lambda: torch.matmul(p, q))
        got = td.dense_matmul(p, q)
        one = (td.dense_matmul(p[:1], q) if p.ndim == 3
               else td.dense_matmul(p, q[:1]))
        cublas = torch.equal(got, torch.matmul(p, q))
        pl = td.plan_dense_matmul(p.shape, p.stride(), q.shape, q.stride(),
                                  p.data_ptr() % 8, q.data_ptr() % 8)
        narrow = None
        if (pl.va, pl.vb) != (1, 1):
            c4 = torch.empty_like(got)

            def four(p=p, q=q, pl=pl, c4=c4):
                launch("destripe_dense_matmul", dev, p.data_ptr(),
                       q.data_ptr(), c4.data_ptr(), pl.batch, pl.m, pl.n,
                       pl.K, *pl.sa, *pl.sb, 1, 1)
                return c4

            if not torch.equal(four(), got):
                raise AssertionError("dense_matmul's copy widths differ")
            narrow = _time_ms(four)
            del c4
        print(f"[kernels] dense_matmul level {key}: {tuple(p.shape)} @ "
              f"{tuple(q.shape)} as {pl.batch} x ({pl.m}, {pl.n}), K = "
              f"{pl.K}, {4 * pl.va}- and {4 * pl.vb}-byte loads"
              + ("" if narrow is None else
                 f" (4- and 4-byte: {narrow:.4f} ms, bit-equal)")
              + f"; one plane alone bit-equal to it in the "
              f"batch: {torch.equal(one, got[:1])}; bit-equal to cuBLAS "
              f"at B={batch}: {cublas}")
        if not torch.equal(one, got[:1]):
            raise AssertionError("dense_matmul depends on the batch")
        rec["dense_matmul"][key].update(cublas_bit_equal=cublas,
                                        copy_widths=[pl.va, pl.vb],
                                        ms_4byte_copies=narrow)


def _level_forms(g, dev, h, w, an_x_lo, an_y, syn_y, syn_x_lo):
    """The four products of a dense level with an (h, w) input, at B=64,
    in the order the step runs them, the operators passed as the step
    passes them (transposed or sliced views)."""
    import torch

    L = an_x_lo.shape[0]
    return {
        "an_x": (torch.randn((BATCH, h, w), generator=g, device=dev) * 0.3,
                 an_x_lo.t()),
        "an_y": (an_y, torch.randn((BATCH, h, L), generator=g,
                                   device=dev) * 0.3),
        "syn_y": (syn_y, torch.randn((BATCH, syn_y.shape[1], L),
                                     generator=g, device=dev) * 0.01),
        "syn_x": (torch.randn((BATCH, syn_y.shape[0], L), generator=g,
                              device=dev) * 0.01, syn_x_lo.t()),
    }


def phase_dense(plan, consts, dev, seed):
    """``dense_matmul`` (:func:`_dense_products`) on the four products of
    every dense level (2-7) at B=64, then the sums over a step's 24
    products of the kernel's and of cuBLAS's times; then the four products
    of level 2 of a LONG_K_SHAPE plane, whose an_x product runs K in the
    thousands (the dense level of a plane whose short side is under 560)."""
    import torch

    from aind_smartspim_destripe_torch.ops import wavelets as tw

    g = torch.Generator(device=dev).manual_seed(seed + 17)
    n = plan.n_levels
    rec = {"dense_matmul": {}}
    for lvl in range(2, n):
        h, w = plan.ladder[n - lvl]  # the level's input: the finer cA band
        forms = _level_forms(g, dev, h, w, consts["an_x_lo"][lvl],
                             consts["an_y"][lvl],
                             consts["syn_y"][n - 1 - lvl],
                             consts["syn_x_lo"][n - 1 - lvl])
        _dense_products(rec, str(lvl), forms, dev)
        del forms
    rows = rec["dense_matmul"].values()
    for lvl in range(2, n):
        lv = [r for k, r in rec["dense_matmul"].items()
              if k.startswith(f"{lvl} ")]
        print(f"[kernels] dense_matmul level {lvl}: four products "
              f"{sum(r['ms'] for r in lv):.4f} ms, torch.matmul "
              f"{sum(r['library_ms'] for r in lv):.4f} ms")
    kern, lib = (sum(r[k] for r in rows) for k in ("ms", "library_ms"))
    print(f"[kernels] dense_matmul per step (levels 2-{n - 1}, "
          f"{len(rows)} products): {kern:.4f} ms against torch.matmul's "
          f"{lib:.4f} ms ({kern / lib:.2f}x)")
    # level 2 of the long-K plane, its operators built for that level
    # alone (the plane's finest x operator would be gigabytes)
    H, W = LONG_K_SHAPE
    lplan = tf_build_plan(H, W)
    m = lplan.n_levels
    hi, wi = lplan.ladder[m - 2]
    L_h, L_w = lplan.ladder[m - 3]

    def put(a):
        return torch.as_tensor(a, device=dev)

    forms = _level_forms(
        g, dev, hi, wi, put(tw.analysis_operator(wi, lplan.wavelet)[:L_w]),
        put(tw.analysis_operator(hi, lplan.wavelet)),
        put(tw.synthesis_operator(L_h, lplan.wavelet)[:hi]),
        put(tw.synthesis_operator(L_w, lplan.wavelet)[:wi, :L_w]))
    _dense_products(rec, f"long-K {H}x{W} 2", forms, dev)
    torch.cuda.synchronize()
    return rec


def tf_build_plan(h, w):
    """The production configurations' plan of an (h, w) plane."""
    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.ops import filter as tf

    cfg = run_capsule.PRODUCTION_PARAMETERS
    return tf.build_plan(h, w, tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))


def _sync(mesh):
    import torch

    for d in dict.fromkeys(mesh):
        torch.cuda.synchronize(d)




def _gate(got, want):
    """(max LSB, pixels > 1 LSB, PSNR dB) of uint16 planes against a
    reference, and whether they pass the flip budget and PSNR floor."""
    import numpy as np

    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    flips = int((d > 1).sum())
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
    ok = flips <= FLIP_BUDGET * d.size and psnr >= PSNR_MIN
    return int(d.max()), flips, d.size, psnr, ok


def _host_ms_and_syncs(fn, mesh, reps=3):
    """Mean host-clock ms of ``reps`` calls of ``fn`` (one warm-up call
    first; the devices synchronised after), the mean host ms until the last
    call had returned, before that synchronisation (the time to launch a
    call's work), and the synchronising CUDA calls made while launching
    them: a step that launches every entry's share without a host wait
    makes none."""
    import torch

    fn()
    _sync(mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for _ in range(reps):
                res = fn()
            launched = time.perf_counter()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    _sync(mesh)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    launch_ms = (launched - t0) * 1e3 / reps
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return res, ms, launch_ms, syncs


def _card_ms(fn, reps=3):
    """Mean card ms of ``reps`` calls of ``fn`` (one warm-up call first):
    the device time of every kernel, copy and fill that ``torch.profiler``
    records for them, so no wait on the host enters it. None, printed as
    not measured, if the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 / reps if us else None


def _ms(v):
    return "not measured" if v is None else f"{v:.2f} ms"


def phase_zmesh(plan, vol, flat, dark, dev, mesh):
    """The plane-sharded step on the mesh against the single-device step:
    bit-equal to one device run on each entry's planes as separate batches
    (the split itself moves no bit), and against one device on the whole
    64-plane batch within 1 LSB outside the flip budget at PSNR >= 100 dB
    (a dense level's folded product rounds by its row count, so batches of
    other sizes may round otherwise: scripts/batch_stages.py). Both results
    are held, on the sampled planes, against the plain path on the CPU, a
    witness independent of the card's GEMMs."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    b = BATCH // len(mesh)
    outs, times, syncs = {}, {}, {}
    for key, devices in (("one", [dev]), ("mesh", mesh)):
        step = make_device_step(plan, 2500.0, True, devices=devices)
        if getattr(step, "shards_rows", False) or step.n_devices != len(
                devices):
            raise AssertionError("the plane-sharded step was not selected")
        fields = (step.put_const(flat), step.put_const(dark.astype(
            np.float32)))
        images = step.put(vol[:BATCH])
        # the step must launch every entry's share without waiting on the
        # host, or the devices would take their turns instead of working at
        # once: count the synchronising calls made while it launches
        res, times[key], _, syncs[key] = _host_ms_and_syncs(
            lambda: step(images, *fields), devices)
        outs[key] = step.to_host(res)
        if key == "one":
            outs["split"] = np.concatenate([
                step.to_host(step(step.put(vol[d * b:(d + 1) * b]), *fields))
                for d in range(len(mesh))])
        del step, fields, images, res
    same = np.array_equal(outs["mesh"], outs["split"])
    lsb, flips, n, psnr, ok = _gate(outs["mesh"], outs["one"])
    print(f"[zmesh] plane-sharded step ({BATCH}, {SHAPE[1]}, {SHAPE[2]}) on "
          f"{len(mesh)} entries ({b} planes each): "
          f"{'bit-equal' if same else 'NOT bit-equal'} to one device on "
          f"{b}-plane batches; against one {BATCH}-plane batch max "
          f"{lsb} LSB, {flips} pixels > 1 LSB ({flips / n:.2e}, budget "
          f"{FLIP_BUDGET}), PSNR {psnr:.1f} dB; {times['mesh']:.2f} ms vs "
          f"{times['one']:.2f} ms (mean of 3 calls, host clock); host "
          f"syncs while launching: {syncs['mesh']} (one device "
          f"{syncs['one']})")
    if not same or not ok:
        raise AssertionError("[zmesh] the plane-sharded step differs")
    if syncs["mesh"]:
        raise AssertionError("[zmesh] the plane-sharded step waits on the "
                             "host, so its devices take turns")
    x = torch.from_numpy(vol[list(ZSAMPLED)])
    with torch.inference_mode():
        ref = tf.destripe_batch(plan, x, 2500.0, flat=flat,
                                dark=dark.astype(np.float32)).numpy()
    for key in ("mesh", "one"):
        lsb, flips, n, psnr, ok = _gate(outs[key][list(ZSAMPLED)], ref)
        print(f"[zmesh] {key} planes {ZSAMPLED} vs the plain path on the CPU:"
              f" max {lsb} LSB, {flips} pixels > 1 LSB ({flips / n:.2e}, "
              f"budget {FLIP_BUDGET}), PSNR {psnr:.1f} dB (min {PSNR_MIN})")
        if not ok:
            raise AssertionError(f"[zmesh] {key} differs from the CPU path")


def _path_launches(tag, fn, mesh, path_kernels=SINGLE):
    """``fn()`` with the launch counts reset just before it and read just
    after; raises unless each kernel of the path launched."""
    from aind_smartspim_destripe_torch import ops

    _sync(mesh)
    ops.reset_launches()
    res = fn()
    _sync(mesh)
    launches = _launches()
    _require(tag, launches, path_kernels)
    return res, launches


def _u16_diff(got, want):
    """Pixels of two uint16 arrays that differ, and that differ by > 1."""
    import numpy as np

    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int((d > 0).sum()), int((d > 1).sum())


def phase_mesh_helpers(plan, vol, flats, dark, dev, mesh):
    """``[mesh-helpers]``: ``parallel.mesh.sharded_destripe_step`` on the
    mesh, with the flat-field and the wrap epilogue, against the fused step
    of ``make_device_step`` on the same mesh (bit for bit: the helper keeps
    the float32 batch for its statistics and applies the epilogue after
    it) and, on the sampled planes ZSAMPLED, against the plain path on the
    CPU (the gate of ``[zmesh]``); its [min, max] equal to those of the
    float32 step on the same shares; ``sharded_destripe_step_2d`` on a
    2 x len(mesh) mesh, two 32-plane tiles each with its own flat, each tile
    bit-equal (outputs and statistics) to the 1-D helper on that tile;
    ``global_minmax`` exact and ``sharded_normalize_image`` bit-equal to
    the same formula on one device. Each step's launches (every kernel of
    the single-band path), ms per call beside the fused step's (host clock,
    mean of 3), split into the host's time to launch a call and the
    card's device time for it (:func:`_card_ms`), the same split for one
    share's float32 destripe, and host syncs while launching (must be 0).
    Returns the launch counts of each path."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.ops.flatfield import (
        flatfield_correction,
        wrap_cast,
    )
    from aind_smartspim_destripe_torch.parallel import mesh as tm
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    dark32 = dark.astype(np.float32)
    images = torch.from_numpy(vol[:BATCH]).to(dev)
    fields = (torch.from_numpy(flats[0]).to(dev),
              torch.from_numpy(dark32).to(dev))
    b = BATCH // len(mesh)
    # the float32 step on the helper's shares, for its statistics
    consts = tf.device_constants(plan, dev)
    with torch.inference_mode():
        floats = [tf.destripe_batch(plan, images[d * b:(d + 1) * b], 2500.0,
                                    consts) for d in range(len(mesh))]
    del consts
    want_stats = torch.stack([torch.stack([f.amin() for f in floats]).amin(),
                              torch.stack([f.amax() for f in floats]).amax()])
    lo, hi = tm.global_minmax(mesh, floats)
    if not (torch.equal(lo, want_stats[0]) and torch.equal(hi,
                                                           want_stats[1])):
        raise AssertionError("[mesh-helpers] global_minmax is not exact")
    del floats
    print(f"[mesh-helpers] global_minmax of the float32 step's {len(mesh)} "
          f"shares: [{lo.item():.6g}, {hi.item():.6g}], exact")
    # the plain path on the CPU: one float32 destripe of the sampled
    # planes, both epilogues
    x = torch.from_numpy(vol[list(ZSAMPLED)])
    with torch.inference_mode():
        ref = tf.destripe_batch(plan, x, 2500.0)
        refs = {"flat": flatfield_correction(
                    ref, torch.from_numpy(flats[0]),
                    torch.from_numpy(dark32)).numpy(),
                "wrap": wrap_cast(ref).numpy()}
    del ref
    paths, rec = {}, {}
    for mode in ("flat", "wrap"):
        with_flat = mode == "flat"
        run = tm.sharded_destripe_step(mesh, plan, 2500.0, with_flat)
        (res, stats), paths[f"mesh_helper_{mode}"] = _path_launches(
            f"mesh-helpers {mode}", lambda: run(images, *fields), mesh)
        got = np.concatenate([r.cpu().numpy() for r in res])
        step = make_device_step(plan, 2500.0, with_flat, devices=mesh)
        put = step.put(vol[:BATCH])
        consts_f = (step.put_const(flats[0]), step.put_const(dark32))
        fused = step.to_host(step(put, *consts_f))
        n0, n1 = _u16_diff(got, fused)
        _, ms, launch_ms, syncs = _host_ms_and_syncs(
            lambda: run(images, *fields), mesh)
        _, fused_ms, fused_launch_ms, fused_syncs = _host_ms_and_syncs(
            lambda: step(put, *consts_f), mesh)
        card_ms = _card_ms(lambda: run(images, *fields))
        fused_card_ms = _card_ms(lambda: step(put, *consts_f))
        stats_ok = torch.equal(stats, want_stats)
        print(f"[mesh-helpers] sharded_destripe_step ({BATCH}, {SHAPE[1]}, "
              f"{SHAPE[2]}) {mode} on {len(mesh)} entries: "
              f"{'bit-equal' if not n0 else 'NOT bit-equal'} to "
              f"make_device_step's fused step on the same mesh ({n0} pixels "
              f"differ, {n1} by > 1 LSB); stats [{stats[0].item():.6g}, "
              f"{stats[1].item():.6g}] {'equal' if stats_ok else 'DIFFER'} "
              f"to the float32 step's; {ms:.2f} ms per call vs the fused "
              f"step's {fused_ms:.2f} ms (mean of 3, host clock), launched "
              f"in {launch_ms:.2f} vs {fused_launch_ms:.2f} ms on the host, "
              f"{_ms(card_ms)} vs {_ms(fused_card_ms)} of device time "
              f"(torch.profiler, mean of 3); host syncs while launching: "
              f"{syncs} (fused {fused_syncs})")
        lsb, flips, n, psnr, ok = _gate(got[list(ZSAMPLED)], refs[mode])
        print(f"[mesh-helpers] {mode} planes {ZSAMPLED} vs the plain path on "
              f"the CPU: max {lsb} LSB, {flips} pixels > 1 LSB "
              f"({flips / n:.2e}, budget {FLIP_BUDGET}), PSNR {psnr:.1f} dB "
              f"(min {PSNR_MIN})")
        rec[mode] = dict(ms=ms, fused_ms=fused_ms, launch_ms=launch_ms,
                         fused_launch_ms=fused_launch_ms, card_ms=card_ms,
                         fused_card_ms=fused_card_ms, syncs=syncs,
                         pixels_differ=n0, pixels_over_1lsb=n1)
        if n0 or not stats_ok or not ok or syncs:
            raise AssertionError(f"[mesh-helpers] sharded_destripe_step "
                                 f"{mode} failed")
        del res, step, put, run
    torch.cuda.empty_cache()

    # one share's float32 destripe, as each step launches it: the 1-D
    # helper's (b planes) and the 2-D step's (b / 2)
    consts = tf.device_constants(plan, dev)
    for nb in (b, b // 2):
        def share(nb=nb):
            with torch.inference_mode():
                return tf.destripe_batch(plan, images[:nb], 2500.0, consts)
        _, _, launch, _ = _host_ms_and_syncs(share, mesh)
        card = _card_ms(share)
        print(f"[mesh-helpers] one share's destripe_batch ({nb}, {SHAPE[1]}, "
              f"{SHAPE[2]}): launched in {launch:.2f} ms on the host, "
              f"{_ms(card)} of device time (mean of 3)")
        rec[f"share_{nb}"] = dict(launch_ms=launch, card_ms=card)
    del consts
    torch.cuda.empty_cache()

    # tiles x planes: two 32-plane tiles, each with its side's flat
    mesh2 = [list(mesh)] * 2
    tiles = images.reshape((2, BATCH // 2) + images.shape[1:])
    tflats = torch.stack([torch.from_numpy(f) for f in flats[:2]]).to(dev)
    tdarks = torch.stack([fields[1]] * 2)
    run2 = tm.sharded_destripe_step_2d(mesh2, plan, 2500.0)
    (out2, stats2), paths["mesh_helper_2d"] = _path_launches(
        "mesh-helpers 2d", lambda: run2(tiles, tflats, tdarks), mesh)
    _, ms2, launch2, syncs2 = _host_ms_and_syncs(
        lambda: run2(tiles, tflats, tdarks), mesh)
    card2 = _card_ms(lambda: run2(tiles, tflats, tdarks))
    same = True
    for t in range(2):
        one, one_stats = tm.sharded_destripe_step(mesh2[t], plan, 2500.0)(
            tiles[t], tflats[t], tdarks[t])
        same &= all(torch.equal(a, c) for a, c in zip(out2[t], one))
        same &= torch.equal(stats2[t], one_stats)
    print(f"[mesh-helpers] sharded_destripe_step_2d {tuple(tiles.shape)} on "
          f"a 2 x {len(mesh)} mesh: {'bit-equal' if same else 'NOT equal'} "
          f"to the 1-D helper per tile with its own flat (outputs and "
          f"(T, 2) stats); {ms2:.2f} ms per call (mean of 3, host clock), "
          f"launched in {launch2:.2f} ms on the host, {_ms(card2)} of device "
          f"time (torch.profiler, mean of 3); host syncs while launching: "
          f"{syncs2}")
    rec["2d"] = dict(ms=ms2, launch_ms=launch2, card_ms=card2, syncs=syncs2)
    if not same or syncs2:
        raise AssertionError("[mesh-helpers] sharded_destripe_step_2d "
                             "failed")
    del out2, run2, tiles

    norm = tm.sharded_normalize_image(mesh, images)
    xf = images.to(torch.float32)
    want = 1 + ((xf - xf.amin()) / (xf.amax() - xf.amin())).to(torch.float16)
    same = torch.equal(torch.cat([p.to(dev) for p in norm]), want)
    print(f"[mesh-helpers] sharded_normalize_image {tuple(images.shape)}: "
          f"{'bit-equal' if same else 'NOT equal'} to the same formula on "
          f"one device")
    if not same:
        raise AssertionError("[mesh-helpers] sharded_normalize_image "
                             "differs")
    del norm, xf, want, images
    torch.cuda.empty_cache()
    return paths, rec


def phase_execute_worker(plan, vol, flats, dark, dev):
    """``[execute-worker]``: ``zarr_destriper.execute_worker`` on the
    tile's planes 64-127 as one (1, 1, 64, H, W) block, written into a port
    store at z 64:128 and decoded back, bit-equal to ``make_device_step``
    on the same 64 planes: with the retrospective flat, with the same
    planes passed as float32 (the JAX package's input; the same bits), and
    with the hemisphere flat (retrospective off: the tile's side, 1, from
    its tile config). Each call's launches (every kernel of the
    single-band path) and seconds. Returns the launch counts of each."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch import zarr_destriper as tz
    from aind_smartspim_destripe_torch.io.zarr import ZarrArray
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    cfg = run_capsule.PRODUCTION_PARAMETERS
    _, H, W = SHAPE
    block = vol[BATCH:2 * BATCH]
    dark32 = dark.astype(np.float32)
    step = make_device_step(plan, 2500.0, True, devices=[dev])
    imgs = step.put(block)
    want = [step.to_host(step(imgs, step.put_const(f), step.put_const(
        dark32))) for f in flats]
    del step, imgs
    work = ROOT / "build" / "smoke_worker"
    shutil.rmtree(work, ignore_errors=True)
    store = ZarrArray.create(str(work / "out.zarr"), (1, 1, 2 * BATCH, H, W),
                             (1, 1, BATCH, 128, 128), np.uint16)
    z = (slice(0, 1), slice(0, 1), slice(BATCH, 2 * BATCH), slice(0, H),
         slice(0, W))
    cases = (
        ("retrospective", block, 0, True),
        ("retrospective-f32", block.astype(np.float32), 0, True),
        ("hemisphere", block, 1, False),
    )
    paths = {}
    try:
        for tag, data, side, retro in cases:
            shadow = {"retrospective": retro, "darkfield": dark32,
                      "flatfield": flats[0] if retro else flats,
                      "tile_config": {"471320": {"461360": 1}}}
            t0 = time.perf_counter()
            res, paths[f"execute_worker_{tag}"] = _path_launches(
                f"execute-worker {tag}", lambda: tz.execute_worker(
                    data[None, None], z, store, cfg["cells_config"],
                    cfg["no_cells_config"], shadow_correction=shadow,
                    dataset_name="471320_461360.zarr", device=dev), [dev])
            secs = time.perf_counter() - t0
            back = np.asarray(store[0, 0, BATCH:2 * BATCH])
            n0, n1 = _u16_diff(back, want[side])
            same = (n0 == 0 and np.array_equal(np.squeeze(res), back)
                    and not np.asarray(store[0, 0, :BATCH]).any())
            print(f"[execute-worker] {tag}: block {tuple(data.shape)} "
                  f"{data.dtype} destriped and written at z {BATCH}:"
                  f"{2 * BATCH} in {secs:.2f} s (plan, device call, store "
                  f"write); decoded back "
                  f"{'bit-equal' if same else 'NOT bit-equal'} to "
                  f"make_device_step on the same planes with flat {side} "
                  f"({n0} pixels differ, {n1} by > 1 LSB); z 0:{BATCH} "
                  f"left empty")
            if not same:
                raise AssertionError(f"[execute-worker] {tag} differs")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return paths


def phase_wavelets(vol, dev, mesh):
    """``[wavelets]``: the public transform API on log(1 + x) of the
    64-plane batch at full width on the card: ``wavedec2`` / ``waverec2``
    (8 db3 levels) blocked and through the dense operators, against the CPU
    twin on the sampled planes ZSAMPLED and as a perfect reconstruction
    (1e-4); one level of ``dwt2_conv`` /
    ``idwt2_conv`` against ``dwt2`` / ``idwt2``, and of
    ``parallel.halo.dwt2_y_sharded`` / ``idwt2_y_sharded`` on the mesh
    against the unsharded level (1e-5). The tolerances are the CPU tests',
    of the input's largest magnitude, save for the coarse cA of n levels:
    of 2^n times it, since each level's 2-D lowpass sums to 2. Host-clock
    seconds of each."""
    import torch

    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel import halo as th

    _, H, W = SHAPE
    wav = tw.wavelet("db3")
    x = torch.log1p(torch.from_numpy(vol[:BATCH]).to(dev).to(torch.float32))
    scale = x.abs().max().item()
    planes = list(ZSAMPLED)
    rec = {}

    def check(tag, pairs, tol):
        """Raise unless each band of ``pairs`` (name, got, want, gain) is
        within ``tol`` times the input's largest magnitude times its gain
        of ``want``; print the band with the worst share of its
        allowance."""
        worst = None
        for name, g, w, gain in pairs:
            err = (g.to(w.device) - w).abs().max().item()
            allowed = tol * scale * gain
            if worst is None or err / allowed > worst[0]:
                worst = (err / allowed, name, err, allowed)
        share, name, err, allowed = worst
        print(f"[wavelets] {tag}: max_abs_err {err:.3e} (tol {allowed:.3e}, "
              f"band {name}) {'ok' if share <= 1 else 'FAIL'}")
        rec[tag] = dict(max_abs_err=err, tol=allowed, band=name)
        if share > 1:
            raise AssertionError(f"[wavelets] {tag} {name}: {err} > "
                                 f"{allowed}")

    def timed(fn):
        _sync(mesh)
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh)
        return out, time.perf_counter() - t0

    def bands(coeffs):
        """(name, band, gain) of each band: the coarse cA's gain
        2^levels, every other band's 1."""
        n = len(coeffs) - 1
        return [(f"cA{n}", coeffs[0], 2 ** n)] + [
            (f"{k}{n - i}", band, 1) for i, det in enumerate(coeffs[1:])
            for k, band in zip(("cH", "cV", "cD"), det)]

    xc = x[planes].cpu()
    ref = bands(tw.wavedec2(xc, wav))
    forms = {"blocked": (None, None),
             "dense": (tw.analysis_operators((H, W), wav),
                       tw.synthesis_operators((H, W), wav))}
    for form, (an, syn) in forms.items():
        coeffs, t_an = timed(lambda: tw.wavedec2(x, wav, operators=an))
        y, t_syn = timed(lambda: tw.waverec2(coeffs, wav, operators=syn))
        print(f"[wavelets] {form} wavedec2 / waverec2 {tuple(x.shape)} "
              f"float32, {len(coeffs) - 1} levels: {t_an:.3f} s / "
              f"{t_syn:.3f} s (host clock, first call)")
        check(f"{form} wavedec2 vs the CPU twin on planes {ZSAMPLED}",
              [(name, c[planes], r, gain) for (name, c, gain), (_, r, _)
               in zip(bands(coeffs), ref)], FULL_TOL)
        check(f"{form} waverec2 (perfect reconstruction)",
              [("x", y[..., :H, :W], x, 1)], FULL_TOL)
        del coeffs, y
    torch.cuda.empty_cache()

    def level(got, want):  # one level's (name, got, want, gain)
        return list(zip(("cA1", "cH1", "cV1", "cD1"), got, want,
                        (2, 1, 1, 1)))

    (ca, det), t_p = timed(lambda: tw.dwt2(x, wav))
    (cac, detc), t_c = timed(lambda: tw.dwt2_conv(x, wav))
    check("dwt2_conv vs dwt2", level((cac, *detc), (ca, *det)), LEVEL_TOL)
    del cac, detc
    y, t_ps = timed(lambda: tw.idwt2(ca, det, wav))
    yc, t_cs = timed(lambda: tw.idwt2_conv(ca, det, wav))
    check("idwt2_conv vs idwt2", [("x", yc, y, 1)], LEVEL_TOL)
    del yc
    print(f"[wavelets] one level: dwt2 {t_p:.3f} s, dwt2_conv {t_c:.3f} s, "
          f"idwt2 {t_ps:.3f} s, idwt2_conv {t_cs:.3f} s (host clock, "
          f"first call)")
    (sca, sdet), t_sa = timed(lambda: th.dwt2_y_sharded(x, "db3", mesh))
    check(f"dwt2_y_sharded vs dwt2 on {len(mesh)} entries",
          level([sh.gather(dev) for sh in (sca, *sdet)], (ca, *det)),
          LEVEL_TOL)
    ys, t_ss = timed(lambda: th.idwt2_y_sharded(
        sca, sdet, "db3", mesh, out_shape=(H, W)))
    check("idwt2_y_sharded vs idwt2", [("x", ys.gather(dev),
                                        y[..., :H, :W], 1)], LEVEL_TOL)
    print(f"[wavelets] Y-sharded level on {len(mesh)} entries: "
          f"dwt2_y_sharded {t_sa:.3f} s, idwt2_y_sharded {t_ss:.3f} s "
          f"(host clock, first call)")
    del x, ca, det, sca, sdet, ys, y
    torch.cuda.empty_cache()
    return rec


def _shard_rows_max(m, n_dev):
    """(rows of the largest proportional block, fewest valid rows of a
    block) when m rows are split over n_dev entries."""
    r0 = [m * d // n_dev for d in range(n_dev + 1)]
    sizes = [r0[d + 1] - r0[d] for d in range(n_dev)]
    return max(sizes), min(sizes)


def phase_halo_kernels(hplan, dense, dev, seed, n_dev):
    """The row-sharded route's kernel calls against their twins at its
    level-0 and level-1 shard shapes (one plane): K1 and K4 from the band
    form alone (u16 with log1p at level 0, f32 at level 1; K4 with the
    flat-field epilogue at level 0, bare at level 1), the per-plane notch
    product on the cH band shard, the histogram of that shard with the
    row bound the route gives it, and the masked median of the shard;
    and the dual route's blend on the level-0 window of the second shard,
    emitting the shard's rows through the fused flat-field epilogue."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_band as cb
    from aind_smartspim_destripe_torch.ops import cuda_hist as th
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops.cuda_blend import RADIUS
    from aind_smartspim_destripe_torch.ops.cuda_build import launch
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch
    from aind_smartspim_destripe_torch.parallel.halo import _plan_x_blocks

    g = torch.Generator(device=dev).manual_seed(seed + 11)
    n = hplan.n_levels
    H, W = hplan.height, hplan.width
    (k1, k4), _ = _plan_x_blocks(hplan)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def compare(*args, **kwargs):
        _compare(*args, tag="halo-kernels", **kwargs)

    rec = {name: {} for name in HALO + ("blend_smooth_mix",)}
    for lvl in (0, 1):
        i = n - 1 - lvl
        # the level's input rows on the largest shard: H split evenly at
        # level 0, the finest cA band's proportional blocks at level 1
        rows = (-(-H // n_dev) if lvl == 0
                else _shard_rows_max(hplan.ladder[n - 1][0], n_dev)[0])
        a_lo, s_x = put(dense["an_x_lo"][lvl]), put(dense["syn_x_lo"][i])
        L, w_in = a_lo.shape
        # K1: level 0 reads the raw planes, level 1 the cA shard
        if lvl == 0:
            src = torch.randint(0, 4000, (1, rows, w_in), generator=g,
                                device=dev, dtype=torch.int32).to(
                                    torch.uint16)
        else:
            src = torch.rand((1, rows, w_in), generator=g,
                             device=dev) * 3 + 5
        st1, cf1 = put(k1[lvl]["start"]), put(k1[lvl]["coef"])
        log1p = lvl == 0
        compare(rec, "an_x_lowpass_chunked", lvl,
                lambda: cb.an_x_lowpass_chunked(src, None, st1, cf1, log1p),
                lambda: cb.an_x_lowpass_log1p_plain(src, a_lo, log1p),
                ins=(src, st1, cf1),
                ops=2.0 * cf1.shape[1] * src.shape[1] * L
                + (3.0 * src.numel() if log1p else 0.0),
                library=None if log1p else (
                    lambda: torch.matmul(src, a_lo.t())))
        # K4: the y-synthesised correction shard of this level
        st4, cf4 = put(k4[i]["start"]), put(k4[i]["coef"])
        stacked = torch.randn((1, rows, L), generator=g,
                              device=dev) * 0.01
        img = epi = None
        kw = {}
        if lvl == 0:
            img = src
            flat = 1.0 + 0.2 * torch.rand((rows, w_in), generator=g,
                                          device=dev)
            kw = dict(flat=flat, dark=torch.full_like(flat, 3.0))
            epi = tuple(kw.values())
        compare(rec, "syn_x_exp_chunked", lvl,
                lambda: cb.syn_x_exp_chunked(stacked, img, None, st4, cf4,
                                             **kw),
                lambda: cb.syn_x_exp_plain(stacked, img, s_x, **kw),
                ins=(stacked, img, st4, cf4, epi),
                ops=(2.0 * cf4.shape[1] + (8.0 if img is not None else 0.0))
                * rows * w_in,
                library=None if img is not None else (
                    lambda: torch.matmul(stacked, s_x.t())),
                witness=lambda: cb.syn_x_exp_ordered(stacked, img, st4, cf4,
                                                     **kw))
        del src, stacked, img, epi, kw, a_lo, s_x
        # the cH band shard of this level: the notch product, the histogram
        h_b, w_b = hplan.ladder[i]
        rows_b, bound = _shard_rows_max(h_b, n_dev)
        ch = torch.randn((1, rows_b, w_b), generator=g, device=dev) * 0.5
        bank = put(dense["notch_cat"][i])
        # both operator choices: the no-cells operator (sel 1) starts w_b
        # columns into the bank, misaligned for 16-byte copies; where the
        # wrapper plans 8-byte loads, also the kernel launched directly at
        # 4-byte loads (bit-equal, timed)
        v = tn.plan_notch_select(1, rows_b, w_b, ch.data_ptr(),
                                 bank.data_ptr())
        for s in (1, 0):
            key = lvl if s else f"{lvl} sel=0"
            sel = torch.full((1,), s, dtype=torch.int32, device=dev)
            op = bank[:, s * w_b:(s + 1) * w_b]
            compare(rec, "notch_select_chunked", key,
                    lambda: tn.notch_select(ch, sel, bank),
                    lambda: tn.notch_select_plain(ch, sel, bank),
                    scale=ch.abs().max().item(), ins=(ch, sel, op),
                    ops=2.0 * rows_b * w_b * w_b,
                    library=lambda: torch.matmul(ch, op))
            narrow = None
            if v != 1:
                out4 = torch.empty_like(ch)

                def four(sel=sel, out4=out4):
                    launch("destripe_notch_select", dev, ch.data_ptr(),
                           sel.data_ptr(), bank.data_ptr(), out4.data_ptr(),
                           1, rows_b, w_b, 1)
                    return out4

                if not torch.equal(four(), tn.notch_select(ch, sel, bank)):
                    raise AssertionError("notch_select's copy widths differ")
                narrow = _time_ms(four)
                del out4
                print(f"[halo-kernels] notch_select_chunked level {key}: "
                      f"{4 * v}-byte loads as planned, 4-byte loads "
                      f"{narrow:.3f} ms (bit-equal)")
            rec["notch_select_chunked"][key].update(copy_width=v,
                                                    ms_4byte_copies=narrow)
        a = ch[:, :bound].abs()
        lo = a.amin(dim=(1, 2)) ** 2
        span = a.amax(dim=(1, 2)) ** 2 - lo
        del a
        compare(rec, "histogram256_batch", lvl,
                lambda: th.histogram256_batch(ch, lo, span, square=True,
                                              row_bound=bound),
                lambda: th.histogram256_batch_plain(ch, lo, span,
                                                    square=True,
                                                    row_bound=bound),
                ins=(ch[:, :bound], lo, span), ops=5.0 * bound * w_b)
        rec["histogram256_batch"][lvl]["row_bound"] = [bound, rows_b]
        # the masked median of the whole shard (the route's call), under
        # the shard's Otsu threshold capped by the cells configuration's
        thr = torch.minimum(
            torch.full((1,), float(hplan.cells.max_threshold), device=dev),
            torch.sqrt(threshold_otsu_batch(ch[:, :bound], square=True)))
        compare(rec, "row_median_masked", lvl,
                lambda: tn.row_median_masked(ch, thr),
                lambda: tn.row_median_masked_plain(ch, thr),
                ins=(ch, thr), ops=4.0 * ch.numel())
        del ch, bank, thr
        torch.cuda.empty_cache()
    # the dual route's blend on the level-0 window of the second shard
    # (its rows and RADIUS rows of each neighbour), emitting the shard's
    # rows through the fused flat-field epilogue, as the route calls it
    q = -(-H // n_dev)
    g0, g1 = q, min(2 * q, H)
    a, b = g0 - RADIUS, min(H, g1 + RADIUS)
    gb = torch.Generator(device=dev).manual_seed(seed + 17)
    xw = torch.randint(0, 4000, (1, b - a, W), generator=gb, device=dev,
                       dtype=torch.int32).to(torch.uint16)
    bw = torch.randn((2, b - a, W), generator=gb, device=dev) * 300 + 500
    _blend_modes(rec, 0, xw, bw, threshold_otsu_batch(xw),
                 *_fields_of(seed + 19, dev, g1 - g0, W), tag="halo-kernels",
                 out_rows=(g0 - a, g1 - g0), modes=("flat",))
    del xw, bw
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return rec


def halo_capsule(work, dev, seed):
    """A synthetic capsule of one tile of HALO_SHAPE uint16 planes with
    flats and dark (:func:`halo_tile`)."""
    vol, flats, dark = halo_tile(dev, seed)
    t0 = time.perf_counter()
    data, results, tile = build_capsule(work, vol, flats, dark)
    print(f"[capsule] synthetic tile {HALO_SHAPE} uint16 written in "
          f"{time.perf_counter() - t0:.1f} s")
    return vol, flats[0], dark, data, results, tile


def halo_tile(dev, seed):
    """HALO_SHAPE uint16 planes (every other plane bright, as the cells
    branch), the two sides' flats and the dark, made from the seed."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 3)
    Z, H, W = HALO_SHAPE
    z = torch.arange(Z, device=dev)[:, None, None]
    vol = torch.where(z % 2 == 1, 3000.0, 280.0) + torch.randn(
        (Z, H, 1), generator=g, device=dev) * 50
    vol = vol + torch.randn((Z, H, W), generator=g, device=dev) * 8
    vol = vol.clamp_(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
    yy = np.linspace(-1, 1, H, dtype=np.float32)[:, None]
    xx = np.linspace(-1, 1, W, dtype=np.float32)[None, :]
    flats = [(1.0 + 0.25 * side + 0.3 * (xx * xx + yy * yy) / 2).astype(
        np.float32) for side in (0, 1)]
    dark = (3 + (np.arange(W) % 3)[None, :] * np.ones((H, 1))).astype(
        np.uint16)
    return vol, flats, dark


def phase_lowrank_kernels(hplan, dev, seed):
    """[lowrank-kernels]: the exact-rank notch tail against its plain twin
    at the HALO_SHAPE plane path's levels 0 (even width) and 1 (odd), on a
    batch of LOWRANK_SEL's planes (one cells, three no-cells) with the
    Otsu thresholds under the production caps; bound: 4 h w r operations
    a plane at its configuration's rank, at the FP32 peak."""
    import torch

    from aind_smartspim_destripe_torch.ops import cuda_notch as tn
    from aind_smartspim_destripe_torch.ops import fft_notch
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    g = torch.Generator(device=dev).manual_seed(seed + 23)
    n = hplan.n_levels
    thr_cap = (hplan.cells.max_threshold, hplan.no_cells.max_threshold)
    sel = torch.tensor(LOWRANK_SEL, dtype=torch.int32, device=dev)
    rec = {"notch_delta_lowrank": {}}
    for lvl in (0, 1):
        i = n - 1 - lvl
        if hplan.notch_routes()[i] != "lowrank":
            raise AssertionError(f"level {lvl} of {HALO_SHAPE[1:]} does not "
                                 f"take the exact-rank notch")
        (h, w), sigmas = hplan.ladder[i], hplan.notch_sigmas()[i]
        ch = torch.randn((len(LOWRANK_SEL), h, w), generator=g,
                         device=dev) * 0.5
        otsu = torch.sqrt(threshold_otsu_batch(ch, square=True))
        thr = torch.minimum(torch.where(sel == 0, thr_cap[0], thr_cap[1]),
                            otsu)
        f = fft_notch.notch_factors(w, sigmas)
        p, ds = (torch.as_tensor(a, device=dev) for a in (f.p, f.ds))
        ops = 4.0 * h * w * sum(f.ranks[s] for s in LOWRANK_SEL)
        _compare(rec, "notch_delta_lowrank", lvl,
                 lambda: tn.notch_delta_lowrank(ch, thr, sel, p, ds, f.ranks),
                 lambda: tn.notch_delta_lowrank_plain(ch, thr, sel, p, ds,
                                                      f.ranks),
                 scale=ch.abs().max().item(), ins=(ch, thr, sel, p, ds),
                 ops=ops, tag="lowrank-kernels")
        del ch, otsu, thr, p, ds
        torch.cuda.empty_cache()
    return rec


def step_check_halo(tag, plan, vol, flat, dark, dev, mesh, dual=False):
    """The row-sharded step alone on one resident plane (host clock around
    synchronised calls, peak device memory; the sha256 of its output, which
    scripts/step_hash.py computes for another commit's package), then its
    output against the single-device plane path on the card: within 1 LSB
    outside the flip budget, PSNR >= 100 dB. Returns the output, its
    sha256 and the plane path's launches in its one step
    (``[plane-<tag>]``: the notch from the factors at every level, two
    launches a level, and no dense notch)."""
    import numpy as np

    outs = [halo_step(tag, plan, vol, flat, dark, mesh, dual)[0]]
    out, launches = halo_step(tag, plan, vol, flat, dark, [dev], dual)
    outs.append(out)
    _require(f"plane-{tag}", launches, PLANE_WIDE)
    if (launches["notch_delta"]
            or launches["notch_delta_lowrank"] != 2 * plan.n_levels):
        raise AssertionError(f"plane-{tag}: the notch did not run from the "
                             f"factors at each of {plan.n_levels} levels")
    digest = hashlib.sha256(np.ascontiguousarray(outs[0]).tobytes()
                            ).hexdigest()
    print(f"[step-{tag}] sha256 of the row-sharded step's output on plane 0 "
          f"of the halo tile: {digest}")
    d = np.abs(outs[0].astype(np.int64) - outs[1].astype(np.int64))
    flips = int((d > 1).sum())
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
    print(f"[check-{tag}] row-sharded step vs the single-device plane path "
          f"on the card: max {int(d.max())} LSB, {flips} pixels > 1 LSB "
          f"({flips / d.size:.2e}, budget {FLIP_BUDGET}), PSNR {psnr:.1f} dB "
          f"(min {PSNR_MIN})")
    if flips > FLIP_BUDGET * d.size or psnr < PSNR_MIN:
        raise AssertionError(f"check-{tag}: the row-sharded step disagrees")
    return outs[0], digest, launches


def halo_step(tag, plan, vol, flat, dark, devices, dual=False):
    """Plane 0 of ``vol`` through the step made for ``devices`` (the
    row-sharded route on a mesh, timed over 3 calls; the plane path on one
    device); its output on the host, and the launches of the first call
    (counts reset just before it)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import ops
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    _, H, W = HALO_SHAPE
    step = make_device_step(plan, 2500.0, True, devices=devices, dual=dual,
                            crossover=CROSSOVER)
    if getattr(step, "shards_rows", False) != (len(devices) > 1):
        raise AssertionError(f"{tag}: the wrong route was selected")
    args = (step.put(vol[:1]), step.put_const(flat),
            step.put_const(dark.astype(np.float32)))
    ops.reset_launches()
    res = step(*args)
    _sync(devices)
    launches = _launches()
    if len(devices) > 1:
        del res
        torch.cuda.empty_cache()
        for d in dict.fromkeys(devices):
            torch.cuda.reset_peak_memory_stats(d)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            res = step(*args)
        _sync(devices)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in dict.fromkeys(devices))
        mode = "dual-band blend, " if dual else ""
        print(f"[step-{tag}] row-sharded step (1, {H}, {W}) uint16 -> "
              f"uint16 on {len(devices)} entries, {mode}flat-field "
              f"epilogue: {ms:.1f} ms per plane = {H * W / 1e3 / ms:.1f} "
              f"MPix/s; peak device memory {peak / 2**30:.2f} GiB")
    out = step.to_host(res)
    del step, args, res
    torch.cuda.empty_cache()
    return out, launches


def check_banded(plan, vol, flat, dark, mesh, ref):
    """[check-banded]: the row-sharded step with the dense-x gate forced to
    64 columns, as __graft_entry__.py runs the JAX package's (every level
    that wide takes the banded/spectral x tier: K1/K4 from the filter
    taps, the blocked lowpass passes under K1/K4's 560 columns, the rfft
    notch), against the dense tier's output ``ref`` on the same plane:
    under BANDED_FLIPS of pixels > 1 LSB and at BANDED_PSNR dB or more,
    that package's banded-vs-dense gate."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import ops
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    os.environ["DESTRIPE_BANDED_X_MIN_W"] = "64"
    try:
        t0 = time.perf_counter()
        step = make_device_step(plan, 2500.0, True, devices=mesh)
        plan_s = time.perf_counter() - t0
        args = (step.put(vol[:1]), step.put_const(flat),
                step.put_const(dark.astype(np.float32)))
        ops.reset_launches()
        res = step(*args)
        _sync(mesh)
        launches = _launches()
        out = step.to_host(res)
    finally:
        del os.environ["DESTRIPE_BANDED_X_MIN_W"]
    del step, args, res
    torch.cuda.empty_cache()
    d = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    share = float((d > 1).mean())
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
    print(f"[check-banded] row-sharded step {out.shape} with the dense-x "
          f"gate at 64 columns (planned in {plan_s:.1f} s) vs the dense "
          f"tier: max {int(d.max())} LSB, {share:.2e} of pixels > 1 LSB "
          f"(budget {BANDED_FLIPS}), PSNR {psnr:.1f} dB (min {BANDED_PSNR})")
    if not (share < BANDED_FLIPS and psnr >= BANDED_PSNR):
        raise AssertionError("[check-banded] the banded x tier disagrees")
    # every level that wide is gated, so no notch bank: no notch_select
    _require("check-banded", launches,
             tuple(k for k in HALO if k != "notch_select_chunked"))


def step_banded(mesh, dev, seed):
    """[step-banded]: one BANDED_SHAPE uint16 plane, at or above the
    default dense-x gate, through the row-sharded step on the mesh (the
    halo threshold forced down so the plane takes the row route; the wrap
    epilogue): planning and step seconds (host clock around synchronised
    calls), peak device memory; every kernel of the route launched, the
    output finite uint16 of the plane's shape, and the stripe energy (the
    variance of the row means) cut as on the plane path, the JAX package's
    beyond-gate check (tests/test_halo_sharding.py)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import ops
    from aind_smartspim_destripe_torch.parallel.halo import (
        banded_x_min_w_default,
    )
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    Z, H, W = BANDED_SHAPE
    if W < banded_x_min_w_default():
        raise AssertionError("[step-banded] the plane is under the gate")
    plan = tf_build_plan(H, W)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    vol = 280.0 + torch.randn((Z, H, 1), generator=g, device=dev) * 50
    vol = vol + torch.randn((Z, H, W), generator=g, device=dev) * 8
    vol = vol.clamp_(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
    os.environ["DESTRIPE_HALO_THRESHOLD_BYTES"] = "1024"
    try:
        t0 = time.perf_counter()
        step = make_device_step(plan, 2500.0, False, devices=mesh)
        plan_s = time.perf_counter() - t0
        if not getattr(step, "shards_rows", False):
            raise AssertionError("[step-banded] the row route was not taken")
        x = step.put(vol)
        ops.reset_launches()
        res = step(x, None, None)
        _sync(mesh)
        launches = _launches()
        del res
        torch.cuda.empty_cache()
        for d in dict.fromkeys(mesh):
            torch.cuda.reset_peak_memory_stats(d)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            res = step(x, None, None)
        _sync(mesh)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in dict.fromkeys(mesh))
        out = step.to_host(res)
    finally:
        del os.environ["DESTRIPE_HALO_THRESHOLD_BYTES"]
    del step, x, res
    torch.cuda.empty_cache()
    before = float(np.var(vol[0].astype(np.float64).mean(axis=1)))
    after = float(np.var(out[0].astype(np.float64).mean(axis=1)))
    print(f"[step-banded] row-sharded step {BANDED_SHAPE} uint16 -> uint16 "
          f"on {len(mesh)} entries, wrap epilogue, dense-x gate "
          f"{banded_x_min_w_default()}: planned in {plan_s:.1f} s, "
          f"{ms:.1f} ms per plane = {H * W / 1e3 / ms:.1f} MPix/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; stripe energy {before:.1f}"
          f" -> {after:.1f}")
    _require("step-banded", launches, HALO)
    if out.shape != vol.shape or out.dtype != np.uint16:
        raise AssertionError(f"[step-banded] output {out.shape} {out.dtype}")
    if not after < 0.65 * before:
        raise AssertionError("[step-banded] the stripes were not removed")
    return dict(ms=ms, plan_s=plan_s, peak_gib=peak / 2**30)


def synthetic_tile(dev, seed):
    """The plane paths' tile: SHAPE uint16 planes (every 4th one bright
    with cells, each with a random row profile and pixel noise), the two
    sides' flat-fields and the dark frame, made on the card from ``seed``."""
    import numpy as np
    import torch

    g = torch.Generator(device=dev).manual_seed(seed + 1)
    Z, H, W = SHAPE
    z = torch.arange(Z, device=dev)[:, None, None]
    base = torch.where(z % 4 == 1, 3000.0, 280.0)  # every 4th plane: cells
    vol = base + torch.randn((Z, H, 1), generator=g, device=dev) * 50
    vol = vol + torch.randn((Z, H, W), generator=g, device=dev) * 8
    vol = vol.clamp_(0, 65535).to(torch.int32).cpu().numpy().astype(np.uint16)
    yy = np.linspace(-1, 1, H, dtype=np.float32)[:, None]
    xx = np.linspace(-1, 1, W, dtype=np.float32)[None, :]
    flats = [(1.0 + 0.25 * side + 0.3 * (xx * xx + yy * yy) / 2).astype(
        np.float32) for side in (0, 1)]
    dark = (3 + (np.arange(W) % 3)[None, :] * np.ones((H, 1))).astype(np.uint16)
    return vol, flats, dark


def build_capsule(base: Path, vol, flat_sides, dark, tiles=None):
    """The capsule input layout of tests/test_run_capsule_e2e.py: one tile
    of ``vol`` on laser side 0, or ``tiles``, {name: (side, vol)}."""
    from aind_smartspim_destripe_torch.io import group, imsave

    tile = "471320_461360"
    tiles = tiles or {tile: (0, vol)}
    data, results = base / "data", base / "results"
    (data / "derivatives").mkdir(parents=True)
    results.mkdir()
    acq = {"tiles": [{"coordinate_transformations": [
        {"type": "scale", "scale": ["1.8", "1.8", "2.0"]}]}]}
    (data / "acquisition.json").write_text(json.dumps(acq))
    sides = {str(side): [] for side in range(len(flat_sides))}
    for name, (side, _) in tiles.items():
        sides[str(side)].append(name)
    (data / "laser_tiles.json").write_text(json.dumps(sides))
    for side, f in enumerate(flat_sides):
        imsave(str(data / f"flat_{side}.tiff"), f)
        os.replace(data / f"flat_{side}.tiff",
                   data / f"estimated_flat_laser_Ex_488_Em_525_{side}.tif")
    imsave(str(data / "derivatives" / "Dark.tiff"), dark)
    os.replace(data / "derivatives" / "Dark.tiff",
               data / "derivatives" / "DarkMaster_cropped.tif")
    for name, (_, v) in tiles.items():
        tg = group(str(data / "Ex_488_Em_525" / f"{name}.zarr"))
        lvl0 = tg.create_dataset(0, shape=(1, 1) + v.shape,
                                 chunks=(1, 1, 64, 128, 128), dtype=v.dtype)
        lvl0[:] = v[None, None]
    return data, results, tile


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from aind_smartspim_destripe_torch import run_capsule
    from aind_smartspim_destripe_torch.io import ensure_native_codec
    from aind_smartspim_destripe_torch.ops import cuda_build
    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.parallel.halo import _dense_operators

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. environment ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    tf.f32_matmul()
    print(f"[env] torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {kind} x{torch.cuda.device_count()}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(f"[env] blosc-zstd codec backend: {ensure_native_codec()}")
    # each card's context and GEMM handle, made once per process here, so
    # that the runs below time the same warm work on one card and on many
    t0 = time.perf_counter()
    for d in range(torch.cuda.device_count()):
        a = torch.ones((64, 64), device=f"cuda:{d}")
        torch.matmul(a, a)
        torch.cuda.synchronize(d)
    print(f"[env] {torch.cuda.device_count()} card(s) initialised in "
          f"{time.perf_counter() - t0:.2f} s")

    # -- 2. kernel build --------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.kernel_library()
    # registers per thread, shared memory and spilled bytes of each kernel
    # instance, as ptxas reports them
    ptxas = {}
    for part in cuda_build.kernel_library.build_log.split(
            "Compiling entry function")[1:]:
        fn = re.search(r"(k[1-4]|hist|otsu_tail|abs_range|row_median_batch|"
                       r"row_median_short|row_median_masked_warp|"
                       r"row_median|notch_delta|notch_select|"
                       r"notch_project|notch_synth|notch_fft|blend|"
                       r"dense_matmul)_kernel(I(.*?)EE)?", part)
        n = re.search(r"Used (\d+) registers", part)
        if not (fn and n):
            continue
        # template arguments: integers and bools, and the image types
        targs = [num or {"t": "u16", "f": "f32"}[ty] for num, ty in
                 re.findall(r"L[ib](\d+)E?|([tf])", fn.group(3) or "")]
        name = fn.group(1) + (f"<{','.join(targs)}>" if targs else "")
        smem = re.search(r"(\d+) bytes smem", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        ptxas[name] = dict(registers=int(n.group(1)),
                           smem=int(smem.group(1)) if smem else 0,
                           spill=int(spill.group(1)) if spill else 0)
    regs = " ".join(f"{k}={v['registers']}/{v['spill']}"
                    for k, v in ptxas.items())
    print(f"[build] {', '.join(sorted(set(SOURCE.values())))} -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{cuda_build.kernel_library.build_seconds:.2f} s; registers per "
          f"thread, spilled bytes: {regs or 'n/a'})")
    gemm = {k: v for k, v in ptxas.items()
            if k.startswith(("dense_matmul<", "notch_select<",
                             "notch_delta<", "notch_project<",
                             "notch_synth<"))}
    print("[build] shared GEMM tile (csrc/gemm_f32.cuh) instances, "
          "registers / shared memory bytes / spilled bytes: "
          + " ".join(f"{k}={v['registers']}/{v['smem']}/{v['spill']}"
                     for k, v in gemm.items()))
    # every instance the five entry points launch: dense_matmul<va, b's
    # columns unit-stride, vb>, notch_select<v>, notch_delta<v>, and the
    # exact-rank tail's notch_project<v>, notch_synth<v>
    expect = {f"dense_matmul<{va},{u},{vb}>" for va in (1, 2)
              for u, vb in ((0, 1), (1, 1), (1, 2))}
    expect |= {"notch_select<1>", "notch_select<2>"}
    expect |= {"notch_delta<1>", "notch_delta<2>"}
    expect |= {f"notch_{k}<{v}>" for k in ("project", "synth") for v in (1, 2)}
    if not cuda_build.kernel_library.build_log or expect - gemm.keys():
        raise AssertionError(
            "the build log does not report the GEMM tile instances "
            f"{sorted(expect - gemm.keys())}: their spills are unchecked")
    if any(v["spill"] for v in gemm.values()):
        raise AssertionError("a GEMM tile instance spills registers")
    # the redesigned K2, K3, K4, medians and histogram: every instance
    # reported, none spilling (K2/K3: vector width, K (0: at run time),
    # correction half; the masked median's warp route: keys per lane, one
    # output per band row; the histogram: image type, squared)
    rows = {k: v for k, v in ptxas.items()
            if k.startswith(("k2<", "k3<", "k4<", "row_median", "hist<",
                             "otsu_tail", "abs_range", "blend<",
                             "notch_fft<"))}
    print("[build] K2, K3, K4, row-median, histogram, blend and chirp-z "
          "notch instances, "
          "registers / shared memory bytes / spilled bytes: "
          + " ".join(f"{k}={v['registers']}/{v['smem']}/{v['spill']}"
                     for k, v in rows.items()))
    expect = {f"k2<{v},{k}>" for v in (1, 2, 4) for k in (0, 6)}
    expect |= {f"k3<{v},{k},{c}>" for v in (1, 2, 4) for k in (0, 3)
               for c in (0, 1)}
    expect |= {f"k4<{t},{m}>" for t in ("u16", "f32") for m in range(4)}
    expect |= {f"row_median<{b}>" for b in (0, 1)}
    expect |= {f"row_median_batch<{b}>" for b in (0, 1)}
    expect |= {"row_median_short"}
    expect |= {f"row_median_masked_warp<{k}>" for k in (1, 2, 4, 8, 16, 32)}
    expect |= {f"hist<{t},{q}>" for t in ("u16", "f32") for q in (0, 1)}
    expect |= {"otsu_tail", "abs_range"}
    expect |= {f"blend<{t},{m}>" for t in ("u16", "f32") for m in range(3)}
    expect |= {f"notch_fft<{m}>" for m in (256, 512, 1024, 2048, 4096)}
    if expect - rows.keys():
        raise AssertionError(
            "the build log does not report the instances "
            f"{sorted(expect - rows.keys())}: their spills are unchecked")
    # the chirp-z kernel at 128 registers: M = 2048 and 4096 spill 8 bytes
    # (two registers a thread; 80 registers spill ~300 bytes and ran 15%
    # slower, ~150 unspilled ran 45% slower at one block an SM)
    if any(v["spill"] > (16 if k.startswith("notch_fft<") else 0)
           for k, v in rows.items()):
        raise AssertionError("a K2, K3, K4, row-median, histogram, blend or "
                             "chirp-z notch instance spills registers")

    # -- 3. kernels vs plain twins ----------------------------------------
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = tf.build_plan(SHAPE[1], SHAPE[2],
                         tf.FilterConfig.from_dict(cfg["cells_config"]),
                         tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    consts = _twin_consts(plan, dev)
    rec = phase_kernels(plan, consts, dev, args.seed)
    torch.cuda.empty_cache()
    drec = phase_dual_kernels(plan, consts, dev, args.seed)
    frec, fdrec, fft_names = phase_fft_notch(plan, consts, dev, args.seed)
    rec.update(frec)
    drec.update(fdrec)
    per_step = {
        "histogram256_batch": {"per_step": _per_step(
            rec["histogram256_batch"], "histogram256_batch", "single-band")},
        "row_median_masked": {
            "per_step": _per_step(rec["row_median_masked"],
                                  "row_median_masked", "single-band"),
            "dual_per_step": _per_step(drec["row_median_masked"],
                                       "row_median_masked", "dual-band")},
    }
    del consts
    torch.cuda.empty_cache()
    mrec = phase_median(dev, args.seed)
    consts = tf.device_constants(plan, dev)
    mrec.update(phase_dense(plan, consts, dev, args.seed))
    del consts
    torch.cuda.empty_cache()

    # -- 4. the main paths: run_capsule.run on the card --------------------
    work = ROOT / "build" / "smoke_capsule"
    shutil.rmtree(work, ignore_errors=True)
    vol, flats, dark = synthetic_tile(dev, args.seed)
    t0 = time.perf_counter()
    data, results, tile = build_capsule(work, vol, flats, dark)
    print(f"[capsule] synthetic tile {SHAPE} uint16 written in "
          f"{time.perf_counter() - t0:.1f} s")

    launches = run_path("slice", data, results, SINGLE)
    lvl0 = check_store(results, tile)
    hashes = {"step": step_ms("step", plan, vol, flats[0], dark, dev,
                              seed=args.seed)}

    results_dual = work / "results_dual"
    results_dual.mkdir()
    os.environ["DESTRIPE_DUAL_BAND"] = "1"
    try:
        launches_dual = run_path("slice-dual", data, results_dual, PLANE)
    finally:
        del os.environ["DESTRIPE_DUAL_BAND"]
    lvl0_dual = check_store(results_dual, tile)
    hashes["step-dual"] = step_ms("step-dual", plan, vol, flats[0], dark,
                                  dev, dual=True, seed=args.seed)

    # -- 5. sampled planes, then every plane of a step, vs the CPU ---------
    check_planes("check", plan, lvl0, vol, flats[0], dark)
    check_planes("check-dual", plan, lvl0_dual, vol, flats[0], dark,
                 dual=True)
    every = check_every_plane(plan, lvl0, vol, flats[0], dark, dev)
    shutil.rmtree(work, ignore_errors=True)

    # -- the other entry points: facade, file batch, flats, multi-host ------
    paths = {"capsule": launches, "capsule_dual": launches_dual,
             "facade": phase_facade(vol, flats, dark)}
    work_entry = ROOT / "build" / "smoke_entry"
    shutil.rmtree(work_entry, ignore_errors=True)
    try:
        inp, names = batch_tree(work_entry, vol)
        paths["batch"] = phase_batch("batch", plan, inp, names, vol,
                                     work_entry / "out")
        paths["batch_dual"] = phase_batch("batch-dual", plan, inp, names, vol,
                                          work_entry / "out_dual", dual=True)
        paths["flat_estimation"] = phase_flat_estimation(work_entry, dev,
                                                         args.seed)
        torch.cuda.empty_cache()  # the processes below share the card
        phase_multihost(work_entry / "multihost", plan, vol, flats, dark)
    finally:
        shutil.rmtree(work_entry, ignore_errors=True)

    # -- 6. the multi-device routes ----------------------------------------
    n_cards = torch.cuda.device_count()
    mesh = ([torch.device("cuda", i) for i in range(n_cards)]
            if n_cards >= 2 else [dev, dev])
    print(f"[halo] mesh {[str(d) for d in mesh]} ({n_cards} card(s) "
          f"visible)")
    phase_zmesh(plan, vol, flats[0], dark, dev, mesh)
    helper_paths, helper_rec = phase_mesh_helpers(plan, vol, flats, dark,
                                                  dev, mesh)
    paths.update(helper_paths)
    paths.update(phase_execute_worker(plan, vol, flats, dark, dev))
    wavelet_rec = phase_wavelets(vol, dev, mesh)
    del vol
    hplan = tf.build_plan(HALO_SHAPE[1], HALO_SHAPE[2],
                          tf.FilterConfig.from_dict(cfg["cells_config"]),
                          tf.FilterConfig.from_dict(cfg["no_cells_config"]))
    t0 = time.perf_counter()
    hdense = _dense_operators(hplan)  # the row-sharded route's
    print(f"[halo] plan {HALO_SHAPE[1:]}: {hplan.n_levels} levels, dense "
          f"operators built on the host in {time.perf_counter() - t0:.1f} s")
    hrec = phase_halo_kernels(hplan, hdense, dev, args.seed, len(mesh))
    del hdense
    hrec.update(phase_lowrank_kernels(hplan, dev, args.seed))
    work_halo = ROOT / "build" / "smoke_capsule_halo"
    shutil.rmtree(work_halo, ignore_errors=True)
    try:
        hvol, hflat, hdark, hdata, hresults, htile = halo_capsule(
            work_halo, dev, args.seed)
        launches_halo = run_path("slice-halo", hdata, hresults, HALO,
                                 shape=HALO_SHAPE, devices=mesh)
        check_store(hresults, htile, HALO_SHAPE)
    finally:
        shutil.rmtree(work_halo, ignore_errors=True)
    dense_out, hashes["step-halo"], paths["plane_wide"] = step_check_halo(
        "halo", hplan, hvol, hflat, hdark, dev, mesh)
    _, hashes["step-dual-halo"], paths["plane_wide_dual"] = step_check_halo(
        "dual-halo", hplan, hvol, hflat, hdark, dev, mesh, dual=True)
    check_banded(hplan, hvol, hflat, hdark, mesh, dense_out)
    del dense_out, hvol
    banded = step_banded(mesh, dev, args.seed)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "shape")
    kernels = []
    paths["capsule_halo"] = launches_halo
    for name in REPLACES:
        recs = [r[name] for r in (rec, drec, hrec, mrec) if r.get(name)]
        main = recs[0]
        first = main[0] if 0 in main else next(iter(main.values()))
        # the main path's run: the single-band capsule for its kernels, the
        # dual one for the blend, the halo capsule for the row-sharded
        # route's, flat estimation (its darkfield medians) for the
        # unmasked median, which no capsule path launches
        if name == "row_median_batch":
            path = paths["flat_estimation"]
        elif name == "notch_delta_lowrank":  # the plane path at HALO_SHAPE
            path = paths["plane_wide"]
        else:
            path = (launches if name in SINGLE else launches_dual
                    if name in PLANE else launches_halo)
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": path[name],
            "launches_dual": launches_dual[name],
            "launches_halo": launches_halo[name],
            "launches_by_path": {k: v[name] for k, v in paths.items()},
            "max_abs_err": max(v["max_abs_err"] for r in recs
                               for v in r.values()),
            **{k: first[k] for k in keys if k != "max_abs_err"},
        }
        if 1 in main and name != "row_median_batch":
            entry["level1"] = {k: main[1][k] for k in keys}
        if name in DUAL:
            entry["dual"] = {k: drec[name][0][k] for k in keys}
        if name == "syn_y_pass":
            entry["dual_level1"] = {k: drec[name][1][k] for k in keys}
        if name == "notch_delta":  # its GEMM launch and the product alone
            def parts(r):
                return {k: v for k, v in r.items() if k.startswith(
                    ("gemm", "product_alone"))}
            entry.update(parts(first))
            entry["level1"].update(parts(main[1]))
            entry["dual"].update(parts(drec[name][0]))
        if name == "notch_delta_fft":  # the dense tail on the same bands
            entry["dense_ms"] = first["dense_ms"]
            entry["level2"] = {k: main[2][k] for k in keys}
            for lvl in (1, 2):
                entry[f"level{lvl}"]["dense_ms"] = main[lvl]["dense_ms"]
            entry["dual"]["dense_ms"] = drec[name][0]["dense_ms"]
            entry["kernels_of_one_call"] = fft_names
        if name in ("an_y_pass", "syn_y_pass", "syn_x_exp",
                    "syn_x_exp_chunked"):
            entry["bit_equal_witness"] = all(
                v.get("bit_equal_witness", False) for r in recs
                for v in r.values())
        if name == "row_median_batch":
            entry.update({k: main["path"][k] for k in keys
                          if k != "max_abs_err"})
            entry["shapes"] = {lvl: {k: main[lvl][k] for k in keys}
                               for lvl in ("path_contiguous", 0, 1, "1d",
                                           "4d")}
        if name == "dense_matmul":
            entry["forms"] = {k: {**{f: v[f] for f in keys},
                                  "cublas_bit_equal": v["cublas_bit_equal"],
                                  "copy_widths": v["copy_widths"],
                                  "ms_4byte_copies": v["ms_4byte_copies"]}
                              for k, v in main.items()}
        if name == "notch_select_chunked":
            extra = ("copy_width", "ms_4byte_copies")
            entry["sel0"] = {f"level{lvl}": {k: main[f"{lvl} sel=0"][k]
                                             for k in keys + extra}
                             for lvl in (0, 1)}
            entry["sel1"] = {f"level{lvl}": {k: main[lvl][k] for k in extra}
                             for lvl in (0, 1)}
        if name in ("dense_matmul", "notch_select_chunked"):
            stem = WRAPPER.get(name, name) + "<"
            entry["ptxas"] = {k: v for k, v in ptxas.items()
                              if k.startswith(stem)}
        if name == "histogram256_batch":
            entry["row_bound"] = {
                f"level{lvl}": {k: r[k] for k in keys + ("row_bound",)}
                for lvl, r in hrec[name].items()}
        if name == "row_median_masked":
            entry["halo"] = {f"level{lvl}": {k: r[k] for k in keys}
                             for lvl, r in hrec[name].items()}
        if name == "blend_smooth_mix":  # f32 error; the uint16 modes' LSB
            entry["max_abs_err"] = first["max_abs_err"]
            entry["modes"] = {m: {k: main[f"0 {m}"][k] for k in keys}
                              for m in ("flat", "wrap")}
            entry["halo_window_flat"] = {k: hrec[name][0][k] for k in keys}
            entry["div17"] = drec["div17"]
            entry["fused_bit_equal"] = all(
                r.get("bit_equal_witness", False) for r in (
                    main["0 flat"], main["0 wrap"], hrec[name][0]))
        entry.update(per_step.get(name, {}))
        kernels.append(entry)
    print(json.dumps({"steps_sha256": hashes, "check_every": every,
                      "step_banded": banded, "mesh_helpers": helper_rec,
                      "wavelets": wavelet_rec}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def run_path(tag, data, results, path_kernels, shape=SHAPE, devices=None):
    """One run_capsule.run on ``devices`` (None: every visible card),
    launch counts reset just before it and read just after; raises unless
    every kernel of the path launched."""
    import torch

    from aind_smartspim_destripe_torch import ops, run_capsule

    Z, H, W = shape
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_capsule.run(data_folder=str(data), results_folder=str(results),
                    scratch_folder=str(results.parent / "scratch"),
                    devices=devices)
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    secs = time.perf_counter() - t0
    launches = _launches()
    log = "".join(p.read_text() for p in results.glob("destripe_log_*.log"))
    piped = re.findall(r"pipeline done: .*", log)
    print(f"[{tag}] run_capsule.run: {Z * H * W / 1e6:.1f} MPix in "
          f"{secs:.2f} s = {Z * H * W / 1e6 / secs:.1f} MPix/s end to end "
          f"(pyramid and stores included); {piped[-1] if piped else ''}")
    _require(tag, launches, path_kernels)
    return launches


def _launches():
    """Each kernel's launches since the last ``ops.reset_launches()``."""
    from aind_smartspim_destripe_torch import ops

    by_wrapper = {k.__name__: k.launches for k in ops.kernels()}
    # a kernel the package does not have (an older checkout's, timed by
    # scripts/step_hash.py) counts 0
    return {name: sum(by_wrapper.get(w, 0) for w in LAUNCHED_BY.get(
        name, (WRAPPER.get(name, name),))) for name in REPLACES}


def _require(tag, launches, path_kernels):
    """Print a path's launch counts; raise unless each of its kernels
    launched."""
    print(f"[{tag}] kernel launches in the run: {launches}")
    if not all(launches[k] for k in path_kernels):
        raise AssertionError(f"[{tag}] a kernel of the path never launched: "
                             f"{launches}")


def check_store(results, tile, shape=SHAPE):
    """Levels 0-2 of the output tile, level 1 against level 0, and one
    stored chunk decoded by the store's own codec; returns level 0."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.io import open_zarr
    from aind_smartspim_destripe_torch.ops.multiscale import windowed_mean

    Z, H, W = shape
    tile_group = open_zarr(str(results / "destriped_data" / "Ex_488_Em_525"
                               / f"{tile}.zarr"))
    if set(tile_group.keys()) != {"0", "1", "2"}:
        raise AssertionError(f"pyramid levels {sorted(tile_group.keys())}")
    lvl0 = tile_group["0"]
    if tuple(lvl0.shape) != (1, 1) + shape or lvl0.dtype != np.uint16:
        raise AssertionError(f"level 0 {lvl0.shape} {lvl0.dtype}")
    head = np.asarray(lvl0[0, 0, 0:4])
    want1 = windowed_mean(torch.from_numpy(head)).numpy()
    if not np.array_equal(np.asarray(tile_group["1"][0, 0, 0:2]), want1):
        raise AssertionError("level 1 is not the windowed mean of level 0")
    if tuple(tile_group["2"].shape) != (1, 1, Z // 4, H // 4, W // 4):
        raise AssertionError(f"level 2 shape {tile_group['2'].shape}")
    print(f"[store] {results.name}: levels 0-2 present, level 1 agrees with "
          f"level 0; level-0 mean {head.mean():.1f}")
    # one stored chunk, decoded by the store's own blosc-zstd codec
    key = lvl0.separator.join("0" * len(lvl0.shape))
    frame = (Path(lvl0.path) / key).read_bytes()
    if frame[2] >> 5 & 7 != 4:
        raise AssertionError(f"chunk {key} is not a blosc-zstd frame")
    # the first chunk's region (an edge chunk is stored padded)
    region = tuple(slice(0, min(c, n)) for c, n in zip(lvl0.chunks,
                                                      lvl0.shape))
    chunk = np.frombuffer(lvl0.codec.decode(frame), np.uint16).reshape(
        lvl0.chunks)
    if not np.array_equal(chunk[region], np.asarray(lvl0[region])):
        raise AssertionError(f"chunk {key} decodes to other data")
    print(f"[store] chunk {key} {tuple(lvl0.chunks)}: blosc-zstd frame of "
          f"{len(frame)} bytes ({chunk.nbytes / len(frame):.2f}x) decodes "
          f"to the data read back")
    return lvl0


def step_ms(tag, plan, vol, flat, dark, dev, dual=False, seed=0):
    """The device step alone: one resident 64-plane uint16 batch, repeated
    (CUDA events), its peak device memory, and the sha256 of its output
    (returned), which scripts/step_hash.py computes for another commit's
    package on the same batch."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    _, H, W = SHAPE
    step = make_device_step(plan, 2500.0, True, devices=[dev], dual=dual,
                            crossover=CROSSOVER)
    imgs = step.put(vol[:BATCH])
    flat_d = step.put_const(flat)
    dark_d = step.put_const(dark.astype(np.float32))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ms = _time_ms(lambda: step(imgs, flat_d, dark_d), reps=5)
    print(f"[{tag}] device step ({BATCH}, {H}, {W}) uint16 -> uint16, "
          f"{'dual-band blend, ' if dual else ''}flat-field epilogue: "
          f"{ms:.2f} ms = {BATCH * H * W / 1e3 / ms:.1f} MPix/s; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    out = step.to_host(step(imgs, flat_d, dark_d))
    digest = hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest()
    print(f"[{tag}] sha256 of the step's output on the smoke batch (planes "
          f"0-{BATCH - 1}, seed {seed}): {digest}")
    del step, imgs
    torch.cuda.empty_cache()
    return digest


def check_planes(tag, plan, lvl0, vol, flat, dark, dual=False):
    """Four sampled planes of a run's level 0 against the port's plain path
    on the CPU: within 1 LSB outside the flip budget, PSNR >= 100 dB."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.ops.dual_band import (
        dual_band_destripe_batch,
    )
    from aind_smartspim_destripe_torch.ops.flatfield import (
        flatfield_correction,
    )

    planes = np.stack([np.asarray(lvl0[0, 0, i]) for i in SAMPLED])
    x = torch.from_numpy(vol[list(SAMPLED)])
    t0 = time.perf_counter()
    with torch.inference_mode():
        if dual:
            ref = flatfield_correction(
                dual_band_destripe_batch(plan, x, CROSSOVER, -1.0),
                torch.from_numpy(flat),
                torch.from_numpy(dark.astype(np.float32))).numpy()
        else:
            ref = tf.destripe_batch(plan, x, 2500.0, flat=flat,
                                    dark=dark.astype(np.float32)).numpy()
    d = np.abs(planes.astype(np.int64) - ref.astype(np.int64))
    flips = int((d > 1).sum())
    mse = float((d.astype(np.float64) ** 2).mean())
    psnr = 10 * np.log10(65535.0**2 / mse) if mse else float("inf")
    print(f"[{tag}] planes {SAMPLED} vs the plain path on the CPU "
          f"({time.perf_counter() - t0:.1f} s): max {int(d.max())} LSB, "
          f"{flips} pixels > 1 LSB ({flips / d.size:.2e}, budget "
          f"{FLIP_BUDGET}), PSNR {psnr:.1f} dB (min {PSNR_MIN})")
    if flips > FLIP_BUDGET * d.size:
        raise AssertionError(f"{tag}: sampled planes exceed the flip budget")
    if psnr < PSNR_MIN:
        raise AssertionError(f"{tag}: sampled planes at {psnr:.1f} dB")


def check_every_plane(plan, lvl0, vol, flat, dark, dev):
    """[check-every]: every plane of the single-band run's first 64-plane
    step against the port's plain path on the CPU, EVERY_CHUNK planes per
    CPU call (to bound host memory).

    The step takes two kinds of decision per plane: the classifier's
    choice, and at each level the Otsu threshold of the band (a bin of a
    256-bin histogram). The card and the CPU sum in other orders, so their
    bands differ in the last bits; where two bins nearly tie for Otsu's
    maximum, that moves the threshold by a bin on one side only, and the
    plane's output by up to tens of LSB (PERF.md §6: planes 7 and 25 at
    level 4, where the JAX package sides with the card on one and with the
    CPU on the other). So the check holds each part where it can hold, and
    fails (raises) on any miss:

    - the decisions, exactly: the card's classifier choice equals the
      CPU's, and each of the card's Otsu thresholds equals the CPU's Otsu
      of the card's own band, bit for bit (its histogram and tail);
    - the rest, per plane at PSNR >= PSNR_MIN: the CPU's plain path run
      with the card's thresholds against the capsule's output.

    The card's decisions come from the step run again on the card, which
    must give the capsule's output bit for bit. Per plane it prints the
    max LSB, the share of pixels > 1 LSB and the PSNR of the plain
    comparison (the CPU's own thresholds), which is not gated, with the
    levels (tails, coarsest first) where the two sides' Otsu bins differ,
    and the PSNR with the card's thresholds."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.ops import filter as tf

    t0 = time.perf_counter()
    real_otsu, real_cls = tf.threshold_otsu_batch, tf.classify_from_sums
    rec = {"otsu": [], "again": [], "cls": [], "bin": [], "out": []}

    def bare(k):
        """The call's options without the root (the card's IEEE sqrt, where
        torch's CPU sqrt may be 1 ulp off): the threshold itself."""
        return {n: v for n, v in k.items() if n != "sqrt"}

    def threshold(ch, out, a, k):
        return real_otsu(ch, *a, **bare(k)) if k.get("sqrt") else out

    def to_cpu(v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        return tuple(map(to_cpu, v)) if isinstance(v, tuple) else v

    def otsu_card(ch, *a, **k):
        out = real_otsu(ch, *a, **k)
        t = threshold(ch, out, a, k)
        rec["out"].append(out.cpu())
        rec["otsu"].append(t.cpu())
        rec["bin"].append(_otsu_bin(t, ch).cpu())
        rec["again"].append(real_otsu(
            to_cpu(ch), *a, **{n: to_cpu(v) for n, v in bare(k).items()}))
        return out

    def cls_card(*a, **k):
        out = real_cls(*a, **k)
        rec["cls"].append(out.cpu())
        return out

    tf.threshold_otsu_batch, tf.classify_from_sums = otsu_card, cls_card
    try:
        with torch.inference_mode():
            card = tf.destripe_batch(
                plan, torch.from_numpy(vol[:BATCH]).to(dev), 2500.0,
                flat=torch.from_numpy(flat).to(dev),
                dark=torch.from_numpy(dark.astype(np.float32)).to(dev),
            ).cpu().numpy()
    finally:
        tf.threshold_otsu_batch, tf.classify_from_sums = real_otsu, real_cls
    torch.cuda.empty_cache()
    got_all = np.asarray(lvl0[0, 0, :BATCH])
    if not np.array_equal(card, got_all):
        raise AssertionError("[check-every] the step on the card does not "
                             "give the capsule's output")
    thr_card = torch.stack(rec["otsu"])  # (levels, BATCH), coarsest first
    out_card = torch.stack(rec["out"])  # what the step took: their roots
    bin_card = torch.stack(rec["bin"])
    if not torch.equal(thr_card, torch.stack(rec["again"])):
        bad = (thr_card != torch.stack(rec["again"])).nonzero().tolist()
        raise AssertionError(f"[check-every] the card's Otsu thresholds "
                             f"(tail, plane) {bad} differ from the CPU's "
                             f"Otsu of the card's bands")
    cls_card = rec["cls"][0]

    rows = []
    for c0 in range(0, BATCH, EVERY_CHUNK):
        part = slice(c0, c0 + EVERY_CHUNK)
        x = torch.from_numpy(vol[part])
        mine = {"otsu": [], "cls": [], "bin": []}

        def otsu_cpu(ch, *a, **k):
            out = real_otsu(ch, *a, **k)
            mine["otsu"].append(out)
            mine["bin"].append(_otsu_bin(threshold(ch, out, a, k), ch))
            return out

        def cls_cpu(*a, **k):
            out = real_cls(*a, **k)
            mine["cls"].append(out)
            return out

        def otsu_decided(*a, **k):
            i = len(mine["otsu"])
            mine["otsu"].append(None)
            return out_card[i, part].clone()

        refs = []
        for otsu in (otsu_cpu, otsu_decided):
            mine["otsu"] = []
            tf.threshold_otsu_batch, tf.classify_from_sums = otsu, cls_cpu
            try:
                with torch.inference_mode():
                    refs.append(tf.destripe_batch(
                        plan, x, 2500.0, flat=flat,
                        dark=dark.astype(np.float32)).numpy())
            finally:
                tf.threshold_otsu_batch = real_otsu
                tf.classify_from_sums = real_cls
            if otsu is otsu_cpu:
                bin_cpu = torch.stack(mine["bin"])
        if not all(torch.equal(c, cls_card[part]) for c in mine["cls"]):
            raise AssertionError(f"[check-every] planes {c0}-"
                                 f"{c0 + EVERY_CHUNK - 1}: the classifier "
                                 f"chose otherwise on the card")
        for i, g in enumerate(got_all[part]):
            p = c0 + i
            d, dd = (np.abs(g.astype(np.int64) - r[i].astype(np.int64))
                     for r in refs)
            tails = (bin_cpu[:, i] != bin_card[:, p]).nonzero().flatten()
            rows.append((p, int(d.max()), float((d > 1).mean()), _psnr(d),
                         _psnr(dd), int(dd.max()), tails.tolist()))
    secs = time.perf_counter() - t0
    for p, lsb, share, psnr, psnr_d, lsb_d, tails in rows:
        print(f"[check-every] plane {p}: max {lsb} LSB, {share:.2e} of "
              f"pixels > 1 LSB, PSNR {psnr:.1f} dB; Otsu bins differ at "
              f"tails {tails}; with the card's thresholds: max {lsb_d} LSB, "
              f"PSNR "
              f"{psnr_d:.1f} dB")
    low = [r[0] for r in rows if r[3] < PSNR_MIN]
    worst = min(rows, key=lambda r: r[4])
    print(f"[check-every] planes 0-{BATCH - 1} in {secs:.1f} s: classifier "
          f"and every Otsu threshold ({thr_card.shape[0]} levels) "
          f"reproduced on the CPU from the card's bands, bit for bit; with "
          f"the card's thresholds the lowest PSNR {worst[4]:.1f} dB (plane "
          f"{worst[0]}, min {PSNR_MIN}); with the CPU's own, planes {low} "
          f"under {PSNR_MIN} dB (lowest "
          f"{min(r[3] for r in rows):.1f}), "
          f"{sum(r[2] > 0 for r in rows)} planes with pixels > 1 LSB, share "
          f"over all planes {np.mean([r[2] for r in rows]):.2e}")
    if worst[4] < PSNR_MIN:
        raise AssertionError(f"[check-every] plane {worst[0]} at "
                             f"{worst[4]:.1f} dB with the card's thresholds")
    return dict(seconds=secs, min_psnr_card_thresholds=worst[4],
                planes_under_floor_own_thresholds=low,
                psnr_db=[round(r[3], 2) for r in rows],
                psnr_db_card_thresholds=[round(r[4], 2) for r in rows],
                share_over_1lsb=[r[2] for r in rows],
                otsu_tails_differ={r[0]: r[6] for r in rows if r[6]})


def _otsu_bin(t, ch):
    """Per plane, the bin of 256 over [min ch^2, max ch^2] whose center is
    the Otsu threshold ``t`` of band ``ch`` (B, h, w)."""
    import torch

    a = ch.abs().to(torch.float64)
    lo = a.amin(dim=(1, 2)) ** 2
    span = a.amax(dim=(1, 2)) ** 2 - lo
    pos = (t.to(torch.float64) - lo) / torch.where(span > 0, span, 1.0)
    return (pos * 256).floor().clamp(0, 255).to(torch.int64)


def _psnr(d):
    """PSNR in dB of integer differences ``d`` over the uint16 range."""
    import numpy as np

    mse = float((d.astype(np.float64) ** 2).mean())
    return 10 * np.log10(65535.0**2 / mse) if mse else float("inf")


def _gate_print(tag, what, got, want):
    """Gate uint16 planes against a reference (``_gate``), print, raise on
    a miss."""
    lsb, flips, n, psnr, ok = _gate(got, want)
    print(f"[{tag}] {what}: max {lsb} LSB, {flips} pixels > 1 LSB "
          f"({flips / n:.2e}, budget {FLIP_BUDGET}), PSNR {psnr:.1f} dB "
          f"(min {PSNR_MIN})")
    if not ok:
        raise AssertionError(f"[{tag}] {what} outside the budget")


def phase_facade(vol, flats, dark):
    """``filtering.filter_stripes`` with the production configurations and
    prospective hemisphere flats, one call per plane on the [check] planes
    SAMPLED (plane 1 bright, the cells branch), on the card (the default
    device), against the same calls on the CPU: each plane on its own
    within the [check] budget (a call is one plane)."""
    import torch

    from aind_smartspim_destripe_torch import filtering, ops, run_capsule

    cfg = run_capsule.PRODUCTION_PARAMETERS
    sc = {"retrospective": False, "flatfield": flats, "darkfield": dark,
          "tile_config": {"471320": {"461360": 1}}}
    kw = dict(input_tile_path="471320_461360",
              no_cells_config=cfg["no_cells_config"],
              cells_config=cfg["cells_config"], shadow_correction=sc)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [filtering.filter_stripes(vol[i], **kw) for i in SAMPLED]
    secs = time.perf_counter() - t0
    launches = _launches()
    t0 = time.perf_counter()
    want = [filtering.filter_stripes(vol[i], **kw, device="cpu")
            for i in SAMPLED]
    print(f"[facade] filter_stripes on planes {SAMPLED} {vol.shape[1:]} "
          f"uint16, hemisphere flat 1: {secs / len(SAMPLED):.3f} s per plane "
          f"on the card (plan operators built on the host included), "
          f"{(time.perf_counter() - t0) / len(SAMPLED):.3f} s on the CPU")
    _require("facade", launches, SINGLE)
    for i, g, w in zip(SAMPLED, got, want):
        _gate_print("facade", f"plane {i} alone, card vs the CPU plain path",
                    g, w)
    return launches


def batch_tree(work, vol):
    """The file-batch input: BATCH_PLANES uint16 planes of ``vol`` as
    uncompressed TIFFs in two subdirectories, and a sidecar ``.txt``;
    returns the root and the planes' relative paths."""
    from aind_smartspim_destripe_torch.io import imsave

    inp = work / "batch_in"
    names = []
    for sub, count in zip(("c0/c0_r0", "c1/c1_r0"), BATCH_PLANES):
        (inp / sub).mkdir(parents=True)
        for _ in range(count):
            names.append(f"{sub}/{len(names):03d}.tiff")
            imsave(str(inp / names[-1]), vol[len(names) - 1], compression=0)
    (inp / "notes.txt").write_text("sidecar")
    return inp, names


def phase_batch(tag, plan, inp, names, vol, out, dual=False):
    """The CLI's ``batch`` mode in-process, 16-plane batches and 8 IO
    threads, on the card: every kernel of the path launched, the tree
    mirrored with its sidecar, four sampled planes against the CPU plain
    path (microscope_high_int 2700, the cast to uint16 of the written
    files) within the [check] budget."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import ops
    from aind_smartspim_destripe_torch.__main__ import main as cli
    from aind_smartspim_destripe_torch.io import imread
    from aind_smartspim_destripe_torch.ops import filter as tf
    from aind_smartspim_destripe_torch.ops.dual_band import (
        dual_band_destripe_batch,
    )

    out.mkdir()
    argv = ["batch", "--input_path", str(inp), "--output_path", str(out),
            "--chunks", "16", "--workers", "8"]
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli(argv + (["--dual_band"] if dual else []))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches()
    if rc != 0:
        raise AssertionError(f"[{tag}] the CLI returned {rc}")
    _, H, W = vol.shape
    mpix = len(names) * H * W / 1e6
    print(f"[{tag}] CLI batch: {len(names)} planes {H}x{W} uint16 "
          f"({mpix:.1f} MPix) in {secs:.2f} s = {mpix / secs:.1f} MPix/s "
          f"(plan operators, TIFF reads and deflate writes included)")
    _require(tag, launches, PLANE if dual else SINGLE)
    tree = sorted(str(p.relative_to(out)) for p in out.rglob("*")
                  if p.is_file())
    if tree != sorted(names + ["notes.txt"]):
        raise AssertionError(f"[{tag}] output tree {tree[:5]}...")
    if (out / "notes.txt").read_text() != "sidecar":
        raise AssertionError(f"[{tag}] sidecar not copied")
    got = np.stack([imread(str(out / names[i])) for i in BATCH_SAMPLED])
    x = torch.from_numpy(vol[list(BATCH_SAMPLED)])
    with torch.inference_mode():
        ref = (dual_band_destripe_batch(plan, x, CROSSOVER, -1.0) if dual
               else tf.destripe_batch(plan, x, 2700.0))
    _gate_print(tag, f"tree mirrored, sidecar copied; planes "
                f"{BATCH_SAMPLED} vs the CPU plain path", got,
                ref.numpy().astype(np.uint16))
    return launches


def phase_flat_estimation(work, dev, seed):
    """``slide_flat_estimation`` on the card over a FLAT_GRID of tiles (two
    slides) made from a known smooth flat and a dark ramp (so that the
    darkfield, which BaSiC's medians feed, is not zero), with the
    production BaSiC knobs; the unified flat against the truth
    (correlation > 0.8, the bound of tests/test_flatfield_estimation_e2e.py)
    and each slide's fit against the same fit on the CPU
    (tests/test_torch_basic.py's tolerances: flatfield mean relative 1e-2,
    darkfield mean absolute 2.5, baseline correlation 0.9999)."""
    import numpy as np
    import torch

    from aind_smartspim_destripe_torch import ops, run_capsule
    from aind_smartspim_destripe_torch.flatfield_estimation import (
        slide_flat_estimation,
        unify_fields,
    )
    from aind_smartspim_destripe_torch.io import imsave
    from aind_smartspim_destripe_torch.models import BaSiC
    from aind_smartspim_destripe_torch.utils.utils import (
        read_image_directory_structure,
    )

    _, H, W = SHAPE
    cols = [f"4713{2 * i}0" for i in range(FLAT_GRID[0])]
    rows = [f"4613{2 * j}0" for j in range(FLAT_GRID[1])]
    yy, xx = np.mgrid[0:H, 0:W]
    flat_true = 1.0 + 0.3 * np.exp(-((yy - H / 2) ** 2 + (xx - W / 2) ** 2)
                                   / (2 * (H / 3) ** 2))
    dark_true = 100.0 * (1.0 + 0.5 * xx / W)
    n = len(cols) * len(rows) * 2
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    base = torch.rand((n, 1, 1), generator=g, device=dev) * 300 + 300
    tiles = (base * torch.as_tensor(flat_true, dtype=torch.float32,
                                    device=dev)
             + torch.as_tensor(dark_true, dtype=torch.float32, device=dev)
             + torch.randn((n, H, 1), generator=g, device=dev) * 20
             + torch.randn((n, H, W), generator=g, device=dev) * 10)
    tiles = tiles.clamp_(0, 65535).to(torch.int32).cpu().numpy().astype(
        np.uint16)
    root = work / "flat"
    i = 0
    for col in cols:
        for row in rows:
            d = root / "Ex_488_Em_525" / col / f"{col}_{row}"
            d.mkdir(parents=True)
            for z in range(2):
                imsave(str(d / f"{z}.tiff"), tiles[i], compression=0)
                i += 1
    struct = read_image_directory_structure(str(root), "Ex_.*")
    channel = list(struct)[0]
    cfg = run_capsule.PRODUCTION_PARAMETERS
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = slide_flat_estimation(struct, channel, [0, 1], BASIC_KNOBS,
                                cfg["no_cells_config"], cfg["cells_config"])
    secs = time.perf_counter() - t0
    launches = _launches()
    for idx, r in res.items():
        print(f"[flat-estimation] slide {idx}: {len(r['data'])} tiles "
              f"{H}x{W} destriped in {r['seconds']['destripe']:.2f} s, "
              f"BaSiC fit (working size 128, dark, sorted, 35 reweights) "
              f"{r['seconds']['fit']:.2f} s with {r['host_syncs']} host "
              f"syncs")
    _require("flat-estimation", launches, SINGLE + ("row_median_batch",))
    flat, _, _ = unify_fields(*([r[k] for r in res.values()]
                                for k in ("flatfield", "darkfield",
                                          "baseline")))
    corr = np.corrcoef(flat.astype(np.float64).ravel(), flat_true.ravel())[0, 1]
    print(f"[flat-estimation] {secs:.2f} s for 2 slides; unified flat vs "
          f"the truth: correlation {corr:.4f} (min 0.8)")
    if not corr > 0.8:
        raise AssertionError("[flat-estimation] the flat was not recovered")
    for idx, r in res.items():
        t0 = time.perf_counter()
        cpu = BaSiC(**BASIC_KNOBS, device="cpu").fit(np.stack(r["data"]))
        rel = float(np.mean(np.abs(r["flatfield"] - cpu.flatfield)
                            / cpu.flatfield))
        dark = float(np.mean(np.abs(r["darkfield"] - cpu.darkfield)))
        bcorr = float(np.corrcoef(r["baseline"], cpu.baseline)[0, 1])
        print(f"[flat-estimation] slide {idx} card fit vs the CPU fit "
              f"({time.perf_counter() - t0:.2f} s): flatfield mean relative "
              f"{rel:.2e} (max 1e-2), darkfield mean abs {dark:.3f} (max "
              f"2.5; darkfield mean {r['darkfield'].mean():.2f}, CPU "
              f"{cpu.darkfield.mean():.2f}, truth {dark_true.mean():.2f}), "
              f"baseline correlation {bcorr:.6f} (min 0.9999)")
        if not (rel <= 1e-2 and dark <= 2.5 and bcorr > 0.9999):
            raise AssertionError("[flat-estimation] the card's fit differs")
    return launches


def phase_multihost(work, plan, vol, flats, dark):
    """Two ``python -m aind_smartspim_destripe_torch capsule`` processes
    joined over gloo on a free localhost port, both on the card, on a
    channel of MH_TILES tiles of MH_Z planes (two per laser side) with
    flats and dark: disjoint ownership covering every tile, levels 0-2 of
    each tile, one provenance write, one sampled plane per tile against the
    CPU plain path; any failed process fails the phase."""
    import socket

    import numpy as np
    import torch

    from aind_smartspim_destripe_torch.io import open_zarr
    from aind_smartspim_destripe_torch.ops import filter as tf

    tiles = {name: (i // 2, vol[i * MH_Z:(i + 1) * MH_Z])
             for i, name in enumerate(MH_TILES)}
    t0 = time.perf_counter()
    data, results, _ = build_capsule(work, None, flats, dark, tiles=tiles)
    print(f"[multihost] channel of {len(tiles)} tiles ({MH_Z}, "
          f"{vol.shape[1]}, {vol.shape[2]}) uint16 written in "
          f"{time.perf_counter() - t0:.1f} s")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for pid in (0, 1):
            env = dict(os.environ,
                       DESTRIPE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       DESTRIPE_NUM_PROCESSES="2",
                       DESTRIPE_PROCESS_ID=str(pid))
            log = open(work / f"process_{pid}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "aind_smartspim_destripe_torch",
                 "capsule", "--data", str(data), "--results", str(results),
                 "--scratch", str(work / "scratch")],
                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT),
                log))
        for p, _ in procs:
            p.wait(timeout=600)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    outs = [(work / f"process_{pid}.log").read_text() for pid in (0, 1)]
    for (p, _), out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"[multihost] a process failed "
                                 f"({p.returncode}):\n{out[-3000:]}")
    owned = [{Path(t).name for t in re.findall(
        r"Processing (\S+?\.zarr) - writing to", out)} for out in outs]
    every = {f"{t}.zarr" for t in MH_TILES}
    writes = [out.count("Provenance written:") for out in outs]
    print(f"[multihost] 2 processes (gloo, 127.0.0.1:{port}), both on "
          f"{torch.cuda.get_device_name(0)}: wall {wall:.2f} s for "
          f"{len(tiles)} tiles = "
          f"{len(tiles) * MH_Z * vol.shape[1] * vol.shape[2] / 1e6 / wall:.1f}"
          f" MPix/s (process start-up included); process 0 owns "
          f"{sorted(owned[0])}, process 1 {sorted(owned[1])}; provenance "
          f"writes {writes}")
    if owned[0] & owned[1] or owned[0] | owned[1] != every or not all(
            "Multi-host run: process" in out for out in outs):
        raise AssertionError("[multihost] tile ownership is not a partition")
    if writes != [1, 0]:
        raise AssertionError("[multihost] provenance not written once by "
                             "process 0")
    dark32 = dark.astype(np.float32)
    got, ref = [], []
    for i, (name, (side, v)) in enumerate(tiles.items()):
        check_store(results, name, v.shape)
        k = (5 * i) % MH_Z
        got.append(np.asarray(open_zarr(str(
            results / "destriped_data" / "Ex_488_Em_525"
            / f"{name}.zarr"))["0"][0, 0, k]))
        with torch.inference_mode():
            ref.append(tf.destripe_batch(
                plan, torch.from_numpy(v[k:k + 1]), 2500.0, flat=flats[side],
                dark=dark32).numpy()[0])
        lsb, flips, n, psnr, _ = _gate(got[-1], ref[-1])
        print(f"[multihost] {name} plane {k} alone: max {lsb} LSB, {flips} "
              f"pixels > 1 LSB ({flips / n:.2e}), PSNR {psnr:.1f} dB")
    _gate_print("multihost", "one plane per tile vs the CPU plain path",
                np.stack(got), np.stack(ref))
    return wall


if __name__ == "__main__":
    sys.exit(main())
