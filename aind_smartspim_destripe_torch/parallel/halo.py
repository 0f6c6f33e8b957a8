"""
Row (Y) sharding of the destripe step: the row-sharded ("Y-halo") route for
planes too large for one device.

Counterpart of ``aind_smartspim_destripe_tpu/parallel/halo.py``. The JAX
package runs ``shard_map`` over a device mesh from one process; here one
controller drives a mesh that is a plain list of devices
(:func:`.mesh.make_mesh`):

- a row-sharded array is a :class:`RowShards`: one tensor per mesh entry,
  on the entry's device, holding a contiguous block of the global rows
  (its first ``valid`` rows; rows after them pad the block and no consumer
  reads them). A replicated array is a :class:`RowShards` of one part on
  the mesh's first device;
- ``ppermute`` becomes a copy of the rows a shard's window needs from its
  neighbours to the shard's device (:func:`_rows`);
- ``psum`` / ``pmin`` / ``pmax`` become reductions of the per-shard
  partials on the mesh's first device.

A mesh entry may name a device more than once; the parts of one device are
separate tensors and never share storage.

The y passes follow the JAX package's operator-slice formulation: a banded
operator is split by output rows into one slice per entry
(:func:`_plan_op_shards`, bit-equal to the JAX planner), each slice reads a
contiguous window of input rows, and the pass is one ``torch.matmul`` per
shard (the JAX package leaves these einsums to XLA too). Coarse levels
whose window would pass a shard's rows run replicated on the first device.
The x passes and the per-level filter are row-local and run per shard
through the kernels of :mod:`..ops`: K1 and K4 (:func:`.cuda_band.
an_x_lowpass_chunked`, :func:`.cuda_band.syn_x_exp_chunked`), the Otsu
histogram with a row bound, the masked row median and the per-plane notch
product (:func:`.cuda_notch.notch_select`); bands under the kernels'
pay-off gate (:data:`_PALLAS_MIN_PX`) are filtered whole.

The same operator-slice passes, planned on the fly, give one DWT level of
row-sharded planes: :func:`banded_apply_y_sharded`, :func:`dwt2_y_sharded`
and :func:`idwt2_y_sharded`, the x passes local to each shard.

Levels whose input width reaches the dense-x gate
(:func:`banded_x_min_w_default`) carry no dense x operator, as in the JAX
package: their O(w^2) matrices are never built. Such a level runs K1/K4 per
shard where the band fits their windows (the band forms are built from the
filter taps, never from a dense operator: :func:`_k1_taps_band`,
:func:`_k4_taps_band`), the blocked lowpass passes
(:func:`..ops.wavelets.an_lo_pass_last`, :func:`..ops.wavelets.
syn_lo_pass_last`) where it does not, and its notch as the rfft map
(:func:`..ops.fft_notch.apply_notch_fft`, cuFFT on the card) for both
operator choices.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda_band, cuda_notch, fft_notch, wavelets
from ..ops.cuda_band import (
    analysis_taps,
    band_form_taps,
    check_k1_band,
    check_k4_band,
    synthesis_taps,
)
from ..ops.cuda_blend import RADIUS, blend_smooth_mix
from ..ops.cuda_hist import histogram256_batch
from ..ops.cuda_notch import row_median_masked
from ..ops.dual_band import check_crossover
from ..ops.filter import (
    DestripePlan,
    _dwt_operators,
    _filter_level_delta,
    classifier_sums,
    classify_from_sums,
    normalize_flat_dark,
)
from ..ops.fft_notch import apply_notch_fft
from ..ops.flatfield import flatfield_correction, wrap_cast
from ..ops.otsu import _u16_range, otsu_from_counts, threshold_otsu_batch
from .mesh import make_mesh

__all__ = [
    "OpShards",
    "RowShards",
    "banded_x_min_w_default",
    "halo_threshold_bytes",
    "halo_batch_bytes",
    "halo_constants",
    "halo_device_constants",
    "shard_rows",
    "banded_apply_y_sharded",
    "dwt2_y_sharded",
    "idwt2_y_sharded",
    "destripe_y_sharded",
    "dual_band_destripe_y_sharded",
]


# The JAX package's kernel pay-off gate (ops/filter.py _PALLAS_MIN_PX): the
# route runs a cH band of at least this many pixels through the sharded
# histogram, median and notch kernels, smaller ones whole.
_PALLAS_MIN_PX = 32 * 1024


def banded_x_min_w_default() -> int:
    """Plane width at which the JAX package's halo route switches its x
    operators from the dense forms to the banded/spectral ones: a memory
    gate derived from ``DESTRIPE_DENSE_X_BUDGET_BYTES`` (default 3 GiB,
    ~8 w^2 bytes of dense x operators per plane width w), or
    ``DESTRIPE_BANDED_X_MIN_W`` directly. 20067 by default."""
    env = os.environ.get("DESTRIPE_BANDED_X_MIN_W")
    if env is not None:
        return int(env)
    budget = int(
        os.environ.get("DESTRIPE_DENSE_X_BUDGET_BYTES", str(3 * 2**30))
    )
    return int(np.sqrt(budget / 8.0)) + 1


def halo_threshold_bytes() -> int:
    """f32 plane bytes above which a mesh of several entries shards rows
    instead of planes (``DESTRIPE_HALO_THRESHOLD_BYTES``, default 1 GiB)."""
    return int(os.environ.get("DESTRIPE_HALO_THRESHOLD_BYTES", str(1 << 30)))


def halo_batch_bytes() -> int:
    """Budget of one row-sharded dispatch's per-device working set
    (``DESTRIPE_HALO_BATCH_BYTES``, default 2 GiB)."""
    return int(os.environ.get("DESTRIPE_HALO_BATCH_BYTES", str(2 << 30)))


# ---------------------------------------------------------------------------
# Row-sharded arrays
# ---------------------------------------------------------------------------


class RowShards(NamedTuple):
    """A (B, R, W) (or (R, W)) array held as row blocks: ``parts[d]``
    holds global rows ``offset(d) .. offset(d) + valid[d]`` in its first
    ``valid[d]`` rows, with ``offset(d)`` the sum of the earlier
    ``valid``."""

    parts: tuple
    valid: tuple

    @property
    def rows(self) -> int:
        return sum(self.valid)

    def offsets(self):
        return np.concatenate([[0], np.cumsum(self.valid)]).astype(int)

    def gather(self, device) -> torch.Tensor:
        """The whole array as one tensor on ``device``."""
        return _rows(self, 0, self.rows, torch.device(device))


def _map(v: RowShards, fn) -> RowShards:
    """``fn(part, d)`` on every part (pad rows included): row-local work."""
    return RowShards(tuple(fn(p, d) for d, p in enumerate(v.parts)),
                     v.valid)


def _head(v: RowShards, n: int) -> RowShards:
    """The first ``n`` global rows of ``v`` (no copy)."""
    off = v.offsets()
    return RowShards(v.parts, tuple(
        int(np.clip(n - off[d], 0, k)) for d, k in enumerate(v.valid)))


def _rows(v: RowShards, a: int, b: int, device, fill=0.0) -> torch.Tensor:
    """Global rows ``[a, b)`` of ``v`` as one tensor on ``device``, rows
    past the array filled with ``fill``: the halo exchange. Rows that live
    on other parts are copied from them; a range inside one part on
    ``device`` is a view of it (made contiguous)."""
    off = v.offsets()
    pieces = []
    for d, p in enumerate(v.parts):
        lo, hi = max(a, off[d]), min(b, off[d + 1])
        if lo < hi:
            pieces.append(p[..., lo - off[d]:hi - off[d], :].to(device))
    past = b - max(a, v.rows)
    if past > 0:
        ref = v.parts[0]
        shape = list(ref.shape)
        shape[-2] = past
        pieces.append(torch.full(shape, fill, dtype=ref.dtype, device=device))
    if len(pieces) == 1:
        return pieces[0].contiguous()
    return torch.cat(pieces, dim=-2)


def shard_rows(x, mesh, value=0.0) -> RowShards:
    """Split (B, H, W) or (H, W) rows (tensor or numpy) evenly over the
    mesh: entry d holds rows ``[d q, (d + 1) q)``, q = ceil(H / D), the last
    shards padded with ``value`` up to the mesh multiple. Every part is a
    new tensor."""
    x = torch.as_tensor(x)
    H, D = x.shape[-2], len(mesh)
    q = -(-H // D)
    parts, valid = [], []
    for d, dev in enumerate(mesh):
        a, b = min(d * q, H), min((d + 1) * q, H)
        shape = list(x.shape)
        shape[-2] = q
        part = torch.empty(shape, dtype=x.dtype, device=dev)
        part[..., :b - a, :] = x[..., a:b, :]
        part[..., b - a:, :] = value
        parts.append(part)
        valid.append(b - a)
    return RowShards(tuple(parts), tuple(valid))


def _replicated(t: torch.Tensor) -> RowShards:
    return RowShards((t,), (t.shape[-2],))


# ---------------------------------------------------------------------------
# Host planning
# ---------------------------------------------------------------------------


class OpShards(NamedTuple):
    """Row-block split of one banded operator over D mesh entries."""

    slices: np.ndarray  # (D, Mq, Wc) per-entry operator slice
    c0s: np.ndarray  # (D,) first input row of each entry's window
    row_idx: np.ndarray  # (M,) global gather dropping per-block pad rows


def _plan_op_shards(OP: np.ndarray, N: int, D: int):
    """Split a banded (M, N) operator into D row blocks; returns
    (OpShards, halo K, padded N). Output rows are assigned proportionally
    (entry d gets rows [floor(d M / D), floor((d + 1) M / D))), which keeps
    each block's window aligned with the entry's own input rows. The JAX
    package's planner, line for line."""
    OP = np.asarray(OP)
    if N % D:
        N_pad = -(-N // D) * D
        OP = np.pad(OP, [(0, 0), (0, N_pad - N)])
        N = N_pad
    M = OP.shape[0]
    Nq = N // D
    r0 = [M * d // D for d in range(D + 1)]
    Mq = max(r0[d + 1] - r0[d] for d in range(D))

    starts, widths = [], []
    for d in range(D):
        rows = OP[r0[d] : r0[d + 1]]
        nz = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        if len(nz):
            starts.append(int(nz[0]))
            widths.append(int(nz[-1]) + 1 - int(nz[0]))
        else:
            starts.append(min(d * Nq, N - 1))
            widths.append(1)
    Wc = min(max(widths), N)
    slices = np.zeros((D, Mq, Wc), OP.dtype)
    c0s = np.zeros((D,), np.int32)
    row_idx = np.concatenate(
        [np.arange(r0[d], r0[d + 1]) - r0[d] + d * Mq for d in range(D)]
    ).astype(np.int32)
    K = 0
    for d in range(D):
        c0 = max(0, min(starts[d], N - Wc))
        c0s[d] = c0
        rows = OP[r0[d] : r0[d + 1], c0 : c0 + Wc]
        slices[d, : rows.shape[0]] = rows
        K = max(K, d * Nq - c0, (c0 + Wc) - (d + 1) * Nq, 0)
    return OpShards(slices, c0s, row_idx), K, N


def _window_starts(n_blocks: int, stride: int, pad: int, smax: int):
    """The JAX kernels' closed-form window starts ``clip(stride i - pad, 0,
    smax)``."""
    return tuple(min(max(stride * i - pad, 0), smax) for i in range(n_blocks))


def _windows_cover(start: np.ndarray, coef: np.ndarray, r_out: int,
                   w_win: int, starts) -> bool:
    """Does every block of ``r_out`` output rows of the band form (start,
    coef) keep its nonzero columns inside its window ``[starts[i],
    starts[i] + w_win)``? (The JAX package's ``blocked_operator`` raises
    otherwise, and the level then keeps its dense x pass.)"""
    nz = coef != 0
    has = nz.any(axis=1)
    K = coef.shape[1]
    first = np.where(has, start + nz.argmax(axis=1), np.iinfo(np.int64).max)
    last = np.where(has, start + K - 1 - nz[:, ::-1].argmax(axis=1), -1)
    for i, s in enumerate(starts):
        a, b = i * r_out, min((i + 1) * r_out, coef.shape[0])
        if a >= b or not has[a:b].any():
            continue
        if first[a:b].min() < s or last[a:b].max() >= s + w_win:
            return False
    return True


def _k1_taps_band(w: int, wavelet_name: str):
    """K1's band form of the lowpass analysis operator of width w
    (``analysis_operator(w)[:L]``), from the filter taps
    (:func:`..ops.cuda_band.analysis_taps`)."""
    cols, lo, _ = analysis_taps(w, wavelet_name)
    start, (coef,) = band_form_taps(cols, w, lo)
    check_k1_band(start, coef.shape[1])
    return start, coef


def _k4_taps_band(L_x: int, tw: int, wavelet_name: str):
    """K4's band form of the trimmed lowpass synthesis operator
    (``synthesis_operator(L_x)[:tw, :L_x]``), from the filter taps
    (:func:`..ops.cuda_band.synthesis_taps`)."""
    cols, lo, _ = synthesis_taps(L_x, tw, wavelet_name)
    start, (coef,) = band_form_taps(cols, L_x, lo)
    check_k4_band(start, coef.shape[1])
    return start, coef


def _plan_x_blocks(plan: DestripePlan):
    """The level set of the per-shard K1/K4 tier, as in the JAX package:
    K1 by analysis level (finest first), K4 by synthesis index (coarsest
    first), for levels at least 560 wide whose band fits the TPU kernels'
    closed-form windows. Each holds the band form that K1/K4 read instead
    of the JAX package's bf16 blocked operators, built from the filter
    taps (O(w) host memory at any width, the dense-x gate's included).
    Returns ``((k1, k4), (k1_static, k4_static))``."""
    rup = lambda a, b: -(-a // b) * b  # noqa: E731
    cdiv = lambda a, b: -(-a // b)  # noqa: E731
    n = plan.n_levels
    k1, k1_static, k4, k4_static = {}, {}, {}, {}
    w_cur = plan.width
    for lvl in range(n):
        L_w = plan.ladder[-1 - lvl][1]
        smax = rup(w_cur, 128) - 384
        if smax >= 0 and w_cur >= 560:
            start, coef = _k1_taps_band(w_cur, plan.wavelet)
            starts = _window_starts(cdiv(L_w, 128), 256, 128, smax)
            if _windows_cover(start, coef, 128, 384, starts):
                k1[lvl] = {"start": start, "coef": coef}
                k1_static[lvl] = {"out_w": L_w}
        w_cur = L_w
    for i in range(n):
        L_x = plan.ladder[i][1]
        tw = plan.ladder[i + 1][1] if i + 1 < n else plan.width
        smax = rup(L_x, 128) - 384
        if smax >= 0 and tw >= 560:
            start, coef = _k4_taps_band(L_x, tw, plan.wavelet)
            starts = _window_starts(cdiv(tw, 256), 128, 128, smax)
            if _windows_cover(start, coef, 256, 384, starts):
                k4[i] = {"start": start, "coef": coef}
                k4_static[i] = {"out_w": tw}
    return (k1, k4), (k1_static, k4_static)


def _dense_operators(plan: DestripePlan) -> dict:
    """The dense operators the route reads, as numpy arrays: ``an_y`` and
    ``an_x_lo`` finest first, ``syn_y``, ``syn_x_lo`` and ``notch_cat``
    (the dense bank, :func:`..ops.fft_notch.notch_cat`) coarsest first, the
    layout of :func:`..ops.filter.device_constants`. The y operators are
    built at every level; a level whose input width reaches the dense-x
    gate (:func:`banded_x_min_w_default`) gets None for its three x-axis
    operators, which are O(w^2) and never built: the route applies the
    blocked lowpass passes and the rfft notch there instead (the JAX
    package's gate, line for line)."""
    n, gate = plan.n_levels, banded_x_min_w_default()
    gated = {lvl for lvl, (_, w) in enumerate(plan.level_inputs())
             if w >= gate}
    return dict(_dwt_operators(plan, no_x=gated), notch_cat=tuple(
        None if n - 1 - i in gated else fft_notch.notch_cat(w, sigmas)
        for i, ((_, w), sigmas) in enumerate(
            zip(plan.ladder, plan.notch_sigmas()))))


def halo_constants(plan: DestripePlan, n_devices: int,
                   notch_blocks: bool = True):
    """Host planning of the row-sharded route for one geometry and mesh
    size, as the JAX package plans it. Returns ``(arrays, static)``:

    - per analysis level ``lvl`` (string key in ``arrays``), the
      :class:`OpShards` of its four y operators ``an_lo``, ``an_hi``,
      ``syn_lo``, ``syn_hi``; ``static[lvl]`` their halo rows and padded
      input rows, or None from the first level whose halo passes a
      shard's rows (it and every coarser level run replicated);
    - ``"xk1"`` / ``"xk4"``: the K1/K4 band forms of the per-shard x tier
      (:func:`_plan_x_blocks`);
    - ``"notch"``: the per-plane notch banks (:func:`.cuda_notch.
      stacked_notch_operators`, coarsest-first index) of the levels whose
      band passes the kernels' pay-off gate; the dual-band route passes
      ``notch_blocks=False`` and multiplies its static halves with the
      dense ``notch_cat`` instead.

    Levels at or above the dense-x gate get no notch bank (it costs the
    O(w^2) bytes the gate bounds; their notch runs spectrally)."""
    return _plan_route(plan, n_devices, notch_blocks, _dense_operators(plan))


def _plan_route(plan: DestripePlan, n_devices: int, notch_blocks: bool,
                dense: dict):
    """:func:`halo_constants` from the plan's :func:`_dense_operators`."""
    D = int(n_devices)
    arrays: dict = {}
    static: dict = {}
    for lvl in range(plan.n_levels):
        an_y = np.asarray(dense["an_y"][lvl])
        syn_y = np.asarray(dense["syn_y"][plan.n_levels - 1 - lvl])
        L_h = an_y.shape[0] // 2
        N_in = an_y.shape[1]
        half = syn_y.shape[1] // 2
        ops = {
            "an_lo": (an_y[:L_h], N_in),
            "an_hi": (an_y[L_h:], N_in),
            "syn_lo": (syn_y[:, :half], half),
            "syn_hi": (syn_y[:, half:], half),
        }
        lvl_arrays, lvl_static, feasible = {}, {}, True
        for name, (OP, N) in ops.items():
            shards, K, N_pad = _plan_op_shards(OP, N, D)
            if K > N_pad // D:
                feasible = False
                break
            lvl_arrays[name] = shards
            lvl_static[name] = {"halo": max(K, 1), "n_pad": N_pad}
        if not feasible:
            static[lvl] = None
            break
        arrays[str(lvl)] = lvl_arrays
        static[lvl] = lvl_static
    (a1, a4), (s1, s4) = _plan_x_blocks(plan)
    if a1:
        arrays["xk1"] = {str(k): v for k, v in a1.items()}
        static["xk1"] = s1
    if a4:
        arrays["xk4"] = {str(k): v for k, v in a4.items()}
        static["xk4"] = s4
    # a width-gated level has no notch matrix to stack (notch_cat None)
    skip = [not (notch_blocks and lh * lw >= _PALLAS_MIN_PX) or cat is None
            for (lh, lw), cat in zip(plan.ladder, dense["notch_cat"])]
    if not all(skip):
        nb_arrays, nb_static = {}, {}
        for i, pair in enumerate(plan.notch_matrices(skip=skip)):
            if pair is not None:
                nb_arrays[str(i)] = cuda_notch.stacked_notch_operators(*pair)
                nb_static[i] = {"w": plan.ladder[i][1]}
        arrays["notch"] = nb_arrays
        static["notch"] = nb_static
    return arrays, static


class HaloConstants(NamedTuple):
    """The route's constants on the mesh (:func:`halo_device_constants`)."""

    static: dict  # halo_constants' static record
    y: dict  # lvl -> op name -> (slices per entry, c0s, valid rows, Wc)
    xk1: dict  # lvl -> device -> (start, coef)
    xk4: dict  # synthesis index -> device -> (start, coef)
    notch: dict  # coarsest-first index -> device -> (w, 2w) bank
    dense: dict  # device -> the dense operators the route still reads


def halo_device_constants(plan: DestripePlan, mesh,
                          notch_blocks: bool = True) -> HaloConstants:
    """:func:`halo_constants` moved to the mesh: each entry's y operator
    slices on its device; the K1/K4 band forms, the notch banks and the
    dense operators the route still reads (of :func:`_dense_operators`)
    once per distinct device. Dense
    operators that the route replaces are dropped before they reach a
    device: ``notch_cat`` where a bank serves, the y operators of sharded
    levels, and on a CUDA device the x operators of K1/K4 levels (the
    kernels read the band forms; the plain twins on a CPU device read the
    dense x operators, or those the band forms encode). Levels at or above
    the dense-x gate have no dense x operators at all."""
    mesh = tuple(make_mesh(mesh))
    devices = tuple(dict.fromkeys(mesh))
    dense = _dense_operators(plan)
    arrays, static = _plan_route(plan, len(mesh), notch_blocks, dense)
    n = plan.n_levels

    sharded = [lvl for lvl in range(n) if static.get(lvl) is not None]
    dropped = {
        "notch_cat": set(static.get("notch", {})),
        "an_y": set(sharded),
        "syn_y": {n - 1 - lvl for lvl in sharded},
    }
    on_card = dict(dropped, an_x_lo=set(static.get("xk1", {})),
                   syn_x_lo=set(static.get("xk4", {})))

    def put(a, dev):
        a = np.ascontiguousarray(a)
        dtype = torch.int32 if a.dtype.kind in "iu" else torch.float32
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def dense_on(dev):
        drop = on_card if dev.type == "cuda" else dropped
        return {k: tuple(None if a is None or i in drop.get(k, ())
                         else put(a, dev) for i, a in enumerate(v))
                for k, v in dense.items()}

    def per_device(group, fn):
        return {int(k): {dev: fn(v, dev) for dev in devices}
                for k, v in arrays.get(group, {}).items()}

    def band(v, dev):
        return put(v["start"], dev), put(v["coef"], dev)

    y = {}
    for lvl in sharded:
        y[lvl] = {}
        for name, sh in arrays[str(lvl)].items():
            D = len(mesh)
            M = len(sh.row_idx)
            valid = [M * (d + 1) // D - M * d // D for d in range(D)]
            y[lvl][name] = (
                [put(sh.slices[d], dev) for d, dev in enumerate(mesh)],
                [int(c) for c in sh.c0s], valid, sh.slices.shape[-1])
    return HaloConstants(
        static=static, y=y,
        xk1=per_device("xk1", band), xk4=per_device("xk4", band),
        notch=per_device("notch", put),
        dense={dev: dense_on(dev) for dev in devices},
    )


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def _apply_ops(x: RowShards, ops) -> list:
    """``OP @ x`` along the rows for each planned operator of ``ops`` (they
    read the same input rows): one window per shard serves all of them,
    then one ``torch.matmul`` per operator slice. Returns one
    :class:`RowShards` per operator, entry d holding its proportional row
    block."""
    slices0, _, _, _ = ops[0]
    outs = [[] for _ in ops]
    for d, op0 in enumerate(slices0):
        a = min(o[1][d] for o in ops)
        b = max(o[1][d] + o[3] for o in ops)
        win = _rows(x, a, b, op0.device)
        for k, (slices, c0s, _, wc) in enumerate(ops):
            s = c0s[d] - a
            outs[k].append(torch.matmul(slices[d], win[..., s:s + wc, :]))
    return [RowShards(tuple(o), tuple(op[2])) for o, op in zip(outs, ops)]


def _dense_y(v: RowShards, op: torch.Tensor) -> RowShards:
    """A replicated level's y pass: the band gathered to the first
    device and multiplied whole."""
    return _replicated(torch.matmul(op, v.gather(op.device)))


# ---------------------------------------------------------------------------
# One DWT level on row shards (planned on the fly)
# ---------------------------------------------------------------------------


def _sharded(x, mesh) -> RowShards:
    return x if isinstance(x, RowShards) else shard_rows(x, mesh)


def _planned_op(OP: np.ndarray, N: int, mesh) -> tuple:
    """One banded (M, N) operator planned over the mesh
    (:func:`_plan_op_shards`) and moved to its entries, in
    :func:`_apply_ops`' form; raises ``ValueError`` when the halo passes a
    shard's rows (too many entries for N rows)."""
    D = len(mesh)
    shards, K, N_pad = _plan_op_shards(OP, N, D)
    if K > N_pad // D:
        raise ValueError(f"halo {K} exceeds shard height {N_pad // D}: too "
                         f"many devices for {N} rows")
    M = len(shards.row_idx)
    return ([torch.as_tensor(shards.slices[d], device=dev)
             for d, dev in enumerate(mesh)],
            [int(c) for c in shards.c0s],
            [M * (d + 1) // D - M * d // D for d in range(D)],
            shards.slices.shape[-1])


def banded_apply_y_sharded(x, OP: np.ndarray, mesh) -> RowShards:
    """``OP @ x`` along the rows of a (B, N, W) tensor (split by
    :func:`shard_rows`) or of a :class:`RowShards`, the operator's shards
    planned on the fly. Returns a :class:`RowShards` (``.gather(device)``
    for one tensor). Raises ``ValueError`` when the mesh has too many
    entries for the rows."""
    mesh = make_mesh(mesh)
    x = _sharded(x, mesh)
    return _apply_ops(x, [_planned_op(OP, x.rows, mesh)])[0]


def _x_analysis(v: RowShards, wav) -> tuple:
    """The row-local x analysis pass of every part (the blocked
    :func:`..ops.wavelets._an_pass_last`, O(flen) operator bytes) ->
    ``(lo, hi)`` as :class:`RowShards`."""
    pairs = [wavelets._an_pass_last(p, wav) for p in v.parts]
    return tuple(RowShards(tuple(pr[i] for pr in pairs), v.valid)
                 for i in (0, 1))


def dwt2_y_sharded(x, wavelet_name: str, mesh):
    """One 2-D analysis level of (B, H, W) planes with the rows sharded
    over the mesh: the y pass per shard through its halo window, then the
    x pass locally. Returns ``(cA, (cH, cV, cD))`` as :class:`RowShards`
    whose gathered values match :func:`..ops.wavelets.dwt2`."""
    wavelets.f32_matmul()
    mesh = make_mesh(mesh)
    x = _sharded(x, mesh)
    A_y = wavelets.analysis_operator(x.rows, wavelet_name)
    L_y = A_y.shape[0] // 2
    lo_y, hi_y = _apply_ops(x, [_planned_op(A_y[:L_y], x.rows, mesh),
                                _planned_op(A_y[L_y:], x.rows, mesh)])
    wav = wavelets.wavelet(wavelet_name)
    ca, cv = _x_analysis(lo_y, wav)
    ch, cd = _x_analysis(hi_y, wav)
    return ca, (ch, cv, cd)


def idwt2_y_sharded(ca, details, wavelet_name: str, mesh,
                    out_shape: Optional[tuple] = None) -> RowShards:
    """Inverse of :func:`dwt2_y_sharded` (one level): the x synthesis
    locally per shard (the blocked
    :func:`..ops.wavelets._syn_pass_last`), then the y synthesis as two
    banded passes (the lowpass and highpass halves of the synthesis
    operator) through their halo windows; ``out_shape`` crops as the
    trimmed synthesis operators do. Takes :class:`RowShards` or (B, h, w)
    tensors; returns a :class:`RowShards`."""
    wavelets.f32_matmul()
    mesh = make_mesh(mesh)
    ca, ch, cv, cd = (_sharded(c, mesh) for c in (ca, *details))
    wav = wavelets.wavelet(wavelet_name)
    L_y = ca.rows
    S_y = wavelets.synthesis_operator(L_y, wavelet_name)
    w_out = None
    if out_shape is not None:
        S_y, w_out = S_y[: out_shape[0]], out_shape[1]

    def rows(lo, hi):  # the x synthesis of [lo | hi]
        return RowShards(tuple(
            wavelets._syn_pass_last(a, b, wav)[..., :w_out]
            for a, b in zip(lo.parts, hi.parts)), lo.valid)

    lo_y = banded_apply_y_sharded(rows(ca, cv), S_y[:, :L_y], mesh)
    hi_y = banded_apply_y_sharded(rows(ch, cd), S_y[:, L_y:], mesh)
    return RowShards(tuple(a + b for a, b in zip(lo_y.parts, hi_y.parts)),
                     lo_y.valid)


def _otsu_sharded(v: RowShards, dev0, square: bool = True) -> torch.Tensor:
    """Per-plane Otsu thresholds of a row-sharded band (of ``v**2``, squared
    in the kernel, with ``square``): shard-local extrema reduced on
    ``dev0`` (the min of the minima is the global min), shard-local
    histograms of each shard's valid rows (the row bound excludes the rows
    that pad a shard), their integer counts added and converted to f32
    once, then the threshold tail. Equal to the unsharded Otsu."""
    los, his, kept = [], [], []
    for p, n in zip(v.parts, v.valid):
        if n == 0:
            continue
        q = p[:, :n]
        if q.dtype == torch.uint16:
            lo_p, hi_p = _u16_range(q, (1, 2))
        else:
            a = q.abs() if square else q
            lo_p, hi_p = a.amin(dim=(1, 2)), a.amax(dim=(1, 2))
        los.append(lo_p.to(dev0))
        his.append(hi_p.to(dev0))
        kept.append((p, n))
    lo = torch.stack(los).amin(dim=0)
    hi = torch.stack(his).amax(dim=0)
    if square:
        lo, hi = lo * lo, hi * hi
    span = hi - lo
    safe = torch.where(span > 0, span, torch.ones_like(span))
    counts = sum(
        histogram256_batch(p, lo.to(p.device), safe.to(p.device),
                           square=square, row_bound=n).to(dev0, torch.int64)
        for p, n in kept)
    return otsu_from_counts(counts.to(torch.float32), lo, hi)


def _const_rows(c) -> Optional[RowShards]:
    if c is None or isinstance(c, RowShards):
        return c
    return _replicated(c)


def destripe_y_sharded(
    x,  # (B, H, W) uint16/float32 tensor or array, or its RowShards
    mesh,
    plan: DestripePlan,
    consts: Optional[HaloConstants] = None,
    *,
    microscope_high_int: float = 2700.0,
    flat=None,
    dark=None,
    wrap: bool = False,
    dual: bool = False,
) -> RowShards:
    """The destripe step with the row axis sharded over ``mesh``
    (reference filtering.py:139-224): per-plane float16-sigmoid classifier,
    multi-level analysis (y passes by operator slices over each shard's
    window, x passes per shard), per-plane Otsu, masked-median inpainting
    and the notch of every cH band, delta synthesis, and the flat-field or
    wrap epilogue. Returns the output rows, float32 or (with an epilogue)
    uint16, as :class:`RowShards` (``.gather(device)`` for one tensor).

    ``consts``: :func:`halo_device_constants` of the plan on this mesh
    (built when None). ``flat``/``dark``: (H, W) fields (tensors, arrays or
    :class:`RowShards`). ``dual=True`` skips the classifier and returns the
    (2B, H, W) float32 band pair (``[:B]`` cells = foreground, ``[B:]``
    no-cells = background) for :func:`dual_band_destripe_y_sharded`."""
    mesh = tuple(make_mesh(mesh))
    dev0 = mesh[0]
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    if dual and (flat is not None or dark is not None or wrap):
        raise ValueError(
            "dual mode returns both float32 bands; blend them before "
            "applying a flat-field or wrap epilogue"
        )
    if not isinstance(x, RowShards):
        x = torch.as_tensor(x)
        if x.shape[-2:] != (plan.height, plan.width):
            raise ValueError(f"plan geometry {(plan.height, plan.width)} != "
                             f"data {tuple(x.shape[-2:])}")
        if x.dtype not in (torch.uint16, torch.float32):
            x = x.to(torch.float32)
        x = shard_rows(x, mesh)
    elif x.rows != plan.height or x.parts[0].shape[-1] != plan.width:
        raise ValueError(f"plan geometry {(plan.height, plan.width)} != "
                         f"data {(x.rows, x.parts[0].shape[-1])}")
    if consts is None:
        consts = halo_device_constants(plan, mesh, notch_blocks=not dual)
    if not isinstance(flat, RowShards) and (flat is not None
                                            or dark is not None):
        flat, dark = normalize_flat_dark(plan.height, plan.width, flat,
                                         dark, dev0)
    flat, dark = _const_rows(flat), _const_rows(dark)

    n = plan.n_levels
    H = plan.height
    B0 = x.parts[0].shape[0]
    dense = consts.dense
    if n == 0:  # tiny plane: wavedec2 returns it untouched
        xf = x.gather(dev0).to(torch.float32)
        out0 = torch.exp(torch.log(1.0 + xf)) + 1.0
        out0 = torch.cat([out0, out0]) if dual else out0
        return _replicated(_epilogue(out0, flat, dark, wrap, dev0))

    k1s, k4s = consts.static.get("xk1", {}), consts.static.get("xk4", {})
    fin = n - 1
    # level-0 K1 reads the raw planes (log1p fused) and the finest K4 fuses
    # exp and the epilogue, so log(1 + x) is never stored
    fuse_io = 0 in k1s and fin in k4s
    if dual:
        is_cells = torch.arange(2 * B0, device=dev0) < B0
    else:
        sums = [torch.stack(classifier_sums(p[:, :k])).to(dev0)
                for p, k in zip(x.parts, x.valid) if k]
        is_cells = classify_from_sums(
            *sum(sums).to(torch.float32), microscope_high_int)

    def y_pass(v, lvl, *names):
        if lvl in consts.y:
            return _apply_ops(v, [consts.y[lvl][nm] for nm in names])
        an_y = dense[dev0]["an_y"][lvl]
        syn_y = dense[dev0]["syn_y"][n - 1 - lvl]
        L_h, half = an_y.shape[0] // 2, syn_y.shape[1] // 2
        op = {"an_lo": an_y[:L_h], "an_hi": an_y[L_h:],
              "syn_lo": syn_y[:, :half], "syn_hi": syn_y[:, half:]}
        return [_dense_y(v, op[nm]) for nm in names]

    wav = wavelets.wavelet(plan.wavelet)

    # analysis, finest -> coarsest: the x lowpass (per shard) first; a
    # level at the dense-x gate without K1 takes the blocked pass
    a = x if fuse_io else _map(
        x, lambda p, d: torch.log(1.0 + p.to(torch.float32)))
    chs = []
    for lvl in range(n):
        if lvl in k1s:
            bands = consts.xk1[lvl]
            lox = _map(a, lambda p, d: cuda_band.an_x_lowpass_chunked(
                p, dense[p.device]["an_x_lo"][lvl], *bands[p.device],
                log1p=fuse_io and lvl == 0))
        elif dense[dev0]["an_x_lo"][lvl] is None:
            lox = _map(a, lambda p, d: wavelets.an_lo_pass_last(p, wav))
        else:
            lox = _map(a, lambda p, d: torch.matmul(
                p, dense[p.device]["an_x_lo"][lvl].t()))
        a, hi_b = y_pass(lox, lvl, "an_lo", "an_hi")
        chs.append(hi_b)
    del a, lox

    # filter every cH band, coarsest first
    deltas = []
    thr_cap = (plan.cells.max_threshold, plan.no_cells.max_threshold)
    n_out = 2 * B0 if dual else B0
    sel = torch.where(is_cells, 0, 1).to(torch.int32)
    sigmas = plan.notch_sigmas()
    for j in range(n):
        ch = chs[n - 1 - j]
        chs[n - 1 - j] = None
        h_b, w_b = plan.ladder[j]
        # a level at the dense-x gate has no notch matrix: both notches as
        # the rfft map, each plane taking its own
        spectral = None
        if dense[dev0]["notch_cat"][j] is None and j not in consts.notch:
            spectral = functools.partial(_notch_both_fft, sigmas=sigmas[j])
        if h_b * w_b < _PALLAS_MIN_PX:
            # small band: filtered whole on the first device, as the plane
            # path filters it (notch_delta)
            chg = ch.gather(dev0)
            otsu_sqrt = None
            if dual:
                otsu_sqrt = threshold_otsu_batch(chg, square=True,
                                                 sqrt=True, repeat=2)
            deltas.append(_replicated(_filter_level_delta(
                chg, is_cells, dense[dev0]["notch_cat"][j], *thr_cap,
                otsu_sqrt=otsu_sqrt, notch_apply=spectral, level=n - 1 - j)))
            continue
        otsu = torch.sqrt(_otsu_sharded(ch, dev0, square=True))
        max_thr = torch.where(is_cells, float(thr_cap[0]), float(thr_cap[1]))
        thr = torch.minimum(max_thr, otsu.repeat(n_out // B0))
        bank = consts.notch.get(j)
        if bank is None:
            bank = {dev: dense[dev]["notch_cat"][j] for dev in dense}

        def tail(p, d, thr=thr, bank=bank, spectral=spectral):
            t = thr.to(p.device)
            med = row_median_masked(p, t)
            c = p.repeat(n_out // B0, 1, 1) if dual else p
            stripes = torch.sqrt(c * c) > t[:, None, None]
            inpainted = torch.where(stripes, med, c)
            s = sel.to(p.device)
            if spectral is None:
                filtered = cuda_notch.notch_select(inpainted, s,
                                                   bank[p.device])
            else:
                both = spectral(inpainted)
                w = c.shape[-1]
                filtered = torch.where((s == 0)[:, None, None],
                                       both[..., :w], both[..., w:])
            return torch.where(stripes, 0.0, filtered - c)

        deltas.append(_map(ch, tail))
    del chs

    # delta synthesis, coarsest -> finest
    corr = None
    for i, delta in enumerate(deltas):
        deltas[i] = None
        lvl = n - 1 - i
        L_h = plan.ladder[i][0]
        (stacked,) = y_pass(delta, lvl, "syn_hi")
        if corr is not None:
            (lo,) = y_pass(_head(corr, L_h), lvl, "syn_lo")
            stacked = RowShards(tuple(s + t for s, t in zip(stacked.parts,
                                                            lo.parts)),
                                stacked.valid)
        if i in k4s:
            bands = consts.xk4[i]
            ops = {dev: (dense[dev]["syn_x_lo"][i], *bands[dev])
                   for dev in bands}
            if i == fin and fuse_io:
                return _k4_final(stacked, x, ops, flat, dark, wrap)
            corr = _map(stacked, lambda p, d: cuda_band.syn_x_exp_chunked(
                p, None, *ops[p.device]))
        elif dense[dev0]["syn_x_lo"][i] is None:
            tw = plan.ladder[i + 1][1] if i + 1 < n else plan.width
            corr = _map(stacked, lambda p, d: wavelets.syn_lo_pass_last(
                p, wav, tw))
        else:
            corr = _map(stacked, lambda p, d: torch.matmul(
                p, dense[p.device]["syn_x_lo"][i].t()))

    # finest level without the fused ingest (planes under K1's width)
    xl = torch.log(1.0 + x.gather(dev0).to(torch.float32))
    if dual:
        xl = torch.cat([xl, xl])
    out0 = torch.exp(xl + corr.gather(dev0)) + 1.0
    return _replicated(_epilogue(out0, flat, dark, wrap, dev0))


def _notch_both_fft(rows, sigmas):
    """Both notches of a width-gated level, (kB, h, w) -> (kB, h, 2w):
    [cells | no-cells], the column layout of ``notch_cat``'s product."""
    return torch.cat([apply_notch_fft(rows, s) for s in sigmas], dim=-1)


def _epilogue(y, flat, dark, wrap, dev):
    if flat is not None:
        return flatfield_correction(y, flat.gather(dev), dark.gather(dev))
    return wrap_cast(y) if wrap else y


def _k4_final(stacked, x, ops, flat, dark, wrap) -> RowShards:
    """The finest K4 per shard with exp and the epilogue fused: each shard
    reads the raw planes (and the fields) of its own rows; the rows that
    pad a shard read the next shard's or a fill, and are never read back.
    ``ops``: device -> (dense operator or None, band start, band coef)."""
    off = stacked.offsets()
    parts = []
    for d, p in enumerate(stacked.parts):
        dev = p.device
        a, b = int(off[d]), int(off[d]) + p.shape[-2]
        img = _rows(x, a, b, dev)
        kw = dict(wrap=wrap)
        if flat is not None:
            kw = dict(flat=_rows(flat, a, b, dev, fill=1.0),
                      dark=_rows(dark, a, b, dev, fill=0.0))
        parts.append(cuda_band.syn_x_exp_chunked(p, img, *ops[dev], **kw))
    return RowShards(tuple(parts), stacked.valid)


def dual_band_destripe_y_sharded(
    x,
    mesh,
    plan: DestripePlan,
    consts: Optional[HaloConstants] = None,
    *,
    crossover: float = 100.0,
    threshold: float = -1.0,
    smooth_radius: int = RADIUS,
    flat=None,
    dark=None,
    wrap: bool = False,
) -> RowShards:
    """The dual-band destripe on the row-sharded layout: both bands from
    one row-sharded decomposition (:func:`destripe_y_sharded` with
    ``dual=True``), the sigmoid centres from the sharded Otsu of the raw
    planes (or the fixed ``threshold`` when >= 0), then the blend per shard
    on a window widened by ``smooth_radius`` rows from each neighbour and
    cropped back to the shard's rows, so the box smooth sees the same rows
    as on the whole plane and clamps only at its true top and bottom.
    The blend emits only the shard's rows of the window, through the
    flat-field or wrap epilogue (fused into its store) when asked."""
    check_crossover(crossover)
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    mesh = tuple(make_mesh(mesh))
    dev0 = mesh[0]
    if not isinstance(x, RowShards):
        x = torch.as_tensor(x)
        if x.dtype not in (torch.uint16, torch.float32):
            x = x.to(torch.float32)
        x = shard_rows(x, mesh)
    if not isinstance(flat, RowShards) and (flat is not None
                                            or dark is not None):
        flat, dark = normalize_flat_dark(plan.height, plan.width, flat,
                                         dark, dev0)
    flat, dark = _const_rows(flat), _const_rows(dark)
    if consts is None:
        consts = halo_device_constants(plan, mesh, notch_blocks=False)
    both = destripe_y_sharded(x, mesh, plan, consts, dual=True)
    B = x.parts[0].shape[0]
    H = plan.height
    if threshold >= 0:
        centers = torch.full((B,), float(threshold), dtype=torch.float32,
                             device=dev0)
    elif H * plan.width >= _PALLAS_MIN_PX:
        centers = _otsu_sharded(x, dev0, square=False)
    else:
        centers = threshold_otsu_batch(x.gather(dev0))
    q = -(-H // len(mesh))
    parts, valid = [], []
    for d, dev in enumerate(mesh):
        g0, g1 = min(d * q, H), min((d + 1) * q, H)
        a, b = max(0, g0 - smooth_radius), min(H, g1 + smooth_radius)
        epi = dict(wrap=wrap)
        if flat is not None:
            epi = dict(flat=_rows(flat, g0, g1, dev),
                       dark=_rows(dark, g0, g1, dev))
        if g1 > g0:
            out = blend_smooth_mix(_rows(x, a, b, dev), _rows(both, a, b, dev),
                                   None, centers.to(dev), crossover,
                                   smooth_radius, out_rows=(g0 - a, g1 - g0),
                                   **epi)
        else:
            out = torch.empty((B, 0, plan.width), device=dev, dtype=(
                torch.uint16 if flat is not None or wrap else torch.float32))
        parts.append(out)
        valid.append(g1 - g0)
    return RowShards(tuple(parts), tuple(valid))
