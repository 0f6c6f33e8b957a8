"""
The banded DWT passes of the destripe step: K1-K4 wrappers, their plain
PyTorch twins, and the host builder of the band forms the kernels read
(from the wavelet's taps).

Counterpart of ``aind_smartspim_destripe_tpu/ops/pallas_band.py``. Each
wrapper dispatches on the device of its input: a CPU tensor takes the plain
twin (the dense-operator ``torch.matmul`` form with the same prologue and
epilogue, also callable directly as ``<wrapper>_plain`` on any device), a
CUDA tensor launches the Hopper kernel of ``csrc/band.cu`` (built and
launched by :mod:`.cuda_build`) or raises. There is no fallback between the
two. Each wrapper counts its kernel launches in ``<wrapper>.launches``.

- :func:`an_x_lowpass_log1p` (K1): ``log(1 + x) @ A_x_lo^T`` along rows,
  raw uint16 or f32 in, with the classifier's partial sums;
- :func:`an_y_pass` (K2): the lowpass and highpass y analysis, with the
  per-plane range of ``|cH|``;
- :func:`syn_y_pass` (K3): ``S_y[:, :L] @ corr + S_y[:, L:] @ delta``;
- :func:`syn_x_exp` (K4): ``stacked @ S_x_lo^T``, optionally fused with
  ``exp(log(1 + x) + corr) + 1`` and the flat-field or wrap epilogue; with
  fewer image planes than corrections (dual band: 2B corrections, B planes)
  correction ``b`` reads image plane ``b mod B``;
- :func:`an_x_lowpass_chunked` and :func:`syn_x_exp_chunked`: K1 without
  its classifier sums and K4, on the row shards of the row-sharded route.
  They take the band form alone: that route never puts the dense x
  operator of a K1/K4 level on the card (the CPU twin rebuilds it).

K1-K4 take the level's dense operator beside its band form. The kernels
read the band form only, and the plane step's constants on a card
(:func:`band_level_forms_taps`, built from the wavelet's taps) hold no
dense operator for a banded level: the argument is then None. The plain
twins, which run off the card, read the dense operator, which a plan's
constants off the card always hold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import wavelets
from .cuda_build import check, launch, on_cuda, sm_count
from .flatfield import flatfield_correction, wrap_cast

__all__ = [
    "band_form_taps",
    "analysis_taps",
    "synthesis_taps",
    "check_k1_band",
    "check_k2_band",
    "check_k3_band",
    "check_k4_band",
    "k4_geometry",
    "band_dense",
    "band_level_forms_taps",
    "an_x_lowpass_log1p",
    "an_y_pass",
    "syn_y_pass",
    "syn_x_exp",
    "an_x_lowpass_chunked",
    "syn_x_exp_chunked",
    "an_x_lowpass_log1p_plain",
    "an_y_pass_plain",
    "an_y_pass_ordered",
    "syn_y_pass_plain",
    "syn_y_pass_ordered",
    "syn_x_exp_plain",
    "syn_x_exp_ordered",
    "KERNELS",
]

# Launch geometry of csrc/band.cu: K1 runs blocks of 1024 outputs of a row
# (float32 input's classifier partials per 256 of them); a K1 segment
# stages at most 2112 inputs, so its band form's starts step by 0-2 per
# output and K is at most 63 (check_k1_band). K4's persistent blocks walk
# items of 2 rows by a segment of at most 1024 outputs (k4_geometry), whose
# ring rows hold at most 1088 inputs, so its starts step by 0-1 and K is at
# most 62 (check_k4_band). K2 and K3 run blocks of 256 columns by a run of
# 8 (K2) or 16 (K3) output rows, staging the span of input rows the run
# reads: K2's starts step by 0-2 per output, K3's by 0-1 and at most 8
# times in a run, and K is at most 64 (check_k2_band, check_k3_band); K2
# writes one |cH| range partial per block.
_K1_GROUP = 256
_K1_SEG, _K1_CAP = 1024, 2 * 1024 + 64
_K4_SEG, _K4_CAP = 1024, 1024 + 64
_K4_OUTS, _K4_ROWS = 4, 2  # outputs a thread, rows an item
_K4_BLOCKS_PER_SM, _K4_MAX_STAGES = 3, 4
_SMEM_PER_SM = 232448  # the shared memory an H100 SM gives its blocks
_BAND_COLS, _K2_ROWS, _K3_ROWS, _BAND_MAX_K = 256, 8, 16, 64
_GRID_MAX = 65535  # grid.y and grid.z


# ---------------------------------------------------------------------------
# Host: band forms from the wavelet's taps
# ---------------------------------------------------------------------------


def band_dense(start: np.ndarray, coef: np.ndarray, n: int) -> np.ndarray:
    """The dense (m, n) operator a band form ``(start, coef)`` encodes."""
    m, K = coef.shape
    dense = np.zeros((m, n), coef.dtype)
    cols = start[:, None].astype(np.int64) + np.arange(K)[None, :]
    np.put_along_axis(dense, cols, coef, axis=1)
    return dense


def band_form_taps(cols: np.ndarray, n: int, *vals: np.ndarray):
    """Compact band form of the (m, n) operators whose row i is the sum of
    its taps ``v[i, t]`` (float64) at columns ``cols[i, t]``, rounded to
    float32, for each ``v`` of ``vals`` (the operators share their taps'
    columns), without building them: O(m t) memory where a dense operator
    is O(m n). Returns ``start`` (m,) int32 and one ``coef`` (m, K)
    float32 per operator, with ``A[i, start[i] + k] = coef[i, k]`` and
    every other entry zero (:func:`band_dense` rebuilds it; taps at one
    column add in the order given). K is the widest row support; starts
    clamp to ``n - K`` so every window stays in bounds."""
    cols = np.asarray(cols, np.int64)
    m, t = cols.shape
    lo = cols.min(axis=1)
    width = int((cols.max(axis=1) - lo).max()) + 1
    at = (np.repeat(np.arange(m), t), (cols - lo[:, None]).ravel())
    wins = []
    for v in vals:
        win = np.zeros((m, width))
        np.add.at(win, at, np.asarray(v, np.float64).ravel())
        wins.append(win.astype(np.float32))
    nz = np.logical_or.reduce([w != 0 for w in wins])
    has = nz.any(axis=1)
    first = np.where(has, lo + nz.argmax(axis=1), 0)
    last = np.where(has, lo + width - 1 - nz[:, ::-1].argmax(axis=1), 0)
    K = int((last - first + 1)[has].max()) if has.any() else 1
    start = np.minimum(first, n - K)
    idx = start[:, None] + np.arange(K)[None, :] - lo[:, None]
    inside = (idx >= 0) & (idx < width)
    idx = np.clip(idx, 0, width - 1)
    coefs = tuple(np.ascontiguousarray(np.where(
        inside, np.take_along_axis(w, idx, axis=1), 0).astype(np.float32))
        for w in wins)
    return start.astype(np.int32), coefs


def analysis_taps(n: int, wavelet_name: str):
    """The taps of ``wavelets.analysis_operator(n)``: ``(cols, lo, hi)``,
    each (L, flen). Output k of the lowpass (highpass) half sums ``lo[k,
    i]`` (``hi[k, i]``) at column ``cols[k, i]``, the symmetric fold of 2k
    + 1 + i - (flen - 1), in order of i, as the dense builder adds them."""
    wav = wavelets.wavelet(wavelet_name)
    flen = wav.flen
    L = wavelets.dwt_coeff_len(n, flen)
    k = np.arange(L)[:, None]
    cols = wavelets._fold_symmetric(2 * k + 1 + np.arange(flen)[None, :]
                                    - (flen - 1), n)
    return (cols, np.broadcast_to(wav.dec_lo[::-1], (L, flen)),
            np.broadcast_to(wav.dec_hi[::-1], (L, flen)))


def synthesis_taps(coeff_len: int, out_len: int, wavelet_name: str):
    """The taps of ``wavelets.synthesis_operator(coeff_len)[:out_len]``'s
    lowpass and highpass halves: ``(cols, lo, hi)``, each (out_len, flen //
    2 + 1). Output m takes ``rec_lo[j]`` (``rec_hi[j]``) of coefficient k
    for j = m + flen - 2 - 2k in [0, flen); the taps that reach no
    coefficient are zeros."""
    wav = wavelets.wavelet(wavelet_name)
    flen = wav.flen
    m = np.arange(out_len)[:, None]
    cols = (m + flen - 2) // 2 - np.arange(flen // 2 + 1)[None, :]
    j = m + flen - 2 - 2 * cols
    valid = (j >= 0) & (j < flen) & (cols >= 0) & (cols < coeff_len)
    j = np.clip(j, 0, flen - 1)
    return (np.clip(cols, 0, coeff_len - 1),
            np.where(valid, wav.rec_lo_arr[j], 0.0),
            np.where(valid, wav.rec_hi[j], 0.0))


def check_k1_band(start: np.ndarray, K: int) -> None:
    """Raise ValueError unless K1 can take this band form: starts that step
    by 0, 1 or 2 per output (the analysis band's), so a segment of its
    outputs reads a run of inputs that fits the kernel's shared memory."""
    step = np.diff(np.asarray(start, np.int64))
    if (step.size and (step.min() < 0 or step.max() > 2)) or (
            2 * (_K1_SEG - 1) + K + 3 > _K1_CAP):
        raise ValueError("K1 takes band forms whose starts step by 0-2 per "
                         f"output, K <= {_K1_CAP - 2 * _K1_SEG - 1}")


def check_k4_band(start: np.ndarray, K: int) -> None:
    """Raise ValueError unless K4 can take this band form: starts that step
    by 0 or 1 per output (the synthesis band's), so a segment of its
    outputs reads a run of inputs that fits the kernel's shared memory."""
    step = np.diff(np.asarray(start, np.int64))
    if (step.size and (step.min() < 0 or step.max() > 1)) or (
            (_K4_SEG - 1) + K + 3 > _K4_CAP):
        raise ValueError("K4 takes band forms whose starts step by 0-1 per "
                         f"output, K <= {_K4_CAP - _K4_SEG - 2}")


def check_k2_band(start: np.ndarray, K: int, stride: int = 2) -> None:
    """Raise ValueError unless K2 can take this band form: starts that
    step by 0 to ``stride`` per output (the analysis band's: ``stride``
    where the window moves, less where it is clamped at an edge, 1 at the
    end of an odd height), a stride of at most 2 and 1 <= K <= 64, so a
    run of its outputs reads a span of input rows that fits the kernel's
    shared memory."""
    step = np.diff(np.asarray(start, np.int64))
    if (step.size and (step.min() < 0 or step.max() > stride)) or not (
            0 < stride <= 2 and 1 <= K <= _BAND_MAX_K):
        raise ValueError("K2 takes band forms whose starts step by 0 to a "
                         f"stride of at most 2 per output, 1 <= K <= "
                         f"{_BAND_MAX_K}")


def check_k3_band(start: np.ndarray, K: int) -> None:
    """Raise ValueError unless K3 can take this band form: starts that
    step by 0 or 1 per output (the synthesis band's: two outputs per input
    row), at most 8 times in each run of 16 outputs (runs from output 0),
    and 1 <= K <= 64, so a run reads a span of input rows that fits the
    kernel's shared memory."""
    start = np.asarray(start, np.int64)
    step = np.diff(start)
    runs = np.arange(0, start.size, _K3_ROWS)
    ends = np.minimum(runs + _K3_ROWS, start.size) - 1
    if (step.size and (step.min() < 0 or step.max() > 1)) or (
            (start[ends] - start[runs]).max(initial=0) > _K3_ROWS // 2) or (
            not 1 <= K <= _BAND_MAX_K):
        raise ValueError("K3 takes band forms whose starts step by 0 or 1 "
                         f"per output, at most {_K3_ROWS // 2} times in a "
                         f"run of {_K3_ROWS}, 1 <= K <= {_BAND_MAX_K}")


def band_level_forms_taps(h: int, w: int, wavelet_name: str) -> dict:
    """Band forms of the four operators of the banded level whose input is
    (h, w), from the wavelet's taps (:func:`analysis_taps`,
    :func:`synthesis_taps`) in O((h + w) flen), without building the dense
    operators (O(h^2 + w^2): 2 GB each in float64 at 16384): ``an_x_lo``
    (L_w, w) for K1, ``an_y`` (2 L_h, h) for K2 (lowpass and highpass
    halves share their starts), ``syn_y`` (h, 2 L_h) for K3 (the
    cA-correction and cH-delta halves share theirs) and ``syn_x_lo`` (w,
    L_w) for K4."""
    flen = wavelets.wavelet(wavelet_name).flen
    L_h = wavelets.dwt_coeff_len(h, flen)
    L_w = wavelets.dwt_coeff_len(w, flen)
    an_x, an_y = analysis_taps(w, wavelet_name), analysis_taps(h, wavelet_name)
    syn_y = synthesis_taps(L_h, h, wavelet_name)
    syn_x = synthesis_taps(L_w, w, wavelet_name)
    return _level_forms(band_form_taps(an_x[0], w, an_x[1]),
                        band_form_taps(an_y[0], h, *an_y[1:]),
                        band_form_taps(syn_y[0], L_h, *syn_y[1:]),
                        band_form_taps(syn_x[0], L_w, syn_x[1]))


def _level_forms(k1, k2, k3, k4) -> dict:
    """The band-form dict of a level from each kernel's ``(start,
    coefs)``, checked against what each kernel can take."""
    (k1_start, (k1_coef,)), (k2_start, (k2_lo, k2_hi)) = k1, k2
    (k3_start, (k3_lo, k3_hi)), (k4_start, (k4_coef,)) = k3, k4
    check_k1_band(k1_start, k1_coef.shape[1])
    check_k2_band(k2_start, k2_lo.shape[1])
    check_k3_band(k3_start, k3_lo.shape[1])
    check_k4_band(k4_start, k4_coef.shape[1])
    return {
        "k1_start": k1_start, "k1_coef": k1_coef,
        "k2_start": k2_start, "k2_lo": k2_lo, "k2_hi": k2_hi,
        "k3_start": k3_start, "k3_lo": k3_lo, "k3_hi": k3_hi,
        "k4_start": k4_start, "k4_coef": k4_coef,
    }


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# K1: analysis x-pass, lowpass half, log(1 + x) fused
# ---------------------------------------------------------------------------


def an_x_lowpass_log1p_plain(x, a_lo, log1p=True, cls_cut=None):
    """Plain twin of :func:`an_x_lowpass_log1p`, on any device."""
    xf = x.to(torch.float32)
    out = torch.matmul(torch.log(1.0 + xf) if log1p else xf, a_lo.t())
    if cls_cut is None:
        return out
    m = xf >= cls_cut
    xd = xf.to(torch.float64)
    dims = (1, 2)
    sums = torch.stack([
        m.sum(dims, dtype=torch.float64),
        (~m).sum(dims, dtype=torch.float64),
        torch.where(m, xd, 0.0).sum(dims),
        torch.where(m, 0.0, xd).sum(dims),
    ], dim=1)
    return out, sums.to(torch.float32)


def an_x_lowpass_log1p(
    x: torch.Tensor,  # (B, H, W) uint16 or float32
    a_lo: Optional[torch.Tensor],  # (L, W) dense lowpass; None on a card
    start: torch.Tensor,  # (L,) int32 band form of a_lo
    coef: torch.Tensor,  # (L, K) float32
    log1p: bool = True,
    cls_cut: Optional[float] = None,
):
    """``f(x) @ a_lo^T`` with ``f = log(1 + x)`` (or the identity when
    ``log1p=False``): (B, H, L) float32. With ``cls_cut`` also returns the
    classifier's per-plane sums (B, 4) float32 ``[fg_cnt, bg_cnt, fg_sum,
    bg_sum]`` of the raw values against ``x >= cls_cut``, summed in float64
    (exact for uint16 input) and rounded once. The kernel reads the band
    form only: ``a_lo`` is None on a card (the plane step's constants of
    a banded level), and read by the plain twin off it."""
    if not on_cuda(x):
        return an_x_lowpass_log1p_plain(x, a_lo, log1p, cls_cut)
    out, sums = _k1(x, start, coef, log1p, cls_cut)
    an_x_lowpass_log1p.launches += 1
    return out if sums is None else (out, sums)


def _k1(x, start, coef, log1p, cls_cut):
    """Launch K1 over the full width: (out, the (B, 4) float32 classifier
    sums or None). The kernel adds uint16 input's sums in int64 (exact);
    float32 input's come as float64 partials per 256 outputs of a row,
    summed here."""
    B, H, W = x.shape
    L, K = coef.shape
    dev = x.device
    check("x", x, (torch.uint16, torch.float32), dev)
    check("start", start, (torch.int32,), dev, (L,))
    check("coef", coef, (torch.float32,), dev)
    if H > _GRID_MAX or B > _GRID_MAX:
        raise ValueError(f"{B} planes of {H} rows exceed K1's grid")
    out = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    u16 = x.dtype == torch.uint16
    sums = partials = None
    if cls_cut is not None and u16:
        sums = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    elif cls_cut is not None:
        partials = torch.empty((B, H * _cdiv(L, _K1_GROUP), 4),
                               dtype=torch.float64, device=dev)
    launch(
        "destripe_k1", dev, x.data_ptr(), int(u16), out.data_ptr(),
        _ptr(sums), _ptr(partials), start.data_ptr(), coef.data_ptr(),
        K, B, H, W, L, int(log1p), float(cls_cut or 0.0),
    )
    if cls_cut is None:
        return out, None
    return out, (sums if u16 else partials.sum(dim=1)).to(torch.float32)


# ---------------------------------------------------------------------------
# K2: analysis y-pass, lowpass and highpass together
# ---------------------------------------------------------------------------


def an_y_pass_plain(x, a_y):
    """Plain twin of :func:`an_y_pass`, on any device."""
    L = a_y.shape[0] // 2
    lox = torch.matmul(a_y, x)
    lo, hi = lox[:, :L], lox[:, L:]
    a = hi.abs()
    return lo, hi, (a.amin(dim=(1, 2)), a.amax(dim=(1, 2)))


def an_y_pass_ordered(x, start, coef_lo, coef_hi):
    """K2 term by term, on any device, from the band form: each output's
    K taps summed in k order from 0, one multiply-add (``torch.addcmul``)
    per term, lowpass and highpass alike, and the per-plane range of
    ``|cH|``. The kernel sums each output with the same operations in the
    same order, so on the card it is bit-equal to this."""
    idx = start.to(torch.int64)
    shape = (x.shape[0], coef_lo.shape[0], x.shape[2])
    lo = torch.zeros(shape, dtype=torch.float32, device=x.device)
    hi = torch.zeros_like(lo)
    for k in range(coef_lo.shape[1]):
        rows = x[:, idx + k, :]
        lo = torch.addcmul(lo, coef_lo[:, k, None], rows)
        hi = torch.addcmul(hi, coef_hi[:, k, None], rows)
    a = hi.abs()
    return lo, hi, (a.amin(dim=(1, 2)), a.amax(dim=(1, 2)))


def an_y_pass(
    x: torch.Tensor,  # (B, H, Wc) float32 — the x-pass output
    a_y: Optional[torch.Tensor],  # (2L, H) dense [lo; hi]; None on a card
    start: torch.Tensor,  # (L,) int32
    coef_lo: torch.Tensor,  # (L, K) float32
    coef_hi: torch.Tensor,  # (L, K) float32
):
    """Returns ``(lo, hi, (min|hi|, max|hi|))``: the cA and cH bands, each
    (B, L, Wc) float32, and the per-plane extremes of ``|cH|`` ((B,) each),
    which give the Otsu bin range without a second read of the band. The
    kernel reads the band form only: ``a_y`` is None on a card, and read
    by the plain twin off it."""
    if not on_cuda(x):
        return an_y_pass_plain(x, a_y)

    B, H, Wc = x.shape
    L, K = coef_lo.shape
    dev = x.device
    check("x", x, (torch.float32,), dev)
    check("start", start, (torch.int32,), dev, (L,))
    check("coef_lo", coef_lo, (torch.float32,), dev)
    check("coef_hi", coef_hi, (torch.float32,), dev, (L, K))
    _check_band_launch("K2", B, Wc, K)
    lo = torch.empty((B, L, Wc), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    # one |cH| range partial per block: runs of rows by strips of columns
    mm = torch.empty((B, _cdiv(L, _K2_ROWS) * _cdiv(Wc, _BAND_COLS), 2),
                     dtype=torch.float32, device=dev)
    launch(
        "destripe_k2", dev, x.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        mm.data_ptr(), start.data_ptr(), coef_lo.data_ptr(),
        coef_hi.data_ptr(), K, B, H, Wc, L,
    )
    an_y_pass.launches += 1
    return lo, hi, (mm[..., 0].amin(dim=1), mm[..., 1].amax(dim=1))


def _check_band_launch(name, B, Wc, K):
    """Raise ValueError for a K2/K3 call the kernel's grid or shared memory
    cannot take."""
    if B > _GRID_MAX or _cdiv(Wc, _BAND_COLS) > _GRID_MAX:
        raise ValueError(f"{B} planes of {Wc} columns exceed {name}'s grid")
    if not 1 <= K <= _BAND_MAX_K:
        raise ValueError(f"{name} takes 1 <= K <= {_BAND_MAX_K}, not {K}")


# ---------------------------------------------------------------------------
# K3: y synthesis of the correction
# ---------------------------------------------------------------------------


def syn_y_pass_plain(corr, delta, s_y):
    """Plain twin of :func:`syn_y_pass`, on any device."""
    L = s_y.shape[1] // 2
    if corr is None:
        return torch.matmul(s_y[:, L:], delta)
    return torch.matmul(s_y, torch.cat([corr, delta], dim=1))


def syn_y_pass_ordered(corr, delta, start, coef_lo, coef_hi):
    """K3 term by term, on any device, from the band form: one accumulator
    from 0, one multiply-add (``torch.addcmul``) per term, the cH-delta
    half in k order and then (unless ``corr`` is None) the cA-correction
    half in k order. The kernel sums each output with the same operations
    in the same order, so on the card it is bit-equal to this."""
    idx = start.to(torch.int64)
    acc = torch.zeros((delta.shape[0], coef_hi.shape[0], delta.shape[2]),
                      dtype=torch.float32, device=delta.device)
    halves = [(coef_hi, delta)] + ([] if corr is None else [(coef_lo, corr)])
    for coef, src in halves:
        for k in range(coef.shape[1]):
            acc = torch.addcmul(acc, coef[:, k, None], src[:, idx + k, :])
    return acc


def syn_y_pass(
    corr: Optional[torch.Tensor],  # (B, L, Wc) float32, or None
    delta: torch.Tensor,  # (B, L, Wc) float32
    s_y: Optional[torch.Tensor],  # (Ho, 2L) dense, trimmed; None on a card
    start: torch.Tensor,  # (Ho,) int32
    coef_lo: torch.Tensor,  # (Ho, K) float32 — the cA-correction half
    coef_hi: torch.Tensor,  # (Ho, K) float32 — the cH-delta half
) -> torch.Tensor:
    """``S_y[:, :L] @ corr + S_y[:, L:] @ delta`` -> (B, Ho, Wc) float32;
    ``corr=None`` drops the cA half (the correction starts at zero). The
    kernel reads the band form only: ``s_y`` is None on a card, and read
    by the plain twin off it."""
    if not on_cuda(delta):
        return syn_y_pass_plain(corr, delta, s_y)

    B, L, Wc = delta.shape
    Ho, K = coef_hi.shape
    dev = delta.device
    check("delta", delta, (torch.float32,), dev)
    if corr is not None:
        check("corr", corr, (torch.float32,), dev, (B, L, Wc))
    check("start", start, (torch.int32,), dev, (Ho,))
    check("coef_lo", coef_lo, (torch.float32,), dev, (Ho, K))
    check("coef_hi", coef_hi, (torch.float32,), dev)
    _check_band_launch("K3", B, Wc, K)
    out = torch.empty((B, Ho, Wc), dtype=torch.float32, device=dev)
    launch(
        "destripe_k3", dev, _ptr(corr), delta.data_ptr(), out.data_ptr(),
        start.data_ptr(), coef_lo.data_ptr(), coef_hi.data_ptr(),
        K, B, L, Wc, Ho,
    )
    syn_y_pass.launches += 1
    return out


# ---------------------------------------------------------------------------
# K4: x synthesis, optionally fused with exp and the uint16 epilogue
# ---------------------------------------------------------------------------

_BARE, _EXP, _FLAT, _WRAP = 0, 1, 2, 3


def _image_planes(stacked, images) -> int:
    """The image batch, which the correction batch must be a multiple of."""
    bi = stacked.shape[0] if images is None else images.shape[0]
    if bi == 0 or stacked.shape[0] % bi:
        raise ValueError(f"correction batch {stacked.shape[0]} not a "
                         f"multiple of image batch {bi}")
    return bi


def syn_x_exp_plain(stacked, images, s_x_lo, flat=None, dark=None,
                    wrap=False):
    """Plain twin of :func:`syn_x_exp`, on any device."""
    return _syn_x_epilogue(torch.matmul(stacked, s_x_lo.t()), stacked,
                           images, flat, dark, wrap)


def syn_x_exp_ordered(stacked, images, start, coef, flat=None, dark=None,
                      wrap=False):
    """K4 term by term, on any device, from the band form: each output's K
    taps summed in k order from 0, one multiply-add (``torch.addcmul``) per
    term, then the plain twins' epilogue. The kernel sums and finishes each
    output with the same operations in the same order, so on the card it
    is bit-equal to this (``chip_smoke.py`` and the card tests hold it
    so)."""
    _check_epilogue(images, flat, wrap)
    idx = start.to(torch.int64)
    acc = torch.zeros(stacked.shape[:-1] + (coef.shape[0],),
                      dtype=torch.float32, device=stacked.device)
    for k in range(coef.shape[1]):
        acc = torch.addcmul(acc, coef[:, k], stacked[..., idx + k])
    return _syn_x_epilogue(acc, stacked, images, flat, dark, wrap)


def _syn_x_epilogue(corr, stacked, images, flat, dark, wrap):
    """The plain twins' epilogue of K4 on the x-synthesised ``corr``."""
    if images is None:
        return corr
    reps = stacked.shape[0] // _image_planes(stacked, images)
    xlog = torch.log(1.0 + images.to(torch.float32))
    y = torch.exp(xlog.repeat(reps, 1, 1) + corr) + 1.0
    if flat is not None:
        return flatfield_correction(y, flat, dark)
    return wrap_cast(y) if wrap else y


def syn_x_exp(
    stacked: torch.Tensor,  # (B, H, L) float32 — the y-synthesised correction
    images: Optional[torch.Tensor],  # (Bi, H, W) uint16/float32 (B % Bi == 0)
    s_x_lo: Optional[torch.Tensor],  # (W, L) dense lowpass; None on a card
    start: torch.Tensor,  # (W,) int32
    coef: torch.Tensor,  # (W, K) float32
    flat: Optional[torch.Tensor] = None,  # (H, W) float32
    dark: Optional[torch.Tensor] = None,  # (H, W) float32
    wrap: bool = False,
) -> torch.Tensor:
    """``corr = stacked @ s_x_lo^T``. With ``images=None`` returns corr
    (float32). Otherwise ``y = exp(log(1 + images) + corr) + 1``, returned
    as float32, or as uint16 through the flat-field correction
    (``flat``/``dark``) or the modulo-2^16 wrap cast (``wrap``). Output
    plane ``b`` reads image plane ``b mod Bi``. The kernel reads the band
    form only: ``s_x_lo`` is None on a card, and read by the plain twin
    off it."""
    _check_epilogue(images, flat, wrap)
    if not on_cuda(stacked):
        return syn_x_exp_plain(stacked, images, s_x_lo, flat, dark, wrap)
    out = _k4(stacked, images, start, coef, flat, dark, wrap)
    syn_x_exp.launches += 1
    return out


class K4Geometry(NamedTuple):
    """One K4 launch: segments of ``seg`` columns (``nseg`` of them), ring
    rows of ``cap`` floats, ``stages`` ring slots (``smem`` bytes a
    block), ``items`` items of 2 rows by a segment of one output plane,
    and ``grid`` persistent blocks, block g walking items [items g / grid,
    items (g + 1) / grid)."""

    seg: int
    nseg: int
    cap: int
    stages: int
    smem: int
    items: int
    grid: int


def k4_geometry(B: int, H: int, W: int, K: int, sms: int,
                img_bytes: int = 0, fields: bool = False) -> K4Geometry:
    """K4's launch for B output planes of H x W from a band of K taps on
    a card of ``sms`` SMs, with image planes of ``img_bytes`` a pixel (0:
    none, the bare form) and the flat and dark fields or not, from the
    call's shapes alone: the width split into the fewest segments of at
    most 1024 columns, of near-equal width (a multiple of 4, so every
    thread's outputs stay aligned), so every block's items cost the same;
    a ring row of the inputs a segment reads (at most seg - 1 + K, 3 more
    for alignment); a ring slot of an item's 2 st rows, pixel rows and
    field rows (csrc/band.cu K4Slot); as many slots, up to 4, as fit
    three blocks on an SM; and three blocks on every SM, or one per item
    where there are fewer."""
    if min(B, H, W, K, sms) < 1:
        raise ValueError(f"k4_geometry needs positive sizes, got B={B}, "
                         f"H={H}, W={W}, K={K}, sms={sms}")
    if K > _K4_CAP - _K4_SEG - 2:
        raise ValueError(f"K4 takes bands of at most "
                         f"{_K4_CAP - _K4_SEG - 2} taps, got {K}")
    nseg = _cdiv(W, _K4_SEG)
    seg = _cdiv(_cdiv(W, nseg), _K4_OUTS) * _K4_OUTS
    nseg = _cdiv(W, seg)
    cap = _cdiv(seg + K + 2, 4) * 4
    slot_bytes = _K4_ROWS * (4 * cap + _K4_SEG * (img_bytes + 8 * fields))
    stages = min(_K4_MAX_STAGES,
                 _SMEM_PER_SM // _K4_BLOCKS_PER_SM // slot_bytes)
    items = nseg * _cdiv(H, _K4_ROWS) * B
    if items >= 2 ** 31:
        raise ValueError(f"K4 takes fewer than 2^31 items, got {items}")
    return K4Geometry(seg, nseg, cap, stages, stages * slot_bytes, items,
                      min(items, _K4_BLOCKS_PER_SM * sms))


def _k4(stacked, images, start, coef, flat, dark, wrap):
    """Launch K4 over the full width with the epilogue the inputs ask for."""
    B, H, L = stacked.shape
    W, K = coef.shape
    Bi = _image_planes(stacked, images)
    dev = stacked.device
    check("stacked", stacked, (torch.float32,), dev)
    check("start", start, (torch.int32,), dev, (W,))
    check("coef", coef, (torch.float32,), dev)
    mode = _BARE
    if images is not None:
        check("images", images, (torch.uint16, torch.float32), dev,
              (Bi, H, W))
        mode = _FLAT if flat is not None else (_WRAP if wrap else _EXP)
    if flat is not None:
        check("flat", flat, (torch.float32,), dev, (H, W))
        check("dark", dark, (torch.float32,), dev, (H, W))
    out_dtype = torch.uint16 if mode in (_FLAT, _WRAP) else torch.float32
    out = torch.empty((B, H, W), dtype=out_dtype, device=dev)
    geo = k4_geometry(B, H, W, K, sm_count(dev.index),
                      0 if images is None else images.element_size(),
                      flat is not None)
    launch(
        "destripe_k4", dev, stacked.data_ptr(), _ptr(images),
        int(images is not None and images.dtype == torch.uint16),
        _ptr(flat), _ptr(dark), out.data_ptr(), start.data_ptr(),
        coef.data_ptr(), K, B, Bi, H, L, W, mode, geo.seg, geo.cap,
        geo.stages, geo.grid,
    )
    return out


def _check_epilogue(images, flat, wrap):
    if flat is not None and wrap:
        raise ValueError("flat-field and wrap epilogues are exclusive")
    if (flat is not None or wrap) and images is None:
        raise ValueError("epilogues need the original images")


# ---------------------------------------------------------------------------
# K1 and K4 on the row shards of the row-sharded route
# ---------------------------------------------------------------------------


def _band_matmul(x: torch.Tensor, start: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """``x @ A^T`` for the (m, n) operator A that the band form ``(start,
    coef)`` encodes, without building A (a width at the dense-x gate, whose
    dense operator is never built): each output the sum of its K taps,
    O(x.numel() / n * m * K) operations and one output-sized accumulator."""
    idx = start.to(torch.int64)
    out = x[..., idx] * coef[:, 0]
    for k in range(1, coef.shape[1]):
        out += x[..., idx + k] * coef[:, k]
    return out


def an_x_lowpass_chunked(
    x: torch.Tensor,  # (B, h, W) uint16 or float32: one row shard
    a_lo: Optional[torch.Tensor],  # (L, W) dense operator, or None
    start: torch.Tensor,  # (L,) int32 band form of a_lo
    coef: torch.Tensor,  # (L, K) float32
    log1p: bool = True,
) -> torch.Tensor:
    """``f(x) @ a_lo^T`` on one row shard, without the classifier sums:
    (B, h, L) float32 (``f`` as in :func:`an_x_lowpass_log1p`).

    The TPU kernel tiles its operator over output-column chunks so that it
    fits the 16 MiB of scoped VMEM at halo widths. The card has no such
    limit: K1 reads its K taps per output from the band form, so one launch
    covers the shard's full width and there is nothing to chunk. The
    kernel reads the band form only (``a_lo`` may be None); the plain twin
    reads the dense operator, or the band form where there is none."""
    if not on_cuda(x):
        if a_lo is not None:
            return an_x_lowpass_log1p_plain(x, a_lo, log1p)
        xf = x.to(torch.float32)
        return _band_matmul(torch.log(1.0 + xf) if log1p else xf, start,
                           coef)
    out, _ = _k1(x, start, coef, log1p, None)
    an_x_lowpass_chunked.launches += 1
    return out


def syn_x_exp_chunked(
    stacked: torch.Tensor,  # (B, h, L) float32: one row shard
    images: Optional[torch.Tensor],  # (Bi, h, W) uint16/float32 or None
    s_x_lo: Optional[torch.Tensor],  # (W, L) dense operator, or None
    start: torch.Tensor,  # (W,) int32
    coef: torch.Tensor,  # (W, K) float32
    flat: Optional[torch.Tensor] = None,  # (h, W) float32
    dark: Optional[torch.Tensor] = None,  # (h, W) float32
    wrap: bool = False,
) -> torch.Tensor:
    """:func:`syn_x_exp` on one row shard, with its epilogue on the shard's
    own rows (``flat``/``dark`` are the shard's rows of the fields). One
    launch over the full width, as for :func:`an_x_lowpass_chunked`: the
    TPU kernel's output-column chunks exist only to fit scoped VMEM. The
    kernel reads the band form only (``s_x_lo`` may be None); the plain
    twin reads the dense operator, or the band form where there is none."""
    _check_epilogue(images, flat, wrap)
    if not on_cuda(stacked):
        if s_x_lo is not None:
            return syn_x_exp_plain(stacked, images, s_x_lo, flat, dark, wrap)
        return _syn_x_epilogue(_band_matmul(stacked, start, coef), stacked,
                               images, flat, dark, wrap)
    out = _k4(stacked, images, start, coef, flat, dark, wrap)
    syn_x_exp_chunked.launches += 1
    return out


KERNELS = (an_x_lowpass_log1p, an_y_pass, syn_y_pass, syn_x_exp,
           an_x_lowpass_chunked, syn_x_exp_chunked)
for _k in KERNELS:
    _k.launches = 0
