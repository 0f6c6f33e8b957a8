"""
Daubechies filter banks, the per-axis DWT operators (numpy) and the 2-D
transform API (torch).

Counterpart of ``aind_smartspim_destripe_tpu/ops/wavelets.py``. The
destripe step applies a DWT level along one axis as a banded linear map;
the numpy builders produce that map as a dense float32 matrix in pywt's
conventions, which the step either multiplies directly (``torch.matmul``)
or hands to :mod:`.cuda_band` in compact band form. At plane widths where a
dense x operator (O(w^2)) is too large to build, the row-sharded route
applies the x lowpass passes as the blocked, shift-invariant maps
:func:`an_lo_pass_last` and :func:`syn_lo_pass_last` (O(flen) operator
bytes) instead.

The public transform API works on tensors of any leading batch shape, on
their device, with float32 products (TF32 off on the card):
:func:`dwt2` / :func:`idwt2` (one level, blocked by default or through the
dense operators), :func:`wavedec2` / :func:`waverec2` (pywt's multi-level
API) and the convolution forms :func:`dwt2_conv` / :func:`idwt2_conv` that
cross-check them. Conventions:

- "symmetric" half-sample extension by ``flen - 1`` samples per side,
  folded into the analysis matrix;
- analysis output length ``(n + flen - 1) // 2`` per axis;
- synthesis output length ``2 * n - flen + 2`` per axis, with waverec2's
  crop-by-one rule folded into the trimmed synthesis operators.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Wavelet",
    "wavelet",
    "dwt_max_level",
    "dwt_coeff_len",
    "idwt_len",
    "wavedec2_shapes",
    "analysis_operator",
    "synthesis_operator",
    "analysis_operators",
    "synthesis_operators",
    "an_lo_pass_last",
    "syn_lo_pass_last",
    "dwt2",
    "idwt2",
    "dwt2_conv",
    "idwt2_conv",
    "wavedec2",
    "waverec2",
]


def _daubechies_scaling(n_moments: int) -> np.ndarray:
    """Minimum-phase Daubechies scaling filter with ``n_moments`` vanishing
    moments (length ``2 * n_moments``), normalised to sum to sqrt(2), by
    spectral factorisation of the half-band polynomial in y-space with
    Newton-polished roots (kept strictly inside the unit circle)."""
    if n_moments == 1:
        return np.array([1.0, 1.0]) / np.sqrt(2.0)

    n = n_moments
    p_desc = np.array(
        [math.comb(n - 1 + k, k) for k in range(n)], np.complex128
    )[::-1]
    y_roots = np.roots(p_desc)
    dp = p_desc[:-1] * np.arange(len(p_desc) - 1, 0, -1)
    for _ in range(4):
        d = np.polyval(dp, y_roots)
        step = np.where(
            d != 0, np.polyval(p_desc, y_roots) / np.where(d == 0, 1, d), 0
        )
        y_roots = y_roots - step
    w = 1.0 - 2.0 * y_roots
    s = np.sqrt(w * w - 1.0)
    z_a, z_b = w + s, w - s
    inside = np.where(np.abs(z_a) < np.abs(z_b), z_a, z_b)
    if inside.size != n - 1:  # pragma: no cover - numeric safety net
        raise RuntimeError(f"spectral factorization failed for db{n}")

    ell = np.array([1.0 + 0.0j])
    for r in inside:
        ell = np.convolve(ell, [1.0, -r])
    ell = np.real_if_close(ell, tol=1e6)
    if np.iscomplexobj(ell):  # pragma: no cover
        ell = ell.real

    h = np.array([1.0])
    for _ in range(n):
        h = np.convolve(h, [0.5, 0.5])
    h = np.convolve(h, ell)
    h = h * (np.sqrt(2.0) / h.sum())
    if abs(h[0]) < abs(h[-1]):  # minimum phase: energy front-loaded
        h = h[::-1]
    return np.ascontiguousarray(h, dtype=np.float64)


def f32_matmul() -> None:
    """Full float32 matrix products on the card: TF32 off for cuBLAS and
    cuDNN. TF32 keeps ~3 decimal digits; plain bf16 missed the 60 dB
    fidelity gate by ~30 dB, and TF32 has not been measured."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Wavelet:
    """Orthogonal wavelet filter bank (pywt layout): ``rec_lo`` is the
    scaling filter; the other three follow the quadrature-mirror rules
    ``dec_lo[k] = rec_lo[flen-1-k]``, ``dec_hi[k] = (-1)^(k+1) rec_lo[k]``,
    ``rec_hi[k] = (-1)^k dec_lo[k]``."""

    name: str
    rec_lo: Tuple[float, ...]

    @property
    def flen(self) -> int:
        return len(self.rec_lo)

    @property
    def _bank(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        rec_lo = np.asarray(self.rec_lo, dtype=np.float64)
        signs = np.where(np.arange(rec_lo.size) % 2 == 0, -1.0, 1.0)
        dec_lo = rec_lo[::-1].copy()
        dec_hi = signs * rec_lo
        rec_hi = -signs * dec_lo
        return dec_lo, dec_hi, rec_lo, rec_hi

    @property
    def dec_lo(self) -> np.ndarray:
        return self._bank[0]

    @property
    def dec_hi(self) -> np.ndarray:
        return self._bank[1]

    @property
    def rec_lo_arr(self) -> np.ndarray:
        return self._bank[2]

    @property
    def rec_hi(self) -> np.ndarray:
        return self._bank[3]


@lru_cache(maxsize=None)
def wavelet(name: str) -> Wavelet:
    """Look up a wavelet by pywt-style name ('haar', 'db1'..'db20')."""
    key = name.lower()
    if key == "haar":
        key = "db1"
    if key.startswith("db"):
        try:
            order = int(key[2:])
        except ValueError:
            raise ValueError(f"Unknown wavelet: {name!r}") from None
        if not 1 <= order <= 20:
            raise ValueError(f"db order out of supported range: {name!r}")
        return Wavelet(name=key, rec_lo=tuple(_daubechies_scaling(order)))
    raise ValueError(f"Unknown wavelet: {name!r}")


def dwt_max_level(data_len: int, filter_len: int) -> int:
    """pywt.dwt_max_level: floor(log2(data_len / (filter_len - 1)))."""
    if data_len < filter_len - 1 or data_len < 1:
        return 0
    return int(math.floor(math.log2(data_len / (filter_len - 1.0))))


def dwt_coeff_len(data_len: int, filter_len: int) -> int:
    """Per-axis analysis output length for symmetric extension."""
    return (data_len + filter_len - 1) // 2


def idwt_len(coeff_len: int, filter_len: int) -> int:
    """Per-axis synthesis output length."""
    return 2 * coeff_len - filter_len + 2


def wavedec2_shapes(
    shape: Tuple[int, int], wav: Wavelet, level: Optional[int]
) -> Tuple[int, List[Tuple[int, int]]]:
    """Level count (``level=None`` -> pywt's max level over both axes) and
    the per-level detail shapes, coarsest first."""
    h, w = shape
    flen = wav.flen
    if level is None:
        level = min(dwt_max_level(h, flen), dwt_max_level(w, flen))
    ladder = []
    ch, cw = h, w
    for _ in range(level):
        ch, cw = dwt_coeff_len(ch, flen), dwt_coeff_len(cw, flen)
        ladder.append((ch, cw))
    ladder.reverse()
    return level, ladder


def _fold_symmetric(idx: np.ndarray, n: int) -> np.ndarray:
    """Fold arbitrary indices into [0, n) by half-sample reflection."""
    period = 2 * n
    idx = np.mod(idx, period)
    return np.where(idx < n, idx, period - 1 - idx)


@lru_cache(maxsize=None)
def analysis_operator(n: int, wavelet_name: str) -> np.ndarray:
    """(2L, n) float32 matrix of one analysis pass along an axis: rows
    [0:L] lowpass, rows [L:2L] highpass, symmetric extension folded in."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    L = dwt_coeff_len(n, flen)
    k = np.arange(L)[:, None]
    i = np.arange(flen)[None, :]
    src = _fold_symmetric(2 * k + 1 + i - (flen - 1), n)
    A = np.zeros((2 * L, n))
    rows = np.repeat(np.arange(L), flen)
    np.add.at(A, (rows, src.ravel()), np.tile(wav.dec_lo[::-1], L))
    np.add.at(A, (L + rows, src.ravel()), np.tile(wav.dec_hi[::-1], L))
    return A.astype(np.float32)


@lru_cache(maxsize=None)
def synthesis_operator(coeff_len: int, wavelet_name: str) -> np.ndarray:
    """(2*coeff_len - flen + 2, 2*coeff_len) float32 matrix of one
    synthesis pass from stacked [lowpass; highpass] coefficients:
    upsample by 2, convolve with the reconstruction filters, crop."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    L = coeff_len
    out_len = idwt_len(L, flen)
    m = np.arange(out_len)[:, None]
    k = np.arange(L)[None, :]
    j = m + (flen - 2) - 2 * k
    valid = (j >= 0) & (j < flen)
    jc = np.clip(j, 0, flen - 1)
    S = np.zeros((out_len, 2 * L))
    S[:, :L] = np.where(valid, wav.rec_lo_arr[jc], 0.0)
    S[:, L:] = np.where(valid, wav.rec_hi[jc], 0.0)
    return S.astype(np.float32)


def analysis_operators(
    shape: Tuple[int, int], wav: Wavelet, level: Optional[int] = None,
    x_skip_min: Optional[int] = None,
):
    """Per-level (A_y, A_x) operator pairs, finest level first.
    ``x_skip_min``: levels whose input width reaches it get ``A_x = None``;
    their O(w^2) x operator is never built (:func:`an_lo_pass_last` applies
    it instead)."""
    n_levels, _ = wavedec2_shapes(shape, wav, level)
    ops = []
    h, w = shape
    for _ in range(n_levels):
        a_x = (None if x_skip_min is not None and w >= x_skip_min
               else analysis_operator(w, wav.name))
        ops.append((analysis_operator(h, wav.name), a_x))
        h, w = dwt_coeff_len(h, wav.flen), dwt_coeff_len(w, wav.flen)
    return ops


def synthesis_operators(
    shape: Tuple[int, int], wav: Wavelet, level: Optional[int] = None,
    x_skip_min: Optional[int] = None,
):
    """Per-level (S_y, S_x) operator pairs, coarsest level first, with
    output rows trimmed to the next level's detail shape (final level: the
    image shape) so waverec2's crop-by-one rule needs no slice.
    ``x_skip_min``: levels whose output width reaches it get ``S_x = None``
    (:func:`syn_lo_pass_last` applies it instead)."""
    _, ladder = wavedec2_shapes(shape, wav, level)
    targets = list(ladder[1:]) + [shape]
    return [
        (synthesis_operator(h, wav.name)[:th],
         None if x_skip_min is not None and tw >= x_skip_min
         else synthesis_operator(w, wav.name)[:tw])
        for (h, w), (th, tw) in zip(ladder, targets)
    ]


# ---------------------------------------------------------------------------
# Blocked lowpass passes along the last axis
#
# With the symmetric extension written into the data, the banded analysis
# and synthesis maps are shift-invariant: every block of _AN_R analysis (or
# 2 _AN_R synthesis) outputs is the same small matrix applied to a short
# overlapping window of the input, so a pass is one batched product of
# windows by an O(flen) operator.
# ---------------------------------------------------------------------------

_AN_R = 64  # analysis outputs per block (per filter)


@lru_cache(maxsize=None)
def _blocked_analysis_mat(wavelet_name: str) -> np.ndarray:
    """(K, 2R) float32: a window of 2R + flen - 2 extended samples ->
    [R lowpass outputs | R highpass outputs]."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    R = _AN_R
    K = 2 * R + flen - 2
    lo_rev = wav.dec_lo[::-1]
    hi_rev = wav.dec_hi[::-1]
    M = np.zeros((K, 2 * R))
    for r in range(R):
        for i in range(flen):
            M[2 * r + i, r] += lo_rev[i]
            M[2 * r + i, R + r] += hi_rev[i]
    return M.astype(np.float32)


@lru_cache(maxsize=None)
def _blocked_synthesis_mat(wavelet_name: str) -> Tuple[np.ndarray, int]:
    """((2T, R_out) float32, T): windows of T lowpass and T highpass
    coefficients -> R_out = 2 _AN_R reconstructed samples (upsample,
    convolve, crop)."""
    wav = wavelet(wavelet_name)
    flen = wav.flen
    R_out = 2 * _AN_R
    T = (R_out - 1 + flen - 2) // 2 + 1
    rec_lo = wav.rec_lo_arr
    rec_hi = wav.rec_hi
    M = np.zeros((2 * T, R_out))
    for s in range(R_out):
        for t in range(T):
            j = s + flen - 2 - 2 * t
            if 0 <= j < flen:
                M[t, s] += rec_lo[j]
                M[T + t, s] += rec_hi[j]
    return M.astype(np.float32), T


@lru_cache(maxsize=64)
def _operand(mat_key: tuple, device: torch.device) -> torch.Tensor:
    """A blocked pass's matrix on ``device``: ``kind`` "an" (both
    filters' outputs), "an_lo" (the lowpass outputs only), "syn" (lowpass
    and highpass windows) or "syn_lo" (the lowpass window only)."""
    name, kind = mat_key
    if kind.startswith("an"):
        m = _blocked_analysis_mat(name)
        m = m[:, :_AN_R] if kind == "an_lo" else m
    else:
        M, T = _blocked_synthesis_mat(name)
        m = M[:T] if kind == "syn_lo" else M
    return torch.as_tensor(np.ascontiguousarray(m), device=device)


def _windows(c: torch.Tensor, step: int, nq: int, width: int):
    """(..., nq, width) windows of the last axis: window q starts at
    q * step (``c`` holds at least step * nq + width - step samples)."""
    base = c[..., : step * nq].reshape(c.shape[:-1] + (nq, step))
    halo = c[..., step : step + step * nq].reshape(
        c.shape[:-1] + (nq, step))[..., : width - step]
    return torch.cat([base, halo], dim=-1)


def _an_windows(x: torch.Tensor, wav: Wavelet):
    """The analysis windows of the last axis of ``x``, symmetric extension
    written in (:func:`_fold_symmetric`: ``F.pad(mode="reflect")`` would
    drop the edge sample): (..., nq, 2 _AN_R + flen - 2) and L."""
    flen = wav.flen
    n = x.shape[-1]
    L = dwt_coeff_len(n, flen)
    R = _AN_R
    nq = -(-L // R)
    idx = _fold_symmetric(np.arange(-(flen - 1), n + flen - 1), n)
    ext = x.index_select(-1, torch.as_tensor(idx, device=x.device))
    need = 1 + 2 * R * (nq + 1)
    if ext.shape[-1] < need:
        ext = torch.nn.functional.pad(ext, (0, need - ext.shape[-1]))
    return _windows(ext[..., 1:], 2 * R, nq, 2 * R + flen - 2), L


def _an_pass_last(x: torch.Tensor, wav: Wavelet):
    """One analysis pass along the last axis -> (lo, hi), each (..., L):
    the blocked equivalent of ``x @ analysis_operator(n).T``."""
    win, L = _an_windows(x, wav)
    out = torch.matmul(win, _operand((wav.name, "an"), x.device))
    lead, nq, R = x.shape[:-1], win.shape[-2], _AN_R
    lo = out[..., :R].reshape(lead + (nq * R,))[..., :L]
    hi = out[..., R:].reshape(lead + (nq * R,))[..., :L]
    return lo, hi


def an_lo_pass_last(x: torch.Tensor, wav: Wavelet) -> torch.Tensor:
    """Lowpass-only analysis along the last axis -> (..., L): the blocked
    equivalent of ``x @ analysis_operator(n)[:L].T`` (the dense ``an_x_lo``
    of :meth:`..filter.DestripePlan.constants`), at O(flen) operator bytes
    instead of O(n^2). float32 in, float32 out."""
    win, L = _an_windows(x, wav)
    out = torch.matmul(win, _operand((wav.name, "an_lo"), x.device))
    return out.reshape(x.shape[:-1] + (win.shape[-2] * _AN_R,))[..., :L]


def _syn_windows(c: torch.Tensor, nq: int, H: int, T: int) -> torch.Tensor:
    """(..., nq, T) synthesis windows of the coefficients ``c``, zero
    padded past their end."""
    c = torch.nn.functional.pad(c, (0, max(0, H * nq + T - c.shape[-1])))
    return _windows(c, H, nq, T)


def _syn_pass_last(lo: torch.Tensor, hi: torch.Tensor,
                   wav: Wavelet) -> torch.Tensor:
    """One synthesis pass along the last axis from L lowpass and L highpass
    coefficients -> (..., 2L - flen + 2): the blocked equivalent of
    ``cat([lo, hi], -1) @ synthesis_operator(L).T``."""
    out_len = idwt_len(lo.shape[-1], wav.flen)
    M, T = _blocked_synthesis_mat(wav.name)
    R_out = M.shape[1]
    H = R_out // 2
    nq = -(-out_len // R_out)
    win = torch.cat([_syn_windows(lo, nq, H, T), _syn_windows(hi, nq, H, T)],
                    dim=-1)
    out = torch.matmul(win, _operand((wav.name, "syn"), lo.device))
    return out.reshape(lo.shape[:-1] + (nq * R_out,))[..., :out_len]


def syn_lo_pass_last(lo: torch.Tensor, wav: Wavelet,
                     out_len: int) -> torch.Tensor:
    """Lowpass-only synthesis along the last axis, cropped to ``out_len``
    samples: the blocked equivalent of ``lo @ synthesis_operator(L)
    [:out_len, :L].T`` (the dense trimmed ``syn_x_lo``). Output s = q R_out
    + s' of coefficient t = q H + t' has tap j = s' + flen - 2 - 2 t', so
    every tap of the dense operator lands in block q's window."""
    M, T = _blocked_synthesis_mat(wav.name)
    R_out = M.shape[1]
    nq = -(-out_len // R_out)
    win = _syn_windows(lo, nq, R_out // 2, T)
    out = torch.matmul(win, _operand((wav.name, "syn_lo"), lo.device))
    return out.reshape(lo.shape[:-1] + (nq * R_out,))[..., :out_len]


# ---------------------------------------------------------------------------
# The public transform API
# ---------------------------------------------------------------------------


def _swap(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(-1, -2)


def _on(op, like: torch.Tensor) -> torch.Tensor:
    """An operator (numpy or tensor) as a tensor of ``like``'s dtype and
    device."""
    return torch.as_tensor(op, dtype=like.dtype, device=like.device)


def dwt2(x: torch.Tensor, wav: Wavelet, ops=None):
    """One 2-D analysis level over the last two axes of ``x`` (leading axes
    are batch): ``(cA, (cH, cV, cD))`` with pywt's values. By default the
    blocked passes (no per-geometry operator); ``ops``, a dense ``(A_y,
    A_x)`` pair (:func:`analysis_operator`, numpy or tensors), selects the
    dense products instead."""
    f32_matmul()
    if ops is None:
        lo_y, hi_y = _an_pass_last(_swap(x), wav)
        aa, ad = _an_pass_last(_swap(lo_y), wav)
        da, dd = _an_pass_last(_swap(hi_y), wav)
        return aa, (da, ad, dd)
    A_y, A_x = _on(ops[0], x), _on(ops[1], x)
    y = torch.matmul(torch.matmul(A_y, x), A_x.t())
    L_h, L_w = A_y.shape[0] // 2, A_x.shape[0] // 2
    return y[..., :L_h, :L_w], (y[..., L_h:, :L_w], y[..., :L_h, L_w:],
                                y[..., L_h:, L_w:])


def idwt2(ca: torch.Tensor, details, wav: Wavelet, ops=None) -> torch.Tensor:
    """One 2-D synthesis level, the inverse of :func:`dwt2`: blocked by
    default; ``ops``, a dense ``(S_y, S_x)`` pair
    (:func:`synthesis_operator`, rows trimmed or not), selects the dense
    products."""
    f32_matmul()
    ch, cv, cd = details
    if ops is None:
        lo_row = _syn_pass_last(ca, cv, wav)  # lowpass-y channel
        hi_row = _syn_pass_last(ch, cd, wav)  # highpass-y channel
        return _swap(_syn_pass_last(_swap(lo_row), _swap(hi_row), wav))
    S_y, S_x = _on(ops[0], ca), _on(ops[1], ca)
    c2 = torch.cat([torch.cat([ca, cv], dim=-1),  # lowpass-y: [aa | ad]
                    torch.cat([ch, cd], dim=-1)],  # highpass-y: [da | dd]
                   dim=-2)
    return torch.matmul(torch.matmul(S_y, c2), S_x.t())


def _conv_kernels(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(4, flen, flen) outer products in channel order (aa, da, ad, dd) ==
    (cA, cH, cV, cD): the first letter filters y, the second x."""
    return np.stack([np.outer(lo, lo), np.outer(hi, lo), np.outer(lo, hi),
                     np.outer(hi, hi)])


def dwt2_conv(x: torch.Tensor, wav: Wavelet):
    """:func:`dwt2` as one strided convolution (a cross-check of the
    product forms): the symmetric extension correlated with the reversed
    decomposition filters at stride 2, from extended index 1."""
    f32_matmul()
    flen = wav.flen
    h, w = x.shape[-2:]
    xb = x.reshape((-1, 1, h, w))
    for axis, n in ((-2, h), (-1, w)):
        idx = _fold_symmetric(np.arange(-(flen - 1), n + flen - 1), n)
        xb = xb.index_select(axis, torch.as_tensor(idx[1:], device=x.device))
    k = _conv_kernels(wav.dec_lo[::-1], wav.dec_hi[::-1])[:, None]
    out = torch.nn.functional.conv2d(xb, _on(k, x), stride=2)
    oh, ow = dwt_coeff_len(h, flen), dwt_coeff_len(w, flen)
    out = out[..., :oh, :ow].reshape(x.shape[:-2] + (4, oh, ow))
    bands = out.unbind(dim=-3)
    return bands[0], bands[1:]


def idwt2_conv(ca: torch.Tensor, details, wav: Wavelet) -> torch.Tensor:
    """:func:`idwt2` as one transposed convolution (a cross-check of the
    product forms): the coefficients upsampled by 2 and convolved with the
    reconstruction filters, cropped as the synthesis operator crops
    (padding flen - 2)."""
    f32_matmul()
    flen = wav.flen
    h, w = ca.shape[-2:]
    xb = torch.stack([ca, *details], dim=-3).reshape((-1, 4, h, w))
    k = _conv_kernels(wav.rec_lo_arr, wav.rec_hi)[:, None]
    out = torch.nn.functional.conv_transpose2d(xb, _on(k, ca), stride=2,
                                               padding=flen - 2)
    oh, ow = idwt_len(h, flen), idwt_len(w, flen)
    return out[:, 0, :oh, :ow].reshape(ca.shape[:-2] + (oh, ow))


def wavedec2(x: torch.Tensor, wav: Wavelet, level: Optional[int] = None,
             operators=None) -> list:
    """Multi-level 2-D analysis, pywt's ``wavedec2``: ``[cA_n, (cH_n, cV_n,
    cD_n), ..., (cH_1, cV_1, cD_1)]``, coarsest detail first.
    ``operators``: per-level dense ``(A_y, A_x)`` pairs, finest first
    (:func:`analysis_operators`), for the dense products."""
    n_levels, _ = wavedec2_shapes(tuple(x.shape[-2:]), wav, level)
    coeffs, approx = [], x
    for lvl in range(n_levels):
        approx, det = dwt2(approx, wav,
                           None if operators is None else operators[lvl])
        coeffs.append(det)
    coeffs.append(approx)
    return coeffs[::-1]


def waverec2(coeffs, wav: Wavelet, operators=None) -> torch.Tensor:
    """Multi-level 2-D synthesis with pywt's crop-by-one rule: a running
    approximation one sample larger than the next detail band along an
    axis is cut to it first; any other mismatch raises ``ValueError``.
    ``operators``: per-level dense ``(S_y, S_x)`` pairs, coarsest first
    (:func:`synthesis_operators`)."""
    approx = coeffs[0]
    for i, det in enumerate(coeffs[1:]):
        dh, dw = det[0].shape[-2:]
        ah, aw = approx.shape[-2:]
        if not (0 <= ah - dh <= 1 and 0 <= aw - dw <= 1):
            raise ValueError(f"inconsistent coefficient shapes: approx "
                             f"{(ah, aw)} vs detail {(dh, dw)}")
        approx = idwt2(approx[..., :dh, :dw], det, wav,
                       None if operators is None else operators[i])
    return approx
