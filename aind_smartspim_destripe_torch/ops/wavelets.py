"""
Daubechies filter banks and the dense per-axis DWT operators, in numpy.

Counterpart of ``aind_smartspim_destripe_tpu/ops/wavelets.py`` (its numpy
builders only). The destripe step applies a DWT level along one axis as a
banded linear map; these builders produce that map as a dense float32
matrix in pywt's conventions, which the step either multiplies directly
(``torch.matmul``) or hands to :mod:`.cuda_band` in compact band form:

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
    shape: Tuple[int, int], wav: Wavelet, level: Optional[int] = None
):
    """Per-level (A_y, A_x) operator pairs, finest level first."""
    n_levels, _ = wavedec2_shapes(shape, wav, level)
    ops = []
    h, w = shape
    for _ in range(n_levels):
        ops.append((analysis_operator(h, wav.name),
                    analysis_operator(w, wav.name)))
        h, w = dwt_coeff_len(h, wav.flen), dwt_coeff_len(w, wav.flen)
    return ops


def synthesis_operators(
    shape: Tuple[int, int], wav: Wavelet, level: Optional[int] = None
):
    """Per-level (S_y, S_x) operator pairs, coarsest level first, with
    output rows trimmed to the next level's detail shape (final level: the
    image shape) so waverec2's crop-by-one rule needs no slice."""
    _, ladder = wavedec2_shapes(shape, wav, level)
    targets = list(ladder[1:]) + [shape]
    return [
        (synthesis_operator(h, wav.name)[:th],
         synthesis_operator(w, wav.name)[:tw])
        for (h, w), (th, tw) in zip(ladder, targets)
    ]
