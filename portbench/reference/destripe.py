"""
Plain NumPy reference of the production destripe step, one plane at a time.

It follows the upstream pipeline's per-plane math (aind-smartspim-destripe
``filtering.py``: the float16 sigmoid cells classifier, ``log1p`` -> db3
``wavedec2`` with symmetric extension -> per level an Otsu stripe threshold
on ``cH**2``, the row-median inpaint and the packed FFTPACK notch of the
horizontal-detail band -> ``waverec2`` -> ``exp(y) + 1`` -> flat-field and
dark correction to uint16) and the dual-band blend (both configurations,
blended per pixel by the 17 x 17 edge-replicated box mean of a sigmoid
foreground fraction centred on the raw plane's Otsu threshold).

It imports nothing of the measured program: the db3 taps are written out,
the DWT is a sum of shifted slices of the symmetric-padded signal, and the
packed real FFT is rebuilt from ``numpy.fft``. Every plan quantity (level
count, shapes, notch sigmas, thresholds, flats) is worked out again here
from the same inputs the program gets.

``prec="f64"`` is the reference. ``prec="tf32"`` is the lower-precision
control: every array in float32 and the operands of every filter product
(the DWT taps and the FFT's input) rounded to TF32's 10 mantissa bits, as a
float32 product with TF32 on would take them.

The check computes the PyTorch transcription of this module,
:mod:`.destripe_torch`, on the run's device; this module is the tests'
oracle for it.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["DB3_REC_LO", "FLEN", "dwt_max_level", "n_levels", "wavedec2",
           "waverec2", "rfft_packed", "irfft_packed", "threshold_otsu",
           "is_cells", "filter_plane", "flatfield", "destripe_plane",
           "destripe_plane_dual", "box_mean"]

# db3 scaling filter (rec_lo), pywt's ordering
DB3_REC_LO = (0.3326705529500827, 0.8068915093110927, 0.45987750211849154,
              -0.1350110200102546, -0.08544127388202664, 0.03522629188570957)
FLEN = len(DB3_REC_LO)


def _bank():
    rec_lo = np.asarray(DB3_REC_LO, np.float64)
    signs = np.where(np.arange(FLEN) % 2 == 0, -1.0, 1.0)
    dec_lo = rec_lo[::-1].copy()
    dec_hi = signs * rec_lo
    rec_hi = -signs * dec_lo
    return dec_lo, dec_hi, rec_lo, rec_hi


DEC_LO, DEC_HI, REC_LO, REC_HI = _bank()


def dwt_max_level(n: int, flen: int = FLEN) -> int:
    """pywt.dwt_max_level: floor(log2(n / (flen - 1)))."""
    if n < flen - 1 or n < 1:
        return 0
    return int(math.floor(math.log2(n / (flen - 1.0))))


def n_levels(h: int, w: int) -> int:
    """wavedec2's level=None: the smaller axis's maximum level."""
    return min(dwt_max_level(h), dwt_max_level(w))


def _tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest TF32 (10 mantissa bits)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _dtype(prec: str):
    if prec not in ("f64", "tf32"):
        raise ValueError(f"prec must be 'f64' or 'tf32', got {prec!r}")
    return np.float64 if prec == "f64" else np.float32


def _taps(xp, filt, count, prec, stride):
    """sum_i filt[i] * xp[..., stride * k + i] for k < count."""
    dt = _dtype(prec)
    if prec == "tf32":
        xp, filt = _tf32(xp), _tf32(np.asarray(filt, np.float32))
    out = np.zeros(xp.shape[:-1] + (count,), dt)
    for i, f in enumerate(np.asarray(filt, dt)):
        out += f * xp[..., i:i + stride * (count - 1) + 1:stride]
    return out


def _analysis_last(x, filt, prec):
    """One symmetric-mode analysis pass along the last axis (pywt dwt)."""
    n = x.shape[-1]
    L = (n + FLEN - 1) // 2
    pad = [(0, 0)] * (x.ndim - 1) + [(FLEN - 2, FLEN - 1)]
    xp = np.pad(x, pad, mode="symmetric")
    return _taps(xp, filt[::-1], L, prec, 2)


def _synthesis_last(c, filt, prec):
    """One synthesis pass along the last axis: upsample by 2, full
    convolution with ``filt``, crop [flen - 2, flen - 2 + 2L - flen + 2)."""
    L = c.shape[-1]
    up = np.zeros(c.shape[:-1] + (2 * L,), c.dtype)
    up[..., ::2] = c
    pad = [(0, 0)] * (c.ndim - 1) + [(FLEN - 1, FLEN - 1)]
    upp = np.pad(up, pad)
    n_out = 2 * L - FLEN + 2
    # out[t] = sum_j filt[j] * upp[t + 2 flen - 3 - j]
    return _taps(upp[..., FLEN - 2:], filt[::-1], n_out, prec, 1)


def _on_rows(fn, x, *args):
    return np.swapaxes(fn(np.swapaxes(x, -1, -2), *args), -1, -2)


def _dwt2(x, prec):
    a_y = _on_rows(_analysis_last, x, DEC_LO, prec)
    d_y = _on_rows(_analysis_last, x, DEC_HI, prec)
    ca = _analysis_last(a_y, DEC_LO, prec)
    cv = _analysis_last(a_y, DEC_HI, prec)
    ch = _analysis_last(d_y, DEC_LO, prec)
    cd = _analysis_last(d_y, DEC_HI, prec)
    return ca, (ch, cv, cd)


def _idwt2(ca, details, prec):
    ch, cv, cd = details
    lo_x = (_synthesis_last(ca, REC_LO, prec)
            + _synthesis_last(cv, REC_HI, prec))
    hi_x = (_synthesis_last(ch, REC_LO, prec)
            + _synthesis_last(cd, REC_HI, prec))
    return (_on_rows(_synthesis_last, lo_x, REC_LO, prec)
            + _on_rows(_synthesis_last, hi_x, REC_HI, prec))


def wavedec2(x, levels, prec="f64"):
    """[cA_n, (cH_n, cV_n, cD_n), ..., (cH_1, cV_1, cD_1)]."""
    coeffs, approx = [], x
    for _ in range(levels):
        approx, det = _dwt2(approx, prec)
        coeffs.append(det)
    coeffs.append(approx)
    return coeffs[::-1]


def waverec2(coeffs, prec="f64"):
    approx = coeffs[0]
    for det in coeffs[1:]:
        dh, dw = det[0].shape[-2:]
        approx = _idwt2(approx[..., :dh, :dw], det, prec)
    return approx


def rfft_packed(x):
    """scipy.fftpack.rfft along the last axis: [y0, Re y1, Im y1, ...]."""
    n = x.shape[-1]
    r = np.fft.rfft(x, axis=-1)
    out = np.empty(x.shape, np.float64)
    out[..., 0] = r[..., 0].real
    m = (n - 1) // 2
    out[..., 1:2 * m + 1:2] = r[..., 1:m + 1].real
    out[..., 2:2 * m + 2:2] = r[..., 1:m + 1].imag
    if n % 2 == 0:
        out[..., -1] = r[..., n // 2].real
    return out


def irfft_packed(p):
    """Inverse of :func:`rfft_packed` (scipy.fftpack.irfft)."""
    n = p.shape[-1]
    m = (n - 1) // 2
    r = np.zeros(p.shape[:-1] + (n // 2 + 1,), np.complex128)
    r[..., 0] = p[..., 0]
    r[..., 1:m + 1] = p[..., 1:2 * m + 1:2] + 1j * p[..., 2:2 * m + 2:2]
    if n % 2 == 0:
        r[..., n // 2] = p[..., -1]
    return np.fft.irfft(r, n=n, axis=-1)


def threshold_otsu(image, nbins: int = 256) -> float:
    """skimage's threshold_otsu over ``nbins`` equal bins of [min, max]."""
    counts, edges = np.histogram(np.ravel(image), bins=nbins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    counts = counts.astype(np.float64)
    w1 = np.cumsum(counts)
    w2 = np.cumsum(counts[::-1])[::-1]
    with np.errstate(invalid="ignore", divide="ignore"):
        m1 = np.cumsum(counts * centers) / w1
        m2 = (np.cumsum((counts * centers)[::-1]) / w2[::-1])[::-1]
        var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return float(centers[np.nanargmax(var12)])


def is_cells(image, microscope_high_int: float, threshold_mask=0.3) -> bool:
    """The float16 sigmoid foreground classifier (centre 400, crossover 20)
    and the fore/back mean comparison."""
    z = (image.astype(np.float16) - np.float16(400)) / np.float16(20)
    with np.errstate(over="ignore"):
        frac = 1 / (1 + np.exp(-z))
    cell = frac > threshold_mask
    x = image.astype(np.float64)
    fg = x[cell].mean() if cell.any() else 0.0
    bg = x[~cell].mean() if (~cell).any() else 0.0
    return bool(fg > bg and fg > microscope_high_int)


def _notch_gain(n: int, sigma: float):
    k = np.arange(n)
    return 1.0 - np.exp(-(k ** 2) / (2.0 * sigma ** 2))


def _filter_band(ch, sigma_rel, max_threshold, prec):
    """One cH band: Otsu threshold of ch**2 capped by the configuration's,
    row-median inpaint of the masked coefficients, packed-FFT notch along
    the rows with sigma = rows * sigma_rel."""
    dt = _dtype(prec)
    ch_sq = ch * ch
    threshold = min(max_threshold, math.sqrt(threshold_otsu(ch_sq)))
    mask = np.sqrt(ch_sq) > threshold
    background = ch * (1 - mask)
    med = np.median(background, axis=-1, keepdims=True)
    inpainted = background + med * mask
    if prec == "tf32":
        inpainted = _tf32(inpainted)
    spec = rfft_packed(inpainted)
    spec = spec * _notch_gain(spec.shape[-1], ch.shape[-2] * sigma_rel)
    filtered = irfft_packed(spec).astype(dt)
    return ch * mask + filtered * (1 - mask)


def filter_plane(image, configs, prec="f64"):
    """log-space wavelet-FFT filtering of one uint16 plane with each
    configuration of ``configs`` (dicts with ``sigma``, ``max_threshold``),
    from one decomposition; returns one float array per configuration."""
    dt = _dtype(prec)
    h, w = image.shape
    img_log = np.log(1.0 + image.astype(dt))
    coeffs = wavedec2(img_log, n_levels(h, w), prec)
    outs = []
    for cfg in configs:
        sigma_rel = float(cfg["sigma"]) / min(h, w)
        filtered = [coeffs[0]] + [
            (_filter_band(ch, sigma_rel, float(cfg["max_threshold"]), prec),
             cv, cd) for ch, cv, cd in coeffs[1:]]
        # an odd axis comes back one longer (pywt's waverec2): cropped to
        # the plane, as the program crops
        outs.append(np.exp(waverec2(filtered, prec)[:h, :w]) + 1.0)
    return outs


def flatfield(y, flat, dark):
    """Dark subtraction clamped at zero, division by the flat, clip to
    [0, 65535], truncating cast to uint16."""
    y = np.asarray(y, np.float64)
    dark = np.asarray(dark, np.float64)[:y.shape[-2], :y.shape[-1]]
    y = np.where(y <= dark, 0.0, y - dark)
    return np.clip(y / flat, 0, 65535).astype(np.uint16)


def destripe_plane(image, flat, dark, cells_cfg, no_cells_cfg,
                   microscope_high_int=2500.0, prec="f64"):
    """The single-band step on one plane: the classifier picks the
    configuration, then the filter and the flat-field correction."""
    cfg = (cells_cfg if is_cells(image, microscope_high_int)
           else no_cells_cfg)
    return flatfield(filter_plane(image, [cfg], prec)[0], flat, dark)


def box_mean(v, radius: int):
    """Edge-replicated box mean of width 2r + 1, along x and then y."""
    k = 2 * radius + 1
    for axis in (-1, -2):
        n = v.shape[axis]
        pad = [(0, 0)] * v.ndim
        pad[axis] = (radius, radius)
        vp = np.pad(v, pad, mode="edge")
        s = np.zeros_like(v)
        for t in range(k):
            s = s + np.take(vp, np.arange(t, t + n), axis=axis)
        v = s / k
    return v


def destripe_plane_dual(image, flat, dark, fore_cfg, back_cfg,
                        crossover=100.0, radius=8, prec="f64"):
    """The dual-band step on one plane: both configurations, blended by the
    smoothed sigmoid foreground fraction centred on the plane's Otsu
    threshold, then the flat-field correction."""
    dt = _dtype(prec)
    fore, back = filter_plane(image, [fore_cfg, back_cfg], prec)
    x = image.astype(dt)
    center = threshold_otsu(x)
    frac = 1.0 / (1.0 + np.exp(-(x - center) / crossover))
    frac = box_mean(frac, radius)
    return flatfield(fore * frac + back * (1.0 - frac), flat, dark)
