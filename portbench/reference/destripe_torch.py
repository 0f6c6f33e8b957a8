"""
Plain PyTorch reference of the production destripe step, one plane at a time,
on any device.

A line-for-line transcription of :mod:`.destripe` (the NumPy reference) in
``torch`` float64: the same db3 taps (imported from it, with the level
count), the DWT as sums of shifted slices of the symmetric-padded signal, the
packed FFTPACK real FFT rebuilt from ``torch.fft``, the Otsu threshold on
``cH**2``, the row-median inpaint and the notch, ``waverec2``, ``exp(y) + 1``,
then flat and dark; the dual blend with its 17 x 17 edge-replicated box. Each
sum adds its terms in the NumPy module's order. It imports nothing of the
measured program. The check (:mod:`portbench.check`) computes it on the
run's device, one plane after another, once the program's state is freed.

Departures from the NumPy module, where torch has no call of the same
meaning:

- symmetric padding (``np.pad(mode="symmetric")``) is an index gather: the
  mirror of period ``2 n``, which NumPy's repeated reflection gives for any
  pad width; the box's edge replication gathers clamped indices;
- the Otsu histogram takes NumPy's own bin edges (``np.histogram_bin_edges``
  on the host over the device's min and max, in the data's dtype) and puts
  each value in the bin that ``searchsorted`` finds on them, the last bin
  closed: where NumPy's index arithmetic and its one-step corrections land;
- the Otsu tail (256 counts) runs on the host's CPU, whose ``cumsum`` is one
  sequential loop as NumPy's; ``nanargmax`` is ``argmax`` with NaN as -inf;
- the row median sorts each row; of an even row it takes ``(a + b) / 2`` of
  the two middle values, as ``np.median`` does (``torch.median`` would take
  the lower one);
- the classifier's means are torch reductions, summed in another order than
  NumPy's pairwise sums;
- ``log``, ``exp`` and the FFT are the device's own (cuFFT on the card), which
  round differently from NumPy's in the last bits: a coefficient on a bin edge
  or on the stripe threshold may fall the other way, and a uint16 output
  whose float value lies next to a whole number may truncate one count apart.

``prec="f64"`` is the reference. ``prec="tf32"`` is the lower-precision
control, as the NumPy module's: every array in float32 and the operands of
every filter product (the DWT taps and the FFT's input) rounded to TF32's 10
mantissa bits, with NumPy's type promotions (the inpaint and the band's
blend in float64, the packed spectrum in float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .destripe import DB3_REC_LO, FLEN, n_levels

__all__ = ["wavedec2", "waverec2", "rfft_packed",
           "irfft_packed", "threshold_otsu", "is_cells", "filter_plane",
           "flatfield", "destripe_plane", "destripe_plane_dual", "box_mean"]

def _bank():
    rec_lo = list(DB3_REC_LO)
    signs = [-1.0 if i % 2 == 0 else 1.0 for i in range(FLEN)]
    dec_lo = rec_lo[::-1]
    dec_hi = [s * r for s, r in zip(signs, rec_lo)]
    rec_hi = [-s * d for s, d in zip(signs, dec_lo)]
    return dec_lo, dec_hi, rec_lo, rec_hi


DEC_LO, DEC_HI, REC_LO, REC_HI = _bank()


def _dtype(prec: str):
    if prec not in ("f64", "tf32"):
        raise ValueError(f"prec must be 'f64' or 'tf32', got {prec!r}")
    return torch.float64 if prec == "f64" else torch.float32


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 (10 mantissa bits)."""
    b = a.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_taps(filt):
    """The taps rounded to TF32, as Python floats (exact in float32)."""
    return _tf32(torch.tensor(filt, dtype=torch.float32)).tolist()


def _sl(ndim, dim, s):
    idx = [slice(None)] * ndim
    idx[dim] = s
    return tuple(idx)


def _taps(xp, filt, count, prec, stride, dim):
    """sum_i filt[i] * xp[stride * k + i] along ``dim``, for k < count."""
    dt = _dtype(prec)
    if prec == "tf32":
        xp, filt = _tf32(xp), _tf32_taps(filt)
    shape = list(xp.shape)
    shape[dim] = count
    out = torch.zeros(shape, dtype=dt, device=xp.device)
    for i, f in enumerate(filt):
        out += f * xp[_sl(xp.ndim, dim, slice(i, i + stride * (count - 1) + 1,
                                              stride))]
    return out


def _sym_index(n, left, right, device):
    """Indices of ``np.pad(mode="symmetric")`` along an axis of length n."""
    j = torch.arange(-left, n + right, device=device) % (2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def _analysis(x, filt, prec, dim):
    """One symmetric-mode analysis pass along ``dim`` (pywt dwt)."""
    n = x.shape[dim]
    L = (n + FLEN - 1) // 2
    xp = x.index_select(dim, _sym_index(n, FLEN - 2, FLEN - 1, x.device))
    return _taps(xp, filt[::-1], L, prec, 2, dim)


def _synthesis(c, filt, prec, dim):
    """One synthesis pass along ``dim``: upsample by 2, full convolution
    with ``filt``, crop [flen - 2, flen - 2 + 2L - flen + 2)."""
    L = c.shape[dim]
    shape = list(c.shape)
    shape[dim] = 2 * L + 2 * (FLEN - 1)
    upp = torch.zeros(shape, dtype=c.dtype, device=c.device)
    upp[_sl(c.ndim, dim, slice(FLEN - 1, FLEN - 1 + 2 * L, 2))] = c
    n_out = 2 * L - FLEN + 2
    # out[t] = sum_j filt[j] * upp[t + 2 flen - 3 - j]
    return _taps(upp[_sl(c.ndim, dim, slice(FLEN - 2, None))], filt[::-1],
                 n_out, prec, 1, dim)


def _dwt2(x, prec):
    a_y = _analysis(x, DEC_LO, prec, -2)
    d_y = _analysis(x, DEC_HI, prec, -2)
    ca = _analysis(a_y, DEC_LO, prec, -1)
    cv = _analysis(a_y, DEC_HI, prec, -1)
    ch = _analysis(d_y, DEC_LO, prec, -1)
    cd = _analysis(d_y, DEC_HI, prec, -1)
    return ca, (ch, cv, cd)


def _idwt2(ca, details, prec):
    ch, cv, cd = details
    lo_x = _synthesis(ca, REC_LO, prec, -1) + _synthesis(cv, REC_HI, prec, -1)
    hi_x = _synthesis(ch, REC_LO, prec, -1) + _synthesis(cd, REC_HI, prec, -1)
    return (_synthesis(lo_x, REC_LO, prec, -2)
            + _synthesis(hi_x, REC_HI, prec, -2))


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
    r = torch.fft.rfft(x, dim=-1)
    out = torch.empty(x.shape, dtype=torch.float64, device=x.device)
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
    r = torch.zeros(p.shape[:-1] + (n // 2 + 1,), dtype=torch.complex128,
                    device=p.device)
    r[..., 0] = p[..., 0]
    r[..., 1:m + 1] = torch.complex(p[..., 1:2 * m + 1:2],
                                    p[..., 2:2 * m + 2:2])
    if n % 2 == 0:
        r[..., n // 2] = p[..., -1]
    return torch.fft.irfft(r, n=n, dim=-1)


def _histogram(image, nbins):
    """(counts, bin edges) of ``np.histogram(image, bins=nbins)``: counts a
    float64 CPU tensor, edges a CPU tensor of the data's dtype."""
    v = image.reshape(-1)
    np_dt = np.float64 if v.dtype == torch.float64 else np.float32
    lo, hi = torch.stack([v.min(), v.max()]).cpu().numpy().astype(np_dt)
    edges = np.histogram_bin_edges(np.array([lo, hi], np_dt), bins=nbins)
    edges_d = torch.from_numpy(edges).to(v.device)
    idx = (torch.searchsorted(edges_d, v, right=True) - 1).clamp_(0, nbins - 1)
    counts = torch.bincount(idx, minlength=nbins)
    return counts.cpu().to(torch.float64), torch.from_numpy(edges)


def threshold_otsu(image, nbins: int = 256) -> float:
    """skimage's threshold_otsu over ``nbins`` equal bins of [min, max]."""
    counts, edges = _histogram(image, nbins)
    centers = (edges[:-1] + edges[1:]) / 2.0
    w1 = torch.cumsum(counts, 0)
    w2 = torch.cumsum(counts.flip(0), 0).flip(0)
    m1 = torch.cumsum(counts * centers, 0) / w1
    m2 = (torch.cumsum((counts * centers).flip(0), 0) / w2.flip(0)).flip(0)
    var12 = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    var12 = torch.where(torch.isnan(var12), -math.inf, var12)
    return float(centers[int(torch.argmax(var12))])


def is_cells(image, microscope_high_int: float, threshold_mask=0.3) -> bool:
    """The float16 sigmoid foreground classifier (centre 400, crossover 20)
    and the fore/back mean comparison."""
    z = (image.to(torch.float16) - 400.0) / 20.0
    frac = 1 / (1 + torch.exp(-z))
    cell = frac > threshold_mask
    x = image.to(torch.float64)
    fg = float(x[cell].mean()) if bool(cell.any()) else 0.0
    bg = float(x[~cell].mean()) if bool((~cell).any()) else 0.0
    return bool(fg > bg and fg > microscope_high_int)


def _notch_gain(n: int, sigma: float, device):
    k = torch.arange(n, dtype=torch.float64, device=device)
    return 1.0 - torch.exp(-(k ** 2) / (2.0 * sigma ** 2))


def _row_median(x):
    """``np.median(x, axis=-1, keepdims=True)``: the middle of each sorted
    row, or the mean of the two middle values of an even row."""
    s = x.sort(dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2:n // 2 + 1]
    return (s[..., n // 2 - 1:n // 2] + s[..., n // 2:n // 2 + 1]) / 2


def _filter_band(ch, sigma_rel, max_threshold, prec):
    """One cH band: Otsu threshold of ch**2 capped by the configuration's,
    row-median inpaint of the masked coefficients, packed-FFT notch along
    the rows with sigma = rows * sigma_rel."""
    dt = _dtype(prec)
    ch_sq = ch * ch
    threshold = min(max_threshold, math.sqrt(threshold_otsu(ch_sq)))
    mask = torch.sqrt(ch_sq) > threshold
    keep = 1 - mask.to(torch.float64)  # NumPy's ``1 - mask``: int64 there
    background = ch * keep
    inpainted = background + _row_median(background) * mask
    if prec == "tf32":
        inpainted = _tf32(inpainted)
    spec = rfft_packed(inpainted)
    spec = spec * _notch_gain(spec.shape[-1], ch.shape[-2] * sigma_rel,
                              spec.device)
    filtered = irfft_packed(spec).to(dt)
    return ch * mask + filtered * keep


def _as_tensor(a, device):
    return torch.as_tensor(a, device=None if device is None else
                           torch.device(device))


def filter_plane(image, configs, prec="f64", device=None):
    """log-space wavelet-FFT filtering of one uint16 plane with each
    configuration of ``configs`` (dicts with ``sigma``, ``max_threshold``),
    from one decomposition; returns one float tensor per configuration."""
    dt = _dtype(prec)
    image = _as_tensor(image, device)
    h, w = image.shape
    img_log = torch.log(1.0 + image.to(dt))
    coeffs = wavedec2(img_log, n_levels(h, w), prec)
    del img_log
    outs = []
    for cfg in configs:
        sigma_rel = float(cfg["sigma"]) / min(h, w)
        filtered = [coeffs[0]] + [
            (_filter_band(ch, sigma_rel, float(cfg["max_threshold"]), prec),
             cv, cd) for ch, cv, cd in coeffs[1:]]
        outs.append(torch.exp(waverec2(filtered, prec)[:h, :w]) + 1.0)
    return outs


def flatfield(y, flat, dark):
    """Dark subtraction clamped at zero, division by the flat, clip to
    [0, 65535], truncating cast to uint16."""
    y = y.to(torch.float64)
    dark = _as_tensor(dark, y.device).to(torch.float64)[:y.shape[-2],
                                                        :y.shape[-1]]
    y = torch.where(y <= dark, 0.0, y - dark)
    y = torch.clip(y / _as_tensor(flat, y.device), 0, 65535)
    return y.to(torch.int32).to(torch.uint16)


def destripe_plane(image, flat, dark, cells_cfg, no_cells_cfg,
                   microscope_high_int=2500.0, prec="f64", device=None):
    """The single-band step on one plane: the classifier picks the
    configuration, then the filter and the flat-field correction. Returns a
    uint16 tensor on ``device`` (None: the image's)."""
    image = _as_tensor(image, device)
    cfg = (cells_cfg if is_cells(image, microscope_high_int)
           else no_cells_cfg)
    return flatfield(filter_plane(image, [cfg], prec)[0], flat, dark)


def box_mean(v, radius: int):
    """Edge-replicated box mean of width 2r + 1, along x and then y."""
    k = 2 * radius + 1
    for axis in (-1, -2):
        n = v.shape[axis]
        idx = torch.arange(-radius, n + radius,
                           device=v.device).clamp_(0, n - 1)
        vp = v.index_select(axis, idx)
        s = torch.zeros_like(v)
        for t in range(k):
            s = s + vp.narrow(axis, t, n)
        v = s / k
    return v


def destripe_plane_dual(image, flat, dark, fore_cfg, back_cfg,
                        crossover=100.0, radius=8, prec="f64", device=None):
    """The dual-band step on one plane: both configurations, blended by the
    smoothed sigmoid foreground fraction centred on the plane's Otsu
    threshold, then the flat-field correction. Returns a uint16 tensor."""
    dt = _dtype(prec)
    image = _as_tensor(image, device)
    fore, back = filter_plane(image, [fore_cfg, back_cfg], prec)
    x = image.to(dt)
    center = threshold_otsu(x)
    frac = 1.0 / (1.0 + torch.exp(-(x - center) / crossover))
    frac = box_mean(frac, radius)
    return flatfield(fore * frac + back * (1.0 - frac), flat, dark)
