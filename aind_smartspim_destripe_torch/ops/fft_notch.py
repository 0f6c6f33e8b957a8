"""
Gaussian-notch row filter, as a dense operator (numpy) and spectrally.

Counterpart of ``aind_smartspim_destripe_tpu/ops/fft_notch.py``. The
reference multiplies the *packed* FFTPACK rfft output by a 1-D Gaussian
notch, so frequency k's real part takes gain ``g[2k-1]`` and its imaginary
part ``g[2k]``. rfft -> per-bin gains -> irfft is a fixed real linear map
of each row; :func:`packed_notch_matrix` builds it exactly in float64, and
the destripe step applies it as one matrix product (its operands side by
side, :func:`notch_cat`; built on the card past :data:`NOTCH_HOST_MAX_W`
columns, from one transform of the identity for both configurations).
At widths where that (w, w) matrix is too large to build, the row-sharded
route applies the same map with :func:`apply_notch_fft` (``torch.fft``;
cuFFT on the card), at O(w) operator bytes.

The operator minus the identity has exact rank ``r``, the number of packed
positions whose float64 gain is not 1.0 (:func:`notch_rank`; the gain is
1.0 past ~8.6 sigma): :func:`notch_factors` gives it as the product of the
packed analysis rows of those positions and their synthesis rows scaled by
``g - 1`` (:class:`NotchFactors`). Where ``r`` is small against the width
(:func:`lowrank_pays`), the plane step applies the notch as those two
products instead of the (w, w) one: the same map, with the terms whose
gain is exactly 1.0 left out.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .wavelets import f32_matmul

__all__ = ["notch", "gaussian_filter", "packed_notch_matrix", "notch_cat",
           "NOTCH_HOST_MAX_W", "apply_notch", "apply_notch_fft", "notch_rank",
           "lowrank_pays", "NotchFactors", "notch_factors"]

# Widths up to which notch_cat builds on the host (numpy's FFT of the
# identity, once per configuration: a fraction of a second at 2000 columns,
# 13 s at 9002, whose factor 643 is prime). Wider operators are built on a
# CUDA device.
NOTCH_HOST_MAX_W = 2048


def notch(n: int, sigma: float) -> np.ndarray:
    """1-D Gaussian notch ``1 - exp(-x^2 / (2 sigma^2))`` of length n."""
    if n <= 0:
        raise ValueError("n must be positive")
    n = int(n)
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    x = np.arange(n)
    return 1.0 - np.exp(-(x**2) / (2.0 * sigma**2))


def gaussian_filter(shape: tuple, sigma: float) -> np.ndarray:
    """Broadcast the notch over ``shape``."""
    g = notch(n=shape[-1], sigma=sigma)
    return np.broadcast_to(g, shape).copy()


def _packed_gains(n: int, g: np.ndarray):
    """Per-frequency (real, imag) gains of the packed-layout vector ``g``
    for the complex rfft layout of length n//2 + 1."""
    nfreq = n // 2 + 1
    a = np.zeros(nfreq)
    b = np.zeros(nfreq)
    a[0] = g[0]
    b[0] = g[0]
    for k in range(1, (n + 1) // 2):
        a[k] = g[2 * k - 1]
        b[k] = g[2 * k]
    if n % 2 == 0:
        a[n // 2] = g[n - 1]
        b[n // 2] = g[n - 1]
    return a, b


@lru_cache(maxsize=None)
def packed_notch_matrix(n: int, sigma: float) -> np.ndarray:
    """The n x n operator B with ``x @ B.T`` equal to
    ``fftpack.irfft(fftpack.rfft(x) * notch(n, sigma))`` on each row."""
    g = notch(n, float(sigma))
    a, b = _packed_gains(n, g)
    spec = np.fft.rfft(np.eye(n), axis=-1)
    spec = a * spec.real + 1j * (b * spec.imag)
    basis = np.fft.irfft(spec, n=n, axis=-1)
    return np.ascontiguousarray(basis.T)


def notch_cat(n: int, sigmas, device=None):
    """The notch operators of ``sigmas`` at width ``n``, transposed and
    side by side: (n, len(sigmas) n) float32, so that ``rows @ cat`` holds
    every configuration's notched rows (the destripe step's
    ``notch_cat``).

    Up to :data:`NOTCH_HOST_MAX_W` columns, or for any device but a CUDA
    one, a numpy array of :func:`packed_notch_matrix`'s operators. Wider,
    for a CUDA ``device``, a tensor built there by cuFFT in float64 from
    one transform of the identity for every sigma, cast to float32 once:
    it rounds apart from numpy's FFT, within a float32 ulp of the host's
    operator (of ``max(|entry|, 2^-20)``)."""
    sigmas = tuple(float(s) for s in sigmas)
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda" and n > NOTCH_HOST_MAX_W:
        return _notch_cat_torch(n, sigmas, device)
    return np.concatenate([packed_notch_matrix(n, s).astype(np.float32).T
                           for s in sigmas], axis=1)


def _notch_cat_torch(n: int, sigmas: tuple, device) -> torch.Tensor:
    """:func:`notch_cat` by ``torch.fft`` in float64 on ``device``."""
    spec = torch.fft.rfft(torch.eye(n, dtype=torch.float64, device=device),
                          dim=-1)
    cat = torch.empty((n, len(sigmas) * n), dtype=torch.float32,
                      device=device)
    for i, sigma in enumerate(sigmas):
        a, b = (torch.as_tensor(g, device=device)
                for g in _packed_gains(n, notch(n, sigma)))
        cat[:, i * n:(i + 1) * n] = torch.fft.irfft(
            torch.complex(a * spec.real, b * spec.imag), n=n, dim=-1)
    return cat


@lru_cache(maxsize=64)
def _gains(n: int, sigma: float, device: torch.device):
    """The (real, imag) packed gains of length n // 2 + 1 as float32
    tensors on ``device``, made once per width, sigma and device."""
    a, b = _packed_gains(n, notch(n, sigma))
    return (torch.as_tensor(a, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device))


def apply_notch(rows: torch.Tensor, bmat) -> torch.Tensor:
    """A precomputed notch operator (:func:`packed_notch_matrix`, numpy or
    a tensor) on the last axis of ``rows``: ``rows @ bmat.T`` in float32."""
    f32_matmul()
    bmat = torch.as_tensor(bmat, dtype=rows.dtype, device=rows.device)
    return torch.matmul(rows, bmat.t())


def apply_notch_fft(rows: torch.Tensor, sigma: float) -> torch.Tensor:
    """The packed-gain spectral map of :func:`packed_notch_matrix` on the
    last axis of float32 ``rows``, by rfft and irfft: O(n log n) work and
    O(n) operator bytes, where the matrix is O(n^2) both ways."""
    n = rows.shape[-1]
    a, b = _gains(n, float(sigma), rows.device)
    spec = torch.fft.rfft(rows, dim=-1)
    spec = torch.complex(a * spec.real, b * spec.imag)
    return torch.fft.irfft(spec, n=n, dim=-1).to(rows.dtype)


def notch_rank(n: int, sigma: float) -> int:
    """The rank of ``packed_notch_matrix(n, sigma) - I``: the packed
    positions whose float64 gain is not 1.0. The gain grows with the
    position, so they are the first ``r``."""
    return int(np.count_nonzero(notch(n, float(sigma)) != 1.0))


def lowrank_pays(n: int, sigmas) -> bool:
    """Does a level of width ``n`` with these notch sigmas apply its notch
    as the factors (:func:`notch_factors`: two products, 4 h n r operations
    a plane at rank r) rather than the (n, n) operators (2 h n^2)? Where
    ``2 max(r) <= n / 2``: below both crossovers that
    ``scripts/kernel_ab.py`` measures on an H100 (the two routes tie at
    2 r / n = 1.11 on even widths; odd widths run the factors at ~0.64 of
    the dense kernel's FLOP rate, so they tie near 0.64)."""
    return 4 * max(notch_rank(n, s) for s in sigmas) <= n


class NotchFactors(NamedTuple):
    """A level's notch as the factors of its operators minus the identity
    (:func:`notch_factors`), the plane step's entry for the level in place
    of the dense bank."""
    p: object  # (n, rp) packed analysis rows: an array or a tensor
    ds: object  # (len(sigmas) rp, n) synthesis rows times g - 1
    ranks: Tuple[int, ...]  # each configuration's rank, host ints


def notch_factors(n: int, sigmas, dtype=np.float32) -> NotchFactors:
    """The factors of each notch operator minus the identity, for the
    sigmas of one level: ``NotchFactors(p, ds, ranks)`` with ``ranks[c] =
    notch_rank(n, sigmas[c])``, ``p`` (n, rp) the packed analysis rows of
    the first ``rp`` positions (``rp``: the largest rank rounded up to a
    multiple of 4; column x maps a row to its packed FFTPACK coefficient
    x) and ``ds`` (len(sigmas) rp, n), whose rows ``c rp + x`` for
    ``x < ranks[c]`` are position x's synthesis row (``irfft`` of a unit
    coefficient there) times ``g_c[x] - 1``, and zero past ``ranks[c]``.
    So ``rows @ p @ ds[c rp:(c + 1) rp]`` is the notch of configuration c
    minus ``rows``: ``p @ ds[c rp:(c + 1) rp] ==
    packed_notch_matrix(n, sigmas[c]).T - I``. Built in float64 from the
    angles reduced mod n, cast to ``dtype`` once."""
    sigmas = tuple(float(s) for s in sigmas)
    ranks = tuple(notch_rank(n, s) for s in sigmas)
    rp = -(-max(ranks) // 4) * 4
    # pt = p.T: frequency k's real part at position 2k - 1, its imaginary
    # part at 2k, element j at the angle 2 pi m / n, m = j k reduced mod n
    m = np.outer(np.arange(1, rp // 2 + 1), np.arange(n)) % n
    theta = 2.0 * np.pi * np.arange(n) / n
    pt = np.empty((rp, n))
    pt[0] = 1.0
    pt[1::2] = np.cos(theta)[m]
    pt[2::2] = -np.sin(theta)[m[:-1]]
    pt[n:] = 0.0  # positions past the width (rp > n only where n < 4)
    # synthesis weights: 1/n for the DC and Nyquist terms, 2/n for the rest
    scale = np.full(rp, 2.0 / n)
    scale[0] = 1.0 / n
    if n % 2 == 0 and n - 1 < rp:  # the Nyquist term, position n - 1
        scale[n - 1] = 1.0 / n
    ds = np.zeros((len(sigmas) * rp, n), dtype=dtype)
    for c, (s, r) in enumerate(zip(sigmas, ranks)):
        g = notch(n, s)[:r]
        ds[c * rp:c * rp + r] = ((g - 1.0) * scale[:r])[:, None] * pt[:r]
    return NotchFactors(np.ascontiguousarray(pt.T, dtype=dtype), ds, ranks)
