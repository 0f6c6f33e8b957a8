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
(:func:`notch_route`), the plane step applies the notch as those two
products instead of the (w, w) one: the same map, with the terms whose
gain is exactly 1.0 left out.

Only the packed positions below ``r`` move a row, so only the frequencies
``k <= K = r // 2`` are needed. Where the rank is too large for the
factors to pay, the plane step computes those frequencies and synthesises
them back by chirp-z (Bluestein) transforms: each DFT of length n becomes
a circular convolution with a chirp, run as power-of-two FFTs of M >= n +
2K points, O(M log M) work a row in place of the (n, n) product.
:func:`notch_chirp` builds the tables it reads (:class:`NotchChirp`), and
:func:`notch_route` picks a level's route from its width and ranks.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .wavelets import f32_matmul

__all__ = ["notch", "gaussian_filter", "packed_notch_matrix", "notch_cat",
           "NOTCH_HOST_MAX_W", "apply_notch", "apply_notch_fft", "notch_rank",
           "notch_route", "chirp_size", "NotchFactors", "notch_factors",
           "NotchChirp", "notch_chirp"]

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


# The chirp-z route's bounds (csrc/notch.cu notch_fft_kernel): its FFT
# lengths (one block of M / 8 threads a pair of rows, M complex values in
# shared memory), and the least width at which it beats the dense tail.
CHIRP_M = (256, 512, 1024, 2048, 4096)
CHIRP_MIN_W = 192


def chirp_size(n: int, sigmas):
    """``(K, M)`` of the chirp-z notch at width ``n``: the highest frequency
    whose gain minus 1 is not zero in any configuration (``max(r) // 2``),
    and the least power of two ``M >= n + 2K`` (the linear convolutions
    of the analysis, outputs ``-K..K``, and of the synthesis, inputs
    ``-K..K``, must not wrap)."""
    k = max(notch_rank(n, s) for s in sigmas) // 2
    return k, 1 << (n + 2 * k - 1).bit_length()


def notch_route(n: int, sigmas) -> str:
    """How the plane step applies a level's notch, from its width ``n``
    and the ranks of its sigmas (:func:`notch_rank`), on an H100:

    - ``"lowrank"``, the factors (:func:`notch_factors`; 4 h n r operations
      a plane at rank r), where ``2 max(r) <= n / 2``: below both
      crossovers against the dense (n, n) product that
      ``scripts/kernel_ab.py`` measures (the two tie at 2 r / n = 1.11 on
      even widths; odd widths run the factors at ~0.64 of the dense
      kernel's FLOP rate, so they tie near 0.64);
    - ``"chirp"``, the chirp-z transforms (:func:`notch_chirp`), where
      ``n >= CHIRP_MIN_W`` (the crossover against the dense kernel) and
      the frequencies kept leave the Nyquist term out (``2K < n``) in an
      FFT length of :data:`CHIRP_M`;
    - ``"dense"``, the (n, n) operators, elsewhere."""
    r = max(notch_rank(n, s) for s in sigmas)
    if 4 * r <= n:
        return "lowrank"
    k, m = chirp_size(n, sigmas)
    if n >= CHIRP_MIN_W and 2 * k < n and m in CHIRP_M:
        return "chirp"
    return "dense"


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


class NotchChirp(NamedTuple):
    """A level's notch as the tables of its chirp-z transforms
    (:func:`notch_chirp`), the plane step's entry for the level in place of
    the dense bank. Complex values are (re, im) pairs on the last axis."""
    chirp: object  # (n, 2): w_j = exp(-i pi j^2 / n)
    filters: object  # (2, M, 2): the analysis and synthesis filters' FFTs
    twiddle: object  # (M, 2): exp(-2 pi i t / M)
    gains: object  # (len(sigmas), K + 1, 2): (a_k - 1, b_k - 1) / (2 n)
    k: int  # the highest frequency kept, a host int


def notch_chirp(n: int, sigmas, dtype=np.float32) -> NotchChirp:
    """The tables of the chirp-z notch tail at width ``n`` for the sigmas of
    one level (``(K, M) = chirp_size(n, sigmas)``), built in float64 and
    cast to ``dtype`` once. With ``w_j = exp(-i pi j^2 / n)`` (the angle
    reduced exactly as the integer ``j^2 mod 2n``) and ``jk = (j^2 + k^2 -
    (k - j)^2) / 2``, the DFT of a row z is ``Z_k = w_k sum_j (z_j w_j)
    conj(w_{k-j})``, a circular convolution of M points for the outputs
    ``k = -K..K``: ``filters[0]`` is the FFT of ``conj(w_m)`` at the lags
    ``m = -(n - 1) - K..K`` (zero at the other residues of M), over M. The
    synthesis ``y_j = sum_k E_k exp(2 pi i jk / n)``, ``k = -K..K``, is
    ``conj(w_j) sum_k (E_k conj(w_k)) w_{j-k}``: ``filters[1]`` is the FFT of
    ``w_m`` at ``m = -K..n - 1 + K``, over M. ``gains[c, k]`` are the
    packed gains minus 1 of frequency k's real and imaginary parts (packed
    positions ``2k - 1`` and ``2k``; the DC term's at position 0) of
    configuration c, over 2n: the halves of splitting two rows' spectra
    from one complex sequence, and irfft's 1/n. ``twiddle`` holds the M
    roots of unity of the FFTs."""
    sigmas = tuple(float(s) for s in sigmas)
    k, m = chirp_size(n, sigmas)
    if 2 * k >= n:
        raise ValueError(f"the kept frequencies 0..{k} reach the Nyquist "
                         f"term of width {n}")

    def chirp(lags):
        return np.exp(-1j * np.pi * (lags.astype(np.int64) ** 2 % (2 * n)) / n)

    def filt(lags, values):
        f = np.zeros(m, complex)
        f[lags % m] = values
        return np.fft.fft(f) / m

    an = np.arange(-(n - 1) - k, k + 1)
    syn = np.arange(-k, n + k)
    filters = np.stack([filt(an, np.conj(chirp(an))), filt(syn, chirp(syn))])
    gains = np.zeros((len(sigmas), k + 1, 2))
    for c, s in enumerate(sigmas):
        g = notch(n, s) - 1.0
        gains[c, 0] = g[0]
        gains[c, 1:, 0] = g[1:2 * k:2]
        gains[c, 1:, 1] = g[2:2 * k + 1:2]
    twiddle = np.exp(-2j * np.pi * np.arange(m) / m)

    def pairs(z):
        return np.ascontiguousarray(np.stack([z.real, z.imag], -1),
                                    dtype=dtype)

    return NotchChirp(pairs(chirp(np.arange(n))), pairs(filters),
                      pairs(twiddle), (gains / (2 * n)).astype(dtype), k)
