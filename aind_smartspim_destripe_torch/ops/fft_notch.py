"""
Gaussian-notch row filter, as a dense operator (numpy) and spectrally.

Counterpart of ``aind_smartspim_destripe_tpu/ops/fft_notch.py``. The
reference multiplies the *packed* FFTPACK rfft output by a 1-D Gaussian
notch, so frequency k's real part takes gain ``g[2k-1]`` and its imaginary
part ``g[2k]``. rfft -> per-bin gains -> irfft is a fixed real linear map
of each row; :func:`packed_notch_matrix` builds it exactly in float64, and
the destripe step applies it as one matrix product. At widths where that
(w, w) matrix is too large to build, the row-sharded route applies the same
map with :func:`apply_notch_fft` (``torch.fft``; cuFFT on the card), at
O(w) operator bytes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .wavelets import f32_matmul

__all__ = ["notch", "gaussian_filter", "packed_notch_matrix",
           "apply_notch", "apply_notch_fft"]


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
