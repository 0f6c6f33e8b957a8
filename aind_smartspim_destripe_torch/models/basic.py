"""
BaSiC shading estimation (flatfield / darkfield / baseline) in torch.

Counterpart of ``aind_smartspim_destripe_tpu/models/basic.py``, with the
same model, updates, knobs and stopping rules. Images are modelled as

    I_i(x)  =  b_i * S(x)  +  D(x)  +  R_i(x)

with a smooth multiplicative flatfield S (sparse in the DCT domain), an
optional additive darkfield D, per-image baselines b_i and sparse
residuals R_i, fitted by an inexact augmented-Lagrangian (LADMAP-style)
iteration with L1 reweighting. The fit runs on an explicit device
(``device=None``: the current CUDA device); the fitted fields are numpy.

The JAX package's library calls and what stands for them here:

- ``jax.image.resize(..., "linear")``: :func:`resize`, per-axis weight
  matrices built in numpy as ``jax.image.scale_and_translate`` builds them
  (triangle kernel widened by the shrink factor, renormalised at the
  edges), applied as two products;
- ``jax.scipy.fft.dctn`` / ``idctn`` (type 2, orthonormal): the DCT-II
  matrix of the working size on both axes, and its transpose;
- ``jnp.median(axis=0)``: :func:`..ops.filter._row_median` over the stack
  axis (the Hopper median kernel on the card), which averages the two
  middle values as ``jnp.median`` does (``torch.median`` takes the lower);
- ``jax.lax.while_loop``: a Python loop with the same test, one host read
  of the convergence measure per iteration (counted in ``host_syncs``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from ..ops.filter import _row_median
from ..parallel.mesh import one_device

__all__ = ["BaSiC", "resize", "resize_weights", "dct_matrix"]


@lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of a linear resize along one axis,
    as ``jax.image.scale_and_translate`` computes them in float32: sample
    positions ``(j + 0.5) / scale - 0.5``, the triangle kernel widened by
    ``1 / scale`` when shrinking (antialiasing), each output's weights
    renormalised to sum 1, and outputs outside the input zeroed."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.0) \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Linear resize of the last two axes of ``x`` to ``hw``, as
    ``jax.image.resize(..., method="linear")`` (antialiased); an axis whose
    size does not change is left as it is."""
    h, w = x.shape[-2:]
    if h != hw[0]:
        wh = torch.as_tensor(resize_weights(h, hw[0]), device=x.device)
        x = torch.matmul(wh.t(), x)
    if w != hw[1]:
        ww = torch.as_tensor(resize_weights(w, hw[1]), device=x.device)
        x = torch.matmul(x, ww)
    return x


@lru_cache(maxsize=8)
def dct_matrix(n: int) -> np.ndarray:
    """The orthonormal DCT-II matrix C (n, n), built in float64 and
    returned in float32: ``dctn(x, type=2, norm="ortho") = C x C^T`` and
    ``idctn(y) = C^T y C`` for an (n, n) array."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    c = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    c[0] /= np.sqrt(2.0)
    return c.astype(np.float32)


def _dct2(x, c):
    return c @ x @ c.t()


def _idct2(x, c):
    return c.t() @ x @ c


def _shrink(x, thresh):
    return torch.sign(x) * torch.clamp_min(x.abs() - thresh, 0.0)


def _norm(x):
    return torch.linalg.vector_norm(x.reshape(-1))


def _median0(x):
    """Exact median over axis 0, averaging the two middle values."""
    return _row_median(x.movedim(0, -1))[..., 0]


def _ladmap_fit(
    images,  # (n, h, w) float32, working resolution
    weight,  # (n, h, w) float32 fitting weights
    smoothness_flatfield: float,
    max_iterations: int,
    tol: float,
    c,  # the DCT-II matrix of the working size, on images' device
):
    """One inner LADMAP solve at fixed weights (multiplicative model
    ``I_i = b_i * S + R_i``; any darkfield is subtracted from ``images``
    beforehand — see :meth:`BaSiC.fit`). Returns (S, b, R, host reads):
    the loop reads its convergence measure on the host once per
    iteration."""
    n = images.shape[0]
    im_mean = images.mean(dim=0)
    norm = torch.clamp_min(_norm(images), 1e-6)
    mu = 12.5 / norm
    rho = 1.5
    mu_max = mu * 1e7

    lam_s = smoothness_flatfield * norm / 400.0

    S = im_mean / torch.clamp_min(im_mean.mean(), 1e-6)
    b = images.reshape(n, -1).mean(dim=1)
    R = torch.zeros_like(images)
    Y = torch.zeros_like(images)

    k, diff, reads = 0, float("inf"), 0
    while k < max_iterations and diff > tol:
        fit = b[:, None, None] * S[None]
        old = fit + R

        # S step: gradient of 0.5*mu*||I - fit - R + Y/mu||^2 wrt S, then
        # DCT-domain soft-threshold (sparse smooth surface)
        resid = images - fit - R + Y / mu
        b_sq = torch.sum(b * b) + 1e-6
        gS = torch.sum(b[:, None, None] * resid, dim=0) / b_sq
        S_new = _idct2(_shrink(_dct2(S + gS, c), lam_s / (mu * b_sq)), c)

        # b step: per-image least squares against S
        S_sq = torch.sum(S_new * S_new) + 1e-6
        b_new = torch.sum(S_new[None] * (images - R + Y / mu),
                          dim=(1, 2)) / S_sq

        fit = b_new[:, None, None] * S_new[None]
        # R step: pixelwise soft-threshold with the reweighting mask
        resid = images - fit + Y / mu
        R_new = _shrink(resid, weight / mu)

        Y = Y + mu * (images - fit - R_new)
        mu = torch.minimum(mu * rho, mu_max)

        diff_t = _norm(fit + R_new - old) / (_norm(old) + 1e-6)
        S, b, R = S_new, b_new, R_new
        k += 1
        diff = float(diff_t)
        reads += 1
    return S, b, R, reads


def _estimate_darkfield(images, S, b, smoothness_darkfield: float, c):
    """Darkfield from the per-pixel intercept of ``I_i(x)`` regressed
    against the per-image baselines ``b_i``, content-masked (pairs > 5 MAD
    from the per-pixel median residual dropped), DCT-smoothed, and anchored
    by the dark-floor prior ``min(D) = 0`` through the 0.99-quantile of
    ``-(intercept_smooth / S)``. Runs on the UNSORTED stack, since sorting
    destroys the (b_i, I_i(x)) pairing."""
    resid = images - b[:, None, None] * S[None]
    med = _median0(resid)
    mad = _median0(torch.abs(resid - med[None])) + 1e-3
    w = (torch.abs(resid - med[None]) < 5.0 * mad[None]).to(images.dtype)
    wsum = w.sum(dim=0) + 1e-6
    b_w = (w * b[:, None, None]).sum(dim=0) / wsum
    i_w = (w * images).sum(dim=0) / wsum
    db = b[:, None, None] - b_w[None]
    cov = (w * db * (images - i_w[None])).sum(dim=0) / wsum
    var = (w * db * db).sum(dim=0) / wsum + 1e-6
    slope = cov / var  # per-pixel ~S(x)
    intercept = i_w - slope * b_w
    smooth = _idct2(_shrink(_dct2(intercept, c), smoothness_darkfield), c)
    q = torch.quantile(-(smooth / torch.clamp_min(S, 1e-3)), 0.99)
    return torch.clamp_min(smooth + q * S, 0.0)


@dataclass
class BaSiC:
    """BaSiCPy-compatible facade; ``device`` is where the fit runs (None:
    the current CUDA device, raising without one).

    >>> model = BaSiC(get_darkfield=False, smoothness_flatfield=1.0)
    >>> model.fit(images, fitting_weight=mask)
    >>> model.flatfield, model.darkfield, model.baseline
    """

    get_darkfield: bool = False
    smoothness_flatfield: float = 1.0
    smoothness_darkfield: float = 20.0
    sort_intensity: bool = False
    max_reweight_iterations: int = 10
    max_iterations: int = 100
    working_size: int = 128
    epsilon: float = 0.1
    optimization_tol: float = 1e-4
    reweight_tol: float = 1e-3
    device: Any = None

    flatfield: Optional[np.ndarray] = field(default=None, init=False)
    darkfield: Optional[np.ndarray] = field(default=None, init=False)
    baseline: Optional[np.ndarray] = field(default=None, init=False)
    residual: Optional[np.ndarray] = field(default=None, init=False)
    # host reads of the last fit: one per LADMAP iteration and one per
    # reweighting check
    host_syncs: int = field(default=0, init=False)

    def fit(self, images, fitting_weight: Optional[np.ndarray] = None) -> "BaSiC":
        """Fit on ``images`` (n, h, w): a numpy array or a tensor, which
        stays on the fit's device when it lies there already."""
        if not isinstance(images, torch.Tensor):
            images = np.asarray(images, dtype=np.float32)
        if images.ndim != 3:
            raise ValueError(f"expected (n, h, w) images, got {tuple(images.shape)}")
        dev = one_device(self.device)
        x = torch.as_tensor(images, dtype=torch.float32, device=dev)
        n, full_h, full_w = x.shape
        ws = self.working_size
        c = torch.as_tensor(dct_matrix(ws), device=dev)
        syncs = 0

        x_small = resize(x, (ws, ws))
        if fitting_weight is not None:
            wgt = torch.as_tensor(np.asarray(fitting_weight, np.float32),
                                  device=dev)
            if wgt.ndim == 2:
                wgt = torch.broadcast_to(wgt[None], x.shape)
            w_small = resize(wgt, (ws, ws))
        else:
            w_small = torch.ones((n, ws, ws), dtype=torch.float32, device=dev)
        del x

        # Darkfield (two-stage): a quick stage-1 solve on the UNSORTED
        # stack gives per-image baselines b, the dark follows by per-pixel
        # regression against b, then the main reweighted fit runs on the
        # dark-subtracted stack.
        if self.get_darkfield:
            S1, b1, _, reads = _ladmap_fit(
                x_small, w_small, float(self.smoothness_flatfield),
                int(self.max_iterations), float(self.optimization_tol), c)
            syncs += reads
            D = _estimate_darkfield(x_small, S1, b1,
                                    float(self.smoothness_darkfield), c)
            x_work = x_small - D[None]
        else:
            D = torch.zeros((ws, ws), dtype=torch.float32, device=dev)
            x_work = x_small

        if self.sort_intensity:
            # sort each pixel's stack across images: shading structure
            # stays, content decorrelates
            x_work = torch.sort(x_work, dim=0).values

        weight = w_small
        S = b = R = None
        last_S = None
        for _ in range(max(1, int(self.max_reweight_iterations))):
            S, b, R, reads = _ladmap_fit(
                x_work, weight, float(self.smoothness_flatfield),
                int(self.max_iterations), float(self.optimization_tol), c)
            syncs += reads
            # L1 reweighting on the residual
            w_new = torch.ones_like(R) / (
                torch.abs(R) / (torch.mean(torch.abs(x_work)) + 1e-6)
                + self.epsilon)
            weight = w_new * w_small
            weight = weight * (weight.numel() / torch.sum(weight))
            if last_S is not None:
                rel = float(_norm(S - last_S) / (_norm(last_S) + 1e-6))
                syncs += 1
                if rel < self.reweight_tol:
                    last_S = S
                    break
            last_S = S

        S_full = resize(S, (full_h, full_w))
        S_full = S_full / torch.clamp_min(torch.mean(S_full), 1e-6)
        D_full = resize(D, (full_h, full_w))

        self.flatfield = S_full.cpu().numpy()
        self.darkfield = D_full.cpu().numpy()
        self.baseline = b.cpu().numpy()
        self.residual = R.cpu().numpy()
        self.host_syncs = syncs
        return self

    def transform(self, images, timelapse: bool = False) -> np.ndarray:
        """Correct images with the fitted fields: ``(I - D) / S`` (host);
        with ``timelapse=True`` also subtract the per-image baseline."""
        if self.flatfield is None:
            raise RuntimeError("call fit() first")
        images = np.asarray(images, np.float32)
        out = (images - self.darkfield[None]) / np.maximum(
            self.flatfield[None], 1e-6
        )
        if timelapse:
            if self.sort_intensity:
                # the fit ran on the per-pixel-SORTED stack, so baseline[i]
                # belongs to rank i, not to images[i]
                raise ValueError(
                    "timelapse transform is incompatible with "
                    "sort_intensity=True: the per-image baselines were fit "
                    "on the sorted stack and no longer pair with the inputs"
                )
            if images.shape[0] != self.baseline.shape[0]:
                raise ValueError(
                    f"timelapse transform needs one baseline per image: "
                    f"{images.shape[0]} images vs {self.baseline.shape[0]} baselines"
                )
            out = out - self.baseline[:, None, None]
        return out
