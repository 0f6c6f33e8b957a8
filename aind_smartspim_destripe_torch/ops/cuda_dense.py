"""
The matrix products of the destripe step's dense wavelet levels: the
wrapper of the Hopper kernel in ``csrc/dense.cu`` and its plain PyTorch
twin.

The JAX package runs these products as XLA einsums
(``aind_smartspim_destripe_tpu/ops/filter.py``), not as a Pallas kernel.
On the card they run in a kernel of their own for the order of their sums:
cuBLAS picks its kernel, and with it the order in which an entry's terms
are added, by the problem's shape, so one plane's dense-level coefficients
(and the Otsu and stripe-mask decisions taken on them) came out otherwise
in a batch of one plane than in a batch of 64. The kernel adds every
entry's terms in k order, one FMA per term from 0, at any shape: a plane
gives the same bits in any batch.

:func:`dense_matmul` dispatches on the device of ``a``: a CPU tensor takes
the plain twin (``torch.matmul``, also callable as
:func:`dense_matmul_plain` on any device), a CUDA tensor launches the kernel
or raises. It counts its launches in ``dense_matmul.launches``.
"""

from __future__ import annotations

import torch

from .cuda_build import launch, on_cuda

__all__ = ["dense_matmul", "dense_matmul_plain", "KERNELS"]

_BM = 128  # the kernel's output rows per block (csrc/dense.cu)
_GRID_MAX = 65535  # grid.y and grid.z


def dense_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`dense_matmul`, on any device."""
    return torch.matmul(a, b)


def dense_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32 for the forms of the dense levels: planes ``a``
    (B, m, K) by one operator ``b`` (K, n), one operator ``a`` (m, K) by
    planes ``b`` (B, K, n), planes by planes, or (m, K) @ (K, n). Either
    operand may be a strided view (a transposed or sliced operator); the
    result is contiguous, (B, m, n) or (m, n)."""
    if not on_cuda(a):
        return dense_matmul_plain(a, b)
    dev = a.device
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype} is not float32")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if t.ndim not in (2, 3):
            raise ValueError(f"{name} must be 2-D or 3-D, got "
                             f"{tuple(t.shape)}")
    (m, K), (K_b, n) = a.shape[-2:], b.shape[-2:]
    batches = {t.shape[0] for t in (a, b) if t.ndim == 3}
    if K != K_b or len(batches) > 1:
        raise ValueError(f"cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")
    batch = batches.pop() if batches else 1
    if batch > _GRID_MAX or -(-m // _BM) > _GRID_MAX:
        raise ValueError(f"{batch} planes of {m} rows exceed the kernel's "
                         f"grid")
    sa = (a.stride(0) if a.ndim == 3 else 0,) + a.stride()[-2:]
    sb = (b.stride(0) if b.ndim == 3 else 0,) + b.stride()[-2:]
    c = torch.empty((batch, m, n), dtype=torch.float32, device=dev)
    if c.numel():
        launch("destripe_dense_matmul", dev, a.data_ptr(), b.data_ptr(),
               c.data_ptr(), batch, m, n, K, *sa, *sb)
        dense_matmul.launches += 1
    return c if a.ndim == 3 or b.ndim == 3 else c[0]


KERNELS = (dense_matmul,)
for _k in KERNELS:
    _k.launches = 0
