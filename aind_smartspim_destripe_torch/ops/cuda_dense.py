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
or raises. It counts its launches in ``dense_matmul.launches``. Its
launch (the batch folded into the rows or not, the copy widths) is
:func:`plan_dense_matmul`, a pure function of the operands' shapes,
strides and alignment; :func:`copy_width` also plans
``cuda_notch.notch_select``'s loads.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .cuda_build import launch, on_cuda

__all__ = ["dense_matmul", "dense_matmul_plain", "plan_dense_matmul",
           "copy_width", "DensePlan", "KERNELS"]

_TILE = 64  # the output tile's edge in csrc/dense.cu
_GRID_MAX = 65535  # grid.y and grid.z


def copy_width(ptr: int, unit_stride: int, other_strides) -> int:
    """Floats per load along an operand's fast axis in the shared GEMM
    tile: 2 (8-byte loads) where that axis has unit stride, the operand's
    address ``ptr`` (bytes) is 8-byte aligned and every other element
    stride or offset it is read at is even, so every load is aligned; else
    1. (The path's widths are never multiples of 4 floats, so the tile has
    no 16-byte loads.)"""
    if (unit_stride == 1 and ptr % 8 == 0
            and all(s % 2 == 0 for s in other_strides)):
        return 2
    return 1


class DensePlan(NamedTuple):
    """One launch of ``destripe_dense_matmul``: ``batch`` grid planes of an
    (m, n) output over K, the operands' element strides (batch, row, k) and
    (batch, k, column), and the floats per load along a's k (``va``) and
    along b's columns (``vb``, where they have unit stride)."""

    batch: int
    m: int
    n: int
    K: int
    sa: tuple
    sb: tuple
    va: int
    vb: int


@functools.lru_cache(maxsize=1024)
def plan_dense_matmul(a_shape, a_stride, b_shape, b_stride, a_ptr: int = 0,
                      b_ptr: int = 0) -> DensePlan:
    """The launch of ``a @ b`` for operands of these shapes, element
    strides and addresses (bytes; only their alignment is read), as a pure
    function of them (cached: the step calls it with the same few forms).
    Planes ``a`` stacked evenly (``a.stride(0) == m * a.stride(1)``) by one
    operator fold into one (B*m, n) product, as cuBLAS folds them, so the
    grid's last row of tiles is padded once, not once per plane;
    ``operator @ planes`` keeps a z grid (its planes' columns are not one
    strided axis of the output). The fold changes no bit: each output is
    still one thread's k-ordered sum. Raises ValueError on shapes that do
    not multiply or exceed the kernel's grid."""
    (m, K), (K_b, n) = tuple(a_shape[-2:]), tuple(b_shape[-2:])
    batches = {s[0] for s in (a_shape, b_shape) if len(s) == 3}
    if K != K_b or len(batches) > 1:
        raise ValueError(f"cannot multiply {tuple(a_shape)} by "
                         f"{tuple(b_shape)}")
    batch = batches.pop() if batches else 1
    sa = (a_stride[0] if len(a_shape) == 3 else 0,) + tuple(a_stride[-2:])
    sb = (b_stride[0] if len(b_shape) == 3 else 0,) + tuple(b_stride[-2:])
    if len(a_shape) == 3 and len(b_shape) == 2 and sa[0] == m * sa[1]:
        batch, m, sa = 1, batch * m, (0,) + sa[1:]
    if batch > _GRID_MAX or -(-m // _TILE) > _GRID_MAX:
        raise ValueError(f"{batch} planes of {m} rows exceed the kernel's "
                         f"grid")
    va = copy_width(a_ptr, sa[2], sa[:2])
    vb = copy_width(b_ptr, sb[2], sb[:2])
    return DensePlan(batch, m, n, K, sa, sb, va, vb)


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
    p = plan_dense_matmul(a.shape, a.stride(), b.shape, b.stride(),
                          a.data_ptr() % 8, b.data_ptr() % 8)
    batch = next((t.shape[0] for t in (a, b) if t.ndim == 3), 1)
    c = torch.empty((batch, a.shape[-2], b.shape[-1]), dtype=torch.float32,
                    device=dev)
    if c.numel():
        launch("destripe_dense_matmul", dev, a.data_ptr(), b.data_ptr(),
               c.data_ptr(), p.batch, p.m, p.n, p.K, *p.sa, *p.sb, p.va,
               p.vb)
        dense_matmul.launches += 1
    return c if a.ndim == 3 or b.ndim == 3 else c[0]


KERNELS = (dense_matmul,)
for _k in KERNELS:
    _k.launches = 0
