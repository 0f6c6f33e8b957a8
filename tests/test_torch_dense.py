"""The dense levels' products of the torch package on the CPU.

``cuda_dense.dense_matmul`` takes its plain twin, ``torch.matmul``, for CPU
tensors (the kernel, which sums every entry's terms in k order at any
shape, is held against it on the card in tests/test_torch_card.py). Here:
the twin on every operand form the step gives it (a transposed operator,
a sliced one, a batch of planes on either side) against the JAX package's
einsums of the dense levels, within 1e-5 of the operands' scale (two f32
sums in other orders); and the step's output for one plane is the same
bit for bit alone and inside a larger batch, which is what the kernel's
fixed order gives the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_torch import ops as tops  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_dense as td  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402

P = jax.lax.Precision.HIGHEST
RTOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _forms():
    """(name, torch operands, the JAX einsum of the same product)."""
    x = _rand((3, 43, 53), 1)
    op_x = _rand((29, 53), 2)  # an_x_lo: (L, w), used transposed
    an_y = _rand((48, 43), 3)
    syn_y = _rand((43, 48), 4)
    up = _rand((3, 48, 29), 5)
    delta = _rand((3, 24, 29), 6)
    return {
        "planes @ operator^T": (
            (torch.from_numpy(x), torch.from_numpy(op_x).t()),
            jnp.einsum("...hw,jw->...hj", x, op_x, precision=P)),
        "operator @ planes": (
            (torch.from_numpy(an_y), torch.from_numpy(x)),
            jnp.einsum("ih,...hw->...iw", an_y, x, precision=P)),
        "sliced operator @ planes": (
            (torch.from_numpy(syn_y)[:, 24:], torch.from_numpy(delta)),
            jnp.einsum("ih,...hw->...iw", syn_y[:, 24:], delta, precision=P)),
        "operator @ stacked planes": (
            (torch.from_numpy(syn_y), torch.from_numpy(up)),
            jnp.einsum("ih,...hw->...iw", syn_y, up, precision=P)),
        "matrix @ matrix": (
            (torch.from_numpy(x[0]), torch.from_numpy(op_x).t()),
            jnp.einsum("hw,jw->hj", x[0], op_x, precision=P)),
    }


@pytest.mark.parametrize("form", list(_forms()))
def test_dense_matmul_matches_jax_einsum(form):
    (a, b), want = _forms()[form]
    tops.reset_launches()
    got = td.dense_matmul(a, b)
    assert td.dense_matmul.launches == 0  # CPU tensors take the twin
    assert torch.equal(got, td.dense_matmul_plain(a, b))
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= RTOL * scale


@pytest.mark.parametrize("plane", [0, 1])
def test_plane_output_independent_of_batch(plane):
    """One plane destriped alone equals the same plane destriped in a batch
    of four, bit for bit (dense levels only at this size)."""
    h, w = 96, 128
    cfg_c = tf.FilterConfig(wavelet="db3", sigma=64, max_threshold=3)
    cfg_n = tf.FilterConfig(wavelet="db3", sigma=128, max_threshold=12)
    plan = tf.build_plan(h, w, cfg_c, cfg_n)
    rng = np.random.default_rng(5)
    x = np.clip(300 + rng.normal(size=(4, h, 1)) * 50
                + rng.normal(size=(4, h, w)) * 10
                + np.array([0, 2800, 0, 2800])[:, None, None],
                0, 65535).astype(np.uint16)
    kw = dict(flat=np.full((h, w), 1.1, np.float32),
              dark=np.full((h, w), 3.0, np.float32))
    whole = tf.destripe_batch(plan, torch.from_numpy(x), 2500.0, **kw)
    alone = tf.destripe_batch(plan, torch.from_numpy(x[plane:plane + 1]),
                              2500.0, **kw)
    assert torch.equal(whole[plane:plane + 1], alone)
