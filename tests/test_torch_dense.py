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


# ---------------------------------------------------------------------------
# The launch the wrappers plan for the shared GEMM tile (pure functions of
# shapes and strides; the kernels run on the card, tests/test_torch_card.py)
# ---------------------------------------------------------------------------



def _dense_products(batch):
    """(level, form, a, b) for the four products of every dense level of a
    1600x2000 plan, with the step's operand forms (views, no data)."""
    cfg = tf.FilterConfig(wavelet="db3", sigma=64, max_threshold=3)
    plan = tf.build_plan(1600, 2000, cfg, cfg)
    c = tf.device_constants(plan, "cpu")
    n = plan.n_levels
    out = []
    for lvl in range(2, n):
        h, w = plan.ladder[n - lvl]
        an_x_lo, an_y = c["an_x_lo"][lvl], c["an_y"][lvl]
        syn_y, syn_x_lo = c["syn_y"][n - 1 - lvl], c["syn_x_lo"][n - 1 - lvl]
        L = an_x_lo.shape[0]
        out += [
            (lvl, "an_x", torch.empty(batch, h, w), an_x_lo.t()),
            (lvl, "an_y", an_y, torch.empty(batch, h, L)),
            (lvl, "syn_y", syn_y, torch.empty(batch, syn_y.shape[1], L)),
            (lvl, "syn_y sliced", syn_y[:, syn_y.shape[1] // 2:],
             torch.empty(batch, syn_y.shape[1] // 2, L)),
            (lvl, "syn_x", torch.empty(batch, syn_y.shape[0], L),
             syn_x_lo.t()),
        ]
    return out


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_plan_dense_matmul_on_the_dense_levels(batch):
    """Planes by one operator fold into one product of B*m rows; an
    operator by planes keeps a grid plane per plane; the strides reach the
    same elements as the views."""
    for lvl, form, a, b in _dense_products(batch):
        p = td.plan_dense_matmul(a.shape, a.stride(), b.shape, b.stride())
        m, K = a.shape[-2:]
        n = b.shape[-1]
        assert (p.n, p.K) == (n, K), (lvl, form)
        assert p.sb == ((b.stride(0) if b.ndim == 3 else 0),) + b.stride()[-2:]
        if a.ndim == 3:  # planes @ operator^T: folded
            assert (p.batch, p.m) == (1, batch * m), (lvl, form)
            assert p.sa == (0,) + a.stride()[-2:]
        else:
            assert (p.batch, p.m) == (batch, m), (lvl, form)
            assert p.sa == (0,) + a.stride()
        # 8-byte loads along a's rows and b's columns where they are even
        assert p.va == (2 if p.sa[2] == 1 and p.sa[0] % 2 == 0
                        and p.sa[1] % 2 == 0 else 1), (lvl, form)
        assert p.vb == (2 if p.sb[2] == 1 and p.sb[0] % 2 == 0
                        and p.sb[1] % 2 == 0 else 1), (lvl, form)


def test_plan_dense_matmul_keeps_unevenly_stacked_planes():
    """Planes that are not stacked evenly (a slice of each plane's rows)
    keep their grid plane each; a single matrix is one plane."""
    x = torch.empty(4, 50, 30)
    op = torch.empty(20, 30).t()
    a = x[:, :40]
    p = td.plan_dense_matmul(a.shape, a.stride(), op.shape, op.stride())
    assert (p.batch, p.m, p.sa) == (4, 40, (1500, 30, 1))
    p = td.plan_dense_matmul(x[0].shape, x[0].stride(), op.shape,
                             op.stride())
    assert (p.batch, p.m, p.sa) == (1, 50, (0, 30, 1))
    with pytest.raises(ValueError, match="cannot multiply"):
        td.plan_dense_matmul((4, 50, 30), x.stride(), (29, 20), (20, 1))
    with pytest.raises(ValueError, match="cannot multiply"):
        td.plan_dense_matmul((4, 50, 30), x.stride(), (3, 30, 20),
                             (600, 20, 1))


def _strides(shape):
    """Row-major element strides of ``shape``."""
    out, step = [], 1
    for d in reversed(shape):
        out.insert(0, step)
        step *= d
    return tuple(out)


@pytest.mark.parametrize("a_shape,b_shape,fits", [
    ((64, 403, 503), (503, 254), True),
    ((65535 * 64, 1), (1, 1), True),
    ((65535 * 64 + 1, 1), (1, 1), False),
    ((2, 65535 * 32, 1), (1, 1), True),
    ((2, 65535 * 32 + 1, 1), (1, 1), False),
    ((408, 403), (65535, 403, 254), True),
    ((408, 403), (65536, 403, 254), False)], ids=str)
def test_plan_dense_matmul_grid_limit(a_shape, b_shape, fits):
    """The 64-row tiles of the rows, folded planes' rows counted together,
    and the grid planes each stay within the kernel's 65535 grid rows."""
    sa, sb = _strides(a_shape), _strides(b_shape)
    if fits:
        p = td.plan_dense_matmul(a_shape, sa, b_shape, sb)
        assert -(-p.m // 64) <= 65535 and p.batch <= 65535
    else:
        with pytest.raises(ValueError, match="grid"):
            td.plan_dense_matmul(a_shape, sa, b_shape, sb)


@pytest.mark.parametrize("shape", [(1, 4097, 9002), (1, 2050, 4503),
                                   (1, 2049, 9002), (1, 1025, 4503),
                                   (3, 259, 1026)], ids=str)
def test_plan_notch_select_on_halo_shards(shape):
    """The notch product's launch at the row-sharded route's level-0 and
    level-1 shard shapes (16384x18000 on two and on four entries): 8-byte
    loads where w is even (the bank's no-cells operator starts w columns
    in) and both bases are 8-byte aligned, else 4-byte."""
    from aind_smartspim_destripe_torch.ops import cuda_notch as tn

    B, h, w = shape
    assert tn.plan_notch_select(B, h, w) == (2 if w % 2 == 0 else 1)
    assert tn.plan_notch_select(B, h, w, x_ptr=4) == 1
    assert tn.plan_notch_select(B, h, w, bank_ptr=12) == 1
    with pytest.raises(ValueError, match="grid"):
        tn.plan_notch_select(65536, h, w)


@pytest.mark.parametrize("ptr,unit,others,want", [
    (0, 1, (9002, 4097 * 9002), 2), (0, 1, (4503,), 1), (4, 1, (254,), 1),
    (8, 1, (254, 0), 2), (0, 503, (1,), 1), (0, 1, (18004, 9002), 2),
    (0, 1, (9006, 4503), 1)], ids=str)
def test_copy_width(ptr, unit, others, want):
    """8-byte loads only along a unit-stride axis whose every load is
    8-byte aligned."""
    assert td.copy_width(ptr, unit, others) == want


def test_kernel_library_digest_covers_every_include():
    """Every local header a CUDA source includes is among the files the
    kernel library's name is keyed by, so an edited header rebuilds it."""
    import re

    from aind_smartspim_destripe_torch.ops import cuda_build

    keyed = set(cuda_build.digest_inputs())
    assert set(cuda_build.SOURCES) <= keyed
    found = 0
    for src in cuda_build.SOURCES:
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                               src.read_text(), flags=re.M):
            assert (src.parent / name).resolve() in keyed, (src.name, name)
            found += 1
    assert found >= 2  # notch.cu and dense.cu include gemm_f32.cuh
