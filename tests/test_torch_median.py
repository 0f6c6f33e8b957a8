"""The port's exact row median against the JAX package on the CPU.

``ops.filter._row_median(x)`` runs ``cuda_notch.row_median_batch`` on a
float32 tensor (on a CPU tensor: its plain twin, the sort), and
``cuda_notch.row_median`` is the sort; both are held exactly (``assert_array_equal``, which compares by value, so
-0.0 equals +0.0 and NaN equals NaN) against the JAX
``pallas_median.row_median_batch`` in interpret mode, the TPU kernel itself,
and against JAX ``_row_median(x, pallas=False)``, on every shape the
kernel's reshape handles (1-D, 2-D, N-D, n = 1 and 2, ragged n) and on
rows with duplicates, signed zeros, infinities and NaN. Any other dtype
takes the sort on both sides.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_median as pm  # noqa: E402
from aind_smartspim_destripe_tpu.ops.pallas_median import (  # noqa: E402
    row_median_batch as jax_row_median_batch,
)
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402

SHAPES = [(7,), (5, 8), (3, 17, 33), (2, 3, 9, 10), (4, 1), (4, 2),
          (2, 10, 1002)]


def _jax_kernel(x):
    return np.asarray(jax_row_median_batch(jnp.asarray(x), interpret=True))


def _check(x):
    """Both forms of the port against the kernel and the sort of JAX."""
    t = torch.from_numpy(x)
    want_kernel = _jax_kernel(x)
    want_sort = np.asarray(jf._row_median(jnp.asarray(x), pallas=False))
    got = tf._row_median(t).numpy()
    got_sort = tn.row_median(t).numpy()
    assert got.shape == want_kernel.shape == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_sort)
    np.testing.assert_array_equal(got_sort, want_sort)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_row_median_matches_jax(shape, scale):
    rng = np.random.default_rng(abs(hash((shape, scale))) % 2**31)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x[..., 0] *= -1  # mixed signs
    _check(x)


def test_row_median_value_classes():
    """Duplicates, +-0, +-inf and NaN (above +inf) in odd and even rows."""
    inf, nan = np.inf, np.nan
    x = np.array([
        [0.0, -0.0, 1.0, 1.0, -2.0, 0.0],
        [3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
        [-0.0, -0.0, 0.0, 0.0, -0.0, 0.0],
        [inf, -inf, 1.0, 2.0, inf, -inf],
        [inf, inf, inf, 5.0, -1.0, inf],
        [-inf, -inf, -inf, -inf, 2.0, 1.0],
        [nan, 1.0, 2.0, 3.0, 4.0, 5.0],
        [nan, nan, nan, nan, 1.0, 2.0],
        [nan, inf, 7.0, -inf, 0.5, 0.5],
    ], np.float32)
    _check(x)
    _check(x[:, :5])  # odd rows
    assert tf._row_median(torch.from_numpy(x[6:7])).item() == 3.5


@pytest.mark.parametrize("n", [1, 2, 7, 1001, 1002])
def test_row_median_ragged_lengths(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-5, 6, size=(3, 4, n)).astype(np.float32)  # many ties
    _check(x)


@pytest.mark.parametrize("dtype", [np.float16, np.int32])
def test_non_f32_dtypes_take_the_sort(dtype, monkeypatch):
    """Another dtype sorts on both sides, through ``_row_median`` as through
    the sort itself: the port never reaches the kernel's wrapper for it."""
    def no_kernel(x):
        raise AssertionError("row_median_batch was called")

    monkeypatch.setattr(tn, "row_median_batch", no_kernel)
    x = (np.random.default_rng(3).normal(size=(3, 5, 9)) * 100).astype(dtype)
    want = np.asarray(jf._row_median(jnp.asarray(x), pallas=True))
    for median in (tf._row_median, tn.row_median):
        got = median(torch.from_numpy(x)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_row_median_batch_wrapper_twin_and_launch_count():
    """On a CPU tensor the wrapper takes its twin (the sort) and counts no
    launch; the twin is the module's exported plain form."""
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 6, 11)).astype(np.float32))
    tn.row_median_batch.launches = 0
    got = tn.row_median_batch(x)
    assert tn.row_median_batch.launches == 0
    assert torch.equal(got, tn.row_median_batch_plain(x))
    assert tn.row_median_batch_plain is tn.row_median


def test_median0_matches_jax_on_moved_stack():
    """BaSiC's darkfield median (``models.basic._median0``: the median over
    a (12, 128, 128) stack's first axis, through ``_row_median`` of its
    ``movedim`` view) and the wrapper on that view against the JAX kernel
    on the moved stack, exactly."""
    from aind_smartspim_destripe_torch.models.basic import _median0

    rng = np.random.default_rng(12)
    x = (rng.normal(size=(12, 128, 128)) * 100).astype(np.float32)
    x[:, ::3] = np.round(x[:, ::3])  # ties
    want = _jax_kernel(np.moveaxis(x, 0, -1))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(_median0(t).numpy(), want[..., 0])
    view = t.movedim(0, -1)
    assert not view.is_contiguous()
    np.testing.assert_array_equal(tn.row_median_batch(view).numpy(), want)


@pytest.mark.parametrize("n", [2, 3, 12, 31, 32, 33])
def test_short_rows_with_ties_and_signed_zeros(n):
    """Rows of up to 32 values (the kernel's register route) and just past
    it, with many ties and both signs of zero, against the JAX kernel."""
    rng = np.random.default_rng(100 + n)
    x = rng.integers(-2, 3, size=(5, 7, n)).astype(np.float32)
    x[x == 0] = rng.choice(np.array([0.0, -0.0], np.float32),
                           size=int((x == 0).sum()))
    _check(x)


_S, _ST, _L2 = tn.SHORT, tn.STAGED, tn.L2


def _moved(shape):
    return torch.empty(shape).movedim(0, -1)


@pytest.mark.parametrize("case,t,want", [
    ("basic stack moved", _moved((12, 128, 128)), (_S, 1, 16384)),
    ("basic contiguous", torch.empty((128, 128, 12)), (_S, 12, 1)),
    ("n=32", torch.empty((4, 32)), (_S, 32, 1)),
    ("n=33", torch.empty((4, 33)), (_ST, 33, 1)),
    ("n=1", torch.empty((9, 1)), (_S, 1, 1)),
    ("1-D", torch.empty((2000,)), (_ST, 2000, 1)),
    ("level 0", torch.empty((64, 802, 1002)), (_ST, 1002, 1)),
    ("4-D", torch.empty((2, 64, 802, 1002)), (_ST, 1002, 1)),
    ("stage cap", torch.empty((3, 11264)), (_ST, 11264, 1)),
    ("past the cap", torch.empty((3, 11265)), (_L2, 11265, 1)),
    ("unit axes", torch.empty((1, 5, 1, 7)), (_S, 7, 1)),
    ("strided rows", torch.empty((10, 12))[::2], (_S, 24, 1)),
    ("strided long rows", torch.empty((10, 1002))[::2], (_ST, 2004, 1)),
    ("long row moved", torch.empty((1002, 64)).t(), None),
    ("axes that do not flatten", torch.empty((4, 6, 8)).permute(1, 0, 2),
     None),
    ("short axes that do not flatten",
     torch.empty((12, 4, 6)).permute(2, 1, 0), None),
], ids=lambda v: v if isinstance(v, str) else "")
def test_median_route(case, t, want):
    """The host's choice of route and strides for the unmasked median:
    short rows by a thread each, read in place at any strides that flatten
    to one row stride; longer rows by a block each, staged up to the cap,
    read in place where their elements are adjacent; None (the wrapper
    copies) otherwise."""
    assert tn.median_route(t.shape, t.stride()) == want
    if want is None:
        c = t.contiguous()
        assert tn.median_route(c.shape, c.stride()) is not None


@pytest.mark.parametrize("n,threads", [(33, 64), (503, 64), (1002, 64),
                                       (2048, 64), (2049, 256), (9002, 256),
                                       (11264, 256), (20000, 256)])
def test_median_block_threads(n, threads):
    """Threads of a block selecting in one long row: 64 up to 2048 values,
    256 above."""
    assert tn._median_threads(n) == threads


# ---------------------------------------------------------------------------
# The masked median (cuda_notch.row_median_masked)
# ---------------------------------------------------------------------------

_W = tn.WARP


@pytest.mark.parametrize("w,want", [
    (1, (_W, 1)), (2, (_W, 1)), (12, (_W, 1)), (31, (_W, 1)), (32, (_W, 1)),
    (33, (_W, 2)), (64, (_W, 2)), (65, (_W, 4)), (129, (_W, 8)),
    (503, (_W, 16)), (1002, (_W, 32)), (1024, (_W, 32)),
    (1025, (_ST, 64)), (2048, (_ST, 64)), (9002, (_ST, 256)),
    (11264, (_ST, 256)), (11265, (_L2, 256)),
])
def test_masked_median_route(w, want):
    """The host's route for the masked median by row length: a warp per row
    (the least power-of-two keys per lane that hold the row) up to 1024
    values, a block per output row above (staged up to 11264 values, 64
    threads up to 2048 values)."""
    route, param = tn.masked_median_route(w)
    assert (route, param) == want
    if route == _W:
        assert (param // 2) * 32 < w <= param * 32


@pytest.mark.parametrize("w", [0, -3])
def test_masked_median_route_refuses_empty_rows(w):
    with pytest.raises(ValueError, match="w >= 1"):
        tn.masked_median_route(w)


@pytest.mark.parametrize("route,n_out,h", [
    (_ST, 65536, 4),  # grid.y holds 65535 output planes
    (_L2, 131072, 1),
    (_W, 5, 2**31 - 1),  # over 2**31 - 1 blocks of 4 output rows
    (_W, 1, 2**31),  # h past an int
])
def test_masked_median_grid_refusals(route, n_out, h):
    with pytest.raises(ValueError, match="grid"):
        tn._check_masked_grid(route, n_out, h)


@pytest.mark.parametrize("route,n_out,h", [
    (_ST, 65535, 4), (_W, 128, 802), (_W, 128, 11), (_L2, 2, 2**31 - 1),
    (_W, 4, 2**31 - 1),
])
def test_masked_median_grid_accepts(route, n_out, h):
    tn._check_masked_grid(route, n_out, h)


def _masked_case(w, seed):
    """Two band planes of 3 rows of w values: row 0 wholly over the
    threshold of every plane but the unmasked ones, row 1 with none
    over it, row 2 mixed with ties and both signs of zero; thresholds per
    output plane: a finite one, NaN and +inf (nothing masked), a negative
    one (everything masked)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=1.0, size=(2, 3, w)).astype(np.float32)
    x[:, 0] = rng.choice([-1.0, 1.0], size=(2, w)) * (
        5.0 + rng.random(size=(2, w)))  # over 2.0 everywhere
    x[:, 1] = rng.uniform(-0.5, 0.5, size=(2, w))  # under 2.0 everywhere
    x[:, 2] = np.round(rng.normal(scale=3.0, size=(2, w)))
    x[:, 2, ::5] = -0.0
    thr = np.array([2.0, np.nan, np.inf, -1.0], np.float32)
    return x, thr


@pytest.mark.parametrize("w", [1, 2, 31, 32, 33, 1024, 1025, 11264, 11265])
def test_row_median_masked_plain_matches_jax(w):
    """The masked median's plain twin against the JAX kernel (interpret
    mode, as test_torch_notch.py runs it) at the route edges' widths, odd
    and even, with wholly masked, unmasked and mixed rows, plain (B
    thresholds) and wrapped (2B: the dual form)."""
    x, thr = _masked_case(w, w)
    for t in (thr[:2], thr):
        got = tn.row_median_masked(torch.from_numpy(x), torch.from_numpy(t))
        xs = x if len(t) == 2 else np.concatenate([x, x])
        want = np.asarray(pm.row_median_masked(
            jnp.asarray(xs), jnp.asarray(t), interpret=True))
        assert got.shape == (len(t), 3, 1)
        np.testing.assert_array_equal(got.numpy(), want)
        plain = tn.row_median_masked_plain(torch.from_numpy(x),
                                           torch.from_numpy(t))
        np.testing.assert_array_equal(plain.numpy(), want)

