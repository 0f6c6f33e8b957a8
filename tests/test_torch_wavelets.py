"""The port's public wavelet transform API on the CPU, against the JAX
package's.

``ops/wavelets.py`` ``dwt2`` / ``idwt2`` (blocked and dense forms),
``dwt2_conv`` / ``idwt2_conv``, ``wavedec2`` / ``waverec2`` (with pywt's
crop-by-one rule), ``ops/fft_notch.apply_notch`` and the Y-sharded level
of ``parallel/halo.py`` (``banded_apply_y_sharded``, ``dwt2_y_sharded``,
``idwt2_y_sharded`` on ``[cpu] * 8``, the JAX package's on the 8 virtual
CPU devices), at tests/test_wavelets.py's and tests/test_halo_sharding.py's
shapes. Tolerances, of the input's largest magnitude: 1e-5 for one level
and 1e-4 for a full ``wavedec2`` / ``waverec2``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import fft_notch as jn  # noqa: E402
from aind_smartspim_destripe_tpu.ops import wavelets as JW  # noqa: E402
from aind_smartspim_destripe_tpu.parallel import halo as jh  # noqa: E402
from aind_smartspim_destripe_tpu.parallel.mesh import make_mesh  # noqa: E402
from aind_smartspim_destripe_torch.ops import fft_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import wavelets as TW  # noqa: E402
from aind_smartspim_destripe_torch.parallel import halo as th  # noqa: E402

LEVEL_TOL = 1e-5  # one level, of the input's largest magnitude
FULL_TOL = 1e-4  # a full wavedec2 / waverec2
CPU8 = [torch.device("cpu")] * 8
SHAPES = [(16, 16), (13, 17), (45, 77), (64, 100), (130, 258)]


def _bands(c):
    return (c[0],) + tuple(c[1])


def _close(got, want, scale, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(8)


@pytest.mark.parametrize("name", ["db1", "db2", "db3", "db4"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dwt2_idwt2_match_jax(name, shape):
    """One level, blocked and dense, against the JAX blocked level."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    scale = np.abs(x).max()
    jw, tw = JW.wavelet(name), TW.wavelet(name)
    want = _bands(JW.dwt2(jnp.asarray(x), jw))
    dense = (TW.analysis_operator(shape[0], name),
             TW.analysis_operator(shape[1], name))
    for ops in (None, dense):
        for g, w in zip(_bands(TW.dwt2(torch.from_numpy(x), tw, ops)), want):
            _close(g, w, scale, LEVEL_TOL)
    c = [torch.from_numpy(np.array(b)) for b in want]
    y_want = JW.idwt2(want[0], want[1:], jw)
    syn = (TW.synthesis_operator(c[0].shape[-2], name),
           TW.synthesis_operator(c[0].shape[-1], name))
    for ops in (None, syn):
        _close(TW.idwt2(c[0], tuple(c[1:]), tw, ops), y_want, scale,
               LEVEL_TOL)


@pytest.mark.parametrize("name", ["db1", "db3"])
@pytest.mark.parametrize("shape", [(45, 77), (16, 16), (13, 17)])
def test_conv_forms_match_jax(name, shape):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    scale = np.abs(x).max()
    jw, tw = JW.wavelet(name), TW.wavelet(name)
    want = _bands(JW.dwt2_conv(jnp.asarray(x), jw))
    got = _bands(TW.dwt2_conv(torch.from_numpy(x), tw))
    for g, w in zip(got, want):
        _close(g, w, scale, LEVEL_TOL)
    y = TW.idwt2_conv(got[0], got[1:], tw)
    _close(y, JW.idwt2_conv(want[0], want[1:], jw), scale, LEVEL_TOL)
    # and the convolution forms against the product forms
    for g, w in zip(got, _bands(TW.dwt2(torch.from_numpy(x), tw))):
        _close(g, w.numpy(), scale, LEVEL_TOL)
    _close(y, TW.idwt2(got[0], got[1:], tw).numpy(), scale, LEVEL_TOL)


@pytest.mark.parametrize("dense", [False, True], ids=["blocked", "dense"])
@pytest.mark.parametrize("name,shape,level", [
    ("db3", (3, 41, 57), None), ("db3", (45, 77), 2), ("db2", (37, 53), None),
    ("db1", (100, 100), None)])
def test_wavedec2_waverec2_match_jax(name, shape, level, dense):
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    scale = np.abs(x).max()
    jw, tw = JW.wavelet(name), TW.wavelet(name)
    hw = shape[-2:]
    an = TW.analysis_operators(hw, tw, level) if dense else None
    syn = TW.synthesis_operators(hw, tw, level) if dense else None
    want = JW.wavedec2(jnp.asarray(x), jw, level)
    got = TW.wavedec2(torch.from_numpy(x), tw, level, operators=an)
    assert len(got) == len(want)
    _close(got[0], want[0], scale, FULL_TOL)
    for g_det, w_det in zip(got[1:], want[1:]):
        for g, w in zip(g_det, w_det):
            _close(g, w, scale, FULL_TOL)
    rec = TW.waverec2(got, tw, operators=syn)
    _close(rec, JW.waverec2(want, jw, JW.synthesis_operators(
        hw, jw, level) if dense else None), scale, FULL_TOL)
    # perfect reconstruction (the trimmed dense operators crop to x)
    _close(rec[..., :hw[0], :hw[1]], x, scale, FULL_TOL)


def test_waverec2_rejects_inconsistent_shapes():
    tw = TW.wavelet("db3")
    coeffs = TW.wavedec2(torch.zeros((45, 77)), tw, level=2)
    coeffs[0] = torch.zeros((coeffs[0].shape[0] + 2, coeffs[0].shape[1]))
    with pytest.raises(ValueError, match="inconsistent"):
        TW.waverec2(coeffs, tw)


def test_apply_notch_matches_jax():
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(3, 7, 60)).astype(np.float32)
    bmat = tn.packed_notch_matrix(60, 9.0).astype(np.float32)
    np.testing.assert_array_equal(bmat, jn.packed_notch_matrix(60, 9.0)
                                  .astype(np.float32))
    want = jn.apply_notch(jnp.asarray(rows), jnp.asarray(bmat))
    _close(tn.apply_notch(torch.from_numpy(rows), bmat), want,
           np.abs(rows).max(), LEVEL_TOL)
    np.testing.assert_allclose(
        tn.apply_notch(torch.from_numpy(rows), bmat).numpy(),
        tn.apply_notch_fft(torch.from_numpy(rows), 9.0).numpy(), atol=1e-5)


@pytest.mark.parametrize("H", [64, 70])  # divisible and ragged row counts
def test_banded_apply_y_sharded_matches_jax(jmesh, H):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H, 40)).astype(np.float32)
    A = TW.analysis_operator(H, "db3")
    L = A.shape[0] // 2
    for OP in (A[:L], A[L:]):
        got = th.banded_apply_y_sharded(torch.from_numpy(x), OP, CPU8)
        assert isinstance(got, th.RowShards)
        want = jh.banded_apply_y_sharded(jnp.asarray(x), OP, jmesh, "z")
        _close(got.gather("cpu"), want, np.abs(x).max(), LEVEL_TOL)


def test_banded_apply_rejects_too_many_shards():
    A = TW.analysis_operator(16, "db3")
    with pytest.raises(ValueError, match="halo"):
        th.banded_apply_y_sharded(torch.zeros((1, 16, 8)),
                                  A[: A.shape[0] // 2], CPU8)


def test_dwt2_idwt2_y_sharded_match_jax(jmesh):
    rng = np.random.default_rng(2)
    # the synthesis halo must fit in one coefficient shard: 160 rows
    x = rng.normal(size=(2, 160, 48)).astype(np.float32) * 10
    scale = np.abs(x).max()
    ca, det = th.dwt2_y_sharded(torch.from_numpy(x), "db3", CPU8)
    jca, jdet = jh.dwt2_y_sharded(jnp.asarray(x), "db3", jmesh, "z")
    plain = _bands(TW.dwt2(torch.from_numpy(x), TW.wavelet("db3")))
    for g, w, p in zip((ca,) + det, (jca,) + jdet, plain):
        _close(g.gather("cpu"), w, scale, LEVEL_TOL)
        _close(g.gather("cpu"), p.numpy(), scale, LEVEL_TOL)
    rec = th.idwt2_y_sharded(ca, det, "db3", CPU8, out_shape=(160, 48))
    want = jh.idwt2_y_sharded(jca, jdet, "db3", jmesh, "z",
                              out_shape=(160, 48))
    _close(rec.gather("cpu"), want, scale, LEVEL_TOL)
    _close(rec.gather("cpu"), x, scale, LEVEL_TOL)
    # gathered tensors in give the same rows
    again = th.idwt2_y_sharded(ca.gather("cpu"), tuple(
        d.gather("cpu") for d in det), "db3", CPU8, out_shape=(160, 48))
    _close(again.gather("cpu"), rec.gather("cpu").numpy(), scale, LEVEL_TOL)
