"""The port's banded/spectral x tier on the CPU, against the JAX package.

Planes at or above the dense-x gate (``DESTRIPE_BANDED_X_MIN_W``, 20067
columns by default) carry no dense x operator on the row-sharded route:
their x lowpass passes run blocked (``ops.wavelets.an_lo_pass_last``,
``syn_lo_pass_last``) or as K1/K4 per shard from band forms built from the
filter taps, and their notch as the rfft map (``ops.fft_notch.
apply_notch_fft``). Here, at small sizes with the gate forced down:

- the blocked passes and the rfft notch against the JAX package's on the
  same seeded input, at float32 tolerance (both sum the same terms in
  float32 in other orders, or through another FFT);
- the band forms built from the taps equal to those of the dense
  operators (the same start and coefficients, bit for bit);
- the banded route against the JAX package's banded route (its dense
  float32 formulation with the gate forced down, as
  tests/test_halo_sharding.py runs it) and against the port's dense route:
  within 1 LSB outside a 1e-3 flip budget and at 90 dB or more (the JAX
  package's own banded-vs-dense gate, __graft_entry__.py: a formulation
  that sums in another order can move a coefficient across an Otsu bin
  edge or the stripe threshold).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import fft_notch as jfn  # noqa: E402
from aind_smartspim_destripe_tpu.ops import wavelets as jw  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import fft_notch as tfn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.ops import wavelets as tw  # noqa: E402
from aind_smartspim_destripe_torch.parallel import halo as th_  # noqa: E402
from aind_smartspim_destripe_tpu.parallel import halo as jh  # noqa: E402
from aind_smartspim_destripe_tpu.parallel.mesh import make_mesh  # noqa: E402
from tests.test_torch_halo import _plans  # noqa: E402

CPU = torch.device("cpu")
WIDTHS = [13, 64, 561, 1200, 2001]


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n", WIDTHS)
def test_an_lo_pass_last_matches_jax(n):
    x = _rand((2, 5, n), n)
    want = np.asarray(jw.an_lo_pass_last(jnp.asarray(x), jw.wavelet("db3")))
    got = tw.an_lo_pass_last(torch.from_numpy(x), tw.wavelet("db3")).numpy()
    assert got.shape == want.shape == (2, 5, tw.dwt_coeff_len(n, 6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the dense operator it stands for
    A = tw.analysis_operator(n, "db3")
    np.testing.assert_allclose(got, x @ A[:A.shape[0] // 2].T, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", WIDTHS)
def test_syn_lo_pass_last_matches_jax(n):
    L = tw.dwt_coeff_len(n, 6)
    lo = _rand((2, 5, L), n + 1)
    want = np.asarray(jw.syn_lo_pass_last(jnp.asarray(lo), jw.wavelet("db3"),
                                          n))
    got = tw.syn_lo_pass_last(torch.from_numpy(lo), tw.wavelet("db3"),
                              n).numpy()
    assert got.shape == want.shape == (2, 5, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    S = tw.synthesis_operator(L, "db3")[:n, :L]
    np.testing.assert_allclose(got, lo @ S.T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [12, 129, 602, 1001])
def test_apply_notch_fft_matches_jax(n):
    """Both operator choices of a level: the cells and no-cells sigmas of
    the production configurations at this width's level."""
    x = _rand((3, 7, n), n + 2) * 3.0
    for sigma in (n * 64 / 1600, n * 128 / 1600):
        want = np.asarray(jfn.apply_notch_fft(jnp.asarray(x), sigma))
        got = tfn.apply_notch_fft(torch.from_numpy(x), sigma).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
        B = tfn.packed_notch_matrix(n, sigma)
        np.testing.assert_allclose(got, x @ B.T.astype(np.float32),
                                   rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n", WIDTHS + [560, 4003])
def test_taps_band_forms_equal_dense(n):
    """K1's and K4's band forms built from the filter taps rebuild the
    dense operators (``band_dense``), bit for bit."""
    A = tw.analysis_operator(n, "db3")
    L = A.shape[0] // 2
    start, coef = th_._k1_taps_band(n, "db3")
    assert start.dtype == np.int32 and coef.dtype == np.float32
    np.testing.assert_array_equal(cb.band_dense(start, coef, n), A[:L])
    for tw_ in (n, n - 1):
        S = tw.synthesis_operator(L, "db3")[:tw_, :L]
        start, coef = th_._k4_taps_band(L, tw_, "db3")
        assert start.dtype == np.int32 and coef.dtype == np.float32
        np.testing.assert_array_equal(cb.band_dense(start, coef, L), S)


@pytest.mark.parametrize("epilogue", ["bare", "exp", "flat", "wrap"])
@pytest.mark.parametrize("n", [64, 561, 1200])
def test_chunked_twins_band_form_match_dense(n, epilogue):
    """With no dense operator (a width at the gate) the plain twins of K1
    and K4 per row shard read the tap-built band form: the dense twins'
    values within float32 tolerance (the same taps summed in another
    order)."""
    rng = np.random.default_rng(n)
    A = tw.analysis_operator(n, "db3")
    L = A.shape[0] // 2
    x = torch.from_numpy(rng.integers(0, 4000, (2, 5, n)).astype(np.uint16))
    start, coef = (torch.from_numpy(a) for a in th_._k1_taps_band(n, "db3"))
    for log1p in (True, False):
        want = cb.an_x_lowpass_chunked(x, torch.from_numpy(A[:L]), start,
                                       coef, log1p)
        got = cb.an_x_lowpass_chunked(x, None, start, coef, log1p)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-3)
    S = torch.from_numpy(tw.synthesis_operator(L, "db3")[:n, :L])
    start, coef = (torch.from_numpy(a)
                   for a in th_._k4_taps_band(L, n, "db3"))
    st = torch.from_numpy(_rand((4, 5, L), n) * 0.01)
    kw = dict(images=None if epilogue == "bare" else x,
              flat=torch.ones((5, n)) * 1.1 if epilogue == "flat" else None,
              dark=torch.full((5, n), 3.0) if epilogue == "flat" else None,
              wrap=epilogue == "wrap")
    want = cb.syn_x_exp_chunked(st, s_x_lo=S, start=start, coef=coef, **kw)
    got = cb.syn_x_exp_chunked(st, s_x_lo=None, start=start, coef=coef, **kw)
    assert got.dtype == want.dtype
    if got.dtype == torch.uint16:
        d = (got.to(torch.int32) - want.to(torch.int32)).abs()
        assert int(d.max()) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _striped(h, w, seed=7):
    """A dim striped plane and a bright one (both classifier branches),
    with pixel noise (noiseless stripes pass the Otsu threshold and are
    kept as foreground)."""
    rng = np.random.default_rng(seed)
    stripes = (rng.normal(size=(1, h, 1)) * 50) * np.ones((1, 1, w))
    dim = 300 + stripes[0] + rng.normal(size=(h, w)) * 10
    bright = 3000 + stripes[0] + rng.normal(size=(h, w)) * 40
    return np.clip(np.stack([dim, bright]), 0, 65535).astype(np.uint16)


def _jax_banded(img, D, plan, dual):
    """The JAX package's route on D of its CPU devices, called eagerly as
    tests/test_halo_sharding.py calls its banded form (XLA's CPU FFT
    refuses the sharded layouts of the route jitted whole)."""
    fn = jh.dual_band_destripe_y_sharded if dual else jh.destripe_y_sharded
    return np.asarray(fn(jnp.asarray(img), make_mesh(D), plan, wrap=True))


def _gate(got, want):
    d = got.astype(np.int64) - want.astype(np.int64)
    assert float((np.abs(d) > 1).mean()) < 1e-3
    mse = float((d.astype(np.float64) ** 2).mean())
    assert 10 * np.log10(65535.0**2 / max(mse, 1e-12)) >= 90.0


# 96 x 1200: every band under the kernels' pay-off gate (filtered whole,
# the dense formulation with the rfft notch); 160 x 1200: level 0's band
# takes the sharded tail (masked median, rfft notch per shard)
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("hw", [(96, 1200), (160, 1200)], ids=str)
def test_banded_route_matches_jax_banded(hw, dual, monkeypatch):
    h, w = hw
    jp, tp = _plans(h, w)
    img = _striped(h, w)
    dense = th_.destripe_y_sharded(img, [CPU] * 2, tp, wrap=True)
    monkeypatch.setenv("DESTRIPE_BANDED_X_MIN_W", "1024")
    monkeypatch.setenv("DESTRIPE_NO_PALLAS", "1")
    consts = th_.halo_device_constants(tp, [CPU] * 2, notch_blocks=not dual)
    assert consts.dense[CPU]["an_x_lo"][0] is None
    assert consts.dense[CPU]["syn_x_lo"][-1] is None
    assert consts.dense[CPU]["notch_cat"][-1] is None
    assert consts.dense[CPU]["an_x_lo"][1] is not None  # 602 < the gate
    assert 0 in consts.xk1 and tp.n_levels - 1 in consts.xk4
    want = _jax_banded(img, 2, jp, dual)
    fn = (th_.dual_band_destripe_y_sharded if dual
          else th_.destripe_y_sharded)
    got = fn(img, [CPU] * 2, tp, consts, wrap=True).gather(CPU).numpy()
    assert got.dtype == np.uint16 and got.shape == img.shape
    _gate(got, want)
    if not dual:
        _gate(got, dense.gather(CPU).numpy())


def test_banded_route_without_x_blocks(monkeypatch):
    """The gate forced to 64: every level that wide is gated, and those
    under K1/K4's 560 columns run the blocked passes; against the dense
    route."""
    h, w = 96, 1200
    _, tp = _plans(h, w)
    img = _striped(h, w, seed=3)
    dense = th_.destripe_y_sharded(img, [CPU] * 2, tp, wrap=True).gather(
        CPU).numpy()
    monkeypatch.setenv("DESTRIPE_BANDED_X_MIN_W", "64")
    consts = th_.halo_device_constants(tp, [CPU] * 2)
    assert all(a is None for a in consts.dense[CPU]["an_x_lo"])
    assert 2 not in consts.xk1  # 303 columns: the blocked pass
    got = th_.destripe_y_sharded(img, [CPU] * 2, tp, consts,
                                 wrap=True).gather(CPU).numpy()
    _gate(got, dense)
