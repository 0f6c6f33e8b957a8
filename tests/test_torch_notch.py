"""The Otsu histogram, masked row median and notch tail of the torch package
(ops/cuda_hist.py, ops/cuda_notch.py).

On the CPU: each plain twin against the JAX package's Pallas kernel
(ops/pallas_hist.py, ops/pallas_median.py, ops/pallas_notch.py) in interpret
mode, at those kernels' own test geometries. Histogram counts and medians
are exact. The notch tail's product is bf16x3 on the TPU kernel (== XLA's
HIGH precision, ~2^-21 relative) and plain f32 in the twin, so it is held to
the tolerance of tests/test_pallas_notch.py; stripe pixels are exactly 0.

The Hopper kernels themselves are held against these twins on the card by
tests/test_torch_card.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import fft_notch as jn  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_hist as ph  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_median as pm  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_notch as pn  # noqa: E402
from aind_smartspim_destripe_torch import ops as tops  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_hist as th  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402


def _range(x, square):
    v = x.reshape(x.shape[0], -1).astype(np.float32)
    if square:
        v = v * v
    lo, hi = v.min(axis=1), v.max(axis=1)
    return lo, np.where(hi > lo, hi - lo, 1.0).astype(np.float32)


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("dtype,shape", [(np.float32, (3, 13, 130)),
                                         (np.float32, (2, 204, 254)),
                                         (np.uint16, (2, 52, 130))])
def test_histogram_matches_pallas(square, dtype, shape):
    rng = np.random.default_rng(shape[1])
    if dtype == np.uint16:
        x = rng.integers(0, 4000, shape).astype(np.uint16)
    else:
        x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    lo, span = _range(x, square)
    want = np.asarray(ph.histogram256_batch(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(span), square=square,
        interpret=True))
    got = th.histogram256_batch(torch.from_numpy(x), torch.from_numpy(lo),
                                torch.from_numpy(span), square=square)
    assert got.dtype == torch.int32 and got.shape == (shape[0], 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy().sum(1) == np.prod(shape[1:]))


@pytest.mark.parametrize("shape,thr", [((4, 37, 203), [0.5, 2.0, 0.0, 100.0]),
                                       ((2, 9, 130), [0.7, 0.1])])
def test_row_median_masked_matches_pallas(shape, thr):
    x = np.random.default_rng(shape[2]).normal(scale=3.0, size=shape).astype(
        np.float32)
    thr = np.asarray(thr, np.float32)
    want = np.asarray(pm.row_median_masked(jnp.asarray(x), jnp.asarray(thr),
                                           interpret=True))
    got = tn.row_median_masked(torch.from_numpy(x), torch.from_numpy(thr))
    assert got.shape == shape[:2] + (1,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def notch_case():
    """The JAX notch kernel's test case: (3, 96, 250), two operators."""
    rng = np.random.default_rng(0)
    B, h, w = 3, 96, 250
    ch = (rng.normal(size=(B, h, w)) * 2.0).astype(np.float32)
    bc = jn.packed_notch_matrix(w, 12.0).astype(np.float32)
    bn = jn.packed_notch_matrix(w, 40.0).astype(np.float32)
    thr = np.array([1.5, 0.8, 2.5], np.float32)
    sel = np.array([0, 1, 0], np.int32)
    return ch, bc, bn, thr, sel


def test_notch_delta_matches_pallas(notch_case):
    ch, bc, bn, thr, sel = notch_case
    want = np.asarray(pn.notch_delta(
        jnp.asarray(ch), None, jnp.asarray(thr), jnp.asarray(sel),
        pn.stacked_notch_operators(bc, bn), interpret=True))
    cat = np.concatenate([bc.T, bn.T], axis=1)
    got = tn.notch_delta(torch.from_numpy(ch), torch.from_numpy(thr),
                         torch.from_numpy(sel), torch.from_numpy(cat)).numpy()
    assert got.shape == ch.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    stripes = np.sqrt(ch * ch) > thr[:, None, None]
    assert np.all(got[stripes] == 0.0) and np.all(want[stripes] == 0.0)


def test_filter_level_delta_goes_through_notch_delta(notch_case, monkeypatch):
    """destripe_batch's per-level tail hands the capped Otsu threshold and
    the per-plane operator choice to notch_delta."""
    ch, bc, bn, _, _ = notch_case
    cat = torch.from_numpy(np.concatenate([bc.T, bn.T], axis=1))
    seen = {}

    def spy(ch_, thr_, sel_, cat_):
        seen.update(thr=thr_, sel=sel_)
        return tn.notch_delta_plain(ch_, thr_, sel_, cat_)

    monkeypatch.setattr(tn, "notch_delta", spy)
    is_cells = torch.tensor([True, False, True])
    t = torch.from_numpy(ch)
    tf._filter_level_delta(t, is_cells, cat, 0.5, 12.0)
    otsu = torch.sqrt(tf.threshold_otsu_batch(t, square=True))
    want = torch.minimum(torch.tensor([0.5, 12.0, 0.5]), otsu)
    assert torch.equal(seen["thr"], want)
    assert seen["sel"].dtype == torch.int32
    assert seen["sel"].tolist() == [0, 1, 0]


def test_registry_lists_every_kernel():
    names = [k.__name__ for k in tops.kernels()]
    assert names == ["an_x_lowpass_log1p", "an_y_pass", "syn_y_pass",
                     "syn_x_exp", "an_x_lowpass_chunked", "syn_x_exp_chunked",
                     "histogram256_batch", "histogram256_range",
                     "abs_range_batch", "otsu_tail", "row_median_masked",
                     "row_median_batch", "notch_delta", "notch_delta_lowrank",
                     "notch_delta_fft", "notch_select", "blend_smooth_mix",
                     "dense_matmul"]
    tops.reset_launches()
    assert all(k.launches == 0 for k in tops.kernels())


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 6), dtype=torch.float32, device="meta")
    t = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain route"):
        th.histogram256_batch(x, t, t)
    with pytest.raises(ValueError, match="no kernel or plain route"):
        tn.row_median_masked(x, t)
    with pytest.raises(ValueError, match="no kernel or plain route"):
        tn.notch_select(x, t, t)
    with pytest.raises(ValueError, match="no kernel or plain route"):
        tn.row_median_batch(x)


# --- the exact-rank notch (notch_delta_lowrank) ----------------------------

from aind_smartspim_destripe_torch.ops import fft_notch as tfn  # noqa: E402


def _stitched_pairs(max_w):
    """(width, sigma) of every level of the 16384 x 18000 plan up to
    ``max_w`` columns, both configurations."""
    tp = tf.build_plan(16384, 18000, tf.FilterConfig(sigma=64.0),
                       tf.FilterConfig(sigma=128.0))
    return [(w, s) for (_, w), sigmas in zip(tp.ladder, tp.notch_sigmas())
            if w <= max_w for s in sigmas]


# the stitched ladder up to 2254 columns, an odd width and a prime one
FACTOR_CASES = _stitched_pairs(2254) + [(1001, 12.0), (1009, 25.0)]


@pytest.mark.parametrize("w,sigma", FACTOR_CASES)
def test_notch_factors_exact(w, sigma):
    """``p @ ds`` is the notch operator minus the identity in float64, at
    the rank of the gains that are not 1.0: to 1e-13 of its largest entry
    against the packed-gain map of ``g - 1`` applied to the identity by
    numpy's FFT, and to 1e-13 of the operator's largest entry against
    ``packed_notch_matrix - I`` (the operator's FFT rounds to ulps of its
    unit diagonal, up to 1.4e-13 of the difference's largest entry)."""
    p, ds, (r,) = tfn.notch_factors(w, (sigma,), np.float64)
    g = tfn.notch(w, sigma)
    assert r == np.count_nonzero(g != 1.0) == tfn.notch_rank(w, sigma)
    rp = p.shape[1]
    assert p.shape == (w, rp) and ds.shape == (rp, w) and rp % 4 == 0
    assert r <= rp < r + 4 and not ds[r:].any()
    a, b = tfn._packed_gains(w, g)
    spec = np.fft.rfft(np.eye(w), axis=-1)
    want = np.fft.irfft((a - 1.0) * spec.real + 1j * (b - 1.0) * spec.imag,
                        n=w, axis=-1)
    assert np.abs(p @ ds - want).max() <= 1e-13 * np.abs(want).max()
    op = tfn.packed_notch_matrix(w, sigma)
    assert (np.abs(p @ ds - (op.T - np.eye(w))).max()
            <= 1e-13 * np.abs(op).max())


def _lowrank_case(k_out):
    """A band of the stitched plan's level 2 (2254 columns): 3 planes,
    ``k_out`` outputs per plane, both operator choices, its thresholds,
    float32 factors and dense operators."""
    w = 2254
    sigmas = (8.015625, 16.03125)
    rng = np.random.default_rng(2254 + k_out)
    ch = torch.from_numpy((rng.normal(size=(3, 24, w)) * 0.4).astype(
        np.float32))
    thr = torch.from_numpy(np.linspace(0.3, 0.9, 3 * k_out).astype(
        np.float32))
    sel = torch.tensor([0, 1, 1] if k_out == 1 else [0] * 3 + [1] * 3,
                       dtype=torch.int32)
    p, ds, ranks = tfn.notch_factors(w, sigmas)
    cat = torch.from_numpy(tfn.notch_cat(w, sigmas))
    return ch, thr, sel, torch.from_numpy(p), torch.from_numpy(ds), ranks, \
        cat, sigmas


@pytest.mark.parametrize("k_out", [1, 2], ids=["single", "dual"])
def test_notch_delta_lowrank_against_dense_and_float64(k_out):
    """The low-rank tail is the dense tail's delta (within float32
    rounding), and at least as close as the dense one to the float64
    delta on the same mask and inpainting, for both operators and the
    wrapped dual form."""
    ch, thr, sel, p, ds, ranks, cat, sigmas = _lowrank_case(k_out)
    got = tn.notch_delta_lowrank(ch, thr, sel, p, ds, ranks)
    dense = tn.notch_delta_plain(ch, thr, sel, cat)
    assert got.shape == dense.shape == (3 * k_out, 24, 2254)
    c = ch.repeat(k_out, 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    assert torch.all(got[stripes] == 0.0) and torch.all(dense[stripes] == 0.0)
    # float64 truth of the same inpainted band
    med = tn.row_median(torch.where(stripes, 0.0, c))
    inpainted = torch.where(stripes, med, c).double()
    ops = [torch.from_numpy(tfn.packed_notch_matrix(2254, s).T) for s in sigmas]
    truth = torch.stack([inpainted[b] @ ops[s] - c[b].double()
                         for b, s in enumerate(sel.tolist())])
    truth = torch.where(stripes, 0.0, truth)
    err_lr = (got.double() - truth)[~stripes]
    err_dense = (dense.double() - truth)[~stripes]
    scale = truth.abs().max()
    assert err_lr.abs().max() <= 1e-5 * scale
    assert err_lr.pow(2).mean().sqrt() <= err_dense.pow(2).mean().sqrt()
    assert err_lr.abs().max() <= err_dense.abs().max()


def test_notch_delta_lowrank_refuses_bad_ranks():
    ch, thr, sel, p, ds, ranks, _, _ = _lowrank_case(1)
    for bad in ((0, ranks[1]), (ranks[0], p.shape[1] + 1), (ranks[0],)):
        with pytest.raises(ValueError, match="ranks"):
            tn.notch_delta_lowrank(ch, thr, sel, p, ds, bad)


# --- the chirp-z notch (notch_delta_fft) ------------------------------------

# the tile plan's chirp-z levels (2, 1, 0), an odd width and a prime one
CHIRP_CASES = [(254, (8.16, 16.32)), (503, (16.12, 32.24)),
               (1002, (32.08, 64.16)), (391, (12.5, 25.0)), (1009, (20.0, 40.0))]


def _records(rec):
    """A NotchChirp's tables as CPU tensors."""
    return rec._replace(**{f: torch.from_numpy(v) for f, v in
                           rec._asdict().items() if isinstance(v, np.ndarray)})


@pytest.mark.parametrize("w,sigmas", CHIRP_CASES)
def test_notch_chirp_tables_exact(w, sigmas):
    """The chirp-z arithmetic on float64 tables maps the identity's rows to
    ``packed_notch_matrix - I``, to 1e-12 of the operator's largest entry,
    for each configuration: in pairs of rows (w rows, so an odd count pads
    the last pair with zeros) and, through the dual form, the two outputs
    of each row."""
    rec = _records(tfn.notch_chirp(w, sigmas, np.float64))
    k, m = tfn.chirp_size(w, sigmas)
    assert rec.k == k and rec.twiddle.shape == (m, 2)
    assert rec.chirp.shape == (w, 2) and rec.filters.shape == (2, m, 2)
    assert rec.gains.shape == (2, k + 1, 2)
    eye = torch.eye(w, dtype=torch.float64)[None]
    inf = torch.tensor([np.inf], dtype=torch.float64)
    for c, s in enumerate(sigmas):
        want = tfn.packed_notch_matrix(w, s).T - np.eye(w)
        tol = 1e-12 * np.abs(tfn.packed_notch_matrix(w, s)).max()
        got = tn.notch_delta_fft_plain(eye, inf, torch.tensor(
            [c], dtype=torch.int32), rec)[0].numpy()
        assert np.abs(got - want).max() <= tol
        dual = tn.notch_delta_fft_plain(eye, inf.repeat(2), torch.tensor(
            [c, 1 - c], dtype=torch.int32), rec)[0].numpy()
        assert np.abs(dual - want).max() <= tol


def _chirp_case(k_out, w=503, sigmas=(16.12, 32.24), h=23):
    """Bands of 3 planes, odd h, ``k_out`` outputs per plane, both
    configurations, thresholds that mask some values."""
    rng = np.random.default_rng(w + k_out)
    ch = torch.from_numpy((rng.normal(size=(3, h, w)) * 0.4).astype(
        np.float32))
    thr = torch.from_numpy(np.linspace(0.3, 0.9, 3 * k_out).astype(
        np.float32))
    sel = torch.tensor([0, 1, 1] if k_out == 1 else [0] * 3 + [1] * 3,
                       dtype=torch.int32)
    cat = torch.from_numpy(tfn.notch_cat(w, sigmas))
    return ch, thr, sel, _records(tfn.notch_chirp(w, sigmas)), cat, sigmas


@pytest.mark.parametrize("w,sigmas", CHIRP_CASES[:3])
@pytest.mark.parametrize("k_out", [1, 2], ids=["single", "dual"])
def test_notch_delta_fft_against_dense_and_float64(k_out, w, sigmas):
    """The chirp-z tail (its plain twin here) is the dense tail's delta
    within float32 rounding, 0 at stripes, and at least as close as the
    dense one to the float64 delta on the same mask and inpainting, for
    both configurations (mixed per plane) and the wrapped dual form."""
    ch, thr, sel, rec, cat, _ = _chirp_case(k_out, w, sigmas)
    got = tn.notch_delta_fft(ch, thr, sel, rec)
    dense = tn.notch_delta_plain(ch, thr, sel, cat)
    assert got.shape == dense.shape == (3 * k_out, 23, w)
    assert got.dtype == torch.float32
    c = ch.repeat(k_out, 1, 1)
    stripes = torch.sqrt(c * c) > thr[:, None, None]
    assert stripes.any() and (~stripes).any()
    assert torch.all(got[stripes] == 0.0) and torch.all(dense[stripes] == 0.0)
    med = tn.row_median(torch.where(stripes, 0.0, c))
    inpainted = torch.where(stripes, med, c).double()
    ops = [torch.from_numpy(tfn.packed_notch_matrix(w, s).T) for s in sigmas]
    truth = torch.stack([inpainted[b] @ ops[s] - c[b].double()
                         for b, s in enumerate(sel.tolist())])
    truth = torch.where(stripes, 0.0, truth)
    err = (got.double() - truth)[~stripes]
    err_dense = (dense.double() - truth)[~stripes]
    assert err.abs().max() <= 1e-6 * truth.abs().max()
    assert err.abs().max() <= err_dense.abs().max()
    assert err.pow(2).mean().sqrt() <= err_dense.pow(2).mean().sqrt()


def test_notch_delta_fft_refuses_other_batches():
    """Three outputs per band plane: the kernel pairs rows of a plane or
    the two outputs of a row, so both forms refuse any other k."""
    ch, thr, sel, rec, _, _ = _chirp_case(1)
    with pytest.raises(ValueError, match="1 or 2"):
        tn.notch_delta_fft(ch, thr.repeat(3), sel.repeat(3), rec)
    with pytest.raises(ValueError, match="Nyquist"):
        tfn.notch_chirp(262, (16.4, 32.75))
