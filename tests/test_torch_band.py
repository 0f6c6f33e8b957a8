"""K1-K4 of the torch package (ops/cuda_band.py).

On the CPU: each plain twin against the JAX package's Pallas kernel
(ops/pallas_band.py) in interpret mode, at that kernel's own test
geometries (640x768 B=2 for level 0, 1280x1280 level=2 for level 1). The
Pallas kernels accumulate three bf16 products in f32 (== XLA's HIGH
precision, ~2^-21 relative), the twins plain f32; the tolerances are those
of tests/test_pallas_band.py for the same reason. Classifier counts are
exact and uint16 outputs within 1 LSB.

The Hopper kernels themselves are held against these twins on the card by
tests/test_torch_card.py and chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_band as pb  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_build  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402

H, W = 640, 768


def _plans(h, w, level):
    jc = jf.FilterConfig(wavelet="db3", level=level, sigma=64, max_threshold=3)
    tc = tf.FilterConfig(wavelet="db3", level=level, sigma=64, max_threshold=3)
    return jf.build_plan(h, w, jc, jc), tf.build_plan(h, w, tc, tc)


def _level(h, w, level, lvl, device="cpu"):
    """(jax plan, jax band spec, jax band ops, port tensors of level lvl)."""
    jp, tp = _plans(h, w, level)
    consts = tf.device_constants(tp, device)
    n = tp.n_levels
    ops = {
        "an_x_lo": consts["an_x_lo"][lvl],
        "an_y": consts["an_y"][lvl],
        "syn_y": consts["syn_y"][n - 1 - lvl],
        "syn_x_lo": consts["syn_x_lo"][n - 1 - lvl],
        **consts[f"band{lvl}"],
    }
    return jp, jf.band_spec(jp, lvl), jf.band_operators(jp, lvl), ops


@pytest.fixture(scope="module")
def lvl0():
    return _level(H, W, 1, 0)


@pytest.fixture(scope="module")
def lvl1():
    return _level(1280, 1280, 2, 1)


def _k1(x, ops, **kw):
    return cb.an_x_lowpass_log1p(
        x, ops["an_x_lo"], ops["k1_start"], ops["k1_coef"], **kw)


def _k2(x, ops):
    return cb.an_y_pass(
        x, ops["an_y"], ops["k2_start"], ops["k2_lo"], ops["k2_hi"])


def _k3(corr, delta, ops):
    return cb.syn_y_pass(
        corr, delta, ops["syn_y"], ops["k3_start"], ops["k3_lo"], ops["k3_hi"])


def _k4(st, img, ops, **kw):
    return cb.syn_x_exp(
        st, img, ops["syn_x_lo"], ops["k4_start"], ops["k4_coef"], **kw)


def test_k1_uint16_log1p_and_classifier_sums(lvl0):
    jp, spec, bops, ops = lvl0
    L_w = jp.ladder[-1][1]
    cut = jf._classifier_cut_f32(400.0, 20.0, 0.3)
    x = np.random.default_rng(10).integers(0, 3000, (2, H, W), np.uint16)
    want, st = pb.an_x_lowpass_log1p(
        jnp.asarray(x), bops["bk1"], spec["k1"]["starts"], L_w,
        cls_cut=cut, interpret=True)
    got, sums = _k1(torch.from_numpy(x), ops, cls_cut=cut)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-3)
    st = np.asarray(st)
    for q, lane in enumerate((0, 128)):  # counts: exact
        np.testing.assert_array_equal(sums[:, q].numpy(),
                                      st[:, :, 0, lane].sum(1))
    m = x.astype(np.float16) >= np.float16(383.25)
    xf = x.astype(np.float64)
    exact = np.stack([np.where(m, xf, 0).sum((1, 2)),
                      np.where(~m, xf, 0).sum((1, 2))], 1)
    np.testing.assert_array_equal(sums[:, 2:].numpy(),
                                  exact.astype(np.float32))
    np.testing.assert_allclose(sums[:, 2].numpy(), st[:, :, 0, 256].sum(1),
                               rtol=1e-6)


def test_k1_float_input(lvl0):
    jp, spec, bops, ops = lvl0
    L_w = jp.ladder[-1][1]
    x = np.random.default_rng(1).uniform(0, 4000, (2, H, W)).astype(np.float32)
    want = pb.an_x_lowpass_log1p(jnp.asarray(x), bops["bk1"],
                                 spec["k1"]["starts"], L_w, interpret=True)
    got = _k1(torch.from_numpy(x), ops)
    assert got.shape == (2, H, L_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


def test_k2_bands_and_abs_range(lvl0):
    jp, spec, bops, ops = lvl0
    L_h, L_w = jp.ladder[-1]
    x = (np.random.default_rng(11).normal(size=(2, H, L_w)) * 3).astype(
        np.float32)
    lo_j, hi_j, mm = pb.an_y_pass(
        jnp.asarray(x), bops["bk2"], spec["k2"]["stride"], spec["k2"]["pad"],
        L_h, stats=True, interpret=True)
    lo, hi, (mn, mx) = _k2(torch.from_numpy(x), ops)
    np.testing.assert_allclose(lo.numpy(), np.asarray(lo_j),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(hi.numpy(), np.asarray(hi_j),
                               rtol=2e-5, atol=2e-4)
    # the range is exact on each package's own band
    a = np.abs(hi.numpy())
    np.testing.assert_array_equal(mn.numpy(), a.min((1, 2)))
    np.testing.assert_array_equal(mx.numpy(), a.max((1, 2)))
    np.testing.assert_allclose(mx.numpy(), np.asarray(mm)[:, :, 0, 128].max(1),
                               rtol=2e-5)


@pytest.mark.parametrize("with_corr", [True, False])
def test_k3_synthesis_y(lvl0, with_corr):
    jp, spec, bops, ops = lvl0
    L_h, L_w = jp.ladder[-1]
    rng = np.random.default_rng(3)
    corr = rng.normal(size=(2, L_h, L_w)).astype(np.float32)
    delta = rng.normal(size=(2, L_h, L_w)).astype(np.float32)
    want = pb.syn_y_pass(
        jnp.asarray(corr) if with_corr else None, jnp.asarray(delta),
        bops["bk3_lo"] if with_corr else None, bops["bk3_hi"],
        spec["k3"]["stride"], spec["k3"]["pad"], H, interpret=True)
    got = _k3(torch.from_numpy(corr) if with_corr else None,
              torch.from_numpy(delta), ops)
    assert got.shape == (2, H, L_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-4)


# K2/K3 witnesses: the production-like 640x768 level 0 (both starts'
# clamps), an odd height (1001 rows: a K2 step of 1 at its end, a partial
# run of both kernels) with an odd width (391 columns), and level 1
WITNESS_GEOMETRIES = {
    "640x768 level 0": (640, 768, 1, 0),
    "1001x777 level 0": (1001, 777, 1, 0),
    "1280x1280 level 1": (1280, 1280, 2, 1),
}


@pytest.fixture(scope="module", params=list(WITNESS_GEOMETRIES))
def witness_level(request):
    h, w, level, lvl = WITNESS_GEOMETRIES[request.param]
    return _level(h, w, level, lvl)


def test_k2_ordered_witness_matches_jax_and_twin(witness_level):
    """``an_y_pass_ordered`` (the term-by-term form the card's K2 is held
    to bit for bit) against the JAX package's K2 in interpret mode, with
    the tolerances of test_k2_bands_and_abs_range, and against the plain
    twin; the |cH| range exactly on its own band."""
    jp, spec, bops, ops = witness_level
    h = ops["an_y"].shape[1]
    L_h = ops["k2_start"].shape[0]
    w = ops["an_x_lo"].shape[0]
    x = (np.random.default_rng(21).normal(size=(2, h, w)) * 3).astype(
        np.float32)
    lo_j, hi_j, _ = pb.an_y_pass(
        jnp.asarray(x), bops["bk2"], spec["k2"]["stride"], spec["k2"]["pad"],
        L_h, stats=True, interpret=True)
    xt = torch.from_numpy(x)
    lo, hi, (mn, mx) = cb.an_y_pass_ordered(xt, ops["k2_start"],
                                            ops["k2_lo"], ops["k2_hi"])
    lo_t, hi_t, _ = cb.an_y_pass_plain(xt, ops["an_y"])
    for got, want in ((lo, lo_j), (hi, hi_j), (lo, lo_t), (hi, hi_t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-4)
    a = np.abs(hi.numpy())
    np.testing.assert_array_equal(mn.numpy(), a.min((1, 2)))
    np.testing.assert_array_equal(mx.numpy(), a.max((1, 2)))


@pytest.mark.parametrize("with_corr", [True, False])
def test_k3_ordered_witness_matches_jax_and_twin(witness_level, with_corr):
    """``syn_y_pass_ordered`` (delta half, then corr half, as the card's
    K3 sums) against the JAX package's K3 in interpret mode and the plain
    twin, with the tolerances of test_k3_synthesis_y."""
    jp, spec, bops, ops = witness_level
    Ho = ops["k3_start"].shape[0]
    L_h = ops["k2_start"].shape[0]
    w = ops["an_x_lo"].shape[0]
    rng = np.random.default_rng(22)
    corr = rng.normal(size=(2, L_h, w)).astype(np.float32)
    delta = rng.normal(size=(2, L_h, w)).astype(np.float32)
    want = pb.syn_y_pass(
        jnp.asarray(corr) if with_corr else None, jnp.asarray(delta),
        bops["bk3_lo"] if with_corr else None, bops["bk3_hi"],
        spec["k3"]["stride"], spec["k3"]["pad"], Ho, interpret=True)
    ct = torch.from_numpy(corr) if with_corr else None
    dt = torch.from_numpy(delta)
    got = cb.syn_y_pass_ordered(ct, dt, ops["k3_start"], ops["k3_lo"],
                                ops["k3_hi"])
    assert got.shape == (2, Ho, w)
    for ref in (np.asarray(want),
                cb.syn_y_pass_plain(ct, dt, ops["syn_y"]).numpy()):
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-4)


# every band form a plan of the repo builds: the production geometries
# (1600x2000 and 2048x2048, db3), the test geometries, odd sizes and the
# other wavelets' widths (db1: K2 K=2; db6: 12; db20: 40)
Y_FORMS = ("1600x2000 db3", "2048x2048 db3", "640x768 db3", "1280x1280 db3",
           "1001x777 db3", "1601x2001 db3", "1600x2000 db1", "1600x2000 db2",
           "1600x2000 db6", "1600x2000 db20")


@pytest.mark.parametrize("name", Y_FORMS)
def test_check_k2_k3_band_accept_every_plan(name):
    hw, wav = name.split()
    h, w = map(int, hw.split("x"))
    cfg = tf.FilterConfig(wavelet=wav, level=None, sigma=64, max_threshold=3)
    consts = tf.device_constants(tf.build_plan(h, w, cfg, cfg), "cpu")
    levels = [k for k in consts if k.startswith("band")]
    assert levels
    for key in levels:
        bd = consts[key]
        cb.check_k2_band(bd["k2_start"].numpy(), bd["k2_lo"].shape[1])
        cb.check_k3_band(bd["k3_start"].numpy(), bd["k3_lo"].shape[1])


@pytest.mark.parametrize("case", ["step 3", "back", "K too wide",
                                  "stride 3"])
def test_check_k2_band_rejects(case):
    start = np.arange(0, 1600, 2, dtype=np.int32)
    K, stride = 6, 2
    if case == "step 3":
        start[300:] += 1
    elif case == "back":
        start[301:] -= 4
    elif case == "K too wide":
        K = 65
    else:
        stride = 3
    with pytest.raises(ValueError, match="K2 takes band forms"):
        cb.check_k2_band(start, K, stride)
    cb.check_k2_band(np.arange(0, 1600, 2, dtype=np.int32), 64)


@pytest.mark.parametrize("case", ["step 2", "back", "K too wide",
                                  "run too long"])
def test_check_k3_band_rejects(case):
    start = np.repeat(np.arange(800, dtype=np.int32), 2)
    K = 3
    if case == "step 2":
        start[700:] += 1
    elif case == "back":
        start[701:] -= 2
    elif case == "K too wide":
        K = 65
    else:  # a step of 1 at every output of the run from output 64
        start[64:96] = start[64] + np.arange(32)
        start[96:] += 16
    with pytest.raises(ValueError, match="K3 takes band forms"):
        cb.check_k3_band(start, K)
    cb.check_k3_band(np.repeat(np.arange(800, dtype=np.int32), 2), 64)


@pytest.mark.parametrize("epilogue", ["exp", "flat", "wrap", "bare"])
def test_k4_synthesis_x_epilogues(lvl0, epilogue):
    jp, spec, bops, ops = lvl0
    L_w = jp.ladder[-1][1]
    rng = np.random.default_rng(4)
    st = (rng.normal(size=(2, H, L_w)) * 0.01).astype(np.float32)
    img = rng.integers(0, 3000, (2, H, W), np.uint16)
    flat = (1.0 + 0.3 * rng.random((H, W))).astype(np.float32)
    dark = rng.uniform(0, 40, (H, W)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if epilogue == "flat":
        kw_j = dict(flat=jnp.asarray(flat), dark=jnp.asarray(dark))
        kw_t = dict(flat=torch.from_numpy(flat), dark=torch.from_numpy(dark))
    elif epilogue == "wrap":
        kw_j = kw_t = dict(wrap=True)
    with_img = epilogue != "bare"
    want = np.asarray(pb.syn_x_exp(
        jnp.asarray(st), jnp.asarray(img) if with_img else None, bops["bk4"],
        spec["k4"]["starts"], W, interpret=True, **kw_j))
    got = _k4(torch.from_numpy(st), torch.from_numpy(img) if with_img else None,
              ops, **kw_t).numpy()
    assert got.dtype == want.dtype and got.shape == (2, H, W)
    if epilogue in ("flat", "wrap"):
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-2 if with_img else 1e-5)


@pytest.mark.parametrize("epilogue", ["exp", "flat", "wrap", "bare"])
def test_k4_ordered_witness_matches_jax(lvl0, epilogue):
    """``syn_x_exp_ordered`` (the term-by-term form the card's K4 is held
    to bit for bit) against the JAX package's K4 in interpret mode, with
    the tolerances of test_k4_synthesis_x_epilogues."""
    jp, spec, bops, ops = lvl0
    L_w = jp.ladder[-1][1]
    rng = np.random.default_rng(14)
    st = (rng.normal(size=(2, H, L_w)) * 0.01).astype(np.float32)
    img = rng.integers(0, 3000, (2, H, W), np.uint16)
    flat = (1.0 + 0.3 * rng.random((H, W))).astype(np.float32)
    dark = rng.uniform(0, 40, (H, W)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if epilogue == "flat":
        kw_j = dict(flat=jnp.asarray(flat), dark=jnp.asarray(dark))
        kw_t = dict(flat=torch.from_numpy(flat), dark=torch.from_numpy(dark))
    elif epilogue == "wrap":
        kw_j = kw_t = dict(wrap=True)
    with_img = epilogue != "bare"
    want = np.asarray(pb.syn_x_exp(
        jnp.asarray(st), jnp.asarray(img) if with_img else None, bops["bk4"],
        spec["k4"]["starts"], W, interpret=True, **kw_j))
    got = cb.syn_x_exp_ordered(
        torch.from_numpy(st), torch.from_numpy(img) if with_img else None,
        ops["k4_start"], ops["k4_coef"], **kw_t).numpy()
    assert got.dtype == want.dtype and got.shape == (2, H, W)
    if epilogue in ("flat", "wrap"):
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-2 if with_img else 1e-5)


def test_k4_ordered_witness_dual_form(lvl0):
    """The witness in the dual-band form (2B corrections of B planes,
    correction b reading plane b mod B) against the plain twin: the same
    sums in another order, within the tolerance above."""
    _, _, _, ops = lvl0
    L_w = ops["syn_x_lo"].shape[1]
    rng = np.random.default_rng(15)
    st = torch.from_numpy((rng.normal(size=(4, H, L_w)) * 0.01).astype(
        np.float32))
    img = torch.from_numpy(rng.integers(0, 3000, (2, H, W), np.uint16))
    got = cb.syn_x_exp_ordered(st, img, ops["k4_start"], ops["k4_coef"])
    want = cb.syn_x_exp_plain(st, img, ops["syn_x_lo"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-2)


K4_FORMS = ("1600x2000 level 0", "1600x2000 level 1", "1280x1280 level 0",
            "1280x1280 level 1", "taps 18000", "taps 20480")


def _k4_form(name):
    """A synthesis band form K4 takes: a plane plan's banded level
    (1600x2000 levels 0-1, 1280x1280) or the row-sharded route's tap-built
    form at 18000 or 20480 columns (a 16384x18000 plane, and the
    4096x20480 plane at the dense-x gate)."""
    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

    if name.startswith("taps"):
        w = int(name.split()[1])
        return _k4_taps_band(tw.dwt_coeff_len(w, 6), w, "db3")
    hw, lvl = name.split(" level ")
    h, w = map(int, hw.split("x"))
    _, tp = _plans(h, w, None if h == 1600 else 2)
    band = tf.device_constants(tp, "cpu")[f"band{lvl}"]
    return band["k4_start"].numpy(), band["k4_coef"].numpy()


@pytest.mark.parametrize("name", K4_FORMS)
def test_check_k4_band_accepts_every_synthesis_form(name):
    start, coef = _k4_form(name)
    assert coef.shape[0] == start.shape[0] and coef.shape[1] == 3
    cb.check_k4_band(start, coef.shape[1])
    assert set(np.diff(start).tolist()) <= {0, 1}


@pytest.mark.parametrize("case", ["step 2", "back", "K too wide"])
def test_check_k4_band_rejects(case):
    start = np.repeat(np.arange(600, dtype=np.int32), 2)
    K = 3
    if case == "step 2":
        start[700:] += 1
    elif case == "back":
        start[701:] -= 2
    else:
        K = 63
    with pytest.raises(ValueError, match="K4 takes band forms"):
        cb.check_k4_band(start, K)
    cb.check_k4_band(np.repeat(np.arange(600, dtype=np.int32), 2), 62)


# K4's launches: (B, H, W, image bytes a pixel, fields) of each K4 call of
# the three benchmark cells (1600x2000 levels 0-1 single and dual; the
# fused 16384x18000 plane's banded levels 0-4 in 4-plane batches), the
# row-sharded route's shards of that plane on two entries (single and
# dual) and of the 4096x20480 plane at the dense-x gate, float32 images
# with the fields (the largest slot), and the card test's fused case whose
# items are not a multiple of the grid
K4_LAUNCHES = {
    "single L0": (64, 1600, 2000, 2, True),
    "single L1": (64, 802, 1002, 0, False),
    "dual L0": (128, 1600, 2000, 2, False),
    "dual L1": (128, 802, 1002, 0, False),
    "stitched L0": (4, 16384, 18000, 2, True),
    "stitched L1": (4, 8194, 9002, 0, False),
    "stitched L2": (4, 4099, 4503, 0, False),
    "stitched L3": (4, 2052, 2254, 0, False),
    "stitched L4": (4, 1028, 1129, 0, False),
    "halo L0": (4, 8195, 18000, 2, True),
    "halo dual L0": (8, 8195, 18000, 2, True),
    "halo L1": (4, 4100, 9002, 0, False),
    "halo 20480": (1, 2051, 20480, 2, True),
    "float32 fields": (3, 37, 2000, 4, True),
    "card fused": (4, 17, 18000, 2, True),
}


def _k4_decode(i, nb, P, nhq):
    """Item i's (q, z, hq, sg), in the kernel's order: correction q of
    image plane z fastest, then z, the row group hq, the segment sg."""
    i, q = np.divmod(i, nb)
    i, z = np.divmod(i, P)
    sg, hq = np.divmod(i, nhq)
    return q, z, hq, sg


@pytest.mark.parametrize("name", list(K4_LAUNCHES))
def test_k4_geometry_owns_every_output_once(name):
    """K4's persistent launch at every shape the cells and the halo route
    give it (a 132-SM card): the segments split the width into near-equal
    runs; the items, each 2 rows by a segment of one output plane, cover
    every output once; the blocks' runs of items partition them, one item
    apart at most; the kernel's step from one item to the next is the
    decoding of the next; every segment's inputs fit a ring row; and the
    ring fits three blocks on an SM."""
    from aind_smartspim_destripe_torch.ops import wavelets as tw
    from aind_smartspim_destripe_torch.parallel.halo import _k4_taps_band

    B, H, W, img_bytes, fields = K4_LAUNCHES[name]
    P = B // 2 if "dual" in name else B
    start, coef = _k4_taps_band(tw.dwt_coeff_len(W, 6), W, "db3")
    K = coef.shape[1]
    geo = cb.k4_geometry(B, H, W, K, 132, img_bytes, fields)
    # segments: near-equal, aligned, covering [0, W)
    assert geo.seg % 4 == 0 and geo.seg <= 1024
    assert (geo.nseg - 1) * geo.seg < W <= geo.nseg * geo.seg
    assert geo.nseg == -(-W // 1024)
    assert W - (geo.nseg - 1) * geo.seg > geo.seg - 4 * geo.nseg
    # every (output plane, row group, segment) exactly once
    nhq = -(-H // 2)
    assert geo.items == geo.nseg * nhq * B
    i = np.arange(geo.items, dtype=np.int64)
    q, z, hq, sg = _k4_decode(i, B // P, P, nhq)
    key = ((z + q * P) * nhq + hq) * geo.nseg + sg
    assert np.array_equal(np.sort(key), i)
    # the kernel's advance (K4Item::advance) gives the next item's decoding
    nq, nz, nh, ns = q + 1, z.copy(), hq.copy(), sg.copy()
    wrap = nq == B // P
    nq[wrap] = 0
    nz[wrap] += 1
    wrap = nz == P
    nz[wrap] = 0
    nh[wrap] += 1
    wrap = nh == nhq
    nh[wrap] = 0
    ns[wrap] += 1
    for got, want in zip((nq, nz, nh, ns), _k4_decode(i + 1, B // P, P,
                                                       nhq)):
        assert np.array_equal(got[:-1], want[:-1])
    # the blocks' runs [N g / G, N (g + 1) / G)
    assert geo.grid == min(geo.items, 3 * 132)
    g = np.arange(geo.grid + 1, dtype=np.int64)
    bounds = geo.items * g // geo.grid
    assert bounds[0] == 0 and bounds[-1] == geo.items
    assert set(np.diff(bounds).tolist()) <= {geo.items // geo.grid,
                                             -(-geo.items // geo.grid)}
    if name == "card fused":
        assert geo.items > geo.grid and geo.items % geo.grid
    # ring rows and shared memory
    j0 = np.arange(geo.nseg) * geo.seg
    j1 = np.minimum(j0 + geo.seg, W)
    span = start[j1 - 1].astype(np.int64) + K - start[j0]
    assert span.max() + 3 <= geo.cap and geo.cap % 4 == 0
    assert 2 <= geo.stages <= 4
    slot = 2 * (4 * geo.cap + 1024 * img_bytes + 1024 * 8 * fields)
    assert geo.smem == geo.stages * slot
    assert 3 * geo.smem <= 232448


def test_k4_geometry_rejects():
    """Bands wider than a ring row holds, and empty shapes."""
    assert cb.k4_geometry(1, 1, 1, 62, 132).cap <= 1088
    with pytest.raises(ValueError, match="at most 62 taps"):
        cb.k4_geometry(4, 16, 2000, 63, 132)
    with pytest.raises(ValueError, match="positive sizes"):
        cb.k4_geometry(0, 16, 2000, 3, 132)


def test_level1_chain(lvl1):
    """Level 1 (no log1p): K1 -> K2 and K3 -> bare K4 at 1280x1280."""
    jp, spec, bops, ops = lvl1
    h, w, lh, lw = jf._band_level_geometry(jp, 1)
    rng = np.random.default_rng(9)
    a = rng.normal(size=(2, h, w)).astype(np.float32)
    lox_j = pb.an_x_lowpass_log1p(jnp.asarray(a), bops["bk1"],
                                  spec["k1"]["starts"], lw, log1p=False,
                                  interpret=True)
    ca_j, ch_j = pb.an_y_pass(lox_j, bops["bk2"], spec["k2"]["stride"],
                              spec["k2"]["pad"], lh, interpret=True)
    lox = _k1(torch.from_numpy(a), ops, log1p=False)
    ca, ch, _ = _k2(lox, ops)
    np.testing.assert_allclose(ca.numpy(), np.asarray(ca_j), rtol=3e-5,
                               atol=6e-4)
    np.testing.assert_allclose(ch.numpy(), np.asarray(ch_j), rtol=3e-5,
                               atol=6e-4)

    corr = rng.normal(size=(2, lh, lw)).astype(np.float32)
    delta = rng.normal(size=(2, lh, lw)).astype(np.float32)
    st_j = pb.syn_y_pass(jnp.asarray(corr), jnp.asarray(delta),
                         bops["bk3_lo"], bops["bk3_hi"], spec["k3"]["stride"],
                         spec["k3"]["pad"], h, interpret=True)
    want = pb.syn_x_exp(st_j, None, bops["bk4"], spec["k4"]["starts"], w,
                        interpret=True)
    got = _k4(_k3(torch.from_numpy(corr), torch.from_numpy(delta), ops),
              None, ops)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=2e-3)


def test_loader_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "build_dir",
                        lambda: cuda_build.Path("/nonexistent/kernels"))
    cuda_build.kernel_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.kernel_library()
    cuda_build.kernel_library.cache_clear()


def test_wrapper_refuses_other_devices(lvl0):
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    route: no silent fallback to the plain twin."""
    _, _, _, ops = lvl0
    x = torch.empty((1, H, W), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain route"):
        _k1(x, ops)
