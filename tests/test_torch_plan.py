"""The torch package's numpy plan against the JAX package's.

Filter banks, operator builders, notch operators, shape ladders, the dense
constants and the classifier cut must be equal (np.array_equal) at the
production geometry 1600x2000, at 2048x2048 and at an odd geometry. The
band forms the Hopper kernels read, built from the wavelet's taps, must
rebuild each dense operator exactly (float64), and the plane step's
constants (device_constants) must carry the JAX package's arrays to torch
unchanged.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_tpu.ops import fft_notch as jn  # noqa: E402
from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops import wavelets as jw  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import fft_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.ops import wavelets as tw  # noqa: E402
from aind_smartspim_destripe_torch.parallel import halo as th_  # noqa: E402

GEOMETRIES = [(1600, 2000), (2048, 2048), (1001, 777)]
CELLS = dict(wavelet="db3", level=None, sigma=64.0, max_threshold=3.0)
NO_CELLS = dict(wavelet="db3", level=None, sigma=128.0, max_threshold=12.0)


def _plans(h, w):
    jp = jf.build_plan(h, w, jf.FilterConfig(**CELLS),
                       jf.FilterConfig(**NO_CELLS))
    tp = tf.build_plan(h, w, tf.FilterConfig(**CELLS),
                       tf.FilterConfig(**NO_CELLS))
    return jp, tp


@pytest.mark.parametrize("name", ["haar", "db1", "db3", "db4", "db8", "db20"])
def test_filter_banks_equal(name):
    a, b = jw.wavelet(name), tw.wavelet(name)
    assert a.rec_lo == b.rec_lo and a.name == b.name
    for attr in ("dec_lo", "dec_hi", "rec_lo_arr", "rec_hi"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


def _banded(tp):
    """The levels that run the banded kernels, as destripe_batch reads
    them: the band keys of the plan's constants on a device."""
    consts = tf.device_constants(tp, "cpu")
    return tuple(sorted(int(k[4:]) for k in consts if k.startswith("band")))


@pytest.mark.parametrize("n", [12, 128, 503, 1002, 2000])
def test_axis_operators_equal(n):
    assert tw.dwt_max_level(n, 6) == jw.dwt_max_level(n, 6)
    assert tw.dwt_coeff_len(n, 6) == jw.dwt_coeff_len(n, 6)
    assert tw.idwt_len(n, 6) == jw.idwt_len(n, 6)
    np.testing.assert_array_equal(tw._fold_symmetric(np.arange(-9, n + 9), n),
                                  jw._fold_symmetric(np.arange(-9, n + 9), n))
    np.testing.assert_array_equal(tw.analysis_operator(n, "db3"),
                                  jw.analysis_operator(n, "db3"))
    np.testing.assert_array_equal(tw.synthesis_operator(n, "db3"),
                                  jw.synthesis_operator(n, "db3"))


@pytest.mark.parametrize("n,sigma", [(12, 2.0), (67, 9.5), (1002, 40.1)])
def test_notch_builders_equal(n, sigma):
    np.testing.assert_array_equal(tn.notch(n, sigma), jn.notch(n, sigma))
    np.testing.assert_array_equal(tn.gaussian_filter((3, n), sigma),
                                  jn.gaussian_filter((3, n), sigma))
    g = tn.notch(n, sigma)
    for a, b in zip(tn._packed_gains(n, g), jn._packed_gains(n, g)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tn.packed_notch_matrix(n, sigma),
                                  jn.packed_notch_matrix(n, sigma))


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_plan_and_dense_constants_equal(hw):
    jp, tp = _plans(*hw)
    assert (tp.height, tp.width, tp.wavelet, tp.n_levels) == (
        jp.height, jp.width, jp.wavelet, jp.n_levels)
    assert tp.ladder == jp.ladder
    assert tp.notch_sigmas() == jp.notch_sigmas()
    shape = hw
    wav_j, wav_t = jw.wavelet("db3"), tw.wavelet("db3")
    for (ja, jx), (ta, tx) in zip(jw.analysis_operators(shape, wav_j),
                                  tw.analysis_operators(shape, wav_t)):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tx, jx)
    for (ja, jx), (ta, tx) in zip(jw.synthesis_operators(shape, wav_j),
                                  tw.synthesis_operators(shape, wav_t)):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tx, jx)
    jc = jp.constants(dense_only=True)
    tc = th_._dense_operators(tp)  # the row-sharded route's dense set
    assert set(tc) == set(jc)
    for key in jc:
        assert len(tc[key]) == len(jc[key])
        for a, b in zip(tc[key], jc[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_ladder_production_geometry():
    _, tp = _plans(1600, 2000)
    assert tp.n_levels == 8
    assert tp.ladder[-1] == (802, 1002) and tp.ladder[0] == (11, 12)
    assert _banded(tp) == (0, 1)


@pytest.mark.parametrize("hw,level", [((1600, 2000), None), ((2048, 2048), 1),
                                      ((1001, 777), None), ((1280, 1280), 2),
                                      ((96, 128), None)])
def test_band_gate_matches_jax(hw, level):
    cfg_j = jf.FilterConfig(wavelet="db3", level=level)
    cfg_t = tf.FilterConfig(wavelet="db3", level=level)
    jp = jf.build_plan(*hw, cfg_j, cfg_j)
    tp = tf.build_plan(*hw, cfg_t, cfg_t)
    want = []
    for lvl in range(jp.n_levels):
        if jf.band_spec(jp, lvl) is None:
            break
        want.append(lvl)
    assert _banded(tp) == tuple(want)


def test_classifier_cut_equal():
    assert tf._classifier_cut(400.0, 20.0, 0.3) == jf._classifier_cut(
        400.0, 20.0, 0.3)
    assert tf._classifier_cut_f32(400.0, 20.0, 0.3) == jf._classifier_cut_f32(
        400.0, 20.0, 0.3)
    cut = tf._classifier_cut_f32(400.0, 20.0, 0.3)
    x = np.arange(65536, dtype=np.float32)
    with np.errstate(over="ignore"):  # 65520.. round to inf in float16
        x16 = x.astype(np.float16)
    np.testing.assert_array_equal(
        x >= np.float32(cut),
        x16 >= np.float16(tf._classifier_cut(400.0, 20.0, 0.3)))


@pytest.mark.parametrize("hw", GEOMETRIES)
def test_band_forms_rebuild_dense_operators(hw):
    """The plane step's constants off the card: each banded level's band
    forms (what the kernels read) rebuild the same dict's dense operators
    (what the plain twins read)."""
    _, tp = _plans(*hw)
    consts = tf.device_constants(tp, "cpu")
    lvls = _banded(tp)
    assert lvls and all(f"band{lvl}" in consts for lvl in lvls)
    assert f"band{len(lvls)}" not in consts
    _check_band_forms(tp, consts, {
        key: tuple(a.numpy() for a in consts[key])
        for key in ("an_y", "an_x_lo", "syn_y", "syn_x_lo")})


def _check_band_forms(tp, consts, dense):
    """Each banded level's band forms of ``consts`` (tensors) rebuild the
    dense operators of ``dense`` (numpy, the constants' layout) exactly."""
    n = tp.n_levels
    for lvl in tp.banded_levels():
        bd = {k: v.numpy() for k, v in consts[f"band{lvl}"].items()}
        an_y, an_x = dense["an_y"][lvl], dense["an_x_lo"][lvl]
        syn_y, syn_x = dense["syn_y"][n - 1 - lvl], dense["syn_x_lo"][n - 1 - lvl]
        L_h = an_y.shape[0] // 2
        pairs = [
            (bd["k1_start"], bd["k1_coef"], an_x),
            (bd["k2_start"], bd["k2_lo"], an_y[:L_h]),
            (bd["k2_start"], bd["k2_hi"], an_y[L_h:]),
            (bd["k3_start"], bd["k3_lo"], syn_y[:, :L_h]),
            (bd["k3_start"], bd["k3_hi"], syn_y[:, L_h:]),
            (bd["k4_start"], bd["k4_coef"], syn_x),
        ]
        for start, coef, op in pairs:
            assert start.dtype == np.int32 and coef.dtype == np.float32
            assert start.min() >= 0
            assert start.max() + coef.shape[1] <= op.shape[1]
            np.testing.assert_array_equal(
                cb.band_dense(start, coef.astype(np.float64), op.shape[1]),
                op.astype(np.float64))
        # K: the wavelet's analysis taps, half as many in synthesis
        flen = tw.wavelet(tp.wavelet).flen
        assert bd["k1_coef"].shape[1] == bd["k2_lo"].shape[1] == flen
        assert bd["k3_lo"].shape[1] == bd["k4_coef"].shape[1] == flen // 2


def test_band_form_of_a_small_operator():
    """``band_form_taps`` of a (3, 40) operator: a row of width 4, two taps
    at one column (they add), and a row whose start clamps to n - K."""
    cols = np.array([[0, 3], [10, 10], [38, 39]])
    vals = np.array([[1.0, 1.0], [0.5, 0.25], [2.0, 2.0]])
    start, (coef, twice) = cb.band_form_taps(cols, 40, vals, 2 * vals)
    assert start.dtype == np.int32 and coef.dtype == np.float32
    assert coef.shape == twice.shape == (3, 4)
    np.testing.assert_array_equal(start, [0, 10, 36])
    A = np.zeros((3, 40), np.float32)
    A[0, 0] = A[0, 3] = 1.0
    A[1, 10] = 0.75
    A[2, 38] = A[2, 39] = 2.0
    np.testing.assert_array_equal(cb.band_dense(start, coef, 40), A)
    np.testing.assert_array_equal(cb.band_dense(start, twice, 40), 2 * A)


def test_constants_from_numpy_round_trip():
    """The plane step's constants on the CPU carry the JAX package's dense
    operators (``constants(dense_only=True)``) to torch unchanged: float32
    tensors, equal entry for entry. A level routed to chirp-z holds its
    tables instead, which map the identity's rows to the JAX package's
    dense bank within float32 rounding."""
    from aind_smartspim_destripe_torch.ops import cuda_notch

    jp, tp = _plans(1001, 777)
    mine = tf.device_constants(tp, "cpu")
    theirs = jp.constants(dense_only=True)
    assert set(theirs) < set(mine)
    assert "chirp" in tp.notch_routes()
    for key, val in theirs.items():
        assert len(mine[key]) == len(val)
        for arr, got in zip(val, mine[key]):
            if isinstance(got, tn.NotchChirp):
                assert all(t.dtype == torch.float32 for t in got[:4])
                w = arr.shape[0]
                eye = torch.eye(w)[None]
                bank = torch.cat([cuda_notch.notch_delta_fft_plain(
                    eye, torch.tensor([np.inf]), torch.tensor([c],
                    dtype=torch.int32), got)[0] + eye[0] for c in (0, 1)], 1)
                np.testing.assert_allclose(bank.numpy(), arr, rtol=0,
                                           atol=2e-6 * np.abs(arr).max())
                continue
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), arr)


# --- the plane step's constants (device_constants) -------------------------

TAP_GEOMETRIES = [((1600, 2000), "db3"), ((2048, 2047), "db3"),
                  ((2301, 2300), "db3"), ((1001, 777), "db3"),
                  ((640, 720), "db3"), ((1200, 1301), "db8")]


def _plan_of(hw, name):
    """The production pair's plan of ``hw`` with the wavelet ``name``."""
    cells = dict(CELLS, wavelet=name)
    no_cells = dict(NO_CELLS, wavelet=name)
    return tf.build_plan(*hw, tf.FilterConfig(**cells),
                         tf.FilterConfig(**no_cells))


@pytest.mark.parametrize("hw,name", TAP_GEOMETRIES)
def test_band_forms_from_taps_equal_the_dense_operators_forms(hw, name):
    """The band forms of ``device_constants(plan, "cpu")``, built from the
    wavelet's taps, rebuild the row-sharded route's dense operators
    (``test_plan_and_dense_constants_equal`` holds them against the JAX
    package's) exactly, and are those of ``band_level_forms_taps``."""
    tp = _plan_of(hw, name)
    consts = tf.device_constants(tp, "cpu")
    lvls = tp.banded_levels()
    assert lvls and lvls == _banded(tp)
    _check_band_forms(tp, consts, th_._dense_operators(tp))
    for lvl in lvls:
        want = cb.band_level_forms_taps(*tp.level_inputs()[lvl], name)
        assert set(consts[f"band{lvl}"]) == set(want)
        for key, arr in want.items():
            np.testing.assert_array_equal(consts[f"band{lvl}"][key].numpy(),
                                          arr)
    assert f"band{len(lvls)}" not in consts


@pytest.mark.parametrize("hw,name", TAP_GEOMETRIES[:2])
def test_device_constants_hold_no_dense_operator_of_a_banded_level(hw, name):
    """On a card a banded level's dense operators are None, the rest as off
    the card; off the card every dense operator is built (the plain twins
    read them), and both hold the same band forms and notch operators."""
    tp = _plan_of(hw, name)
    n, lvls = tp.n_levels, tp.banded_levels()
    host = tf._build_constants(tp, torch.device("cpu"))
    # a card's constants, built here: every ladder width is under the notch
    # gate, so nothing of them is built on the card
    card = tf._build_constants(tp, torch.device("cuda"))
    assert lvls and set(card) == set(host)
    for lvl in range(n):
        for key, idx in (("an_y", lvl), ("an_x_lo", lvl),
                         ("syn_y", n - 1 - lvl), ("syn_x_lo", n - 1 - lvl)):
            if lvl in lvls:
                assert card[key][idx] is None
                assert host[key][idx] is not None
            else:
                np.testing.assert_array_equal(card[key][idx], host[key][idx])
    for a, b in zip(card["notch_cat"], host["notch_cat"]):
        assert type(a) is type(b)
        for x, y in (zip(a, b) if isinstance(a, tuple) else ((a, b),)):
            np.testing.assert_array_equal(x, y)
    for lvl in lvls:
        for key, arr in host[f"band{lvl}"].items():
            np.testing.assert_array_equal(card[f"band{lvl}"][key], arr)
    got = tf.device_constants(tp, "cpu")
    assert set(got) == set(host)
    for key, val in host.items():
        pairs = (zip(val.values(), got[key].values()) if isinstance(val, dict)
                 else zip(val, got[key]))
        for a, b in pairs:
            for x, y in (zip(a, b) if isinstance(a, tuple) else ((a, b),)):
                if isinstance(x, np.ndarray):
                    assert torch.equal(torch.from_numpy(x), y)
                else:
                    assert x == y


def _ladder_widths():
    """(width, sigma pair) of every level of the accepted cells' plans."""
    tp = tf.build_plan(1600, 2000, tf.FilterConfig(**CELLS),
                       tf.FilterConfig(**NO_CELLS))
    return [(w, s) for (_, w), s in zip(tp.ladder, tp.notch_sigmas())]


@pytest.mark.parametrize("w,sigmas", _ladder_widths())
def test_notch_cat_equals_packed_notch_matrix(w, sigmas):
    want = np.concatenate([tn.packed_notch_matrix(w, s).astype(np.float32).T
                           for s in sigmas], axis=1)
    for device in (None, "cpu"):
        got = tn.notch_cat(w, sigmas, device)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [13, 254, 503, 1002, 1129, 2047, 2254, 2301])
def test_notch_cat_by_torch_fft_within_an_ulp(w):
    """The torch form of ``notch_cat`` (a card's past the host gate), here
    on the CPU's FFT: within a float32 ulp of the host's operator, of
    max(|entry|, 2^-20) (float64 rounds the tiniest entries apart by more
    of their own ulps)."""
    sigmas = (w * 64.0 / 1600, w * 128.0 / 1600)
    host = tn.notch_cat(w, sigmas)
    got = tn._notch_cat_torch(w, sigmas, torch.device("cpu"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (w, 2 * w)
    tol = np.spacing(np.maximum(np.abs(host), np.float32(2 ** -20)))
    assert (np.abs(got.numpy() - host) <= tol).all()


@pytest.mark.parametrize("dual", [False, True])
def test_destripe_batch_same_output_with_device_constants(dual):
    from aind_smartspim_destripe_torch.ops import dual_band as tdb

    tp = tf.build_plan(640, 720, tf.FilterConfig(**CELLS),
                       tf.FilterConfig(**NO_CELLS))
    assert tp.banded_levels() == (0,)
    rng = np.random.default_rng(5)
    rows = rng.normal(0, 60, (2, 640, 1))
    base = np.array([300.0, 3100.0])[:, None, None]  # plane 1 bright: cells
    x = torch.as_tensor(np.clip(base + rows + rng.normal(0, 8, (2, 640, 720)),
                                0, 65535).astype(np.uint16))
    flat = torch.as_tensor(1 + 0.1 * rng.random((640, 720)),
                           dtype=torch.float32)
    dark = torch.full((640, 720), 3.0)
    outs = []
    for consts in (tf.device_constants(tp, "cpu"), None):
        if dual:
            outs.append(tdb.dual_band_destripe_batch(
                tp, x, 100.0, consts=consts, flat=flat, dark=dark))
        else:
            outs.append(tf.destripe_batch(tp, x, 2500.0, consts, flat=flat,
                                          dark=dark))
    assert outs[0].dtype == torch.uint16
    for got in outs[1:]:
        assert torch.equal(got, outs[0])


def test_counters_read_after_a_plan_build(monkeypatch):
    from aind_smartspim_destripe_torch.runtime import tracing
    from portbench import harness

    tf.build_plan.cache_clear()
    before = tracing.counters()
    tp = tf.build_plan(200, 240, tf.FilterConfig(**CELLS),
                       tf.FilterConfig(**NO_CELLS))
    tf.device_constants(tp, "cpu")
    after = tracing.counters()
    for key in ("plan.build_s", "plan.constants_s", "plan.upload_s"):
        assert after[key] > before.get(key, 0.0)
    # plan tensors on the CPU are not on a card
    assert after.get("plan.device_bytes", 0) == before.get(
        "plan.device_bytes", 0)
    reader = harness.load_reader("setup.plan_s")
    got = reader.read(None)
    assert got == pytest.approx(sum(after[k] for k in (
        "plan.build_s", "plan.constants_s", "plan.upload_s")))
    monkeypatch.setattr(tracing, "counters", dict)  # a program without them
    assert reader.read(None) is None
    monkeypatch.delattr(tracing, "counters")
    assert reader.read(None) is None


# --- the notch route: the dense operators, the exact-rank factors or the
# chirp-z transforms ---------------------------------------------------------

ROUTE_PLANS = {"tile": (1600, 2000), "stitched": (16384, 18000)}


@pytest.mark.parametrize("name", sorted(ROUTE_PLANS))
def test_notch_route_by_width_and_rank(name):
    """The production tile plan runs its three widest levels (254, 503 and
    1002 columns) by chirp-z and the rest dense, the fused plane's plan
    every level from its factors: the rule read from the widths and the
    sigmas alone (2 max(r) against the width, then the width and the FFT
    length), no operator built."""
    tp = _plans(*ROUTE_PLANS[name])[1]
    ranks = [tuple(tn.notch_rank(w, s) for s in sigmas)
             for (_, w), sigmas in zip(tp.ladder, tp.notch_sigmas())]
    for (_, w), sigmas, r in zip(tp.ladder, tp.notch_sigmas(), ranks):
        assert r == tuple(int(np.count_nonzero(tn.notch(w, s) != 1.0))
                          for s in sigmas)
    share = [2 * max(r) / w for (_, w), r in zip(tp.ladder, ranks)]
    routes = tp.notch_routes()
    if name == "tile":
        assert min(share) >= 1.1
        assert routes == ("dense",) * 5 + ("chirp",) * 3
        assert [w for (_, w), r in zip(tp.ladder, routes)
                if r == "chirp"] == [254, 503, 1002]
        assert [tn.chirp_size(w, s)[1] for (_, w), s in zip(
            tp.ladder[5:], tp.notch_sigmas()[5:])] == [512, 1024, 2048]
    else:
        assert max(share) <= 0.19 and routes == ("lowrank",) * 11


@pytest.mark.parametrize("w,sigmas,route", [
    (1002, (32.08, 64.16), "chirp"),  # the tile's level 0
    (129, (4.16, 8.32), "dense"),  # the tile's level 3: under CHIRP_MIN_W
    (262, (16.4, 32.75), "dense"),  # the gains reach the Nyquist term
    (3000, (120.0, 240.0), "dense"),  # n + 2K past the largest FFT length
    (4096, (32.0, 64.0), "lowrank"),  # 2 max(r) <= n / 2 comes first
    (1002, (16.0, 32.0), "chirp"),  # 2 max(r) / n 0.55: not low enough
])
def test_notch_route_rule(w, sigmas, route):
    """Each arm of the rule: the factors first, then chirp-z where the
    width passes the crossover and the kept frequencies fit an FFT length
    of the kernel without the Nyquist term, dense elsewhere."""
    assert tn.notch_route(w, sigmas) == route
    k, m = tn.chirp_size(w, sigmas)
    assert k == max(tn.notch_rank(w, s) for s in sigmas) // 2
    assert m >= w + 2 * k > m // 2 and m & (m - 1) == 0


LOWRANK_CFG = (dict(CELLS, sigma=8.0), dict(NO_CELLS, sigma=16.0))


@pytest.mark.parametrize("hw,cfgs,levels", [
    ((256, 1024), LOWRANK_CFG, {"lowrank": 5}),
    ((200, 240), (CELLS, NO_CELLS), {}),
    ((96, 1200), (CELLS, NO_CELLS), {"chirp": 2}),
], ids=["factors", "dense", "chirp"])
def test_constants_hold_the_factors_where_routed(hw, cfgs, levels):
    """The plane step's constants give a routed level its record in place
    of the dense bank in ``notch_cat`` (its factors on the ``lowrank``
    route, its chirp-z tables on the ``chirp`` one) and count the routed
    levels in ``plan.notch_lowrank_levels`` and ``plan.notch_fft_levels``;
    the row-sharded route's dense set keeps the dense bank everywhere."""
    from aind_smartspim_destripe_torch.runtime import tracing

    tp = tf.build_plan(*hw, *(tf.FilterConfig(**c) for c in cfgs))
    names = ("plan.notch_lowrank_levels", "plan.notch_fft_levels")
    before = [tracing.counters().get(k, 0) for k in names]
    consts = tf.device_constants(tp, "cpu")
    routes = tp.notch_routes()
    assert [tracing.counters()[k] - b for k, b in zip(names, before)] == [
        levels.get("lowrank", 0), levels.get("chirp", 0)] == [
        routes.count("lowrank"), routes.count("chirp")]
    for i, ((_, w), sigmas) in enumerate(zip(tp.ladder, tp.notch_sigmas())):
        entry = consts["notch_cat"][i]
        if routes[i] == "dense":
            assert tuple(entry.shape) == (w, 2 * w)
            continue
        want = (tn.notch_factors if routes[i] == "lowrank"
                else tn.notch_chirp)(w, sigmas)
        assert isinstance(entry, type(want))
        for got, ref in zip(entry, want):
            if isinstance(ref, np.ndarray):
                assert torch.equal(got, torch.from_numpy(ref))
            else:
                assert got == ref
        if routes[i] == "lowrank":
            assert entry.ranks == tuple(tn.notch_rank(w, s) for s in sigmas)
    dense = th_._dense_operators(tp)
    assert all(isinstance(c, np.ndarray) for c in dense["notch_cat"])


@pytest.mark.parametrize("name,counts", [("tile", (0, 3)),
                                         ("stitched", (11, 0))])
def test_notch_route_counters(name, counts):
    """``plan.notch_lowrank_levels`` and ``plan.notch_fft_levels`` count a
    card's routed levels as the constants are built: 0 and 3 in the tile
    plan, 11 and 0 in the fused plane's (a card's dict built on the host:
    no dense notch operator of either plan is wider than the host's
    gate)."""
    from aind_smartspim_destripe_torch.runtime import tracing

    tp = _plans(*ROUTE_PLANS[name])[1]
    names = ("plan.notch_lowrank_levels", "plan.notch_fft_levels")
    before = [tracing.counters().get(k, 0) for k in names]
    consts = tf._build_constants(tp, torch.device("cuda"))
    assert tuple(tracing.counters()[k] - b
                 for k, b in zip(names, before)) == counts
    kinds = {"lowrank": tn.NotchFactors, "chirp": tn.NotchChirp,
             "dense": np.ndarray}
    assert all(isinstance(c, kinds[r]) for c, r in zip(
        consts["notch_cat"], tp.notch_routes()))


def test_lowrank_plane_step_matches_jax():
    """A 256 x 1024 plan with sigmas 8 / 16 runs every level's notch from
    its factors; the step stays within the CPU suite's flip budget and
    PSNR of the JAX package's dense notch, single band and dual."""
    import jax
    import jax.numpy as jnp

    from aind_smartspim_destripe_torch.ops import dual_band as tdb
    from aind_smartspim_destripe_tpu.ops import dual_band as jdb
    from tests.test_torch_filter import HIGH_INT, _batch, _gate_vs_jax

    h, w = 256, 1024
    jp = jf.build_plan(h, w, *(jf.FilterConfig(**c) for c in LOWRANK_CFG))
    tp = tf.build_plan(h, w, *(tf.FilterConfig(**c) for c in LOWRANK_CFG))
    assert tp.notch_routes() == ("lowrank",) * 5 and tp.banded_levels() == ()
    x = _batch(2, h, w, seed=8)
    want = np.asarray(jax.jit(lambda im: jf.destripe_batch(
        jp, im, HIGH_INT, jp.constants(), wrap=True))(jnp.asarray(x)))
    got = tf.destripe_batch(tp, torch.from_numpy(x), HIGH_INT,
                            wrap=True).numpy()
    _gate_vs_jax(got, want)
    want = np.asarray(jdb.dual_band_destripe_batch(
        jp, jnp.asarray(x), 100.0, -1.0))
    got = tdb.dual_band_destripe_batch(tp, torch.from_numpy(x), 100.0,
                                       -1.0).numpy()
    _gate_vs_jax(got, want)
