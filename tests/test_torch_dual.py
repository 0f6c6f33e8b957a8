"""The dual-band path of the torch package on the CPU, against the JAX
package (ops/dual_band.py, ops/pallas_blend.py and the wrapped forms of
ops/pallas_band.py:syn_x_exp, ops/pallas_notch.py:notch_delta and
ops/pallas_median.py:row_median_masked).

- The blend twin and the CPU route of ``blend_smooth_mix`` against the
  Pallas blend kernel in interpret mode and the XLA formulation, at
  tests/test_dual_band.py's geometry and tolerance (rtol 2e-5, atol 2e-2:
  the two sum the 17 box taps in different orders and the TPU kernel
  divides by 289 once).
- K4's, the median's and the notch's wrapped forms against the Pallas
  kernels in interpret mode, at the tolerances of tests/test_torch_band.py
  and tests/test_torch_notch.py (bf16x3 products there, f32 here); medians
  exact.
- ``destripe_batch(dual=True)``, ``dual_band_destripe_batch``, the device
  step and ``destripe_zarr`` against the JAX package with the flip-budget
  gate of tests/test_torch_filter.py, and the float64 oracle composition of
  tests/test_dual_band.py at > 80 dB.

The Hopper kernels themselves are held against these twins on the card by
tests/test_torch_card.py and chip_smoke.py.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.io.readers import imread  # noqa: E402
from aind_smartspim_destripe_tpu.io.zarr import open_zarr  # noqa: E402
from aind_smartspim_destripe_tpu.ops import dual_band as jdb  # noqa: E402
from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops import flatfield as jff  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_band as pb  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_blend as pbl  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_median as pm  # noqa: E402
from aind_smartspim_destripe_tpu.ops import pallas_notch as pn  # noqa: E402
from aind_smartspim_destripe_tpu.runtime import pipeline as jpl  # noqa: E402
from aind_smartspim_destripe_torch import ops as tops  # noqa: E402
from aind_smartspim_destripe_torch import run_capsule  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_blend as tbl  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import dual_band as tdb  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.runtime import pipeline as tpl  # noqa: E402
from tests.golden import numpy_ref as G  # noqa: E402
from tests.test_dual_band import synthetic_plane  # noqa: E402
from tests.test_run_capsule_e2e import H, W, Z, build_capsule  # noqa: E402
from tests.test_torch_band import _level  # noqa: E402
from tests.test_torch_filter import _batch, _gate_vs_jax  # noqa: E402
from tests.test_torch_notch import notch_case  # noqa: E402, F401

CPU = [torch.device("cpu")]
CELLS = dict(wavelet="db3", level=None, sigma=64.0, max_threshold=3.0)
NO_CELLS = dict(wavelet="db3", level=None, sigma=128.0, max_threshold=12.0)
HIGH_INT = 2500.0
TILES = {"471320_461360": 0, "489620_461360": 1}  # tile -> laser side


def _plans(h, w):
    return (jf.build_plan(h, w, jf.FilterConfig(**CELLS),
                          jf.FilterConfig(**NO_CELLS)),
            tf.build_plan(h, w, tf.FilterConfig(**CELLS),
                          tf.FilterConfig(**NO_CELLS)))


# ---------------------------------------------------------------------------
# (a) the blend
# ---------------------------------------------------------------------------


def _blend_inputs(dtype):
    rng = np.random.default_rng(3)
    B, h, w = 2, 200, 260  # ragged row tiles, a non-128 lane width
    if dtype == np.uint16:
        x = rng.integers(0, 4000, (B, h, w)).astype(np.uint16)
    else:
        x = rng.uniform(0.0, 4000.0, (B, h, w)).astype(np.float32)
    xf = x.astype(np.float32)
    fore = (xf * 0.9 + rng.normal(size=(B, h, w)) * 5).astype(np.float32)
    back = (xf * 1.1 + rng.normal(size=(B, h, w)) * 5).astype(np.float32)
    centers = rng.uniform(100.0, 400.0, (B,)).astype(np.float32)
    return x, fore, back, centers


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "split"])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32],
                         ids=["u16", "f32"])
def test_blend_matches_pallas_and_xla(dtype, stacked):
    x, fore, back, centers = _blend_inputs(dtype)
    want_k = np.asarray(pbl.blend_smooth_mix(
        jnp.asarray(x), jnp.asarray(fore), jnp.asarray(back),
        jnp.asarray(centers), 100.0, interpret=True))
    want_x = np.asarray(jdb.blend_bands_xla(
        jnp.asarray(x), jnp.asarray(fore), jnp.asarray(back),
        jnp.asarray(centers), 100.0))
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, fore=fore, back=back, c=centers).items()}
    if stacked:
        got = tbl.blend_smooth_mix(t["x"], torch.cat([t["fore"], t["back"]]),
                                   None, t["c"], 100.0)
    else:
        got = tbl.blend_smooth_mix(t["x"], t["fore"], t["back"], t["c"],
                                   100.0)
    twin = tbl.blend_bands(t["x"], t["fore"], t["back"], t["c"], 100.0)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, twin)
    for want in (want_k, want_x):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-2)


def test_blend_refuses_unpaired_stack():
    x, fore, _, centers = _blend_inputs(np.float32)
    with pytest.raises(ValueError, match="stacked band pair"):
        tbl.blend_smooth_mix(torch.from_numpy(x), torch.from_numpy(fore),
                             None, torch.from_numpy(centers), 100.0)


# The fused epilogues: shapes at and under the box width on each axis, a
# ragged tile, and a non-multiple-of-4 width; the emitted rows, when cut,
# are a row shard's window's middle (or its end for the tiny plane).
FUSED_SHAPES = [(2, 37, 203), (1, 5, 9), (2, 200, 260)]
FUSED_ROWS = {37: (8, 21), 5: (2, 3), 200: (16, 168)}


def _fused_inputs(shape, epilogue, rows):
    """uint16 planes, the stacked band pair, centres and the fields of the
    emitted rows (a darkfield larger than the rows, cropped by the blend as
    by ``flatfield_correction``)."""
    B, h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    x = rng.integers(0, 4000, shape).astype(np.uint16)
    both = (rng.normal(size=(2 * B, h, w)) * 300 + 800).astype(np.float32)
    centers = rng.uniform(100.0, 3000.0, (B,)).astype(np.float32)
    n = h if rows is None else rows[1]
    kw = {}
    if epilogue == "flat":
        kw = dict(flat=(1.0 + 0.5 * rng.random((n, w))).astype(np.float32),
                  dark=rng.uniform(0.0, 600.0, (n + 3, w + 2)).astype(
                      np.float32))
    elif epilogue == "wrap":
        both[:B] -= 1500.0  # negative foreground values: the wrap's modulo
        kw = dict(wrap=True)
    return x, both, centers, kw


def _torch_epilogue(y, kw):
    if "flat" in kw:
        return tf.flatfield_correction(y, torch.from_numpy(kw["flat"]),
                                       torch.from_numpy(kw["dark"]))
    return tf.wrap_cast(y)


@pytest.mark.parametrize("rows", [None, "cut"], ids=["all-rows", "out-rows"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "split"])
@pytest.mark.parametrize("epilogue", ["flat", "wrap"])
@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: f"{s[1]}x{s[2]}")
def test_blend_fused_cpu_route_is_the_composition(shape, epilogue, stacked,
                                                   rows):
    """The CPU route of the fused blend is the step's composition, bit for
    bit: the twin, the row slice, then the epilogue."""
    rows = FUSED_ROWS[shape[1]] if rows else None
    x, both, centers, kw = _fused_inputs(shape, epilogue, rows)
    B = shape[0]
    t = {k: torch.from_numpy(v) for k, v in
         dict(x=x, both=both, c=centers).items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    if stacked:
        got = tbl.blend_smooth_mix(t["x"], t["both"], None, t["c"], 100.0,
                                   out_rows=rows, **tkw)
    else:
        got = tbl.blend_smooth_mix(t["x"], t["both"][:B], t["both"][B:],
                                   t["c"], 100.0, out_rows=rows, **tkw)
    y = tbl.blend_bands(t["x"], t["both"][:B], t["both"][B:], t["c"], 100.0)
    if rows is not None:
        y = y[:, rows[0]:rows[0] + rows[1]]
    want = _torch_epilogue(y, kw)
    n = shape[1] if rows is None else rows[1]
    assert got.dtype == torch.uint16 and got.shape == (B, n, shape[2])
    assert torch.equal(got, want)


@pytest.mark.parametrize("epilogue", ["flat", "wrap"])
@pytest.mark.parametrize("shape", FUSED_SHAPES,
                         ids=lambda s: f"{s[1]}x{s[2]}")
def test_blend_fused_matches_pallas_then_epilogue(shape, epilogue):
    """The fused blend (CPU route) against the JAX package's Pallas blend
    in interpret mode followed by its own epilogue (and row slice): within
    1 LSB (the TPU kernel sums the box taps in another order and divides by
    289 once)."""
    rows = FUSED_ROWS[shape[1]]
    x, both, centers, kw = _fused_inputs(shape, epilogue, rows)
    B = shape[0]
    y = pbl.blend_smooth_mix(jnp.asarray(x), jnp.asarray(both), None,
                             jnp.asarray(centers), 100.0, interpret=True)
    y = y[:, rows[0]:rows[0] + rows[1]]
    if epilogue == "flat":
        want = jff.flatfield_correction(y, jnp.asarray(kw["flat"]),
                                        jnp.asarray(kw["dark"]))
    else:
        want = jf.wrap_cast(y)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = tbl.blend_smooth_mix(torch.from_numpy(x), torch.from_numpy(both),
                               None, torch.from_numpy(centers), 100.0,
                               out_rows=rows, **tkw).numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.uint16
    assert got.shape == want.shape == (B, rows[1], shape[2])
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    if epilogue == "wrap":  # modulo 2^16: 65535 and 0 are 1 LSB apart
        d = np.minimum(d, 65536 - d)
    assert d.max() <= 1, f"{d.max()} LSB"


def test_blend_refuses_bad_epilogues_and_rows():
    x, both, centers, _ = _fused_inputs((2, 37, 203), "flat", None)
    x, both, centers = map(torch.from_numpy, (x, both, centers))
    flat, dark = torch.ones((37, 203)), torch.zeros((37, 203))

    def blend(**kw):
        return tbl.blend_smooth_mix(x, both, None, centers, 100.0, **kw)

    with pytest.raises(ValueError, match="exclusive"):
        blend(flat=flat, dark=dark, wrap=True)
    with pytest.raises(ValueError, match="together"):
        blend(flat=flat)
    with pytest.raises(ValueError, match="flatfield"):
        blend(flat=torch.ones((36, 203)), dark=dark)
    with pytest.raises(ValueError, match="darkfield"):
        blend(flat=flat, dark=torch.zeros((37, 200)))
    with pytest.raises(ValueError, match="flatfield"):  # fields of the rows
        blend(flat=flat, dark=dark, out_rows=(8, 21))
    for rows in ((-1, 5), (30, 8), (0, 38), (4, -1)):
        with pytest.raises(ValueError, match="outside the window"):
            blend(out_rows=rows)
    with pytest.raises(ValueError, match="exclusive"):
        tdb.dual_band_destripe_batch(_plans(96, 128)[1],
                                     torch.zeros((1, 96, 128)), 100.0,
                                     flat=torch.ones((96, 128)),
                                     dark=torch.zeros((96, 128)), wrap=True)


# ---------------------------------------------------------------------------
# (b), (c) the wrapped kernels
# ---------------------------------------------------------------------------


def test_k4_wrapped_matches_pallas():
    """K4's exp mode with 2B corrections and B raw planes: correction b
    reads image plane b mod B."""
    jp, spec, bops, ops = _level(640, 768, 1, 0)
    h, w = 640, 768
    L_w = jp.ladder[-1][1]
    rng = np.random.default_rng(12)
    st = (rng.normal(size=(4, h, L_w)) * 0.01).astype(np.float32)
    img = rng.integers(0, 3000, (2, h, w), np.uint16)
    want = np.asarray(pb.syn_x_exp(jnp.asarray(st), jnp.asarray(img),
                                   bops["bk4"], spec["k4"]["starts"], w,
                                   interpret=True))
    got = cb.syn_x_exp(torch.from_numpy(st), torch.from_numpy(img),
                       ops["syn_x_lo"], ops["k4_start"], ops["k4_coef"])
    assert got.dtype == torch.float32 and got.shape == (4, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-2)
    with pytest.raises(ValueError, match="not a multiple"):
        cb.syn_x_exp(torch.from_numpy(st[:3]), torch.from_numpy(img),
                     ops["syn_x_lo"], ops["k4_start"], ops["k4_coef"])


def test_notch_and_median_wrapped_match_pallas(notch_case):  # noqa: F811
    """k = 2 output planes per band plane, with a different cap per half
    (so different stripe masks and medians): against the Pallas notch
    kernel with n_out = 2B and the Pallas median over the tiled band."""
    ch, bc, bn, _, _ = notch_case
    B = ch.shape[0]
    thr = np.array([0.9, 1.5, 0.6, 2.5, 1.2, 3.0], np.float32)
    sel = np.array([0, 0, 0, 1, 1, 1], np.int32)
    want = np.asarray(pn.notch_delta(
        jnp.asarray(ch), None, jnp.asarray(thr), jnp.asarray(sel),
        pn.stacked_notch_operators(bc, bn), interpret=True))
    cat = torch.from_numpy(np.concatenate([bc.T, bn.T], axis=1))
    t_ch, t_thr = torch.from_numpy(ch), torch.from_numpy(thr)
    got = tn.notch_delta(t_ch, t_thr, torch.from_numpy(sel), cat).numpy()
    assert got.shape == (2 * B,) + ch.shape[1:]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    tiled = np.concatenate([ch, ch])
    stripes = np.sqrt(tiled * tiled) > thr[:, None, None]
    assert np.all(got[stripes] == 0.0)

    med_j = np.asarray(pm.row_median_masked(jnp.asarray(tiled),
                                            jnp.asarray(thr), interpret=True))
    med = tn.row_median_masked(t_ch, t_thr)
    assert med.shape == (2 * B, ch.shape[1], 1)
    np.testing.assert_array_equal(med.numpy(), med_j)
    assert not np.array_equal(med_j[:B], med_j[B:])  # the halves differ
    with pytest.raises(ValueError, match="not a multiple"):
        tn.row_median_masked(t_ch, t_thr[:4])


# ---------------------------------------------------------------------------
# (d), (e) the dual step
# ---------------------------------------------------------------------------


DUAL_CASES = [((96, 128), 3), ((640, 768), 2)]


@pytest.fixture(scope="module")
def dual_runs():
    """Both packages' dual outputs per geometry (uint16 input)."""
    out = {}
    for (h, w), b in DUAL_CASES:
        jp, tp = _plans(h, w)
        x = _batch(b, h, w, seed=h + 1)
        consts = jp.constants()
        both_j = np.asarray(jf.destripe_batch(jp, jnp.asarray(x), -np.inf,
                                              consts, dual=True))
        blend_j = np.asarray(jdb.dual_band_destripe_batch(
            jp, jnp.asarray(x), 100.0, -1.0, consts=consts))
        both_t = tf.destripe_batch(tp, torch.from_numpy(x), -np.inf,
                                   dual=True).numpy()
        blend_t = tdb.dual_band_destripe_batch(tp, torch.from_numpy(x),
                                               100.0, -1.0).numpy()
        out[(h, w)] = (both_t, both_j, blend_t, blend_j)
    return out


@pytest.mark.parametrize("case", DUAL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}")
def test_dual_destripe_batch_matches_jax(dual_runs, case):
    (h, w), b = case
    both_t, both_j, _, _ = dual_runs[(h, w)]
    assert both_t.dtype == np.float32 and both_t.shape == (2 * b, h, w)
    _gate_vs_jax(both_t, both_j)
    assert np.abs(both_t[:b] - both_t[b:]).max() > 0.1  # the bands differ


@pytest.mark.parametrize("case", DUAL_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}")
def test_dual_band_destripe_batch_matches_jax(dual_runs, case):
    (h, w), b = case
    _, _, blend_t, blend_j = dual_runs[(h, w)]
    assert blend_t.dtype == np.float32 and blend_t.shape == (b, h, w)
    _gate_vs_jax(blend_t, blend_j)


def test_band_path_taken_in_dual_mode(monkeypatch):
    """At 640x768 level 0 runs K1-K4, K4 in its wrapped form."""
    _, tp = _plans(640, 768)
    seen = []
    real = cb.syn_x_exp

    def spy(stacked, images, *a, **kw):
        seen.append((stacked.shape[0], None if images is None
                     else images.shape[0]))
        return real(stacked, images, *a, **kw)

    monkeypatch.setattr(cb, "syn_x_exp", spy)
    tf.destripe_batch(tp, torch.from_numpy(_batch(2, 640, 768, seed=5)),
                      dual=True)
    assert seen == [(4, 2)]


def test_dual_refuses_epilogues():
    _, tp = _plans(96, 128)
    x = torch.zeros((1, 96, 128))
    with pytest.raises(ValueError, match="blend them"):
        tf.destripe_batch(tp, x, wrap=True, dual=True)
    with pytest.raises(ValueError, match="blend them"):
        tf.destripe_batch(tp, x, flat=torch.ones((96, 128)),
                          dark=torch.zeros((96, 128)), dual=True)


def test_dual_band_matches_float64_oracle():
    """The float64 oracle composition of tests/test_dual_band.py: golden
    single-band filters per config, the golden Otsu centre on the raw
    plane, scipy's uniform_filter(17, mode='nearest') and the sigmoid mix."""
    from scipy import ndimage

    h, w = 96, 128
    imgs = np.stack([synthetic_plane(h, w, seed=s) for s in (3, 4)])
    sig_fore, sig_back, thr, crossover = 256.0, 64.0, 12.0, 100.0
    want = []
    for img in imgs.astype(np.float64):
        fore, back = (G.log_space_fft_filtering_ref(
            img, wavelet_name="db3", level=None, sigma=s,
            max_threshold=thr)[:h, :w] for s in (sig_fore, sig_back))
        center = G.threshold_otsu_ref(img.astype(np.float32))
        frac = 1.0 / (1.0 + np.exp(-(img - center) / crossover))
        frac = ndimage.uniform_filter(frac, size=17, mode="nearest")
        want.append(fore * frac + back * (1.0 - frac))
    want = np.stack(want)
    got = tdb.dual_band_filtering(imgs, sigma=(sig_fore, sig_back),
                                  max_threshold=thr, crossover=crossover,
                                  device="cpu")
    u16g = np.clip(got, 0, 65535).astype(np.uint16).astype(np.float64)
    u16w = np.clip(want, 0, 65535).astype(np.uint16).astype(np.float64)
    mse = np.mean((u16g - u16w) ** 2)
    p = 10 * np.log10(65535.0**2 / max(mse, 1e-12))
    assert p > 80, f"dual-band PSNR vs float64 oracle {p:.1f} dB"


def test_host_entry_points_match_jax():
    imgs = np.stack([synthetic_plane(64, 80, seed=s) for s in range(2)])
    a = tdb.dual_band_filtering(imgs, sigma=(128.0, 32.0), threshold=500.0,
                                device="cpu")
    b = jdb.dual_band_filtering(imgs, sigma=(128.0, 32.0), threshold=500.0)
    assert a.shape == imgs.shape and a.dtype == np.float32
    _gate_vs_jax(a, b)
    one = tdb.dual_band_destripe_configs(imgs[0].astype(np.uint16), CELLS,
                                         NO_CELLS, device="cpu")
    ref = jdb.dual_band_destripe_configs(imgs[0].astype(np.uint16), CELLS,
                                         NO_CELLS)
    assert one.shape == imgs.shape[1:]
    _gate_vs_jax(one, ref)


# ---------------------------------------------------------------------------
# (f), (g) the device step, the capsule path and the crossover check
# ---------------------------------------------------------------------------


def test_device_step_dual_matches_jax():
    jp, tp = _plans(96, 128)
    x = _batch(4, 96, 128, seed=7)
    rng = np.random.default_rng(8)
    flat = (1.0 + 0.25 * rng.random((96, 128))).astype(np.float32)
    dark = np.full((96, 128), 3.0, np.float32)
    kw = dict(dual=True, crossover=90.0, dual_threshold=-1.0)
    jstep = jpl.make_device_step(jp, HIGH_INT, True, **kw)
    want = np.asarray(jstep(jstep.put(x), jnp.asarray(flat),
                            jnp.asarray(dark)))
    tstep = tpl.make_device_step(tp, HIGH_INT, True, devices=CPU, **kw)
    got = tstep(tstep.put(x), tstep.put_const(flat),
                tstep.put_const(dark)).numpy()
    assert got.dtype == np.uint16 and got.shape == x.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, f"{d.max()} LSB"
    jw = jpl.make_device_step(jp, HIGH_INT, False, **kw)
    want = np.asarray(jw(jw.put(x), None, None))
    wstep = tpl.make_device_step(tp, HIGH_INT, False, devices=CPU, **kw)
    got = wstep(wstep.put(x), None, None).numpy()
    assert got.dtype == np.uint16 and got.shape == x.shape
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert d.max() <= 1, f"wrap step: {d.max()} LSB"


def test_destripe_zarr_dual_matches_jax(tmp_path, monkeypatch):
    """run_capsule with DESTRIPE_DUAL_BAND=1 on the CPU: level 0 of each
    tile within 1 LSB of the JAX dual step with the flat-field epilogue, and
    the resume journal keyed on the dual mode."""
    data, results = build_capsule(tmp_path)
    monkeypatch.setenv("DESTRIPE_DUAL_BAND", "1")
    monkeypatch.setenv("DESTRIPE_DUAL_CROSSOVER", "80")
    run_capsule.run(data_folder=str(data), results_folder=str(results),
                    scratch_folder=str(tmp_path / "scratch"), devices=CPU)
    cfg = run_capsule.PRODUCTION_PARAMETERS
    jp = jf.build_plan(H, W, jf.FilterConfig.from_dict(cfg["cells_config"]),
                       jf.FilterConfig.from_dict(cfg["no_cells_config"]))
    dark = imread(str(data / "derivatives" / "DarkMaster_cropped.tif"))
    jstep = jpl.make_device_step(jp, 2500.0, True, dual=True, crossover=80.0)
    for tile, side in TILES.items():
        flat = imread(str(data / f"estimated_flat_laser_Ex_488_Em_525_{side}.tif"))
        src = np.asarray(open_zarr(str(data / "Ex_488_Em_525"
                                       / f"{tile}.zarr"))["0"][0, 0])
        want = np.asarray(jstep(jstep.put(src), jnp.asarray(flat, jnp.float32),
                                jnp.asarray(dark, jnp.float32)))
        out = results / "destriped_data" / "Ex_488_Em_525" / f"{tile}.zarr"
        got = np.asarray(open_zarr(str(out))["0"][0, 0])
        assert got.dtype == np.uint16 and got.shape == (Z, H, W)
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1, f"{tile}: {d.max()} LSB"
        meta = json.loads((out / "0" / ".destripe_journal.json").read_text())
        assert meta["meta"]["dual"] is True
        assert meta["meta"]["crossover"] == 80.0
        assert meta["meta"]["dual_threshold"] == -1.0


@pytest.mark.parametrize("bad", [0.0, -5.0, float("nan")])
def test_check_crossover_rejects(bad):
    with pytest.raises(ValueError, match="crossover"):
        tdb.check_crossover(bad)
    _, tp = _plans(96, 128)
    with pytest.raises(ValueError, match="crossover"):
        tpl.make_device_step(tp, HIGH_INT, True, devices=CPU, dual=True,
                             crossover=bad)
    with pytest.raises(ValueError, match="crossover"):
        tdb.dual_band_destripe_batch(tp, torch.zeros((1, 96, 128)), bad)


def test_registry_holds_the_blend_kernel():
    assert tbl.blend_smooth_mix in tops.kernels()
    tops.reset_launches()
    x, fore, back, centers = _blend_inputs(np.float32)
    tbl.blend_smooth_mix(torch.from_numpy(x), torch.from_numpy(fore),
                         torch.from_numpy(back), torch.from_numpy(centers),
                         100.0)
    assert tbl.blend_smooth_mix.launches == 0  # the CPU route is the twin
