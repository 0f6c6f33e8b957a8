"""The port's multi-device routes on the CPU, against the JAX package.

The row-sharded ("Y-halo") route of ``aind_smartspim_destripe_torch.
parallel.halo`` runs on meshes of ``[cpu] * D`` (D in {2, 8}, the port's
counterpart of the 8 virtual CPU devices tests/conftest.py forces for JAX)
at the JAX halo tests' size (tests/test_halo_pallas.py: 320 x 640, a dim
and a bright plane):

- the host planner bit-equal to the JAX planner, with the same K1/K4 and
  notch level sets;
- the twins of the route's kernels (K1/K4 on row shards, the per-plane
  notch product, the row-bounded histogram) against the Pallas kernels in
  interpret mode, at the tolerances of tests/test_torch_band.py and
  tests/test_torch_notch.py (histogram counts exact);
- the single- and dual-band routes against the JAX package's dense f32
  formulation of the same route (100 dB outside a 1% flip budget, the gate
  of tests/test_torch_filter.py), against its kernel tier through
  ``make_device_step`` (the JAX halo tests' own 80 dB / 10% gate, bf16x3
  products against f32) and against the port's own plane path;
- the plane-sharded step against the single-device step (bit-equal), and
  ``destripe_zarr`` on a two-entry mesh against the JAX package's.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.parallel import halo as jh  # noqa: E402
from aind_smartspim_destripe_tpu.parallel.mesh import make_mesh  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_band as cb  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_hist as th  # noqa: E402
from aind_smartspim_destripe_torch.ops import cuda_notch as tn  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.ops.dual_band import (  # noqa: E402
    dual_band_destripe_batch,
)
from aind_smartspim_destripe_torch.parallel import halo as th_  # noqa: E402
from aind_smartspim_destripe_torch.runtime import pipeline  # noqa: E402
from tests.test_torch_filter import _gate_vs_jax  # noqa: E402

H, W = 320, 640
CPU = torch.device("cpu")
CELLS = dict(wavelet="db3", level=None, sigma=64, max_threshold=3)
NO_CELLS = dict(wavelet="db3", level=None, sigma=128, max_threshold=12)


def _mixed_batch(h=H, w=W, seed=7):
    """A dim striped plane and a bright cells-like plane (both classifier
    branches), as tests/test_halo_pallas.py builds them."""
    rng = np.random.default_rng(seed)
    stripes = (rng.normal(size=(1, h, 1)) * 50) * np.ones((1, 1, w))
    dim = 300 + stripes[0]
    bright = 3000 + stripes[0] + rng.normal(size=(h, w)) * 40
    return np.clip(np.stack([dim, bright]), 0, 65535).astype(np.uint16)


def _plans(h=H, w=W):
    return (jf.build_plan(h, w, jf.FilterConfig(**CELLS),
                          jf.FilterConfig(**NO_CELLS)),
            tf.build_plan(h, w, tf.FilterConfig(**CELLS),
                          tf.FilterConfig(**NO_CELLS)))


def _gate_u16(got, want, psnr_min=80.0, flip_budget=0.1):
    """tests/test_halo_pallas.py's cross-formulation gate."""
    d = got.astype(np.int64) - want.astype(np.int64)
    assert float((np.abs(d) > 1).mean()) < flip_budget
    mse = float((d.astype(np.float64) ** 2).mean())
    assert 10 * np.log10(65535.0**2 / max(mse, 1e-12)) >= psnr_min


def _fields(h=H, w=W):
    rng = np.random.default_rng(3)
    return ((1.0 + 0.2 * rng.random((h, w))).astype(np.float32),
            np.full((h, w), 4.0, np.float32))


# ---------------------------------------------------------------------------
# (a) the planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 8])
def test_halo_constants_bit_equal_to_jax(D, monkeypatch):
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")  # JAX plans K1/K4
    jp, tp = _plans()
    ja, js = jh.halo_constants(jp, D)
    ta, ts = th_.halo_constants(tp, D)
    for lvl in range(tp.n_levels):
        assert (ts.get(lvl) is None) == (js.get(lvl) is None), lvl
        if ts.get(lvl) is None:
            continue
        assert ts[lvl] == js[lvl]
        for name in ("an_lo", "an_hi", "syn_lo", "syn_hi"):
            for got, want in zip(ta[str(lvl)][name], ja[str(lvl)][name]):
                np.testing.assert_array_equal(got, np.asarray(want))
    for group in ("xk1", "xk4", "notch"):
        assert set(ts.get(group, {})) == set(js.get(group, {})), group
        assert set(ts[group]), group
    # the port's bank is the f32 (w, 2w) layout of the notch tail
    i = next(iter(ts["notch"]))
    bc, bn = tp.notch_matrices()[i]
    np.testing.assert_array_equal(ta["notch"][str(i)],
                                  np.concatenate([bc.T, bn.T], axis=1))
    _, ts_dual = th_.halo_constants(tp, D, notch_blocks=False)
    assert "notch" not in ts_dual


@pytest.mark.parametrize("M,N,D", [(163, 320, 2), (163, 320, 8),
                                   (81, 163, 8), (320, 162, 3)])
def test_plan_op_shards_bit_equal(M, N, D):
    rng = np.random.default_rng(M + D)
    OP = np.zeros((M, N), np.float32)
    for i in range(M):  # a band of slope N/M
        c = int(i * N / M)
        OP[i, max(0, c - 3):c + 3] = rng.normal(size=len(range(
            max(0, c - 3), min(N, c + 3))))
    got, K, n_pad = th_._plan_op_shards(OP, N, D)
    want, K_j, n_pad_j = jh._plan_op_shards(OP, N, D)
    assert (K, n_pad) == (K_j, n_pad_j)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (b)-(d) the twins of the route's kernels against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def x_blocks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
        jp, tp = _plans()
        jblocks = jh._plan_x_blocks(jp)
    return jp, tp, jblocks, th_._plan_x_blocks(tp)


def test_chunked_k1_twin_matches_jax(x_blocks, monkeypatch):
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
    from aind_smartspim_destripe_tpu.ops import pallas_band as pb

    _, _, ((a1, _), (s1, _)), ((k1, _), _) = x_blocks
    rng = np.random.default_rng(11)
    x_u16 = rng.integers(0, 4000, size=(2, 64, W)).astype(np.uint16)
    for x in (x_u16, np.log1p(x_u16.astype(np.float32))):
        log1p = x.dtype == np.uint16
        want = np.asarray(pb.an_x_lowpass_chunked(
            jnp.asarray(x), tuple(map(jnp.asarray, a1[0])), s1[0]["starts"],
            s1[0]["out_w"], log1p=log1p, budget=330_000))
        got = cb.an_x_lowpass_chunked(
            torch.from_numpy(x),
            torch.from_numpy(cb.band_dense(k1[0]["start"], k1[0]["coef"], W)),
            torch.from_numpy(k1[0]["start"]),
            torch.from_numpy(k1[0]["coef"]), log1p=log1p).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("case", ["bare", "exp", "wrap", "flat"])
def test_chunked_k4_twin_matches_jax(x_blocks, case, monkeypatch):
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
    from aind_smartspim_destripe_tpu.ops import pallas_band as pb

    jp, _, ((_, a4), (_, s4)), ((_, k4), _) = x_blocks
    i = jp.n_levels - 1
    L_x = jp.ladder[i][1]
    rng = np.random.default_rng(13)
    st = (rng.normal(size=(2, 64, L_x)) * 0.1).astype(np.float32)
    imgs = rng.integers(0, 4000, size=(2, 64, W)).astype(np.uint16)
    flat = (1.0 + 0.1 * rng.random((64, W))).astype(np.float32)
    dark = np.full((64, W), 2.0, np.float32)
    kw = {"bare": {}, "exp": dict(images=imgs), "wrap": dict(images=imgs,
                                                             wrap=True),
          "flat": dict(images=imgs, flat=flat, dark=dark)}[case]
    want = np.asarray(pb.syn_x_exp_chunked(
        jnp.asarray(st), None if "images" not in kw else jnp.asarray(imgs),
        tuple(map(jnp.asarray, a4[i])), s4[i]["starts"], s4[i]["out_w"],
        flat=None if "flat" not in kw else jnp.asarray(flat),
        dark=None if "dark" not in kw else jnp.asarray(dark),
        # 330_000 leaves K4 no feasible chunk; the JAX test's own budget
        wrap=kw.get("wrap", False), budget=700_000))
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in kw.items()}
    got = cb.syn_x_exp_chunked(
        torch.from_numpy(st), t.pop("images", None),
        torch.from_numpy(cb.band_dense(k4[i]["start"], k4[i]["coef"], L_x)),
        torch.from_numpy(k4[i]["start"]), torch.from_numpy(k4[i]["coef"]),
        **t).numpy()
    if got.dtype == np.uint16:
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-2 if case == "exp" else 1e-5)


def test_notch_select_twin_matches_jax(monkeypatch):
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
    from aind_smartspim_destripe_tpu.ops import fft_notch
    from aind_smartspim_destripe_tpu.ops import pallas_notch as pn

    rng = np.random.default_rng(11)
    B, h, w = 3, 162, 322
    x = (rng.normal(size=(B, h, w)) * 3.0).astype(np.float32)
    bc = fft_notch.packed_notch_matrix(w, 12.0).astype(np.float32)
    bn = fft_notch.packed_notch_matrix(w, 40.0).astype(np.float32)
    sel = np.array([1, 0, 1], np.int32)
    want = np.asarray(pn.notch_select_chunked(
        jnp.asarray(x), jnp.asarray(sel), pn.stacked_notch_operators(bc, bn),
        interpret=True))
    got = tn.notch_select(torch.from_numpy(x), torch.from_numpy(sel),
                          torch.from_numpy(tn.stacked_notch_operators(
                              bc, bn))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("square,row_bound", [(True, 37), (False, 70),
                                              (True, 0), (False, 1)])
def test_histogram_row_bound_twin_matches_jax(square, row_bound,
                                              monkeypatch):
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
    from aind_smartspim_destripe_tpu.ops.pallas_hist import histogram256_batch

    rng = np.random.default_rng(17 + row_bound)
    x = (rng.normal(size=(3, 70, 200)) * 5).astype(np.float32)
    a = np.abs(x[:, :max(row_bound, 1)]) if square else x
    lo = (a.min(axis=(1, 2)) ** (2 if square else 1)).astype(np.float32)
    hi = (a.max(axis=(1, 2)) ** (2 if square else 1)).astype(np.float32)
    span = np.where(hi > lo, hi - lo, 1.0).astype(np.float32)
    want = np.asarray(histogram256_batch(
        jnp.asarray(x), jnp.asarray(lo), jnp.asarray(span), square=square,
        row_bound=jnp.asarray([row_bound], jnp.int32), interpret=True))
    got = th.histogram256_batch(torch.from_numpy(x), torch.from_numpy(lo),
                                torch.from_numpy(span), square=square,
                                row_bound=row_bound)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    assert int(got.sum()) == 3 * row_bound * 200


def test_otsu_sharded_equals_unsharded():
    """The sharded Otsu (shard extrema, row-bounded shard histograms, the
    integer counts added) equals the unsharded one, ragged rows included."""
    from aind_smartspim_destripe_torch.ops.otsu import threshold_otsu_batch

    rng = np.random.default_rng(17)
    ch = torch.from_numpy((rng.normal(size=(3, 70, 200)) * 5).astype(
        np.float32))
    u16 = torch.from_numpy(rng.integers(0, 4000, size=(2, 70, 90)).astype(
        np.uint16))
    for D in (3, 8):
        rows = th_.shard_rows(ch, [CPU] * D)
        assert rows.valid[-1] < rows.parts[-1].shape[-2]  # pad rows cut
        for square in (True, False):
            got = th_._otsu_sharded(rows, CPU, square=square)
            want = threshold_otsu_batch(ch, square=square)
            assert torch.equal(got, want)
        got = th_._otsu_sharded(th_.shard_rows(u16, [CPU] * D), CPU,
                                square=False)
        assert torch.equal(got, threshold_otsu_batch(u16))


# ---------------------------------------------------------------------------
# (e), (f) the routes against the JAX package and the port's plane path
# ---------------------------------------------------------------------------


def _jax_route(img, D, plan, dual=False, **kw):
    """The JAX package's route on D of its CPU devices, jitted whole (its
    dense f32 formulation: no Pallas kernel runs on the CPU)."""
    fn = jh.dual_band_destripe_y_sharded if dual else jh.destripe_y_sharded
    fields = {k: jnp.asarray(v) for k, v in kw.items()
              if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in fields}
    mesh = make_mesh(D)
    return np.asarray(jax.jit(lambda x, f: fn(x, mesh, plan, **static, **f))(
        jnp.asarray(img), fields))


def _route(img, D, plan, dual=False, **kw):
    fn = th_.dual_band_destripe_y_sharded if dual else th_.destripe_y_sharded
    out = fn(img, [CPU] * D, plan, **kw)
    assert len(out.parts) == D and out.rows == img.shape[1]
    return out.gather(CPU).numpy()


@pytest.mark.parametrize("D,epilogue", [(2, "wrap"), (8, "flat")])
def test_halo_route_matches_jax_dense(D, epilogue):
    jp, tp = _plans()
    img = _mixed_batch()
    flat, dark = _fields()
    kw = (dict(wrap=True) if epilogue == "wrap"
          else dict(flat=flat, dark=dark))
    want = _jax_route(img, D, jp, **kw)
    got = _route(img, D, tp, microscope_high_int=2700.0, **kw)
    assert got.dtype == np.uint16 and got.shape == img.shape
    _gate_vs_jax(got, want)
    plane = tf.destripe_batch(tp, torch.from_numpy(img), 2700.0,
                              **kw).numpy()
    _gate_vs_jax(got, plane)


def test_halo_route_ragged_rows(monkeypatch):
    """310 rows on 8 entries: shards padded to the mesh multiple, the pad
    rows cut by the histogram's row bound and cropped elsewhere."""
    h = 310
    jp, tp = _plans(h, W)
    rng = np.random.default_rng(5)
    img = np.clip(300 + (rng.normal(size=(1, h, 1)) * 50) * np.ones((1, 1, W))
                  + rng.normal(size=(1, h, W)) * 10, 0, 65535).astype(
        np.uint16)
    want = _jax_route(img, 8, jp, wrap=True)
    got = _route(img, 8, tp, wrap=True)
    _gate_vs_jax(got, want)
    plane = tf.destripe_batch(tp, torch.from_numpy(img), 2700.0,
                              wrap=True).numpy()
    _gate_vs_jax(got, plane)
    # the same through the pipeline's step: put() pads 2 rows, the step
    # reads the plane's own rows and to_host() returns them
    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    step = pipeline.make_device_step(tp, 2700.0, False, devices=[CPU] * 8)
    assert step.shards_rows
    rows = step.put(img)
    assert rows.valid == (39,) * 7 + (37,)
    assert all(p.shape[-2] == 39 for p in rows.parts)
    out = step.to_host(step(rows, None, None))
    np.testing.assert_array_equal(out, got)


def test_dual_halo_route_matches_jax_dense():
    jp, tp = _plans()
    img = _mixed_batch()
    want = _jax_route(img, 2, jp, dual=True, wrap=True)
    got = _route(img, 2, tp, dual=True, wrap=True)
    assert got.dtype == np.uint16 and got.shape == img.shape
    _gate_vs_jax(got, want)
    plane = tf.wrap_cast(dual_band_destripe_batch(
        tp, torch.from_numpy(img), 100.0, -1.0)).numpy()
    _gate_vs_jax(got, plane)
    fixed = _route(img, 8, tp, dual=True, wrap=True, threshold=500.0)
    fixed_plane = tf.wrap_cast(dual_band_destripe_batch(
        tp, torch.from_numpy(img), 100.0, 500.0)).numpy()
    _gate_vs_jax(fixed, fixed_plane)
    # the flat-field epilogue, fused into each shard's blend
    flat, dark = _fields()
    want = _jax_route(img, 8, jp, dual=True, flat=flat, dark=dark)
    got = _route(img, 8, tp, dual=True, flat=flat, dark=dark)
    assert got.dtype == np.uint16 and got.shape == img.shape
    _gate_vs_jax(got, want)
    plane = dual_band_destripe_batch(
        tp, torch.from_numpy(img), 100.0, -1.0, flat=torch.from_numpy(flat),
        dark=torch.from_numpy(dark)).numpy()
    _gate_vs_jax(got, plane)


def test_halo_step_matches_jax_kernel_tier(monkeypatch):
    """The production halo step (make_device_step above a lowered byte
    threshold) against the JAX package's, whose Pallas tier runs in
    interpret mode: the JAX halo tests' own cross-formulation gate."""
    monkeypatch.setenv("DESTRIPE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    from aind_smartspim_destripe_tpu.runtime.pipeline import (
        make_device_step as jax_step,
    )

    jp, tp = _plans()
    img = _mixed_batch()
    flat = np.full((H, W), 1.2, np.float32)
    dark = np.full((H, W), 4.0, np.float32)
    js = jax_step(jp, 2500.0, True, devices=jax.devices())
    want = np.asarray(js(js.put(img), js.put_const(flat),
                         js.put_const(dark)))
    step = pipeline.make_device_step(tp, 2500.0, True, devices=[CPU] * 2)
    assert step.shards_rows and step.n_devices == 2
    got = step.to_host(step(step.put(img), step.put_const(flat),
                            step.put_const(dark)))
    assert got.dtype == np.uint16 and got.shape == img.shape
    _gate_u16(got, want)


def test_width_at_dense_x_gate_raises(monkeypatch):
    """A plane as wide as the dense-x gate no longer raises: its plan
    carries no dense x operator and no notch bank at the gated level, and
    the production step runs it through the banded/spectral x tier within
    1 LSB of the dense tier outside a 1e-3 flip budget, at 90 dB or more
    (the JAX package's banded-vs-dense gate, __graft_entry__.py)."""
    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    _, tp = _plans()
    img = _mixed_batch()
    outs = {}
    for gate in (W, W + 1):
        monkeypatch.setenv("DESTRIPE_BANDED_X_MIN_W", str(gate))
        arrays, static = th_.halo_constants(tp, 2)
        consts = th_.halo_device_constants(tp, [CPU] * 2)
        gated = gate <= W
        assert (consts.dense[CPU]["an_x_lo"][0] is None) == gated
        assert (consts.dense[CPU]["syn_x_lo"][-1] is None) == gated
        # the finest notch: a bank, or at the gate no matrix at all
        assert (tp.n_levels - 1 in static.get("notch", {})) != gated
        assert consts.dense[CPU]["notch_cat"][-1] is None
        assert 0 in static["xk1"] and tp.n_levels - 1 in static["xk4"]
        step = pipeline.make_device_step(tp, 2500.0, False,
                                         devices=[CPU] * 2)
        assert step.shards_rows
        outs[gated] = step.to_host(step(step.put(img), None, None))
    d = outs[True].astype(np.int64) - outs[False].astype(np.int64)
    assert float((np.abs(d) > 1).mean()) < 1e-3
    mse = float((d.astype(np.float64) ** 2).mean())
    assert 10 * np.log10(65535.0**2 / max(mse, 1e-12)) >= 90.0


# ---------------------------------------------------------------------------
# (g), (h) the plane-sharded step and destripe_zarr on a mesh
# ---------------------------------------------------------------------------


def test_plane_sharded_step_equals_single_device():
    h, w = 96, 128
    _, tp = _plans(h, w)
    rng = np.random.default_rng(9)
    imgs = np.clip(300 + rng.normal(size=(4, h, 1)) * 50
                   + rng.normal(size=(4, h, w)) * 10
                   + np.array([0, 2800, 0, 2800])[:, None, None],
                   0, 65535).astype(np.uint16)
    flat, dark = _fields(h, w)
    outs = []
    for mesh in ([CPU], [CPU] * 2):
        step = pipeline.make_device_step(tp, 2500.0, True, devices=mesh)
        assert not getattr(step, "shards_rows", False)
        assert step.n_devices == len(mesh)
        outs.append(step.to_host(step(step.put(imgs), step.put_const(flat),
                                      step.put_const(dark))))
    np.testing.assert_array_equal(outs[1], outs[0])


def test_default_devices_split_rows_not_planes(monkeypatch):
    """``devices=None`` (every visible device, three here) takes the row
    split, but runs planes under the threshold on the first device alone;
    an explicit list still splits the planes."""
    real = pipeline.make_mesh
    monkeypatch.setattr(pipeline, "make_mesh", lambda devices=None: (
        [CPU] * 3 if devices is None else real(devices)))
    _, tp = _plans(96, 128)
    step = pipeline.make_device_step(tp, 2500.0, False)
    assert step.n_devices == 1 and not getattr(step, "shards_rows", False)
    step = pipeline.make_device_step(tp, 2500.0, False, devices=[CPU] * 3)
    assert step.n_devices == 3 and not getattr(step, "shards_rows", False)
    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    step = pipeline.make_device_step(tp, 2500.0, False)
    assert step.shards_rows and step.n_devices == 3


def _zarr_run(zd, tmp, tile, vol_path, flat, devices):
    results = tmp / "results"
    results.mkdir(parents=True)
    out_tile = results / "Ex_488_Em_525" / tile
    stats = zd.destripe_zarr(
        dataset_path=vol_path, multiscale="0", output_destriped_zarr=out_tile,
        prediction_chunksize=(4, 64, 600), target_size_mb=64, n_workers=0,
        batch_size=1, super_chunksize=(4, 64, 600), results_folder=results,
        derivatives_path=None, xyz_resolution=(1.8, 1.8, 2.0),
        parameters={"cells_config": CELLS, "no_cells_config": NO_CELLS},
        flatfield=flat, devices=devices)
    return stats, out_tile


def test_destripe_zarr_on_mesh_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    from aind_smartspim_destripe_torch import zarr_destriper as tz
    from aind_smartspim_destripe_tpu import zarr_destriper as jz
    from aind_smartspim_destripe_tpu.io.zarr import group, open_zarr

    Z, h, w = 6, 64, 600
    rng = np.random.default_rng(0)
    vol = np.clip(300 + (rng.normal(size=(Z, h, 1)) * 60) * np.ones((1, 1, w))
                  + rng.normal(size=(Z, h, w)) * 10, 0, 65535).astype(
        np.uint16)
    tile = "471320_461360.zarr"
    g = group(str(tmp_path / "data" / tile))
    g.create_dataset(0, shape=(1, 1, Z, h, w), chunks=(1, 1, 4, 64, 64),
                     dtype=np.uint16)[:] = vol[None, None]
    flat = np.full((h, w), 1.25, np.float32)
    runs = {}
    for name, zd, devices in (("jax", jz, jax.devices()[:2]),
                              ("torch", tz, [CPU] * 2)):
        tmp = tmp_path / name
        stats, out_tile = _zarr_run(zd, tmp, tile, tmp_path / "data" / tile,
                                    flat, devices)
        assert stats.halo, name
        journal = json.loads((out_tile / "0" / ".destripe_journal.json")
                             .read_text())
        runs[name] = (np.asarray(open_zarr(str(out_tile))["0"][0, 0]),
                      journal["meta"])
    got, meta = runs["torch"]
    want, jmeta = runs["jax"]
    assert got.shape == vol.shape and got.dtype == np.uint16
    _gate_vs_jax(got, want)
    assert meta == jmeta
