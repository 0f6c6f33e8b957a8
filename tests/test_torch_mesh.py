"""The port's plane-sharded helpers (``parallel/mesh.py``) on the CPU,
against the JAX package's on the 8 virtual CPU devices tests/conftest.py
forces.

At tests/test_mesh.py's size (16 planes of 48 x 64, 2 x 8 on the 2-D
mesh), on meshes of ``[cpu] * 8``:

- ``sharded_destripe_step`` (flat-field and wrap) and
  ``sharded_destripe_step_2d`` against the JAX steps: uint16 within 1 LSB
  outside a 1% flip budget at >= 100 dB (the gate of
  tests/test_torch_filter.py), and the float32 [min, max] statistics within
  1e-5 of their scale; the 1-D step also bit-equal to the port's own
  ``make_device_step`` on the same mesh, and the 2-D step's tiles to the
  1-D step with each tile's own flat;
- ``make_mesh_2d``, ``shard_planes``, ``global_minmax`` (exact) and
  ``sharded_normalize_image`` (exact in float16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.parallel import mesh as jm  # noqa: E402
from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.parallel import mesh as tm  # noqa: E402
from aind_smartspim_destripe_torch.runtime.pipeline import (  # noqa: E402
    make_device_step,
)
from tests.test_torch_filter import _gate_vs_jax  # noqa: E402

H, W = 48, 64
CPU8 = [torch.device("cpu")] * 8
CELLS = dict(sigma=64, max_threshold=3)
NO_CELLS = dict(sigma=128, max_threshold=12)
STATS_RTOL = 1e-5  # float32 statistics: of the stats' largest magnitude


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jm.make_mesh(8)


def _plans():
    return (jf.build_plan(H, W, jf.FilterConfig(**CELLS),
                          jf.FilterConfig(**NO_CELLS)),
            tf.build_plan(H, W, tf.FilterConfig(**CELLS),
                          tf.FilterConfig(**NO_CELLS)))


def _cat(parts):
    return torch.cat([p.cpu() for p in parts]).numpy()


def _close_stats(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=STATS_RTOL * np.abs(want).max())


@pytest.mark.parametrize("with_flatfield", [True, False],
                         ids=["flat", "wrap"])
def test_sharded_step_matches_jax(jmesh, with_flatfield):
    jplan, tplan = _plans()
    rng = np.random.default_rng(0)
    images = rng.integers(0, 3000, size=(16, H, W)).astype(np.uint16)
    flat = np.full((H, W), 1.2, np.float32)
    dark = np.full((H, W), 4.0, np.float32)
    with jmesh:
        want, want_stats = jm.sharded_destripe_step(
            jmesh, jplan, with_flatfield=with_flatfield)(images, flat, dark)
    out, stats = tm.sharded_destripe_step(
        CPU8, tplan, with_flatfield=with_flatfield)(images, flat, dark)
    assert len(out) == 8 and all(o.shape == (2, H, W) for o in out)
    got = _cat(out)
    assert got.dtype == np.uint16
    _gate_vs_jax(got, np.asarray(want))
    assert stats.shape == (2,) and stats.dtype == torch.float32
    _close_stats(stats, want_stats)
    # the helper's unfused epilogue gives the fused step's bits
    step = make_device_step(tplan, 2500.0, with_flatfield, devices=CPU8)
    fused = step.to_host(step(step.put(images), step.put_const(flat),
                              step.put_const(dark)))
    np.testing.assert_array_equal(got, fused)


def test_sharded_step_2d_matches_jax():
    jplan, tplan = _plans()
    rng = np.random.default_rng(3)
    images = rng.integers(0, 3000, size=(2, 8, H, W)).astype(np.uint16)
    flats = np.stack([np.full((H, W), 1.0 + 0.2 * t, np.float32)
                      for t in range(2)])
    darks = np.zeros((2, H, W), np.float32)
    jmesh2 = jm.make_mesh_2d(8, tile_parallel=2)
    with jmesh2:
        want, want_stats = jm.sharded_destripe_step_2d(jmesh2, jplan)(
            images, flats, darks)
    mesh2 = tm.make_mesh_2d(CPU8, tile_parallel=2)
    out, stats = tm.sharded_destripe_step_2d(mesh2, tplan)(
        images, flats, darks)
    got = np.stack([_cat(tile) for tile in out])
    assert got.shape == images.shape and got.dtype == np.uint16
    _gate_vs_jax(got, np.asarray(want))
    assert stats.shape == (2, 2)
    _close_stats(stats, want_stats)
    # each tile is the 1-D step on its row with the tile's own flat
    for t in range(2):
        one, one_stats = tm.sharded_destripe_step(mesh2[t], tplan)(
            images[t], flats[t], darks[t])
        np.testing.assert_array_equal(got[t], _cat(one))
        np.testing.assert_array_equal(stats[t].numpy(), one_stats.numpy())


def test_make_mesh_2d_and_shard_planes():
    mesh2 = tm.make_mesh_2d(CPU8, tile_parallel=2)
    assert [len(r) for r in mesh2] == [4, 4]
    assert tm.make_mesh_2d(CPU8, n_devices=6, tile_parallel=3) == [
        CPU8[:2]] * 3
    with pytest.raises(ValueError, match="tile_parallel"):
        tm.make_mesh_2d(CPU8, tile_parallel=3)
    x = np.arange(16 * 8 * 8, dtype=np.float32).reshape(16, 8, 8)
    parts = tm.shard_planes(CPU8, x)
    assert [tuple(p.shape) for p in parts] == [(2, 8, 8)] * 8
    np.testing.assert_array_equal(_cat(parts), x)
    with pytest.raises(ValueError, match="multiple"):
        tm.shard_planes(CPU8, x[:12])


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_global_minmax_exact(jmesh, dtype):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(8, 16, 16)) * 1000 + 5000).astype(dtype)
    # both ends of the uint16 range, in two other shards than the first
    x[2, 3, 4], x[5, 6, 7], x[6, 0, 0] = 3, 65000, 40000
    lo, hi = tm.global_minmax(CPU8, tm.shard_planes(CPU8, x))
    assert float(lo) == x.min() and float(hi) == x.max()
    jlo, jhi = jm.global_minmax(jmesh, jm.shard_planes(jmesh, x))
    assert float(lo) == float(jlo) and float(hi) == float(jhi)
    assert lo.dtype == hi.dtype == torch.from_numpy(x).dtype
    assert np.asarray(jlo).dtype == np.asarray(jhi).dtype == x.dtype


def test_sharded_normalize_matches_jax(jmesh):
    rng = np.random.default_rng(2)
    x = rng.uniform(100, 900, size=(8, 16, 16)).astype(np.float32)
    got = _cat(tm.sharded_normalize_image(CPU8, x))
    assert got.dtype == np.float16
    np.testing.assert_array_equal(
        got, np.asarray(jm.sharded_normalize_image(jmesh, x)))
    want = 1 + ((x - x.min()) / (x.max() - x.min())).astype(np.float16)
    np.testing.assert_array_equal(got, want)
