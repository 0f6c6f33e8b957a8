"""The torch package's capsule path on the CPU, against the JAX package.

``run_capsule.run(devices=[cpu])`` on the synthetic capsule of
tests/test_run_capsule_e2e.py (two 16x96x128 tiles): level 0 against the
JAX ``destripe_batch`` with the flat-field epilogue on the same tile,
levels 1-2 against ``windowed_mean_np`` of the port's own level 0, the
OME-NGFF metadata and provenance, resume through the journal, a subprocess
run in which neither jax nor the JAX package is imported, and the port's
own blosc codec against the JAX package's encoder.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu.io.readers import imread  # noqa: E402
from aind_smartspim_destripe_tpu.io.zarr import open_zarr  # noqa: E402
from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_tpu.ops.multiscale import (  # noqa: E402
    windowed_mean_np,
)
from aind_smartspim_destripe_torch import run_capsule  # noqa: E402
from aind_smartspim_destripe_torch.runtime import pipeline  # noqa: E402
from tests.test_run_capsule_e2e import H, W, Z, build_capsule  # noqa: E402

CPU = [torch.device("cpu")]
TILES = {"471320_461360": 0, "489620_461360": 1}  # tile -> laser side
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tile(results, tile):
    return open_zarr(str(results / "destriped_data" / "Ex_488_Em_525"
                         / f"{tile}.zarr"))


@pytest.fixture(scope="module")
def capsule(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("capsule")
    data, results = build_capsule(tmp)
    run_capsule.run(data_folder=str(data), results_folder=str(results),
                    scratch_folder=str(tmp / "scratch"), devices=CPU)
    return data, results


def test_level0_matches_jax(capsule):
    data, results = capsule
    cfg = run_capsule.PRODUCTION_PARAMETERS
    plan = jf.build_plan(H, W, jf.FilterConfig.from_dict(cfg["cells_config"]),
                         jf.FilterConfig.from_dict(cfg["no_cells_config"]))
    dark = imread(str(data / "derivatives" / "DarkMaster_cropped.tif"))
    for tile, side in TILES.items():
        flat = imread(str(data / f"estimated_flat_laser_Ex_488_Em_525_{side}.tif"))
        src = np.asarray(open_zarr(str(data / "Ex_488_Em_525" / f"{tile}.zarr"))["0"][0, 0])
        want = np.asarray(jf.destripe_batch(
            plan, jnp.asarray(src), 2500.0, plan.constants(),
            flat=jnp.asarray(flat, jnp.float32),
            dark=jnp.asarray(dark, jnp.float32)))
        got = np.asarray(_tile(results, tile)["0"][0, 0])
        assert got.dtype == np.uint16 and got.shape == (Z, H, W)
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1, f"{tile}: {d.max()} LSB"


def test_pyramid_metadata_and_provenance(capsule):
    _, results = capsule
    for tile in TILES:
        g = _tile(results, tile)
        assert set(g.keys()) == {"0", "1", "2"}
        lvl0, lvl1 = g["0"][:], g["1"][:]
        np.testing.assert_array_equal(lvl1, windowed_mean_np(lvl0))
        np.testing.assert_array_equal(g["2"][:], windowed_mean_np(lvl1))
        ms = g.attrs["multiscales"][0]
        assert len(ms["datasets"]) == 3
        assert ms["datasets"][0]["coordinateTransformations"][0]["scale"] == [
            1.0, 1.0, 2.0, 1.8, 1.8]
    prov = results / "image_destriping_Ex_488_Em_525_processing.json"
    names = [p["name"] for p in
             json.load(open(prov))["processing_pipeline"]["data_processes"]]
    assert names == ["Image destriping", "Image flat-field correction"]


def test_second_run_resumes_through_journal(capsule, monkeypatch):
    data, results = capsule
    before = {t: _tile(results, t)["0"][:] for t in TILES}

    def no_compute(self, data):
        raise AssertionError("a committed slab was recomputed")

    monkeypatch.setattr(pipeline.StreamingDestriper, "_process_slab",
                        no_compute)
    run_capsule.run(data_folder=str(data), results_folder=str(results),
                    scratch_folder=str(data.parent / "scratch"), devices=CPU)
    for t in TILES:
        np.testing.assert_array_equal(_tile(results, t)["0"][:], before[t])


def test_subprocess_run_never_imports_jax(tmp_path):
    """Every module of the port imported (``parallel.*``, the facade, the
    file-batch destriper, the CLI, BaSiC, flat estimation and the blocked
    writer included, and the names ported last: the mesh helpers, the
    Y-sharded DWT, the wavelet API, the block worker and the host
    helpers), and the CPU capsule run, in a fresh interpreter: neither jax
    nor any module of the JAX package is loaded."""
    data, results = build_capsule(tmp_path)
    code = (
        "import importlib, pkgutil, sys, torch\n"
        "import aind_smartspim_destripe_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'aind_smartspim_destripe_torch.' + m for m in ("
        "'parallel.halo', 'parallel.mesh', 'parallel.distributed', "
        "'filtering', 'destriper', 'destriper_params', '__main__', "
        "'models.basic', 'flatfield_estimation', 'io.blocked_writer')} "
        "<= set(names)\n"
        "from aind_smartspim_destripe_torch.parallel.mesh import ("
        "make_mesh_2d, shard_planes, sharded_destripe_step, "
        "sharded_destripe_step_2d, global_minmax, sharded_normalize_image)\n"
        "from aind_smartspim_destripe_torch.parallel.halo import ("
        "banded_apply_y_sharded, dwt2_y_sharded, idwt2_y_sharded)\n"
        "from aind_smartspim_destripe_torch.ops.wavelets import ("
        "dwt2, idwt2, dwt2_conv, idwt2_conv, wavedec2, waverec2)\n"
        "from aind_smartspim_destripe_torch.zarr_destriper import ("
        "execute_worker, pad_array_n_d, extract_global_to_local)\n"
        "from aind_smartspim_destripe_torch.io.blocked_writer import ("
        "expand_chunks, BlockedArrayWriter)\n"
        "from aind_smartspim_destripe_torch.io.blosc import ("
        "load_system_blosc, system_compress, system_decompress)\n"
        "from aind_smartspim_destripe_torch.ops.multiscale import "
        "windowed_mean_np\n"
        "from aind_smartspim_destripe_torch.ops.fft_notch import apply_notch\n"
        "from aind_smartspim_destripe_torch.runtime.tracing import annotate\n"
        "from aind_smartspim_destripe_torch.utils.utils import ("
        "profile_resources, stop_child_process)\n"
        "from aind_smartspim_destripe_torch import run_capsule\n"
        f"run_capsule.run({str(data)!r}, {str(results)!r}, "
        f"{str(tmp_path / 'scratch')!r}, devices=[torch.device('cpu')])\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'aind_smartspim_destripe_tpu'))]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK', len(names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    assert int(res.stdout.split("NO_JAX_OK")[1].split()[0]) >= 29
    assert set(_tile(results, "471320_461360").keys()) == {"0", "1", "2"}


def test_device_resolution(monkeypatch):
    assert pipeline.resolve_device(CPU) == [torch.device("cpu")]
    assert pipeline.resolve_device(CPU * 2) == [torch.device("cpu")] * 2
    assert pipeline.resolve_device(["cpu", "cuda:1"]) == [
        torch.device("cpu"), torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="no device"):
        pipeline.resolve_device([])
    # None: every visible CUDA device, as the JAX package takes every chip
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert pipeline.resolve_device(None) == [
        torch.device("cuda", i) for i in range(3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.resolve_device(None)


def test_one_device(monkeypatch):
    """A single-device entry point's device: the named one, or None for
    the current CUDA device; no CPU fallback."""
    from aind_smartspim_destripe_torch.parallel.mesh import one_device

    assert one_device("cpu") == torch.device("cpu")
    assert one_device(torch.device("cuda", 2)) == torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        one_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert one_device(None) == torch.device("cuda", 1)


def test_codec_build_with_zstd_shim(tmp_path, monkeypatch):
    """The port's codec builds its own copy of the blosc runtime source
    against libzstd.so.1 with the package's zstd declarations, into the
    port's build directory, and binds it to the port's own io/blosc; the
    JAX package's codec module is never touched."""
    import shutil

    from aind_smartspim_destripe_torch.io import blosc, codec

    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    data = (np.random.default_rng(0).normal(size=200_000) * 40 + 500).astype(
        np.uint16)
    monkeypatch.setattr(codec, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(blosc, "_native", None)
    assert codec.ensure_native_codec() == "native-shim"
    assert codec.ensure_native_codec() == "native-shim"
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]
    assert blosc._native and blosc._load_native() is blosc._native
    for name in ("blosc1_compress", "blosc1_decompress",
                 "blosc1_compress_batch", "blosc1_decompress_batch",
                 "blosc1_compress_slab", "blosc1_decompress_slab"):
        assert getattr(blosc._native, name).argtypes, name
    frame = blosc.compress(data, 2)
    assert blosc.decompress(frame) == data.tobytes()
    from aind_smartspim_destripe_tpu.io import blosc as jb

    assert jb._native is not blosc._native
    monkeypatch.setattr(blosc, "_native", None)
    monkeypatch.setattr(codec.shutil, "which", lambda _: None)
    assert codec.ensure_native_codec() == "zstandard"
    assert blosc.decompress(blosc.compress(data, 2)) == data.tobytes()


@pytest.mark.parametrize("dtype,shuffle", [(np.uint16, 1), (np.uint16, 2),
                                           (np.float32, 1), (np.uint8, 0)])
def test_port_blosc_frames_match_jax_encoder(dtype, shuffle):
    """The port's own io/blosc encodes the same bytes as the JAX package's
    encoder (its native build where there is one), frame by frame, batch by
    batch and slab by slab, and decodes them back."""
    from aind_smartspim_destripe_torch.io import blosc as tb
    from aind_smartspim_destripe_tpu.io import blosc as jb

    rng = np.random.default_rng(int(np.dtype(dtype).itemsize) + shuffle)
    vol = (rng.normal(size=(12, 40, 70)) * 30 + 400).astype(dtype)
    ts = vol.itemsize
    assert tb.compress(vol, ts, shuffle=shuffle) == jb.compress(
        vol, ts, shuffle=shuffle)
    chunks = [vol[i] for i in range(4)]
    mine = [bytes(f) for f in tb.compress_batch(chunks, ts, shuffle=shuffle)]
    theirs = [bytes(f) for f in jb.compress_batch(chunks, ts,
                                                  shuffle=shuffle)]
    assert mine == theirs
    assert [tb.decompress(f) for f in mine] == [c.tobytes() for c in chunks]
    if shuffle == 1 and jb._load_native():
        cs = (4, 16, 32)
        mine = tb.compress_slab(vol, cs)
        theirs = jb.compress_slab(vol, cs)
        assert [bytes(f) for f in mine] == [bytes(f) for f in theirs]
        out = np.empty_like(vol)
        assert tb.decompress_slab([bytes(f) for f in mine], out, cs)
        np.testing.assert_array_equal(out, vol)
