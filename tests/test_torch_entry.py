"""The port's remaining entry points against the JAX package on the CPU:
the ``filtering`` facade, the file-batch destriper (``destriper.batch_filter``)
with its parameters (``destriper_params``) and the CLI (``__main__``).

Images are gated as in tests/test_torch_filter.py: the two packages sum in
different orders, so a coefficient on a threshold may flip and move the
pixels it reconstructs; at most 1% of the pixels may move by more than
1 LSB, and the others must agree at PSNR >= 100 dB. The facade's host
helpers are exact; its flat-field correction is held to 1 LSB.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu import destriper as jd  # noqa: E402
from aind_smartspim_destripe_tpu import filtering as jfil  # noqa: E402
from aind_smartspim_destripe_tpu.destriper_params import (  # noqa: E402
    DestripingParams as JParams,
)
from aind_smartspim_destripe_tpu.io.readers import imread  # noqa: E402
from aind_smartspim_destripe_tpu.io.writers import imsave  # noqa: E402
from aind_smartspim_destripe_tpu.io.zarr import open_zarr  # noqa: E402
from aind_smartspim_destripe_tpu.ops import filter as jf  # noqa: E402
from aind_smartspim_destripe_torch import destriper as td  # noqa: E402
from aind_smartspim_destripe_torch import filtering as tfil  # noqa: E402
from aind_smartspim_destripe_torch.__main__ import main  # noqa: E402
from aind_smartspim_destripe_torch.destriper_params import (  # noqa: E402
    DestripingParams as TParams,
)
from aind_smartspim_destripe_torch.run_capsule import (  # noqa: E402
    PRODUCTION_PARAMETERS,
)
from tests.test_run_capsule_e2e import H, W, Z, build_capsule  # noqa: E402
from tests.test_torch_filter import _batch, _gate_vs_jax  # noqa: E402

CELLS = PRODUCTION_PARAMETERS["cells_config"]
NO_CELLS = PRODUCTION_PARAMETERS["no_cells_config"]
DUAL = {"crossover": 90.0, "threshold": -1.0}


# ---------------------------------------------------------------------------
# The facade
# ---------------------------------------------------------------------------


def test_facade_host_helpers_exact():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 7)) * 3
    np.testing.assert_array_equal(tfil.sigmoid(x), jfil.sigmoid(x))
    img = rng.uniform(300, 500, (6, 9))
    np.testing.assert_array_equal(tfil.foreground_fraction(img, 400, 20),
                                  jfil.foreground_fraction(img, 400, 20))
    planes = _batch(2, 64, 80, seed=4)
    for plane in planes:
        got, want = (f.get_foreground_background_mean(plane)
                     for f in (tfil, jfil))
        assert got[0] == want[0] and got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(tfil.notch(33, 4.0), jfil.notch(33, 4.0))
    np.testing.assert_array_equal(tfil.gaussian_filter((3, 16), 2.0),
                                  jfil.gaussian_filter((3, 16), 2.0))


def test_facade_normalize_invert_flatfield():
    rng = np.random.default_rng(1)
    flats = [rng.integers(100, 4000, (8, 9)).astype(np.uint16)
             for _ in range(2)]
    np.testing.assert_array_equal(tfil.normalize_image(flats),
                                  jfil.normalize_image(flats))
    for img in (flats[0], rng.normal(size=(8, 9)).astype(np.float32)):
        got, want = tfil.invert_image(img), jfil.invert_image(img)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    y = rng.uniform(-100, 140000, (2, 40, 50)).astype(np.float32)
    flat = (1.0 + rng.random((40, 50))).astype(np.float32)
    dark = rng.uniform(0, 50, (45, 60)).astype(np.float32)
    for base in (None, np.array([3.0, 7.0], np.float32)):
        got = tfil.flatfield_correction(y, flat, dark, base, device="cpu")
        want = jfil.flatfield_correction(y, flat, dark, base)
        assert got.dtype == want.dtype == np.uint16
        # 1 LSB: the same f32 operations on both sides (measured exact)
        d = np.abs(got.astype(np.int64) - want.astype(np.int64))
        assert d.max() <= 1


def _shadow(retrospective):
    rng = np.random.default_rng(2)
    flats = [(1.0 + 0.3 * rng.random((64, 80))).astype(np.float32)
             for _ in range(2)]
    return {
        "retrospective": retrospective,
        "flatfield": flats[0] if retrospective else flats,
        "darkfield": np.full((64, 80), 3.0, np.float32),
        "tile_config": {"471320": {"461360": 1}},
    }


# (shadow correction, dual_band, tile path): the cells / no-cells dispatch
# (planes 0 and 2 dim, plane 1 bright with cells), the dual blend, and both
# shadow paths, the prospective one by a bare tile name and a file path
FACADE_CASES = [
    (None, None, "t"),
    (None, DUAL, "t"),
    ("retrospective", None, "471320_461360"),
    ("prospective", None, "471320_461360"),
    ("prospective", DUAL, "/data/Ex_488_Em_525/471320/471320_461360/0.tiff"),
]


@pytest.mark.parametrize("case", FACADE_CASES, ids=lambda c: f"{c[0]}-{bool(c[1])}")
def test_filter_stripes_matches_jax(case):
    shadow, dual, tile = case
    planes = _batch(3, 64, 80, seed=7)
    sc = None if shadow is None else _shadow(shadow == "retrospective")
    for plane in planes:
        kw = dict(image=plane, input_tile_path=tile, no_cells_config=NO_CELLS,
                  cells_config=CELLS, shadow_correction=sc, dual_band=dual)
        got = tfil.filter_stripes(**kw, device="cpu")
        want = jfil.filter_stripes(**kw)
        assert got.dtype == want.dtype and got.shape == plane.shape
        assert got.dtype == (np.float32 if sc is None else np.uint16)
        _gate_vs_jax(got, np.asarray(want))


def test_facade_log_space_fft_filtering():
    plane = _batch(1, 64, 80, seed=8)[0].astype(np.float32)
    got = tfil.log_space_fft_filtering(plane, level=None, sigma=64,
                                       max_threshold=3, device="cpu")
    _gate_vs_jax(got, np.asarray(jfil.log_space_fft_filtering(
        plane, level=None, sigma=64, max_threshold=3)))


# ---------------------------------------------------------------------------
# The file-batch destriper
# ---------------------------------------------------------------------------


def _make_tree(root):
    """7 uint16 planes of 64x80 in two subdirectories (4 + 3), a sidecar
    .txt, and one unreadable .tiff that must be logged and skipped."""
    inp = root / "in"
    for sub in ("c0/c0_r0", "c1/c1_r0"):
        (inp / sub).mkdir(parents=True)
    (inp / "notes.txt").write_text("sidecar")
    planes = _batch(7, 64, 80, seed=11)
    for i, plane in enumerate(planes):
        sub = "c0/c0_r0" if i < 4 else "c1/c1_r0"
        imsave(str(inp / sub / f"{i:02d}.tiff"), plane)
    (inp / "c1" / "c1_r0" / "broken.tiff").write_bytes(b"not a tiff")
    return inp


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*"))


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory):
    """JAX and port batch_filter outputs, single band and dual band."""
    root = tmp_path_factory.mktemp("batch")
    inp = _make_tree(root)
    outs = {}
    for name, dual in (("single", None), ("dual", DUAL)):
        for pkg, fn, kw in (("jax", jd.batch_filter, {}),
                            ("torch", td.batch_filter, {"device": "cpu"})):
            out = root / f"out_{pkg}_{name}"
            out.mkdir()
            fn(input_path=inp, output_path=out, workers=2, chunks=3,
               high_int_filt_params=CELLS, low_int_filt_params=NO_CELLS,
               shadow_correction=None, dual_band=dual, **kw)
            outs[pkg, name] = out
    return inp, outs


@pytest.mark.parametrize("mode", ["single", "dual"])
def test_batch_filter_matches_jax(batch_runs, mode):
    inp, outs = batch_runs
    jo, to = outs["jax", mode], outs["torch", mode]
    assert _tree(to) == _tree(jo)
    assert (to / "notes.txt").read_text() == "sidecar"
    log_t = (to / "destripe_log.txt").read_text()
    assert log_t == (jo / "destripe_log.txt").read_text()
    assert str(inp / "c1" / "c1_r0" / "broken.tiff") in log_t
    files = [p for p in _tree(jo) if p.endswith(".tiff")]
    assert len(files) == 7
    for rel in files:
        got, want = imread(str(to / rel)), imread(str(jo / rel))
        assert got.dtype == want.dtype == np.uint16
        assert got.shape == want.shape == (64, 80)
        _gate_vs_jax(got, want)


def test_destriping_params_match_jax(tmp_path):
    argv = ["--input_path", str(tmp_path), "--output_path", "/tmp/out",
            "--workers", "4", "--dual_band", "--crossover", "80",
            "--dual_threshold", "350"]
    assert vars(TParams.from_args(argv)) == vars(JParams.from_args(argv))
    short = ["--input_path", str(tmp_path), "--output_path", "o"]
    assert vars(TParams.from_args(short)) == vars(JParams.from_args(short))
    with pytest.raises(SystemExit):
        TParams.from_args([])
    for bad, match in ((["--workers", "0"], "workers"),
                       (["--chunks", "0"], "chunks")):
        with pytest.raises(ValueError, match=match):
            TParams.from_args(short + bad)
    with pytest.raises(ValueError, match="not a directory"):
        TParams("/nonexistent-dir", "/tmp").validate()


def test_cli_batch_matches_batch_filter(batch_runs, tmp_path):
    """``main(["batch", ...])``: the production configurations through
    ``batch_filter``, bit-equal to the direct call with the same batches."""
    inp, outs = batch_runs
    for name, extra in (("single", []), ("dual", ["--dual_band",
                                                  "--crossover", "90"])):
        out = tmp_path / name
        out.mkdir()
        assert main(["batch", "--input_path", str(inp), "--output_path",
                     str(out), "--chunks", "3", "--workers", "2",
                     "--device", "cpu", *extra]) == 0
        ref = outs["torch", name]
        assert _tree(out) == _tree(ref)
        for rel in (p for p in _tree(ref) if p.endswith(".tiff")):
            np.testing.assert_array_equal(imread(str(out / rel)),
                                          imread(str(ref / rel)))


def test_cli_capsule_matches_jax(tmp_path):
    """``main(["capsule", ...])`` on the synthetic capsule: level 0 of both
    tiles within 1 LSB of the JAX step with the flat-field epilogue."""
    data, results = build_capsule(tmp_path)
    assert main(["capsule", "--data", str(data), "--results", str(results),
                 "--scratch", str(tmp_path / "scratch"),
                 "--device", "cpu"]) == 0
    plan = jf.build_plan(H, W, jf.FilterConfig.from_dict(CELLS),
                         jf.FilterConfig.from_dict(NO_CELLS))
    dark = imread(str(data / "derivatives" / "DarkMaster_cropped.tif"))
    for tile, side in (("471320_461360", 0), ("489620_461360", 1)):
        flat = imread(str(data / f"estimated_flat_laser_Ex_488_Em_525_{side}.tif"))
        src = np.asarray(open_zarr(str(data / "Ex_488_Em_525"
                                       / f"{tile}.zarr"))["0"][0, 0])
        want = np.asarray(jf.destripe_batch(
            plan, jnp.asarray(src), 2500.0, plan.constants(),
            flat=jnp.asarray(flat, jnp.float32),
            dark=jnp.asarray(dark, jnp.float32)))
        got = np.asarray(open_zarr(str(
            results / "destriped_data" / "Ex_488_Em_525"
            / f"{tile}.zarr"))["0"][0, 0])
        assert got.shape == (Z, H, W)
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1
    prov = results / "image_destriping_Ex_488_Em_525_processing.json"
    assert json.load(open(prov))["processing_pipeline"]["data_processes"]
    assert main(["bogus"]) == 2


def test_entry_points_refuse_to_run_on_the_cpu_unasked(tmp_path, monkeypatch):
    """Without a card and without a CPU device, every entry point raises
    before it reads or writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plane = _batch(1, 64, 80, seed=1)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfil.filter_stripes(plane, "t", NO_CELLS, CELLS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.batch_filter(tmp_path, tmp_path, 1, 1, CELLS, NO_CELLS, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["batch", "--input_path", str(tmp_path), "--output_path",
              str(tmp_path)])
    data, results = build_capsule(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["capsule", "--data", str(data), "--results", str(results)])
    assert not os.listdir(results)
