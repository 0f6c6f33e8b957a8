"""The plain-PyTorch reference, which the check computes, against the NumPy
one, which only these tests run."""

import json

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.generator import make_fields, make_planes
from portbench.reference import destripe as ref_np
from portbench.reference import destripe_torch as ref_t

RESIDENT = ("single.resident", "dual.resident")


def _numpy_plane(config, raw, flat, dark, prec="f64"):
    """The NumPy reference's uint16 output for one raw plane of ``config``."""
    cells, no_cells = config["cells_config"], config["no_cells_config"]
    if config.get("dual_band"):
        return ref_np.destripe_plane_dual(
            raw, flat, dark, cells, no_cells,
            crossover=float(config["crossover"]),
            radius=int(config["smooth_radius"]), prec=prec)
    return ref_np.destripe_plane(raw, flat, dark, cells, no_cells,
                                 float(config["microscope_high_int"]),
                                 prec=prec)


def _planes(shape, n=4, seed=5):
    data = harness.load_cell("single.resident").traffic["data"]
    flat, dark = make_fields(*shape, data)
    return make_planes(seed, n, *shape, data, "cpu").numpy(), flat, dark


# each shape's worst plane, measured on this CPU (torch 2.13, NumPy 2.0):
# f64 reads 0 / 0 on every plane; the TF32 controls differ by one count
# on a few pixels (float32 log, exp and FFT of two libraries), rms <= 0.016
LIMITS = {"f64": (0.01, 1.0), "tf32": (0.05, 1.0)}


@pytest.mark.parametrize("prec", ["f64", "tf32"])
@pytest.mark.parametrize("shape", [(48, 64), (120, 150), (97, 131)])
@pytest.mark.parametrize("cell", RESIDENT)
def test_torch_reference_matches_numpy(cell, shape, prec):
    """Single and dual with the flat-field: the tiny cells' shape, the
    NumPy reference test's and an odd one; every pixel within one count."""
    config = harness.load_cell(cell).config
    planes, flat, dark = _planes(shape)
    rms, mx = LIMITS[prec]
    for i, raw in enumerate(planes):
        want = _numpy_plane(config, raw, flat, dark, prec=prec)
        got = check.reference_plane(config, raw, flat, dark, prec=prec)
        assert got.shape == raw.shape and got.dtype == np.uint16
        n = check.plane_numbers(got, want)
        assert n["rms_lsb"] <= rms and n["max_lsb"] <= mx, (i, n)


@pytest.mark.parametrize("shape", [(48, 64), (120, 150), (97, 131)])
def test_otsu_thresholds_match_at_every_level(shape):
    """Every level's Otsu threshold of cH**2, and the dual blend's of the
    raw plane, is the NumPy reference's: no plane at these sizes has a bin
    decision that differs between the two float64 computations."""
    planes, _, _ = _planes(shape, n=8)
    levels = ref_np.n_levels(*shape)
    for i, raw in enumerate(planes):
        x = np.log(1.0 + raw.astype(np.float64))
        want = ref_np.wavedec2(x, levels)
        got = ref_t.wavedec2(torch.log(1.0 + torch.from_numpy(raw).double()),
                             levels)
        for lvl, (w, g) in enumerate(zip(want[1:], got[1:])):
            a = ref_np.threshold_otsu(w[0] * w[0])
            b = ref_t.threshold_otsu(g[0] * g[0])
            assert a == b, f"plane {i}, level {levels - lvl}: {a!r} {b!r}"
        assert (ref_np.threshold_otsu(raw.astype(np.float64))
                == ref_t.threshold_otsu(torch.from_numpy(raw).double())), i


@pytest.mark.parametrize("n", [1, 2, 5, 6, 13])
@pytest.mark.parametrize("pad", [(4, 5), (0, 9), (11, 3)])
def test_symmetric_index_is_numpy_pad(n, pad):
    x = np.arange(n)
    want = np.pad(x, [pad], mode="symmetric")
    got = ref_t._sym_index(n, *pad, "cpu").numpy()
    np.testing.assert_array_equal(x[got], want)


@pytest.mark.parametrize("n", [7, 8, 1002, 1003])
def test_packed_fft_matches_numpy_module(n):
    x = np.random.default_rng(n).normal(size=(3, n))
    np.testing.assert_allclose(ref_t.rfft_packed(torch.from_numpy(x)).numpy(),
                               ref_np.rfft_packed(x), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        ref_t.irfft_packed(torch.from_numpy(x)).numpy(),
        ref_np.irfft_packed(x), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("values", ["grid", "normal", "constant"])
def test_histogram_is_numpy(values, dtype):
    """Counts equal ``np.histogram``'s, also for values on the bin edges
    (a grid of whole numbers over 256 bins) and a constant array."""
    rng = np.random.default_rng(17)
    x = {"grid": np.arange(0, 1025, dtype=np.float64) % 769,
         "normal": rng.normal(size=5001) ** 2,
         "constant": np.full(300, 3.25)}[values].astype(dtype)
    counts, edges = ref_t._histogram(torch.from_numpy(x), 256)
    want_counts, want_edges = np.histogram(x, bins=256)
    np.testing.assert_array_equal(edges.numpy(), want_edges)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


@pytest.mark.parametrize("n", [1, 2, 9, 10])
def test_row_median_is_numpy(n):
    x = np.random.default_rng(n).normal(size=(5, n))
    x[0] = 0.0
    x[1, : n // 2] = -0.0
    np.testing.assert_array_equal(ref_t._row_median(torch.from_numpy(x)),
                                  np.median(x, axis=-1, keepdims=True))


def test_check_computes_torch_reference_on_run_device(monkeypatch):
    """Every configuration names the torch reference, and the check runs it
    on the device it is given, with the flat and dark frames already
    there."""
    bench = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        config = json.loads((harness.ROOT.parent / c["file"]).read_text())
        assert config["reference"] == "portbench/reference/destripe_torch.py"
    assert check.ref is ref_t

    calls = []
    real = ref_t.destripe_plane

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(ref_t, "destripe_plane", spy)
    config = harness.load_cell("single.resident").config
    planes, flat, dark = _planes((48, 64), n=2)
    items = [(i, p, p) for i, p in enumerate(planes)]
    check.compare(config, items, flat, dark, device="cpu")
    assert len(calls) == 2
    for args, kwargs in calls:
        assert kwargs["device"] == "cpu"
        assert all(isinstance(a, torch.Tensor) for a in args[1:3])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", RESIDENT)
def test_torch_reference_on_card_matches_numpy(cell):
    """On the card (cuFFT, the device's log and exp), one production-size
    plane of each cell within one count of the NumPy reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = harness.load_cell(cell)
    cfg = c.config
    planes, flat, dark = _planes((cfg["height"], cfg["width"]), n=2, seed=23)
    for raw in planes:
        want = _numpy_plane(cfg, raw, flat, dark)
        got = check.reference_plane(cfg, raw, flat, dark, device="cuda")
        n = check.plane_numbers(got, want)
        assert n["rms_lsb"] <= 0.01 and n["max_lsb"] <= 1, n
