"""The plain reference against the port's CPU plain path at a small size
(a test may import both; the reference imports nothing of the port)."""

import numpy as np
import pytest
import torch

from portbench import check
from portbench.generator import make_fields, make_planes
from portbench.reference import destripe as ref
from portbench.tests.tiny import tiny_cell


def _port(config, planes, flat, dark):
    from aind_smartspim_destripe_torch.ops.filter import (
        FilterConfig,
        build_plan,
    )
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        make_device_step,
    )

    h, w = planes.shape[-2:]
    plan = build_plan(h, w, FilterConfig.from_dict(config["cells_config"]),
                      FilterConfig.from_dict(config["no_cells_config"]))
    step = make_device_step(plan, float(config["microscope_high_int"]), True,
                            devices=[torch.device("cpu")],
                            dual=bool(config["dual_band"]),
                            crossover=float(config["crossover"]))
    out = step(step.put(planes), step.put_const(flat),
               step.put_const(dark.astype(np.float32)))
    return step.to_host(out)


@pytest.mark.parametrize("cell", ["single.resident", "dual.resident"])
@pytest.mark.parametrize("shape", [(48, 64), (120, 150)])
def test_reference_matches_port_cpu(cell, shape):
    c = tiny_cell(cell)
    data = c.traffic["data"]
    planes = make_planes(5, 8, *shape, data, "cpu").numpy()
    flat, dark = make_fields(*shape, data)
    got = _port(c.config, planes, flat, dark)
    for raw, out in zip(planes, got):
        n = check.plane_numbers(out, check.reference_plane(c.config, raw,
                                                           flat, dark))
        assert n["rms_lsb"] <= 0.5 and n["max_lsb"] <= 2, n


@pytest.mark.parametrize("n", [7, 8, 1002, 1003])
def test_packed_fft_is_fftpack(n):
    fftpack = pytest.importorskip("scipy.fftpack")
    x = np.random.default_rng(n).normal(size=(3, n))
    np.testing.assert_allclose(ref.rfft_packed(x), fftpack.rfft(x, axis=-1),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(ref.irfft_packed(x), fftpack.irfft(x, axis=-1),
                               rtol=1e-12, atol=1e-12)


def test_reference_matches_golden_oracle():
    pytest.importorskip("jax")  # the oracle imports the JAX package's taps
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from golden import numpy_ref

    rng = np.random.default_rng(3)
    img = np.clip(280 + rng.normal(size=(150, 1)) * 50
                  + rng.normal(size=(150, 190)) * 8, 0, 65535).astype(
        np.uint16)
    for sigma, thr in ((64, 3), (128, 12)):
        want = numpy_ref.log_space_fft_filtering_ref(img, sigma=sigma,
                                                     max_threshold=thr)
        got = ref.filter_plane(img, [dict(sigma=sigma, max_threshold=thr)])[0]
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert ref.is_cells(img, 2500.0) is False


def test_control_fails_the_limits():
    """The reference computed in TF32, in the program's place, reads above
    every cell's limit on one of its numbers."""
    from portbench import harness
    from portbench.tests.tiny import CELLS, cell as full_cell

    h, w = 400, 500
    data = harness.load_cell("single.resident").traffic["data"]
    planes = make_planes(11, 2, h, w, data, "cpu").numpy()
    flat, dark = make_fields(h, w, data)
    for cell in CELLS:
        c = full_cell(cell)
        limits = check.load_limits(harness.ROOT, cell)
        items = [(i, p, check.reference_plane(c.config, p, flat, dark,
                                              prec="tf32"))
                 for i, p in enumerate(planes)]
        worst, _ = check.compare(c.config, items, flat, dark)
        assert any(worst[k] > limits[k] for k in check.NUMBERS), (cell, worst)
