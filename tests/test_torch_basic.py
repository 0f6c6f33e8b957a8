"""The port's BaSiC model and flat-field estimation against the JAX package
on the CPU.

The resize and DCT that stand for ``jax.image.resize(..., "linear")`` and
``jax.scipy.fft.dctn`` are held to 1e-6 (relative to the output's largest
magnitude, and absolute on unit-scale data): both round the same float32
weights, summed in another order. The fits run the same float32 updates
in another summation order; the stopping tests read the same measures, so
the fits stop at the same iterations and the fields agree far inside the
stated bounds (measured: flatfield 1.9e-6 relative without dark, 3.6e-6
with it). ``unify_fields`` is numpy on both sides: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from aind_smartspim_destripe_tpu import flatfield_estimation as jfe  # noqa: E402
from aind_smartspim_destripe_tpu.models.basic import BaSiC as JBaSiC  # noqa: E402
from aind_smartspim_destripe_tpu.utils import utils as jutils  # noqa: E402
from aind_smartspim_destripe_torch import flatfield_estimation as tfe  # noqa: E402
from aind_smartspim_destripe_torch.models import basic as tb  # noqa: E402
from aind_smartspim_destripe_torch.utils import utils as tutils  # noqa: E402
from tests.test_basic_model import synthetic_stack  # noqa: E402
from tests.test_flatfield_estimation_e2e import CFG  # noqa: E402
from tests.test_flatfield_estimation_e2e import (  # noqa: E402,F401
    smartspim_tree,
)
from tests.test_torch_filter import _gate_vs_jax  # noqa: E402

# the production knobs of tests/test_basic_model.py's parity test
PRODUCTION = dict(get_darkfield=True, smoothness_flatfield=1.0,
                  smoothness_darkfield=20.0, sort_intensity=True,
                  max_reweight_iterations=35)


@pytest.mark.parametrize("src,dst", [((96, 120), (32, 32)),
                                     ((32, 32), (96, 120)),
                                     ((50, 40), (50, 64))])
def test_resize_matches_jax(src, dst):
    x = (np.random.default_rng(sum(src)).normal(size=(3,) + src) * 100
         + 500).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3,) + dst, "linear"))
    got = tb.resize(torch.from_numpy(x), dst).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_dct_matches_jax():
    y = np.random.default_rng(0).normal(size=(32, 32)).astype(np.float32)
    c = torch.from_numpy(tb.dct_matrix(32))
    t = torch.from_numpy(y)
    for mine, theirs in ((tb._dct2, jax.scipy.fft.dctn),
                         (tb._idct2, jax.scipy.fft.idctn)):
        want = np.asarray(theirs(jnp.asarray(y), type=2, norm="ortho"))
        assert np.abs(mine(t, c).numpy() - want).max() <= 1e-6
    np.testing.assert_allclose(tb._idct2(tb._dct2(t, c), c).numpy(), y,
                               atol=1e-5)


def test_fit_no_dark_matches_jax():
    imgs, flat_true, _ = synthetic_stack(n=24, h=64, w=64, seed=0)
    mask = np.ones((64, 64), np.float32)
    mask[:8] = 0.5
    knobs = dict(get_darkfield=False, smoothness_flatfield=1.0,
                 sort_intensity=True, max_reweight_iterations=5,
                 working_size=32)
    for weight in (None, mask):
        want = JBaSiC(**knobs).fit(imgs, fitting_weight=weight)
        got = tb.BaSiC(**knobs, device="cpu").fit(imgs, fitting_weight=weight)
        assert got.flatfield.shape == imgs.shape[1:]
        rel = np.abs(got.flatfield - want.flatfield) / want.flatfield
        assert rel.max() <= 1e-3, rel.max()
        np.testing.assert_allclose(got.baseline, want.baseline, rtol=1e-3)
        assert not got.darkfield.any()
        # one host read per LADMAP iteration and per reweighting check
        assert got.host_syncs > knobs["max_reweight_iterations"]
    corr = np.corrcoef(got.flatfield.ravel(), flat_true.ravel())[0, 1]
    assert corr > 0.95


def test_fit_production_knobs_match_jax_and_oracle():
    """The parity test's production knobs (dark, sort_intensity, 35
    reweights) at 64x64, against JAX and against the float64 oracle with
    that test's bounds."""
    from tests.golden.basic_ref import basic_fit_ref

    imgs, flat_true, _ = synthetic_stack(n=24, h=64, w=64, dark=True,
                                         seed=11)
    want = JBaSiC(working_size=64, **PRODUCTION).fit(imgs)
    got = tb.BaSiC(working_size=64, device="cpu", **PRODUCTION).fit(imgs)
    rel = np.abs(got.flatfield - want.flatfield) / want.flatfield
    assert rel.mean() <= 1e-2, rel.mean()
    assert np.abs(got.darkfield - want.darkfield).mean() <= 2.5
    assert np.corrcoef(got.baseline, want.baseline)[0, 1] > 0.9999

    S_ref, D_ref, b_ref = basic_fit_ref(imgs, **PRODUCTION)
    assert np.mean(np.abs(got.flatfield - flat_true) / flat_true) < 0.05
    gap = np.mean(np.abs(got.flatfield - S_ref) / np.maximum(S_ref, 1e-3))
    assert gap < 0.02, gap
    assert np.mean(np.abs(got.darkfield - D_ref)) < 5.0
    assert np.corrcoef(got.baseline, b_ref)[0, 1] > 0.999


def test_transform_matches_jax():
    imgs, *_ = synthetic_stack(n=8, h=32, w=32, seed=5)
    knobs = dict(sort_intensity=False, max_reweight_iterations=2,
                 working_size=32)
    want = JBaSiC(**knobs).fit(imgs)
    got = tb.BaSiC(**knobs, device="cpu")
    got.flatfield, got.darkfield, got.baseline = (
        want.flatfield, want.darkfield, want.baseline)
    for tl in (False, True):
        np.testing.assert_array_equal(got.transform(imgs, timelapse=tl),
                                      want.transform(imgs, timelapse=tl))
    with pytest.raises(ValueError, match="one baseline per image"):
        got.transform(imgs[:3], timelapse=True)
    got.sort_intensity = True
    with pytest.raises(ValueError, match="sort_intensity"):
        got.transform(imgs, timelapse=True)
    with pytest.raises(RuntimeError, match="fit"):
        tb.BaSiC(device="cpu").transform(imgs)
    with pytest.raises(ValueError, match=r"\(n, h, w\)"):
        tb.BaSiC(device="cpu").fit(np.zeros((8, 8)))


def test_fit_refuses_to_run_on_the_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs, *_ = synthetic_stack(n=4, h=16, w=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.BaSiC(working_size=16).fit(imgs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfe.shading_correction(list(imgs), {"working_size": 16})


@pytest.mark.parametrize("mode", ["median", "mean", "mip"])
def test_unify_fields_exact(mode):
    rng = np.random.default_rng(3)
    fields = [[rng.random((4, 5)) * s for s in (1.0, 2.0, 3.0)]
              for _ in range(2)]
    bases = [rng.random(3) for _ in range(3)]
    got = tfe.unify_fields(*fields, bases, mode=mode)
    want = jfe.unify_fields(*fields, bases, mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float16
        np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError):
        tfe.unify_fields(*fields, bases, mode="bogus")


def test_shading_correction_surface_matches_jax():
    imgs, *_ = synthetic_stack(n=8, h=32, w=32)
    params = dict(get_darkfield=False, smoothness_flatfield=1.0,
                  sort_intensity=True, max_reweight_iterations=2,
                  working_size=32)
    got = tfe.shading_correction(list(imgs), params, device="cpu")
    want = jfe.shading_correction(list(imgs), params)
    assert set(got) == set(want) == {"flatfield", "darkfield", "baseline"}
    rel = np.abs(got["flatfield"] - want["flatfield"]) / want["flatfield"]
    assert rel.max() <= 1e-3


def test_slide_flat_estimation_matches_jax(smartspim_tree):
    """The e2e test's tree (2 x 2 tiles, 2 slides): the same directory map,
    destriped tiles within the flip gate, flatfields within 1e-2 relative
    (a coefficient that flips a threshold in one tile moves that tile by up
    to ~10 and the fit with it: 1.8e-3 measured), and the e2e test's
    correlation bound on the unified flat."""
    root, flat_true = smartspim_tree
    s_t = tutils.read_image_directory_structure(str(root), "Ex_.*")
    s_j = jutils.read_image_directory_structure(str(root), "Ex_.*")
    assert s_t == s_j
    params = dict(get_darkfield=False, smoothness_flatfield=1.0,
                  sort_intensity=True, max_reweight_iterations=2,
                  working_size=32)
    channel = list(s_t)[0]
    got = tfe.slide_flat_estimation(s_t, channel, [0, 1], params, CFG, CFG,
                                    device="cpu")
    want = jfe.slide_flat_estimation(s_j, channel, [0, 1], params, CFG, CFG)
    assert set(got) == set(want) == {0, 1}
    for idx in (0, 1):
        g, w = got[idx], want[idx]
        assert len(g["data"]) == len(w["data"]) == 4
        _gate_vs_jax(np.stack(g["data"]), np.stack(w["data"]))
        rel = np.abs(g["flatfield"] - w["flatfield"]) / w["flatfield"]
        assert rel.max() <= 1e-2, rel.max()
        assert g["host_syncs"] > 0 and set(g["seconds"]) == {"destripe", "fit"}
    flat, _, _ = tfe.unify_fields(
        [got[i]["flatfield"] for i in (0, 1)],
        [got[i]["darkfield"] for i in (0, 1)],
        [got[i]["baseline"] for i in (0, 1)],
    )
    corr = np.corrcoef(flat.astype(np.float64).ravel(), flat_true.ravel())[0, 1]
    assert corr > 0.8, corr
