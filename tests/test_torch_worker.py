"""The port's block-level helpers of ``zarr_destriper`` on the CPU, against
the JAX package's.

``execute_worker`` destripes an in-memory block and writes it into a store
at its output slices: with a retrospective flat, with the tile's
hemisphere flat, and without shadow correction (float32 planes, cast by
the store), at tests/test_zarr_pipeline_e2e.py's size (4 planes of
64 x 80). uint16 within 1 LSB outside a 1% flip budget at >= 100 dB (the
gate of tests/test_torch_filter.py), the float32 planes within 1e-5 of
their scale; uint16 and float32 copies of the same planes give the same
bits. ``pad_array_n_d``, ``extract_global_to_local`` and
``validate_capsule_inputs`` exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_tpu import zarr_destriper as jz  # noqa: E402
from aind_smartspim_destripe_tpu.io.zarr import (  # noqa: E402
    ZarrArray as JArray,
)
from aind_smartspim_destripe_torch import zarr_destriper as tz  # noqa: E402
from aind_smartspim_destripe_torch.io.zarr import (  # noqa: E402
    ZarrArray as TArray,
)
from tests.test_torch_filter import _gate_vs_jax  # noqa: E402
from tests.test_zarr_pipeline_e2e import PARAMETERS  # noqa: E402

Z, H, W = 4, 64, 80
SLICES = (slice(0, 1), slice(0, 1), slice(4, 8), slice(0, H), slice(0, W))
F32_RTOL = 1e-5
FLAT = np.full((H, W), 1.5, np.float32)
SHADOW = {
    "retrospective": {"retrospective": True, "flatfield": FLAT,
                      "darkfield": np.zeros((H, W), np.float32),
                      "tile_config": None},
    # tile 471320_461360 lies on hemisphere 1, whose flat is 1.3 x FLAT
    "hemisphere": {"retrospective": False, "flatfield": [FLAT, FLAT * 1.3],
                   "darkfield": np.full((H, W), 3.0, np.float32),
                   "tile_config": {"471320": {"461360": 1}}},
    "none": None,
}


def _block():
    """Striped uint16-valued planes, as tests/test_zarr_pipeline_e2e.py's
    execute_worker test builds them."""
    rng = np.random.default_rng(0)
    block = np.clip(
        300 + (rng.normal(size=(Z, H, W, 1)) * 50).transpose(0, 1, 3, 2)
        * np.ones((1, 1, 1, W)), 0, 65535)[..., 0, :]
    return block.astype(np.uint16)


def _run(mod, array, tmp_path, tag, data, shadow, **kw):
    out = array.create(str(tmp_path / f"{tag}.zarr"), (1, 1, 8, H, W),
                       (1, 1, 4, H, W), np.uint16)
    res = mod.execute_worker(
        data=data[None, None], output_slices=SLICES,
        output_destriped_zarr=out,
        cells_config=PARAMETERS["cells_config"],
        no_cells_config=PARAMETERS["no_cells_config"],
        shadow_correction=shadow, dataset_name="471320_461360.zarr", **kw)
    return np.asarray(res), np.asarray(out[:])


@pytest.mark.parametrize("shadow", sorted(SHADOW))
def test_execute_worker_matches_jax(tmp_path, shadow):
    block = _block()
    sc = SHADOW[shadow]
    want, want_store = _run(jz, JArray, tmp_path, "jax",
                            block.astype(np.float32), sc)
    got, store = _run(tz, TArray, tmp_path, "port", block, sc,
                      device="cpu")
    got_f32, store_f32 = _run(tz, TArray, tmp_path, "port_f32",
                              block.astype(np.float32), sc, device="cpu")
    # uint16 planes in give the float32 planes' bits
    np.testing.assert_array_equal(got, got_f32)
    np.testing.assert_array_equal(store, store_f32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (store[0, 0, :4] == 0).all()
    if sc is None:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_RTOL * np.abs(want).max())
        _gate_vs_jax(store[0, 0, 4:], want_store[0, 0, 4:])
    else:
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(store[0, 0, 4:], np.squeeze(got))
        _gate_vs_jax(got, want)


def test_execute_worker_unknown_tile_raises(tmp_path):
    sc = dict(SHADOW["hemisphere"], tile_config={"1": {"2": 0}})
    with pytest.raises(KeyError):
        _run(tz, TArray, tmp_path, "port", _block(), sc, device="cpu")


def test_pad_array_n_d_and_extract_match_jax():
    for dim in (3, 5):
        for fn in (jz.pad_array_n_d, tz.pad_array_n_d):
            assert fn(np.ones((3, 3)), dim).shape == (1,) * (dim - 2) + (3, 3)
    with pytest.raises(ValueError):
        tz.pad_array_n_d(np.ones((2, 2)), 6)
    rng = np.random.default_rng(4)
    ids = np.concatenate([rng.integers(-5, 40, size=(200, 3)),
                          np.arange(200)[:, None]], axis=1)
    for sl, pad in [((slice(0, 10),) * 3, 0),
                    ((slice(5, 20), slice(0, 30), slice(10, 12)), 2)]:
        np.testing.assert_array_equal(
            tz.extract_global_to_local(ids.copy(), sl, pad),
            jz.extract_global_to_local(ids.copy(), sl, pad))


def test_validate_capsule_inputs(tmp_path):
    (tmp_path / "present.json").write_text("{}")
    names = [str(tmp_path / "present.json"), str(tmp_path / "absent.json")]
    assert tz.validate_capsule_inputs(names) == [names[1]]
    assert tz.validate_capsule_inputs(names) == jz.validate_capsule_inputs(
        names)
