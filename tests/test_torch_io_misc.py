"""The port's host helpers against the JAX package's, exactly.

- ``io/blocked_writer.py``: ``expand_chunks`` in both modes and
  ``BlockedArrayWriter`` (slices, block shape, stores into the port's own
  Zarr array, threaded or not);
- ``io/blosc.py``'s system c-blosc oracle: the system library decodes the
  port's frames and the port decodes the system's, and both packages'
  oracles give the same frames;
- ``ops/multiscale.windowed_mean_np`` against the JAX package's and the
  port's device ``windowed_mean``;
- ``runtime/tracing.annotate`` names a region of the trace;
- ``utils/utils.profile_resources`` and ``stop_child_process``.
"""

import multiprocessing
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_tpu.io import blocked_writer as jbw  # noqa: E402
from aind_smartspim_destripe_tpu.io import blosc as jblosc  # noqa: E402
from aind_smartspim_destripe_tpu.ops import multiscale as jms  # noqa: E402
from aind_smartspim_destripe_tpu.utils import utils as jutils  # noqa: E402
from aind_smartspim_destripe_torch.io import blocked_writer as tbw  # noqa: E402
from aind_smartspim_destripe_torch.io import blosc as tblosc  # noqa: E402
from aind_smartspim_destripe_torch.io.zarr import ZarrArray  # noqa: E402
from aind_smartspim_destripe_torch.ops import multiscale as tms  # noqa: E402
from aind_smartspim_destripe_torch.runtime.tracing import (  # noqa: E402
    annotate,
)
from aind_smartspim_destripe_torch.utils import utils as tutils  # noqa: E402


@pytest.mark.parametrize("mode", ["cycle", "iso"])
@pytest.mark.parametrize("chunks,shape,target,itemsize", [
    ((1, 1, 1), (10, 10, 10), 128, 2), ((64, 128, 128), (512, 1600, 2000),
                                        128 * 2**20, 2),
    ((3, 5, 7), (30, 40, 50), 10_000, 4), ((2, 2), (3, 9), 1, 1)])
def test_expand_chunks_matches_jax(mode, chunks, shape, target, itemsize):
    got = tbw.expand_chunks(chunks, shape, target, itemsize, mode)
    assert got == jbw.expand_chunks(chunks, shape, target, itemsize, mode)


@pytest.mark.parametrize("args", [((0, 1, 1), (4, 4, 4), 100, 2),
                                  ((5, 1, 1), (4, 4, 4), 100, 2),
                                  ((1, 1, 1), (4, 4, 4), 0, 2),
                                  ((1, 1, 1), (4, 4, 4), 100, 0),
                                  ((1, 1, 1), (4, 4, 4), 100, 2, "bogus")])
def test_expand_chunks_validation(args):
    with pytest.raises(ValueError):
        tbw.expand_chunks(*args)


def test_blocked_writer_matches_jax(tmp_path):
    W = tbw.BlockedArrayWriter
    for shape, block in [((5, 5), (2, 2)), ((6, 7, 3), (4, 2, 3))]:
        assert list(W.gen_slices(shape, block)) == list(
            jbw.BlockedArrayWriter.gen_slices(shape, block))
    with pytest.raises(Exception):
        list(W.gen_slices((5, 5), (2,)))
    src = np.arange(2 * 6 * 7, dtype=np.uint16).reshape(2, 6, 7)
    for n_threads in (0, 4):
        dst = ZarrArray.create(str(tmp_path / f"d{n_threads}"), src.shape,
                               (1, 4, 4), np.uint16)
        W.store(src, dst, (1, 3, 5), n_threads=n_threads)
        np.testing.assert_array_equal(dst[:], src)
        assert W.get_block_shape(dst, target_size_mb=1) == \
            jbw.BlockedArrayWriter.get_block_shape(dst, target_size_mb=1)


def _payloads():
    rng = np.random.default_rng(0)
    smooth = (np.add.outer(np.arange(64), np.arange(128)) * 7).astype(
        np.uint16)
    return {"smooth": smooth.tobytes(),
            "noisy": rng.integers(0, 4000, 8192).astype(np.uint16).tobytes(),
            "zeros": bytes(4096)}


@pytest.mark.parametrize("name", ["smooth", "noisy", "zeros"])
@pytest.mark.parametrize("shuffle", [tblosc.NOSHUFFLE, tblosc.SHUFFLE,
                                     tblosc.BITSHUFFLE])
def test_system_blosc_interop(name, shuffle):
    assert tblosc.load_system_blosc() is not None, "libblosc.so.1 expected"
    data = _payloads()[name]
    ours = tblosc.compress_py(data, typesize=2, clevel=3, shuffle=shuffle)
    assert tblosc.system_decompress(ours, len(data)) == data
    theirs = tblosc.system_compress(data, typesize=2, clevel=3,
                                    shuffle=shuffle)
    assert theirs == jblosc.system_compress(data, typesize=2, clevel=3,
                                            shuffle=shuffle)
    assert tblosc.decompress_py(theirs) == data
    with pytest.raises(RuntimeError):
        tblosc.system_decompress(theirs, len(data) + 1)


@pytest.mark.parametrize("preserve_dtype", [True, False])
@pytest.mark.parametrize("shape,dtype", [((5, 7, 9), np.uint16),
                                         ((1, 1, 8, 8, 8), np.float32),
                                         ((4, 6, 10), np.uint16)])
def test_windowed_mean_np_matches_jax(shape, dtype, preserve_dtype):
    rng = np.random.default_rng(1)
    x = (rng.uniform(0, 1000, shape)).astype(dtype)
    got = tms.windowed_mean_np(x, (2, 2, 2), preserve_dtype)
    want = jms.windowed_mean_np(x, (2, 2, 2), preserve_dtype)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if preserve_dtype:
        dev = tms.windowed_mean(torch.from_numpy(x), (2, 2, 2)).numpy()
        assert np.abs(dev.astype(np.float64) - got).max() <= (
            1 if dtype == np.uint16 else 1e-3)


def test_annotate_names_a_trace_region():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with annotate("destripe-region"):
            torch.ones(4).sum()
    assert any(e.key == "destripe-region" for e in prof.key_averages())
    with annotate("outside-a-trace"):
        pass


class _Stop(Exception):
    pass


class _Capped(list):
    """Ends ``profile_resources``' endless loop after three samples."""

    def append(self, v):
        if len(self) == 3:
            raise _Stop
        super().append(v)


@pytest.mark.parametrize("fn", [tutils.profile_resources,
                                jutils.profile_resources],
                         ids=["port", "jax"])
def test_profile_resources_samples(fn):
    t, cpu, mem = _Capped(), [], []
    with pytest.raises(_Stop):
        fn(t, cpu, mem, 0)
    assert len(t) == len(cpu) == len(mem) == 3
    assert t == sorted(t) and all(0 <= m <= 100 for m in mem)


def test_stop_child_process():
    p = multiprocessing.get_context("spawn").Process(target=time.sleep,
                                                     args=(60,))
    p.start()
    tutils.stop_child_process(p)
    assert not p.is_alive() and p.exitcode is not None
