"""The seeded inputs and sample, the reduction of a device trace, and the
set-up's parts read from spans."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.generator import make_planes, sample_planes, seed_bits
from portbench.devtrace import DeviceTrace, Spans
from portbench.program_spans import as_harness_spans

DATA = {"bright_every": 4, "bright_phase": 1, "bright": 3000.0, "dim": 280.0,
        "row_sigma": 50.0, "pixel_sigma": 8.0}


def test_planes_same_seed_same_data():
    a = make_planes(2 ** 33 + 5, 5, 8, 10, DATA, "cpu")
    b = make_planes(2 ** 33 + 5, 5, 8, 10, DATA, "cpu")
    c = make_planes(2 ** 33 + 6, 5, 8, 10, DATA, "cpu")
    assert a.dtype == torch.uint16 and torch.equal(a, b)
    assert not torch.equal(a, c)
    means = a.to(torch.float32).mean(dim=(1, 2))
    assert means[1] > 2500 and all(means[i] < 500 for i in (0, 2, 3, 4))
    assert 0 <= seed_bits(-3) < 2 ** 64


def test_sample_covers_batches_halves_and_tail():
    groups = [(i * 64, (i + 1) * 64) for i in range(4)]
    for seed in range(20):
        ids = sample_planes(seed, groups, 8, DATA)
        assert len(set(ids)) == 8
        for lo, hi in groups:
            mid = (lo + hi) // 2
            assert any(lo <= i < mid for i in ids)
            assert any(mid <= i < hi for i in ids)
        assert sum(i % 4 == 1 for i in ids) >= 2
        ids = sample_planes(seed, [(0, 64), (64, 128)], 8, DATA,
                            must=((64, 104),))
        assert any(64 <= i < 104 for i in ids)
    assert sample_planes(7, groups, 8, DATA) == sample_planes(7, groups, 8,
                                                              DATA)


def test_trace_busy_and_gaps():
    import threading

    main, other = threading.main_thread().ident, -1
    t = DeviceTrace(window_ns=(0, 100))
    t.device = [(10, 20, "k1", "kernel"), (15, 30, "cp", "memcpy"),
                (60, 70, "k2", "kernel"), (95, 120, "k3", "kernel")]
    t.host = [(40, 50, "cudaMemcpyAsync")]
    spans = [("window", main, 0, 100, {}), ("step", main, 35, 55, {}),
             ("read_slab", other, 0, 12, {})]
    assert t.busy_intervals() == [[10, 30], [60, 70], [95, 100]]
    assert np.isclose(t.busy_s(), 35e-9)
    assert np.isclose(t.kind_s("kernel"), 45e-9)
    gaps = t.idle_gaps(spans)
    assert [g[1] for g in gaps] == [30e-9, 25e-9, 10e-9]
    assert gaps[0][0] == "step:cudaMemcpyAsync"
    assert gaps[1][0] == "window:python"
    assert gaps[2][0] == "window:python [read_slab]"
    assert t.by_name()[0] == ["k3", 25e-9]


def test_gaps_named_by_program_phases():
    """The program's spans, in the harness's form, name a gap by the
    innermost phase or collection open on the main thread."""
    import threading

    main = threading.main_thread().ident
    t = DeviceTrace(window_ns=(0, 100))
    t.device = [(0, 20, "k1", "kernel"), (30, 60, "k2", "kernel"),
                (90, 100, "k3", "kernel")]
    t.host = [(22, 28, "cudaLaunchKernel")]
    harness_spans = [("window", main, 0, 100, {}), ("step", main, 1, 100, {})]
    # (id, parent, step, name, thread, start ns, end ns, meta)
    prog = [(1, 0, 1, "step", main, 2, 99, {}),
            (2, 1, 1, "otsu.L3", main, 18, 40, {}),
            (3, 1, 1, "gc", main, 65, 85, {"generation": 2})]
    assert [g[0] for g in t.idle_gaps(harness_spans)] == [
        "step:python", "step:cudaLaunchKernel"]
    gaps = t.idle_gaps(harness_spans + as_harness_spans(prog))
    assert [g[0] for g in gaps] == ["gc:python", "otsu.L3:cudaLaunchKernel"]


@pytest.mark.parametrize("metric,span,seconds", [
    ("setup.start_s", "setup.start", 2.0),
    ("setup.data_s", "setup.data", 0.5),
    ("setup.warmup_s", "setup.warmup", 0.25)])
def test_setup_part_read_from_its_span(metric, span, seconds):
    spans = Spans()
    spans.add(span, 10 ** 9, 10 ** 9 + round(seconds * 1e9))
    spans.add("setup.other", 0, 7 * 10 ** 9)
    read = harness.load_reader(metric).read
    assert read(SimpleNamespace(spans=spans)) == pytest.approx(seconds)
    assert read(SimpleNamespace(spans=Spans())) is None


class _OldEvent:
    """A profiler event of a release without ``activity_type``."""

    def __init__(self, name, device):
        self._name, self._device = name, device

    def name(self):
        return self._name

    def device_type(self):
        return self._device


def test_activity_without_activity_type():
    from portbench.devtrace import _activity

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    assert _activity(_OldEvent("k4_kernel<1>", cuda)) == "kernel"
    assert _activity(_OldEvent("Memcpy DtoH (Device -> Pageable)",
                               cuda)) == "gpu_memcpy"
    assert _activity(_OldEvent("Memset (Device)", cuda)) == "gpu_memset"
    assert _activity(_OldEvent("cudaLaunchKernel", cpu)) == "cuda_runtime"
    assert _activity(_OldEvent("aten::copy_", cpu)) == "cpu_op"
