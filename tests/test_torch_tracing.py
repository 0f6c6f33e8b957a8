"""The port's span recorder (``runtime/tracing.py``) on the CPU.

Off, ``span`` is one shared no-op on every route of the device step. On,
a step records ``step`` with its phases (``an``/``otsu``/``notch``/``syn``
per level), each with the right parent and step id and properly nested;
the plan's set-up spans appear once per cache miss; a garbage collection
is a ``gc`` span; the spans lie on the clock of ``torch.profiler``'s
events and are recorded under a profiler without ``enable()``. The
benchmark's readers of the program's spans (``portbench/metrics/step.*``,
``portbench/program_spans.py``) are held on hand-built runs, including
the None they return when the spans are absent.
"""

import gc
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_torch.ops import filter as tf  # noqa: E402
from aind_smartspim_destripe_torch.runtime import pipeline  # noqa: E402
from aind_smartspim_destripe_torch.runtime import tracing  # noqa: E402
from portbench import harness, program_spans as ps  # noqa: E402
from portbench.devtrace import DeviceTrace, Spans  # noqa: E402
from portbench.tests.tiny import tiny_cell  # noqa: E402

CPU = torch.device("cpu")
H, W, B = 64, 96, 2
ROUTES = ("one", "planes", "halo")
PHASES = ("an.L", "otsu.L", "notch.L", "syn.L")
NAME, START, END = 3, 5, 6


@pytest.fixture
def recorder():
    """The recorder emptied and off, and off again afterwards."""
    tracing.enable()
    tracing.disable()
    yield
    tracing.disable()


def _plan():
    return tf.build_plan(H, W, tf.FilterConfig(sigma=64, max_threshold=3),
                         tf.FilterConfig(sigma=128, max_threshold=12))


def _step(route, monkeypatch, dual=False):
    """A tiny flat-field step on ``route`` and its arguments on the
    route's devices."""
    devices = [CPU] if route == "one" else [CPU, CPU]
    if route == "halo":
        monkeypatch.setenv("DESTRIPE_HALO_THRESHOLD_BYTES", "1024")
    step = pipeline.make_device_step(_plan(), 2500.0, True, devices=devices,
                                     dual=dual)
    rng = np.random.default_rng(3)
    x = rng.integers(100, 3000, (B, H, W)).astype(np.uint16)
    flat = step.put_const(np.ones((H, W), np.float32))
    dark = step.put_const(np.zeros((H, W), np.float32))
    return step, (step.put(x), flat, dark)


def _by_name(spans, name):
    return [s for s in spans if s[NAME] == name]


@pytest.mark.parametrize("route", ROUTES)
def test_off_span_is_the_shared_noop(route, recorder, monkeypatch):
    step, args = _step(route, monkeypatch)
    out = step.to_host(step(*args))
    assert out.shape == (B, H, W) and out.dtype == np.uint16
    assert tracing.collect() == []
    assert tracing.span("step") is tracing.span("an.L0", planes=1)
    with tracing.span("step") as meta:
        assert meta is None
    assert tracing.collect() == []


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("route", ROUTES)
def test_step_records_its_phases(route, dual, recorder, monkeypatch):
    step_fn, args = _step(route, monkeypatch, dual)
    tracing.enable()
    step_fn(*args)
    spans = tracing.collect()
    (step,) = _by_name(spans, "step")
    assert step[1] == 0 and step[2] == step[0]
    assert step[7] == {"planes": B, "devices": 1 if route == "one" else 2}
    inside = [s for s in spans if s[2] == step[0] and s is not step]
    by_id = {s[0]: s for s in spans}
    for s in inside:
        parent = by_id[s[1]]  # every parent is a recorded span of the step
        assert parent[START] <= s[START] <= s[END] <= parent[END]
        assert s[4] == step[4] == threading.get_ident()
    for a in spans:  # spans of one thread nest or are disjoint
        for b in spans:
            if a[START] <= b[START] < a[END]:
                assert b[END] <= a[END], (a, b)
    names = {s[NAME] for s in inside}
    if route == "halo":  # the row-sharded route's own passes
        return
    levels = _plan().n_levels
    for phase in PHASES:
        assert {f"{phase}{lvl}" for lvl in range(levels)} <= names
    assert {s[1] for s in inside if s[NAME].startswith(PHASES)} \
        == {step[0]}
    assert ({"otsu.raw", "blend"} <= names) == dual
    assert ("classify" in names) != dual  # tiny planes: not fused into K1


def test_plan_spans_once_per_cache_miss(recorder):
    tf.build_plan.cache_clear()
    tracing.enable()
    plan = _plan()
    assert _plan() is plan
    consts = tf.device_constants(plan, CPU)
    tf.destripe_batch(plan, torch.ones((1, H, W)), consts=consts)
    spans = tracing.collect()
    names = [s[NAME] for s in spans]
    assert names.count("plan.build") == 1
    assert names.count("plan.constants") == names.count("plan.upload") == 1
    # the phases of plan.constants, inside it
    assert names.count("plan.notch") == names.count("plan.band_forms") == 1
    by_id = {s[0]: s for s in spans}
    for s in spans:
        if s[NAME] in ("plan.notch", "plan.band_forms"):
            assert by_id[s[1]][NAME] == "plan.constants" and s[2] == 0
        elif s[NAME].startswith("plan."):
            assert s[1] == s[2] == 0


def test_gc_is_a_span(recorder):
    tracing.enable()
    with tracing.span("notch.L0"):
        gc.collect()
    (outer,) = _by_name(tracing.collect(), "notch.L0")
    full = [s for s in _by_name(tracing.collect(), "gc")
            if s[7] == {"generation": 2}]
    assert full and all(s[1] == outer[0] for s in full)
    tracing.disable()
    gc.collect()
    assert not [s for s in tracing.collect() if s[START] > outer[END]]


def test_spans_share_the_profilers_clock(recorder, monkeypatch):
    step_fn, args = _step("one", monkeypatch)
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step_fn(*args)
    (step,) = _by_name(tracing.collect(), "step")
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert len(events) > 50
    for e in events:
        assert step[START] <= e.start_ns(), e.name()
        assert e.start_ns() + e.duration_ns() <= step[END], e.name()


def test_a_profiler_turns_recording_on(recorder, monkeypatch):
    step, args = _step("one", monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(*args)
    assert len(_by_name(tracing.collect(), "step")) == 1
    step(*args)  # no profiler, no enable(): nothing more
    assert len(_by_name(tracing.collect(), "step")) == 1


def test_device_trace_names_the_phases(recorder, tmp_path):
    with tracing.device_trace(str(tmp_path)):
        with tracing.span("notch.L3"):
            torch.ones(4).sum()
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "notch.L3" for e in trace["traceEvents"])
    assert _by_name(tracing.collect(), "notch.L3")
    with tracing.span("outside"):  # the annotation ends with the trace
        pass
    assert not _by_name(tracing.collect(), "outside")


def _run(steps, host, pad_ns=1000):
    lo = min(s[START] for s in steps) - pad_ns if steps else 0
    hi = max(s[END] for s in steps) + pad_ns if steps else 1
    return harness.Run(cell=None, window={"steps": len(steps)},
                       trace=DeviceTrace(window_ns=(lo, hi), host=host),
                       spans=Spans())


def _recorded_steps(n):
    tracing.enable()
    for _ in range(n):
        with tracing.span("step"):
            time.sleep(0.002)
    tracing.disable()
    return _by_name(tracing.collect(), "step")


@pytest.mark.parametrize("metric", ["step.host_ms", "step.launches"])
def test_readers(metric, recorder):
    read = harness.load_reader(metric).read
    steps = _recorded_steps(3)
    host = [(s[START] + 10, s[START] + 20, "cudaLaunchKernel")
            for s in steps]
    host += [(steps[0][START] + 30, steps[0][START] + 40, "cudaMemsetAsync"),
             (steps[1][START] + 30, steps[1][START] + 40, "cuLaunchKernel"),
             (steps[1][START] + 50, steps[1][START] + 60,
              "cudaStreamSynchronize"),  # waits, enqueues nothing
             (steps[2][END] + 5, steps[2][END] + 9, "cudaLaunchKernel")]
    run = _run(steps, host)
    want = {"step.host_ms": np.mean([s[END] - s[START] for s in steps]) / 1e6,
            "step.launches": 5 / 3}[metric]
    approx_want = pytest.approx(want)
    assert read(run) == approx_want
    no_calls = read(_run(steps, []))
    assert no_calls == (0 if metric == "step.launches" else approx_want)
    later = harness.Run(cell=None, window={"steps": 3}, spans=Spans(),
                        trace=DeviceTrace(window_ns=(steps[2][END] + 1,
                                                     steps[2][END] + 2)))
    assert read(later) is None  # no step began in the window
    tracing.enable()  # the recorder emptied: a program that recorded none
    assert read(run) is None


@pytest.mark.parametrize("metric", ["step.host_ms", "step.launches"])
def test_readers_without_a_recorder(metric, recorder, monkeypatch):
    steps = _recorded_steps(2)
    monkeypatch.delattr(tracing, "collect")  # a commit before the recorder
    assert harness.load_reader(metric).read(_run(steps, [])) is None


def test_gaps_named_by_the_innermost_program_span():
    main = threading.main_thread().ident
    dt = DeviceTrace(window_ns=(0, 100_000_000),
                     device=[(0, 10_000_000, "k1", "kernel"),
                             (60_000_000, 70_000_000, "k2", "kernel"),
                             (90_000_000, 100_000_000, "k3", "kernel")])
    harness_spans = [("window", main, 0, 100_000_000, {}),
                     ("step", main, 1, 99_000_000, {})]
    prog = [(1, 0, 1, "step", main, 2, 98_000_000, {}),
            (2, 1, 1, "notch.L0", main, 5_000_000, 59_000_000, {}),
            (3, 2, 1, "gc", main, 50_000_000, 58_000_000,
             {"generation": 0})]
    gaps = dt.idle_gaps(harness_spans + ps.as_harness_spans(prog))
    assert gaps == [["notch.L0:python", 0.05], ["step:python", 0.02]]
    idle = ps.idle_by_phase(dt, prog)
    assert idle["idle_s_by_span"] == pytest.approx({"notch.L0": 0.05,
                                                    "step": 0.02})
    assert idle["below_step_share"] == pytest.approx(0.05 / 0.07)
    assert idle["gaps_over_1ms_bare_step"] == 1
    starts, names = ps.innermost(prog, main)
    at = dict(zip(starts.tolist(), names))
    assert at == {2: "step", 5_000_000: "notch.L0", 50_000_000: "gc",
                  58_000_000: "notch.L0", 59_000_000: "step",
                  98_000_000: None}


def test_self_time_per_step():
    spans = [(1, 0, 1, "step", 0, 0, 10_000_000, {}),
             (2, 1, 1, "an.L0", 0, 1_000_000, 4_000_000, {}),
             (3, 2, 1, "gc", 0, 2_000_000, 3_000_000, {}),
             (4, 0, 4, "step", 0, 20_000_000, 26_000_000, {}),
             (5, 4, 4, "an.L0", 0, 21_000_000, 22_000_000, {})]
    got = ps.self_ms_per_step(spans, top=1)
    assert got == pytest.approx({"step": 6.0, "gc": 0.5})
    assert ps.self_ms_per_step(spans[1:3]) == {}
    assert ps.launches_in([(5, 6, "cudaLaunchKernel")], []) == 0
    host = [(1_500_000, 1, "cudaLaunchKernel"), (2_500_000, 1, "cuLaunch"),
            (5_000_000, 1, "cudaMemsetAsync"), (3_000_000, 1, "cudaFree"),
            (21_500_000, 1, "cudaLaunchKernel")]
    main = threading.main_thread().ident
    here = [s[:4] + (main,) + s[5:] for s in spans]
    assert ps.launches_by_span(host, here) == {"an.L0": 1.0, "gc": 0.5,
                                               "step": 0.5}


@pytest.mark.parametrize("cell", ["single.resident", "dual.resident"])
def test_span_report_rehearsal(cell, recorder):
    res = ps.report(tiny_cell(cell), 2 ** 31 + 4099, 0.1, "cpu", steps=2,
                    rounds=2)
    assert res["step_spans"] == res["steps"] > 0
    assert res["step.host_ms"] > 0 and res["setup.plan_s"] >= 0
    known = {"step", "classify", "epilogue", "otsu.raw", "blend", "gc"} | {
        f"{phase}{lvl}" for phase in PHASES for lvl in range(3)}
    assert set(res["host_spans"]) <= known  # the top 15 names, and gc
    assert len(res["host_spans"]) >= 15
    costs = res["recorder_cost_host_ms_per_step"]
    assert costs["on"]["sync_each"] > 0 and costs["off"]["back_to_back"] > 0
    assert len(res["recorder_cost_rounds"]["off"]["sync_each"]) == 2
    assert res["idle"]["idle_s"] == pytest.approx(res["window_s"])
    assert not tracing._on
