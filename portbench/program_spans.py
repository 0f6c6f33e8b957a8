"""
The program's own spans (``aind_smartspim_destripe_torch.runtime.tracing``)
as the benchmark reads them, and a report of a cell's step by phase.

The recorder records while a ``torch.profiler`` session runs, so a
``--trace 1`` window holds the program's ``step`` spans and their phases
(``an.L<l>``, ``otsu.L<l>``, ``notch.L<l>``, ``syn.L<l>``, ``classify``,
``epilogue``, ``otsu.raw``, ``blend``) beside the device trace, on its
clock. A commit whose program has no recorder yields no spans here, and the
readers built on them return None.

    python3 -m portbench.program_spans --workload <cell> --seed <n> \\
        --seconds <s> [--out <file>]

runs one cell on the card with the recorder enabled from before set-up and
prints one JSON object: the set-up spans (``setup.plan_s``: ``plan.build``
+ ``plan.constants`` + ``plan.upload``; ``kernels.load``); the recorder's
cost with no profiler (host milliseconds a step with the recorder off and
on) and each span name's self time per step there (``host_spans_untraced``,
host ms, each step synchronised: the host's enqueue alone); and a traced
window's ``step.host_ms``, ``step.launches``, device operations per step,
``host_spans`` (each span name's self time per step, host ms), the
launches per step under each span and idle gaps named by the innermost
program span. It drives the ``resident``
traffic's state (its ring, flat and dark fields).
"""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np

__all__ = ["LAUNCH_PREFIXES", "program_spans", "window_spans",
           "launches_in", "self_ms_per_step", "launches_by_span",
           "as_harness_spans",
           "innermost", "idle_by_phase", "report", "main"]

# CUDA runtime and driver calls that put work on the device's queue
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                   "cuGraphLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
                   "cuMemset")
PLAN_SPANS = ("plan.build", "plan.constants", "plan.upload")


def program_spans() -> list:
    """Every span the program's recorder holds, or [] where the program has
    none (a commit before ``runtime.tracing.collect``)."""
    try:
        from aind_smartspim_destripe_torch.runtime.tracing import collect
    except ImportError:
        return []
    return collect()


def window_spans(run, name=None) -> list:
    """The program's spans (named ``name``, or all) that began inside the
    traced window of ``run``."""
    lo, hi = run.trace.window_ns
    return [s for s in program_spans()
            if lo <= s[5] < hi and (name is None or s[3] == name)]


def launches_in(host, steps) -> int:
    """How many of the runtime calls ``host`` ((start ns, end ns, name))
    that enqueue device work began inside one of the ``steps`` spans (one
    thread's, so they do not overlap)."""
    if not steps:
        return 0
    starts = np.array(sorted(s[5] for s in steps), np.int64)
    ends = np.array(sorted(s[6] for s in steps), np.int64)
    t = np.array([h[0] for h in host if h[2].startswith(LAUNCH_PREFIXES)],
                 np.int64)
    i = np.searchsorted(starts, t, side="right") - 1
    return int(np.count_nonzero((i >= 0) & (t < ends[np.maximum(i, 0)])))


def self_ms_per_step(spans, top: int = 15) -> dict:
    """{span name: self time per step, host ms}: each span's duration less
    its children's, summed by name over ``spans`` and divided by their
    ``step`` spans; the ``top`` largest, and ``gc`` always."""
    n = sum(1 for s in spans if s[3] == "step")
    if not n:
        return {}
    child = {}
    for s in spans:
        child[s[1]] = child.get(s[1], 0) + s[6] - s[5]
    own = {}
    for s in spans:
        own[s[3]] = own.get(s[3], 0) + s[6] - s[5] - child.get(s[0], 0)
    ranked = sorted(own.items(), key=lambda kv: -kv[1])
    keep = dict(ranked[:top])
    if "gc" in own:
        keep["gc"] = own["gc"]
    return {k: v / 1e6 / n for k, v in keep.items()}


def launches_by_span(host, spans) -> dict:
    """{span name: launching calls per step}: each call of ``host`` that
    enqueues device work, counted under the innermost of ``spans`` open on
    the main thread when it began (``-``: none), over the ``step`` spans."""
    n = sum(1 for s in spans if s[3] == "step")
    if not n:
        return {}
    starts, names = innermost(spans, threading.main_thread().ident)
    t = np.array([h[0] for h in host if h[2].startswith(LAUNCH_PREFIXES)],
                 np.int64)
    by = {}
    for k in np.searchsorted(starts, t, side="right") - 1:
        name = names[k] if k >= 0 and names[k] is not None else "-"
        by[name] = by.get(name, 0) + 1
    return {k: v / n for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def as_harness_spans(spans) -> list:
    """The program's spans in the harness's form (name, thread id, start
    ns, end ns, meta), which ``DeviceTrace.idle_gaps`` names gaps by."""
    return [(s[3], s[4], s[5], s[6], s[7]) for s in spans]


def innermost(spans, thread):
    """(starts, names): from ``starts[i]`` until the next start, the
    innermost of ``spans`` open on ``thread`` is ``names[i]`` (None: no
    span). Spans of one thread nest, so one sweep sorts them out."""
    seg_t, seg_name, stack = [], [], []

    def close(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            seg_t.append(end)
            seg_name.append(stack[-1][1] if stack else None)

    mine = sorted(((s[5], s[6], s[3]) for s in spans if s[4] == thread),
                  key=lambda s: (s[0], -s[1]))
    for t0, t1, name in mine:
        close(t0)
        seg_t.append(t0)
        seg_name.append(name)
        stack.append((t1, name))
    close(float("inf"))
    return np.array(seg_t, np.int64), seg_name


def idle_by_phase(dt, spans, min_ms: float = 1.0) -> dict:
    """Every idle gap of the traced window ``dt`` named by the innermost
    program span of the main thread at its middle: idle seconds by name
    (``-`` outside every program span), and how many gaps longer than
    ``min_ms`` fell inside a ``step`` span but outside its phases."""
    lo, hi = dt.window_ns
    edges = [lo] + [x for iv in dt.busy_intervals() for x in iv] + [hi]
    gaps = np.array([(a, b) for a, b in zip(edges[::2], edges[1::2])
                     if b > a], np.int64).reshape(-1, 2)
    starts, names = innermost(spans, threading.main_thread().ident)
    mid = (gaps[:, 0] + gaps[:, 1]) // 2
    i = np.searchsorted(starts, mid, side="right") - 1
    by = {}
    bare_long = 0
    for (a, b), k in zip(gaps, i):
        name = names[k] if k >= 0 and names[k] is not None else "-"
        by[name] = by.get(name, 0.0) + (b - a) / 1e9
        bare_long += name == "step" and b - a > min_ms * 1e6
    idle = sum(by.values())
    below = sum(v for k, v in by.items() if k not in ("-", "step"))
    return {"idle_s": idle, "idle_s_by_span": dict(
        sorted(by.items(), key=lambda kv: -kv[1])),
            "below_step_share": below / idle if idle else None,
            "gaps_over_1ms_bare_step": int(bare_long)}


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_ms(st, n: int, sync_each: bool) -> float:
    """Mean host milliseconds of ``n`` calls into the step, back to back or
    each followed by a synchronize (the host's enqueue alone)."""
    dt = 0
    for k in range(n):
        t0 = time.perf_counter_ns()
        st.outs[k % st.R] = st.step(st.ring[k % st.R], st.flat_d, st.dark_d)
        dt += time.perf_counter_ns() - t0
        if sync_each:
            _sync(st.dev)
    _sync(st.dev)
    return dt / n / 1e6


def report(cell, seed: int, seconds: float, device, steps: int = 20,
           rounds: int = 6) -> dict:
    """Run ``cell`` once with the program's recorder on from before set-up;
    see the module's docstring for what is returned."""
    import torch

    from aind_smartspim_destripe_torch.runtime import tracing
    from portbench import harness
    from portbench.devtrace import Spans, traced

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tracing.enable()
    spans = Spans()
    driver = harness.load_driver(cell.traffic)
    st = driver.setup(harness.Ctx(config=cell.config, traffic=cell.traffic,
                                  seed=seed, device=device, spans=spans))
    _sync(device)
    setup = tracing.collect()
    out = {"cell": cell.name, "seed": seed,
           "setup.plan_s": sum(s[6] - s[5] for s in setup
                               if s[3] in PLAN_SPANS) / 1e9,
           "setup_spans": [[s[3], (s[6] - s[5]) / 1e9, s[7]] for s in setup
                           if s[3] in PLAN_SPANS + ("kernels.load",)]}

    # the recorder's cost with no profiler: off and on in turns, the median
    # of the rounds (the host's speed drifts by more than the cost)
    cost = {k: {"back_to_back": [], "sync_each": []} for k in ("off", "on")}
    on = []
    for _ in range(rounds):
        for mode, sync_each in (("back_to_back", False), ("sync_each", True)):
            tracing.disable()
            cost["off"][mode].append(_host_ms(st, steps, sync_each))
            tracing.enable()
            cost["on"][mode].append(_host_ms(st, steps, sync_each))
            if sync_each:  # the host's enqueue alone, by phase
                on += tracing.collect()
    out["recorder_cost_host_ms_per_step"] = {
        k: {m: float(np.median(v)) for m, v in c.items()}
        for k, c in cost.items()}
    out["recorder_cost_rounds"] = cost
    out["host_spans_untraced"] = self_ms_per_step(on)

    tracing.enable()
    with traced(True, spans) as dt:
        with spans.span("window"):
            win = driver.window(st, seconds, spans)
    prog = [s for s in tracing.collect()
            if dt.window_ns[0] <= s[5] < dt.window_ns[1]]
    tracing.disable()
    driver.close(st)
    steps_ = [s for s in prog if s[3] == "step"]
    lo, hi = dt.window_ns
    dev_ops = [d for d in dt.device if lo <= d[0] < hi]
    calls = {}
    for h in dt.host:
        if h[2].startswith(LAUNCH_PREFIXES):
            calls[h[2]] = calls.get(h[2], 0) + 1
    n = len(steps_)
    out.update({
        "steps": win["steps"], "step_spans": n,
        "step.host_ms": (sum(s[6] - s[5] for s in steps_) / n / 1e6
                         if n else None),
        "step.launches": launches_in(dt.host, steps_) / n if n else None,
        "device_ops_per_step": len(dev_ops) / n if n else None,
        "launch_calls_by_name": calls,
        "host_spans": self_ms_per_step(prog),
        "launches_by_span": launches_by_span(dt.host, prog),
        "idle_gaps": dt.idle_gaps(spans.items + as_harness_spans(prog)),
        "idle": idle_by_phase(dt, prog),
        "busy_s": dt.busy_s(), "window_s": dt.window_s(),
    })
    return out


def main(argv) -> int:
    import argparse

    import torch

    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the report runs on the card only",
              file=sys.stderr)
        return 2
    res = report(harness.load_cell(args.workload), args.seed, args.seconds,
                 torch.device("cuda", 0))
    res["card"] = torch.cuda.get_device_name(0)
    res["power_limit"] = harness._power_limit()
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
