"""
The benchmark of ``aind_smartspim_destripe_torch``, driven by data.

``BENCHMARK.json`` names each cell's configuration and traffic mix; this
module finds everything else by those names, inside this folder:

- ``configs/<config>.json``: the deployment (plane size, batch, filter
  parameters, single or dual band), as the configuration's ``file`` says;
- ``traffic/<traffic>.json``: the mix's parameters, whose ``driver`` names
  the module of ``drivers/`` that runs it;
- ``metrics/<name>.py``: one reader per per-layer metric, ``read(run)``
  returning a number or None;
- ``limits/<cell>.json``: the limit of every number the check compares.

One call runs one cell once: set-up (timed as ``setup_s`` from the start of
the process; its parts are the spans ``setup.start``, ``setup.data`` and
``setup.warmup`` beside the program's plan counters), the window, the check
against the plain reference, then one JSON line on standard output.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import check, program_spans, roofline
from .generator import sample_planes
from .devtrace import Spans, traced

__all__ = ["ROOT", "Cell", "load_cell", "run_cell", "forbidden_modules",
           "main"]

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aind_smartspim_destripe_tpu")
# the program's plan counters a traced line carries beside its launches
PLAN_COUNTERS = ("plan.device_bytes", "plan.notch_lowrank_levels",
                 "plan.notch_fft_levels")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files loaded."""
    bench_file = ROOT.parent / "BENCHMARK.json"
    spec = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((bench_file.parent / cfg["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_driver(traffic: dict):
    return importlib.import_module(f"portbench.drivers.{traffic['driver']}")


def load_reader(metric: str):
    """The module of ``metrics/<metric>.py`` (its name holds dots, so it is
    loaded from its path)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"),
        ROOT / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Ctx:
    """What a driver's set-up is given."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    spans: Spans
    root: Path = ROOT


@dataclass
class Run:
    """What a per-layer metric's reader is given."""

    cell: Cell
    window: dict
    trace: object
    spans: Spans
    bound_s: float = 0.0


def _launches() -> dict:
    """{kernel wrapper: launches so far} of the port's kernel counters."""
    from aind_smartspim_destripe_torch.ops import kernels

    return {k.__name__: k.launches for k in kernels()}


def _tracing():
    """The program's ``runtime.tracing``, or None where it has none."""
    try:
        from aind_smartspim_destripe_torch.runtime import tracing
    except ImportError:
        return None
    return tracing


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, root: Path = ROOT) -> dict:
    """Run ``cell`` once on ``device``; returns the result's fields.
    Metrics and device readings are produced on a CUDA device only."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
    spans = Spans()
    driver = load_driver(cell.traffic)
    ctx = Ctx(config=cell.config, traffic=cell.traffic,
              seed=seed, device=device, spans=spans, root=root)
    tracing = _tracing()
    counters0 = tracing.counters() if tracing else {}
    t_setup, ns_setup = time.perf_counter(), time.time_ns()
    st = driver.setup(ctx)
    # process start to the traffic's set-up: the interpreter, the imports
    # and torch's CUDA initialisation (recorded after the set-up, which may
    # clear the spans it was handed)
    spans.add("setup.start", ns_setup - round((t_setup - t_start) * 1e9),
              ns_setup)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    launches0 = _launches()
    if trace and tracing:  # garbage collections become spans too
        tracing.enable()
    with traced(trace, spans) as dt:
        with spans.span("window"):
            win = driver.window(st, seconds, spans)
    if trace and tracing:
        tracing.disable()
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()
                if v != launches0.get(k, 0)}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    grp, must = driver.groups(st)
    ids = sample_planes(seed, grp, int(cell.traffic["check_planes"]),
                        cell.traffic["data"], must)
    items = driver.outputs(st, ids)
    driver.close(st)  # the program's state is freed before the reference
    limits = check.load_limits(root, cell.name)
    t_check = time.perf_counter()
    worst, per_plane = check.compare(cell.config, items, st.flat, st.dark,
                                     device=device)
    check_s = time.perf_counter() - t_check
    failed = sum(1 for _, v in per_plane
                 if any(v[k] > limits[k] for k in check.NUMBERS))
    correct = failed == 0 and bool(per_plane)

    out = {"correct": correct, "attempted": int(win["planes"]),
           "failed": int(failed), "metrics": {},
           "device": {"platform": "gpu" if on_card else device.type,
                      "kind": (torch.cuda.get_device_name(device)
                               if on_card else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if on_card and not trace:
        vals = dict(win["e2e"], setup_s=setup_s)
        for m in cell.end_to_end:
            if m["name"] not in vals:
                raise KeyError(f"cell {cell.name} does not report "
                               f"{m['name']}")
            out["metrics"][m["name"]] = {"value": float(vals[m["name"]]),
                                         "unit": m["unit"]}
    if on_card and trace:
        cfg = cell.config
        bound_s, bound_by = roofline.step_bound_s(
            cfg["device_batch"], cfg["height"], cfg["width"],
            bool(cfg["dual_band"]))
        run = Run(cell=cell, window=win, trace=dt, spans=spans,
                  bound_s=bound_s)
        for m in cell.per_layer:
            v = load_reader(m["name"]).read(run)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        out["device"]["busy_s"] = dt.busy_s()
        out["device"]["window_s"] = dt.window_s()
        prog = program_spans.as_harness_spans(program_spans.window_spans(run))
        out["breakdown"] = {"device_ops": dt.by_name(),
                            "idle_gaps": dt.idle_gaps(spans.items + prog)}
        out["step_bound"] = {"ms": bound_s * 1e3, "by": bound_by}
        out["setup_s"] = setup_s  # beside its parts, the setup.* metrics
        out["launches"] = launches  # the kernels' own launch counters
        out["trace_events"] = dt.activities
    if trace and tracing:  # this run's plan counters, as information
        counters = tracing.counters()
        if any(k in counters for k in PLAN_COUNTERS):
            out["plan"] = {k: counters.get(k, 0) - counters0.get(k, 0)
                           for k in PLAN_COUNTERS}
    out["planes_checked"] = [pid for pid, _ in per_plane]
    out["per_plane"] = per_plane
    out["check_s"] = check_s
    # the numbers compared, each beside its limit, come last
    out["check"] = {k: {"value": worst[k], "limit": limits[k]}
                    for k in check.NUMBERS}
    return out


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _power_limit():
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
            else "unknown"
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import aind_smartspim_destripe_torch  # noqa: F401  (absent: exit 1)

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    res["device"]["power_limit"] = _power_limit()
    print(f"{cell.name} seed {args.seed}: card {res['device']['kind']}, "
          f"power limit {res['device']['power_limit']}, planes checked "
          f"{res['planes_checked']}", file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(res), flush=True)
    return 0
