"""
The benchmark's own spans, and the device trace of a ``--trace 1`` window.

Spans are kept in memory: (name, thread id, start ns, end ns, meta) on the
wall clock ``time.time_ns``, which is the clock of ``torch.profiler``'s
events, so a device gap can be named by what the host was doing. The trace
is ``torch.profiler`` over the window with the CUDA activity alone (the
kernels, copies and fills, and the CUDA runtime calls that launched them):
recording every CPU operator as well cost the host ~6 ms a step and made
the resident step host-bound under the trace. It is reduced here from its
raw events to the device's busy time, the time by operation and the idle
gaps.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Spans", "DeviceTrace", "traced"]


class Spans:
    """Thread-safe list of the harness's spans around calls into the
    program."""

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns(), **meta)

    def add(self, name: str, t0: int, t1: int, **meta):
        """Record a span of this thread from ``t0`` to ``t1`` (ns)."""
        with self._lock:
            self.items.append((name, threading.get_ident(), t0, t1, meta))

    def named(self, name: str):
        return [s for s in self.items if s[0] == name]

    def seconds(self, name: str):
        """The seconds of every span named ``name``, or None without one."""
        spans = self.named(name)
        return sum(s[3] - s[2] for s in spans) / 1e9 if spans else None


@dataclass
class DeviceTrace:
    """A window's device activity: intervals (start ns, end ns, name, kind)
    with kind "kernel", "memcpy" or "memset", and the host's CUDA runtime
    calls (start ns, end ns, name)."""

    window_ns: tuple = (0, 0)
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    activities: dict = field(default_factory=dict)

    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kind_s(self, *kinds) -> float:
        return sum(e - s for s, e, _, k in self.device if k in kinds) / 1e9

    def busy_intervals(self):
        """Merged device activity, clipped to the window."""
        lo, hi = self.window_ns
        merged = []
        for s, e, _, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def by_name(self, top: int = 10):
        tot = defaultdict(int)
        for s, e, name, _ in self.device:
            tot[name[:160]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, spans=(), top: int = 10):
        """The longest gaps with no device activity inside the window, each
        named by the main thread's innermost harness span and outermost
        operation at the gap's middle, and the harness spans other threads
        were in."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[::2],
                                                         edges[1::2])]
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:top]
        starts = np.array([h[0] for h in self.host], np.int64)
        ends = np.array([h[1] for h in self.host], np.int64)
        return [[self._name_at((a + b) // 2, spans, starts, ends),
                 (b - a) / 1e9] for a, b in gaps]

    def _name_at(self, t, spans, starts, ends):
        """"<main thread's innermost span>:<runtime call or python>", with
        the spans other threads were in."""
        main = threading.main_thread().ident
        here = [s for s in spans if s[2] <= t < s[3]]
        mine = [s for s in here if s[1] == main]
        mark = max(mine, key=lambda s: s[2])[0] if mine else "host"
        calls = np.flatnonzero((starts <= t) & (t < ends))
        op = (self.host[min(calls, key=lambda i: starts[i])][2]
              if calls.size else "python")
        others = sorted({s[0] for s in here if s[1] != main})
        name = f"{mark}:{op}"
        return name + (" [" + ",".join(others) + "]" if others else "")


@contextlib.contextmanager
def traced(enabled: bool, spans: Spans):
    """Profile the block when ``enabled``; yields a :class:`DeviceTrace`
    that is filled when the block ends (empty when disabled). Without CUDA
    (the CPU tests) the CPU activity stands in, so the path still runs."""
    out = DeviceTrace()
    if not enabled:
        yield out
        return
    act = (torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
           else torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=[act])
    prof.start()
    t0 = time.time_ns()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.stop()
        out.window_ns = (t0, t1)
        _reduce(prof, out)


_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                 "gpu_memset": "memset"}


def _activity(ev) -> str:
    """The event's kineto activity type; older profilers have no
    ``activity_type``, so it is told from the device and the name there."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    name = ev.name()
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return "cuda_runtime" if name.startswith("cuda") else "cpu_op"
    if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
        return "gpu_user_annotation"
    low = name.lower()
    return ("gpu_memcpy" if low.startswith("memcpy")
            else "gpu_memset" if low.startswith("memset") else "kernel")


def _reduce(prof, out: DeviceTrace):
    for ev in prof.profiler.kineto_results.events():
        act = _activity(ev)
        out.activities[act] = out.activities.get(act, 0) + 1
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if act in _DEVICE_KINDS:
            out.device.append((s, e, ev.name(), _DEVICE_KINDS[act]))
        elif act in ("cuda_runtime", "cuda_driver"):
            out.host.append((s, e, ev.name()))
