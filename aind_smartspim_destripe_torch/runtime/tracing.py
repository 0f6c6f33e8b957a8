"""
Device and host tracing.

Counterpart of ``aind_smartspim_destripe_tpu/runtime/tracing.py``:

- ``device_trace``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (host and, where CUDA is present, device activity) into a
  directory;
- ``annotate``: a named region in that trace;
- ``StageTimer``: per-stage wall-clock seconds and pixel counts.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

__all__ = ["device_trace", "annotate", "StageTimer"]


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Profile the enclosed block with ``torch.profiler`` when ``logdir`` is
    set, writing ``trace.json`` there; no-op otherwise."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region in the trace of :func:`device_trace`
    (``torch.profiler.record_function``); costs nothing outside one."""
    return torch.profiler.record_function(name)


@dataclass
class StageTimer:
    """Accumulate per-stage seconds and pixel counts."""

    seconds: Dict[str, float] = field(default_factory=dict)
    pixels: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.pixels[name] = self.pixels.get(name, 0) + pixels

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, sec in self.seconds.items():
            px = self.pixels.get(name, 0)
            out[name] = {
                "seconds": round(sec, 3),
                "mpix_per_s": round(px / sec / 1e6, 1) if sec and px else None,
            }
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
