"""
Device and host tracing.

Counterpart of ``aind_smartspim_destripe_tpu/runtime/tracing.py``:

- ``device_trace``: a context manager around ``torch.profiler`` that writes
  a Chrome trace (host and, where CUDA is present, device activity) into a
  directory;
- ``annotate``: a named region in that trace;
- ``span``: the program's span recorder. Spans sit at the layer boundaries
  of the device step (``step``; ``classify``, ``an.L<l>``, ``otsu.L<l>``,
  ``notch.L<l>``, ``syn.L<l>``, ``epilogue``; the dual step's
  ``otsu.raw`` and ``blend``) and of its set-up (``plan.build``,
  ``plan.constants``, ``plan.upload``, ``kernels.load``). They are kept in
  memory on the clock of ``torch.profiler``'s events (``time.time_ns``),
  so a span names the device's activity, and its gaps, at the same
  instant;
- ``counters``: process-lifetime counters, always on, each one dict update
  at set-up and nothing in the step: ``plan.build_s``,
  ``plan.constants_s`` and ``plan.upload_s`` (the seconds of the set-up
  spans of those names, through :func:`timed`) and ``plan.device_bytes``
  (the bytes of plan tensors put on a card).

The recorder records while it is enabled (:func:`enable`) or while a
``torch.profiler`` session is running, so any profile of the step carries
its phases without a call into this module; :func:`collect` returns what
it recorded. Off, a span costs a flag check and a profiler-state check and
returns one shared no-op context manager: it allocates nothing, formats no
string and enters no ``record_function`` (which costs ~13 us a call even
with no profiler writing).
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import os
import threading
import time
from typing import Optional

import torch

__all__ = ["device_trace", "annotate", "span", "timed", "enable",
           "disable", "collect", "add", "counters"]

_NOOP = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_on = False  # enable() / disable()
_annotate = False  # inside device_trace: spans also enter annotate()
_spans: list = []
_ids = itertools.count(1)
_local = threading.local()
_gc_start = None  # (start ns, parent, step) of the collection under way
_counters: dict = {}


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Profile the enclosed block with ``torch.profiler`` when ``logdir`` is
    set, writing ``trace.json`` there; no-op otherwise. Inside it every
    :func:`span` is also an :func:`annotate` region of the same name, so
    the trace shows the step's phases."""
    global _annotate
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        _annotate = True
        try:
            yield
        finally:
            _annotate = False
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region in the trace of :func:`device_trace`
    (``torch.profiler.record_function``); costs nothing outside one."""
    return torch.profiler.record_function(name)


def _stack() -> list:
    """Open spans of this thread, innermost last: (id, step id)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "meta", "frame", "parent", "t0", "region")

    def __init__(self, name, meta):
        self.name = name
        self.meta = meta

    def __enter__(self) -> dict:
        stack = _stack()
        sid = next(_ids)
        self.parent, step = stack[-1] if stack else (0, 0)
        if self.name == "step":
            step = sid
        self.frame = (sid, step)
        stack.append(self.frame)
        self.region = annotate(self.name) if _annotate else None
        self.t0 = time.time_ns()
        if self.region is not None:
            self.region.__enter__()
        return self.meta

    def __exit__(self, *exc):
        if self.region is not None:
            self.region.__exit__(*exc)
        t1 = time.time_ns()
        _stack().pop()  # with-blocks on one thread close innermost first
        sid, step = self.frame
        _spans.append((sid, self.parent, step, self.name,
                       threading.get_ident(), self.t0, t1, self.meta))
        return False


def span(name: str, **meta):
    """A span named ``name`` around the enclosed block, with ``meta`` kept
    beside it; entering it gives the meta dict, which the block may add to
    (None when the recorder is off). Give ``name`` as a constant or an
    entry of a precomputed tuple, never a formatted string: the name is
    evaluated whether or not the recorder is on."""
    if not (_on or _profiling()):
        return _NOOP
    return _Span(name, meta)


@contextlib.contextmanager
def timed(name: str):
    """:func:`span` ``name`` whose seconds are also added to the counter
    ``<name>_s``, recorder on or off: for set-up phases, never inside the
    step."""
    t0 = time.perf_counter()
    try:
        with span(name) as meta:
            yield meta
    finally:
        add(name + "_s", time.perf_counter() - t0)


def add(name: str, value: float) -> None:
    """Add ``value`` to the process-lifetime counter ``name``."""
    _counters[name] = _counters.get(name, 0) + value


def counters() -> dict:
    """The counters so far, {name: value}; a counter never added is
    absent."""
    return dict(_counters)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each collection becomes a span ``gc`` with its
    generation, inside the span open on the collecting thread (collections
    never overlap: the interpreter runs one at a time)."""
    global _gc_start
    if phase == "start":
        stack = _stack()
        _gc_start = (time.time_ns(),) + (stack[-1] if stack else (0, 0))
    elif _gc_start is not None:
        t0, parent, step = _gc_start
        _gc_start = None
        _spans.append((next(_ids), parent, step, "gc",
                       threading.get_ident(), t0, time.time_ns(),
                       {"generation": info["generation"]}))


def enable() -> None:
    """Start recording, with an empty list, garbage collections included."""
    global _on
    _spans.clear()
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    _on = True


def disable() -> None:
    """Stop recording (the recorded spans stay for :func:`collect`)."""
    global _on
    _on = False
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def collect() -> list:
    """The spans recorded so far, in the order they ended: tuples ``(id,
    parent, step, name, thread, start_ns, end_ns, meta)``. Ids are > 0 and
    unique in the process; ``parent`` is the innermost span open on the same
    thread when the span began and ``step`` the id of the enclosing ``step``
    span (0: none); times are ``time.time_ns`` nanoseconds."""
    return list(_spans)
