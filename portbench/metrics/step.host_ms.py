"""host: enqueue of one device step. The mean duration, in host ms, of the
program's ``step`` spans (``runtime.tracing``, around every route's step
callable) that began inside the traced window: the host's time to launch
one step. The profiler's launch callbacks inflate it (~1.4 ms a single
step, PERF.md); a CUDA graph or fused small operations would move it, and
``step.device_ms`` would not. None where the program records no spans."""

from portbench.program_spans import window_spans


def read(run):
    steps = window_spans(run, "step")
    if not steps:
        return None
    return sum(s[6] - s[5] for s in steps) / len(steps) / 1e6
