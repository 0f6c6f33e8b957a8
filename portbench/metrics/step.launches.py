"""host: enqueue of one device step. Launches per step: the CUDA runtime
and driver calls that put work on the device (kernel and graph launches,
copies, fills) in the device trace, counted where they began inside one of
the program's ``step`` spans (``runtime.tracing``), over the number of
those spans in the window. None where the program records no spans."""

from portbench.program_spans import launches_in, window_spans


def read(run):
    steps = window_spans(run, "step")
    if not steps:
        return None
    return launches_in(run.trace.host, steps) / len(steps)
