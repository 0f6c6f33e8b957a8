"""kernels: the step's least time on the card (``portbench.roofline``: the
compulsory bytes and least-work operations of every role, from the plan's
shapes) over the device time of the kernels per step in the trace."""


def read(run):
    steps = run.window.get("steps")
    kernel_s = run.trace.kind_s("kernel")
    if not steps or not kernel_s or not run.bound_s:
        return None
    return 100.0 * run.bound_s / (kernel_s / steps)
