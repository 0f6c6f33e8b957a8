"""device step: device milliseconds of all kernels, copies and fills per
step in the window, from the device trace."""


def read(run):
    steps = run.window.get("steps")
    busy = run.trace.kind_s("kernel", "memcpy", "memset")
    if not steps or not busy:
        return None
    return 1e3 * busy / steps
