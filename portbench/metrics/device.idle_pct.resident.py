"""device: the share of the traced window in which no kernel, copy or fill
ran on the card (the union of device activity), in the resident cells."""


def read(run):
    window = run.trace.window_s()
    if not window or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / window)
