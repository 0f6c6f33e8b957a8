"""entry: plan set-up. The seconds the program spent building its plan and
its constants and putting them on the card, from the program's
process-lifetime counters (``runtime.tracing.counters``: ``plan.build_s``
+ ``plan.constants_s`` + ``plan.upload_s``), all of them before the
window. None where the program keeps no such counters."""


def read(run):
    try:
        from aind_smartspim_destripe_torch.runtime.tracing import counters
    except ImportError:
        return None
    c = counters()
    keys = ("plan.build_s", "plan.constants_s", "plan.upload_s")
    if not any(k in c for k in keys):
        return None
    return sum(c.get(k, 0.0) for k in keys)
