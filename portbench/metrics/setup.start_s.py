"""entry: process start. The seconds from the start of the benchmark's
process to the traffic's set-up: the interpreter, the imports of torch, the
port and the harness, and torch's CUDA initialisation (the harness's span
``setup.start``). Part of ``setup_s``, beside ``setup.plan_s``,
``setup.data_s`` and ``setup.warmup_s``."""


def read(run):
    return run.spans.seconds("setup.start")
