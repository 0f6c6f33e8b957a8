"""entry: warm-up. The seconds of the resident traffic's two warm-up steps
and the synchronize after them (the span ``setup.warmup``): the kernel
library's load (its build in a checkout's first run), each kernel's first
launch and the allocator's first blocks. Part of ``setup_s``."""


def read(run):
    return run.spans.seconds("setup.warmup")
