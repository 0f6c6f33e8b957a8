"""
Run one cell of the port's benchmark once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last, ``check``
(each number compared with its limit); ``--trace 1`` adds ``breakdown``.
The numbers compared also end standard error. Without a CUDA device, or
with fewer cards than the cell asks for, it exits 2 and prints no result.
The port builds its kernels and codec once per checkout into
``build/torch_kernels/`` inside the checkout; a stream cell's store goes
under ``$TMPDIR`` (the checkout's ``build/`` without one).
"""

import os
import sys
import time

T_START = time.perf_counter()
# the checkout's root, not this folder, on the path: its module names
# would shadow the standard library's
sys.path[:1] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
