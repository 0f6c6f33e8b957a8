"""
CLI entry points.

``python -m aind_smartspim_destripe_torch capsule [--data ... --results
... --scratch ...]`` runs the production capsule flow
(:func:`.run_capsule.run`); ``python -m aind_smartspim_destripe_torch
batch --input_path ... --output_path ...`` runs the file-batch path with
the ``destriper_params`` surface and the production filter configurations
(:func:`.destriper.batch_filter`). Both take ``--device``: by default the
current CUDA device (every visible card for ``capsule``); ``--device cpu``
runs the plain PyTorch path on the CPU. A multi-host capsule run needs
only the ``DESTRIPE_COORDINATOR_ADDRESS`` / ``DESTRIPE_NUM_PROCESSES`` /
``DESTRIPE_PROCESS_ID`` variables on each process.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv.pop(0) if argv and not argv[0].startswith("-") else "capsule"
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="torch device to run on (default: CUDA)")
    dev_ns, argv = pre.parse_known_args(argv)
    device = dev_ns.device

    if mode == "capsule":
        import torch

        p = argparse.ArgumentParser(prog="smartspim-destripe capsule",
                                    parents=[pre])
        p.add_argument("--data", default="../data")
        p.add_argument("--results", default="../results")
        p.add_argument("--scratch", default="../scratch")
        ns = p.parse_args(argv)
        from .run_capsule import run

        run(data_folder=ns.data, results_folder=ns.results,
            scratch_folder=ns.scratch,
            devices=None if device is None else [torch.device(device)])
    elif mode == "batch":
        from .destriper import batch_filter
        from .destriper_params import DestripingParams
        from .run_capsule import PRODUCTION_PARAMETERS

        logging.basicConfig(format="%(asctime)s %(message)s",
                            datefmt="%Y-%m-%d %H:%M")
        params = DestripingParams.from_args(argv)
        batch_filter(
            input_path=params.input_path,
            output_path=params.output_path,
            workers=params.workers,
            chunks=params.chunks,
            high_int_filt_params=PRODUCTION_PARAMETERS["cells_config"],
            low_int_filt_params=PRODUCTION_PARAMETERS["no_cells_config"],
            shadow_correction=None,
            output_format=params.output_format,
            dual_band=(
                {"crossover": params.crossover,
                 "threshold": params.dual_threshold}
                if params.dual_band else None
            ),
            device=device,
        )
    else:
        print(f"unknown mode {mode!r}; use 'capsule' or 'batch'", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
