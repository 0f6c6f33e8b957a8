"""
Logging, resource profiling, environment limits and filesystem helpers.

The JAX-free helpers of ``aind_smartspim_destripe_tpu/utils/utils.py`` are
re-exported as they are; :func:`print_system_information` is this package's
own, logging the CUDA devices torch sees.
"""

from __future__ import annotations

import logging
import os
import platform

import torch

from aind_smartspim_destripe_tpu.utils.utils import (  # noqa: F401
    ResourceProfiler,
    create_folder,
    create_logger,
    get_code_ocean_cpu_limit,
    get_size,
    read_json_as_dict,
)

try:
    import psutil
except ImportError:  # pragma: no cover
    psutil = None

__all__ = [
    "ResourceProfiler",
    "create_folder",
    "create_logger",
    "get_code_ocean_cpu_limit",
    "read_json_as_dict",
    "print_system_information",
]


def print_system_information(logger: logging.Logger):
    """Log environment, CPU, memory and CUDA device details."""
    sep = "=" * 40
    logger.info(f"{sep} Environment {sep}")
    logger.info(f"Assigned cores: {get_code_ocean_cpu_limit()}")
    co_memory = os.environ.get("CO_MEMORY")
    if co_memory:
        logger.info(f"Assigned memory: {get_size(int(co_memory))}")
    logger.info(f"Computation ID: {os.environ.get('CO_COMPUTATION_ID')}")
    logger.info(f"Capsule ID: {os.environ.get('CO_CAPSULE_ID')}")
    logger.info(
        f"Is pipeline execution?: {bool(os.environ.get('AWS_BATCH_JOB_ID'))}"
    )
    uname = platform.uname()
    logger.info(f"{sep} System {sep}")
    for name in ("system", "node", "release", "version", "machine", "processor"):
        logger.info(f"{name.capitalize()}: {getattr(uname, name)}")
    if psutil is not None:
        logger.info(f"{sep} CPU / Memory {sep}")
        logger.info(f"Physical cores: {psutil.cpu_count(logical=False)}")
        logger.info(f"Total cores: {psutil.cpu_count(logical=True)}")
        svmem = psutil.virtual_memory()
        logger.info(f"Memory total: {get_size(svmem.total)}")
        logger.info(f"Memory available: {get_size(svmem.available)}")
        logger.info(f"Memory used: {get_size(svmem.used)} ({svmem.percent}%)")
    logger.info(f"{sep} Accelerators {sep}")
    logger.info(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    logger.info(f"CUDA devices: {n}")
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        logger.info(f"  cuda:{i} {p.name}, {p.total_memory / 2**30:.1f} GiB")
