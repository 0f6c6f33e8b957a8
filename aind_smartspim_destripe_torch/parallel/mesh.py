"""
The device mesh of the multi-device routes.

Counterpart of ``make_mesh`` in ``aind_smartspim_destripe_tpu/parallel/
mesh.py``. The JAX package builds a 1-D ``jax.sharding.Mesh`` and runs
``shard_map`` over it from one process; this package drives the same
routes from one controller over a mesh that is a plain list of
``torch.device`` entries, one shard per entry. An entry may name a device
more than once: ``[cpu] * 8`` is the counterpart of the 8 virtual CPU
devices of the JAX tests, and ``[cuda:0, cuda:0]`` runs a two-shard route
on a one-card host.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["make_mesh", "one_device"]


def make_mesh(devices=None, n_devices: Optional[int] = None
              ) -> List[torch.device]:
    """The mesh: ``devices`` as a list of ``torch.device`` (None: every
    visible CUDA device; raises when CUDA is absent, there is no CPU
    fallback), cut to its first ``n_devices`` entries when given."""
    if devices is None:
        _require_cuda()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [_indexed(torch.device(d)) for d in devices]
    if n_devices is not None:
        mesh = mesh[:n_devices]
    if not mesh:
        raise ValueError("the mesh holds no device")
    return mesh


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device; pass devices=[torch.device('cpu')] to run on "
            "the CPU"
        )


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` names the current CUDA device: give it its index, so that
    an entry compares equal to the device of the tensors made on it."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def one_device(device=None) -> torch.device:
    """The device a single-device entry point runs on: ``device`` (a
    ``torch.device`` or its name), or None for the current CUDA device;
    raises when CUDA is absent, there is no CPU fallback."""
    if device is None:
        _require_cuda()
        device = "cuda"
    return make_mesh([device])[0]
