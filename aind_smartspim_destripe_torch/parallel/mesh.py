"""
The device mesh of the multi-device routes, and the plane-sharded helpers.

Counterpart of ``aind_smartspim_destripe_tpu/parallel/mesh.py``. The JAX
package builds a ``jax.sharding.Mesh`` and runs jitted steps over it from
one process; this package drives the same routes from one controller over
a mesh that is a plain list of ``torch.device`` entries, one shard per
entry (a 2-D mesh, tiles by planes, is a list of such lists). An entry may
name a device more than once: ``[cpu] * 8`` is the counterpart of the 8
virtual CPU devices of the JAX tests, and ``[cuda:0, cuda:0]`` runs a
two-shard route on a one-card host.

A plane-sharded batch is a list of tensors, entry d's on its device
holding planes ``[d b, (d + 1) b)`` (:func:`shard_planes`); the steps
launch every entry's share from the calling thread with no host wait, and
the cross-entry reductions (min/max) gather per-entry partials on the
first entry, with no collective library.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import torch

from ..ops.filter import (
    DestripePlan,
    destripe_batch,
    device_constants,
    f32_matmul,
    normalize_flat_dark,
)
from ..ops.flatfield import flatfield_correction, wrap_cast
from ..ops.otsu import _u16_range

__all__ = [
    "make_mesh",
    "make_mesh_2d",
    "one_device",
    "shard_planes",
    "sharded_destripe_step",
    "sharded_destripe_step_2d",
    "global_minmax",
    "sharded_normalize_image",
]


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


def make_mesh_2d(devices=None, n_devices: Optional[int] = None,
                 tile_parallel: int = 2) -> List[List[torch.device]]:
    """The (tile, plane) mesh: :func:`make_mesh` of ``devices`` as
    ``tile_parallel`` rows of ``n / tile_parallel`` entries; the outer axis
    takes independent tiles, the inner one the planes of a tile. Raises
    ``ValueError`` when the entries do not divide."""
    mesh = make_mesh(devices, n_devices)
    n = len(mesh)
    if tile_parallel < 1 or n % tile_parallel:
        raise ValueError(
            f"{n} devices not divisible by tile_parallel={tile_parallel}")
    q = n // tile_parallel
    return [mesh[r * q:(r + 1) * q] for r in range(tile_parallel)]


def _host_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array as a CPU tensor sharing its memory."""
    if isinstance(x, torch.Tensor):
        return x
    with warnings.catch_warnings():
        # arrays decoded from a store can be read-only; the steps only read
        # their input, so no copy is needed on the host
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(x))


def _share(n: int, entries: int) -> int:
    """Planes per entry of an n-plane batch; raises ``ValueError`` unless
    the entries divide it."""
    if n % entries:
        raise ValueError(f"batch {n} is not a multiple of the mesh's "
                         f"{entries} entries")
    return n // entries


def shard_planes(mesh, batch) -> List[torch.Tensor]:
    """Entry d's share of a (B, ...) batch (tensor or array): planes
    ``[d b, (d + 1) b)``, b = B / D, on entry d's device (a view where the
    batch is there already). Raises ``ValueError`` unless D divides B."""
    mesh = make_mesh(mesh)
    x = _host_tensor(batch)
    b = _share(x.shape[0], len(mesh))
    return [x[d * b:(d + 1) * b].to(dev) for d, dev in enumerate(mesh)]


def _minmax(parts) -> list:
    """Each part's (min, max) as a (2,) tensor on its device; a uint16
    part's as float32 (exact), reduced on its int16 keys (torch reduces no
    uint16)."""
    out = []
    for p in parts:
        if p.dtype == torch.uint16:
            out.append(torch.stack(_u16_range(p, tuple(range(p.ndim)))))
        else:
            out.append(torch.stack([p.amin(), p.amax()]))
    return out


def _reduce(stats: list, dev: torch.device) -> torch.Tensor:
    """The (2,) [min, max] over per-entry (2,) partials, on ``dev``."""
    s = torch.stack([st.to(dev) for st in stats])
    return torch.stack([s[:, 0].amin(), s[:, 1].amax()])


def global_minmax(mesh, shards):
    """The global (min, max) of a plane-sharded array (a list of per-entry
    tensors, or one tensor, split by :func:`shard_planes`): each entry's
    partials, reduced on the first entry. Returns two 0-dim tensors there;
    nothing is read back to the host. Both have the array's dtype."""
    mesh = make_mesh(mesh)
    parts = (list(shards) if isinstance(shards, (list, tuple))
             else shard_planes(mesh, shards))
    lo, hi = _reduce(_minmax(parts), mesh[0]).to(parts[0].dtype).unbind()
    return lo, hi


def sharded_normalize_image(mesh, images) -> List[torch.Tensor]:
    """:func:`..ops.flatfield.normalize_image` over a plane-sharded stack:
    the global min/max (:func:`global_minmax`), then each entry's planes
    mapped to [1, 2] through float16, ``1 + ((x - lo) / (hi - lo))`` cast
    to float16 after the float32 division. Returns one float16 tensor per
    entry."""
    mesh = make_mesh(mesh)
    parts = [p.to(torch.float32) for p in shard_planes(mesh, images)]
    lo, hi = global_minmax(mesh, parts)
    span = hi - lo
    return [1 + ((p - lo.to(p.device)) / span.to(p.device)).to(torch.float16)
            for p in parts]


def _consts_on(plan: DestripePlan, mesh) -> dict:
    """The plan's constants once per distinct device of the mesh."""
    return {dev: device_constants(plan, dev) for dev in dict.fromkeys(mesh)}


def _destripe_parts(plan, consts, microscope_high_int, parts, flat, dark,
                    with_flatfield):
    """Every part through the float32 destripe step and then the
    flat-field correction (or the zarr-store wrap cast), launched from
    this thread without a host wait. Returns the uint16 parts and each
    part's (min, max) of the float32 filtered planes."""
    fields = {}
    if with_flatfield:
        for dev in dict.fromkeys(p.device for p in parts):
            fields[dev] = normalize_flat_dark(plan.height, plan.width, flat,
                                              dark, dev)
    outs, stats = [], []
    for p in parts:
        filtered = destripe_batch(plan, p, microscope_high_int,
                                  consts[p.device])
        stats += _minmax([filtered])
        outs.append(flatfield_correction(filtered, *fields[p.device])
                    if with_flatfield else wrap_cast(filtered))
        del filtered
    return outs, stats


def sharded_destripe_step(mesh, plan: DestripePlan,
                          microscope_high_int: float = 2500.0,
                          with_flatfield: bool = True):
    """The plane-sharded step with statistics: ``run(images, flat, dark)``
    takes (B, H, W) uint16 (or float32) planes, splits them over the mesh
    (:func:`shard_planes`), destripes each share to float32, then applies
    the flat-field correction (``with_flatfield``; ``flat``/``dark`` as
    :func:`..ops.filter.normalize_flat_dark` takes them) or the zarr-store
    wrap cast (which ignores them), and returns ``(out, stats)``: ``out`` one uint16 tensor per
    entry, ``stats`` the (2,) float32 [min, max] of the float32 filtered
    batch on the first entry. The operators go to each device once; every
    share is launched without a host wait.

    Unlike :func:`..runtime.pipeline.make_device_step`, whose epilogue is
    fused into the last synthesis kernel, this step keeps the float32
    batch (for the statistics) and applies the epilogue after it."""
    mesh = make_mesh(mesh)
    f32_matmul()
    consts = _consts_on(plan, mesh)

    def run(images, flat, dark):
        with torch.inference_mode():
            outs, stats = _destripe_parts(
                plan, consts, microscope_high_int,
                shard_planes(mesh, images), flat, dark, with_flatfield)
            return outs, _reduce(stats, mesh[0])

    return run


def sharded_destripe_step_2d(mesh2, plan: DestripePlan,
                             microscope_high_int: float = 2500.0):
    """The tiles-by-planes step on a 2-D mesh (:func:`make_mesh_2d`):
    ``run(images, flats, darks)`` takes (T, B, H, W) planes and per-tile
    (T, H, W) flats and darks; row r of the mesh takes tiles ``[r t, (r +
    1) t)``, t = T / rows, and splits each tile's planes over its entries
    as :func:`sharded_destripe_step` does, each entry correcting with its
    tile's own flat (broadcast, never copied per plane). Returns ``(out,
    stats)``: ``out[i]`` tile i's uint16 tensors, one per entry of its
    row, and ``stats`` the (T, 2) float32 per-tile [min, max] of the
    float32 filtered planes on the mesh's first entry."""
    rows = [make_mesh(r) for r in mesh2]
    f32_matmul()
    consts = _consts_on(plan, [d for r in rows for d in r])
    dev0 = rows[0][0]

    def run(images, flats, darks):
        tq = _share(len(images), len(rows))
        outs, stats = [], []
        with torch.inference_mode():
            for t in range(len(images)):
                row = rows[t // tq]
                out, st = _destripe_parts(
                    plan, consts, microscope_high_int,
                    shard_planes(row, images[t]), flats[t], darks[t], True)
                outs.append(out)
                stats.append(_reduce(st, dev0))
            return outs, torch.stack(stats)

    return run
