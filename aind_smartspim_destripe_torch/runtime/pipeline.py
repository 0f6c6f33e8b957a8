"""
Streaming destripe pipeline: Zarr slabs -> device batches -> Zarr.

Counterpart of ``aind_smartspim_destripe_tpu/runtime/pipeline.py``. One
process, three stages:

  [reader threads]  decode input Zarr chunks for slab k+1..k+prefetch
  [devices]         destripe + flat-field on fixed-size uint16 batches
                    (uint16 in and out, so host<->device traffic is halved)
  [writer threads]  encode and write level-0 chunks of slab k-1

The device stage runs on a mesh (a list of devices, :func:`resolve_device`):
one entry runs the whole batch; several split each batch over their planes,
or, for planes above ``DESTRIPE_HALO_THRESHOLD_BYTES`` of float32, over
their rows (the row-sharded route, :mod:`..parallel.halo`). Each batch goes
host -> device -> step -> host in order; at most two dispatches are in
flight. A plane-sharded batch is launched on every device without a host
wait, so the devices run their shares at the same time, and each device's
copies in and out run on a host thread of their own. A per-slab commit
journal in the output store lets an interrupted run resume instead of
recomputing the tile.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..ops.dual_band import check_crossover, dual_band_destripe_batch
from ..ops.filter import (
    DestripePlan,
    destripe_batch,
    device_constants,
    f32_matmul,
)
from ..parallel.halo import (
    destripe_y_sharded,
    dual_band_destripe_y_sharded,
    halo_batch_bytes,
    halo_device_constants,
    halo_threshold_bytes,
    shard_rows,
)
from ..parallel.mesh import _host_tensor, _share, make_mesh
from .tracing import span

__all__ = [
    "PipelineStats",
    "StreamingDestriper",
    "make_device_step",
    "resolve_device",
]


def resolve_device(devices=None) -> List[torch.device]:
    """The mesh a step runs on (:func:`..parallel.mesh.make_mesh`): None
    means every visible CUDA device (raises when CUDA is absent; there is
    no CPU fallback); a list names the entries, ``[torch.device("cpu")]``
    included, and may repeat a device."""
    return make_mesh(devices)


@dataclass
class PipelineStats:
    planes: int = 0
    slabs: int = 0
    slabs_skipped: int = 0
    read_s: float = 0.0
    compute_s: float = 0.0
    write_s: float = 0.0
    wall_s: float = 0.0
    pixels: int = 0
    # True when the step sharded ROWS over the mesh (the row-sharded route
    # above DESTRIPE_HALO_THRESHOLD_BYTES) instead of planes
    halo: bool = False
    # per-slab records [(z0, z1, read_wait_s, compute_s)]: read_wait is the
    # time the loop blocked on the prefetched read
    slab_records: list = None

    def __post_init__(self):
        if self.slab_records is None:
            self.slab_records = []

    @property
    def gpix_per_s(self) -> float:
        return self.pixels / self.wall_s / 1e9 if self.wall_s else 0.0


def make_device_step(plan: DestripePlan, microscope_high_int: float,
                     with_flatfield: bool, devices=None, dual: bool = False,
                     crossover: float = 100.0, dual_threshold: float = -1.0):
    """(B, H, W) uint16 -> uint16 device step: destripe, then the
    flat-field correction (``with_flatfield``) or the zarr-store wrap cast.
    The plan's constants (:func:`..ops.filter.device_constants`) are made
    on each device once. Matrix products run in full float32 (TF32 off).

    ``dual=True`` replaces the classifier dispatch with the dual-band blend
    (:func:`..ops.dual_band.dual_band_destripe_batch`: both of the plan's
    configurations from one decomposition, blended per pixel by the
    smoothed sigmoid foreground fraction of width ``crossover`` and centre
    ``dual_threshold``, < 0 for the per-plane Otsu), with the flat-field or
    wrap epilogue fused into the blend's store.

    ``devices``: the mesh (:func:`resolve_device`). With more than one
    entry the batch is split over the entries' planes (each entry runs the
    whole step on its planes; constants once per device), or, when one
    plane's float32 bytes pass ``DESTRIPE_HALO_THRESHOLD_BYTES`` (default
    1 GiB), over their rows (:func:`_make_halo_step`). ``None`` takes every
    visible CUDA device for the row split, but runs planes under the
    threshold on the first device alone: on four H100s the plane split of
    a 64-plane batch of 1600 x 2000 planes ran slower than one card (the
    host needs longer to launch a share than the card needs to run it;
    ``scripts/mesh_capsule.py``). A list of devices splits them. A mesh of
    one entry (a one-card host) takes the plane path at any plane size,
    the fused 16384 x 18000 plane included.

    The returned callable ``step(images, flat, dark)`` carries ``.put``
    (numpy batch -> device input), ``.put_const``, ``.to_host`` (its output
    -> numpy) and ``.n_devices``. The plane-sharded step's input is a list
    of per-entry futures (``.put``) and its output a list of per-entry
    tensors; read it through ``.to_host``."""
    if dual:
        check_crossover(crossover)
    mesh = resolve_device(devices)
    f32_matmul()
    if (len(mesh) > 1
            and plan.height * plan.width * 4 > halo_threshold_bytes()):
        return _make_halo_step(plan, microscope_high_int, with_flatfield,
                               mesh, dual, crossover, dual_threshold)
    if devices is None:
        mesh = mesh[:1]
    consts = {dev: device_constants(plan, dev)
              for dev in dict.fromkeys(mesh)}

    def one(images, flat, dark):
        c = consts[images.device]
        if dual:
            epi = (dict(flat=flat, dark=dark) if with_flatfield
                   else dict(wrap=True))
            return dual_band_destripe_batch(
                plan, images, crossover, dual_threshold, consts=c, **epi)
        if with_flatfield:
            return destripe_batch(plan, images, microscope_high_int, c,
                                  flat=flat, dark=dark)
        return destripe_batch(plan, images, microscope_high_int, c,
                              wrap=True)

    if len(mesh) == 1:
        def step(images, flat, dark):
            with span("step", planes=images.size(0), devices=1), \
                    torch.inference_mode():
                return one(images, flat, dark)

        step.put = lambda chunk: _host_tensor(chunk).to(mesh[0])
        step.put_const = step.put
        step.to_host = lambda res: res.cpu().numpy()
        step.n_devices = 1
        return step

    # plane-sharded: entry d takes planes [d b, (d + 1) b) of the batch. The
    # step launches every entry's share from this thread and never waits on
    # a device (the plane step makes no host sync), so the devices run their
    # shares at the same time. The pageable copies in and out hold the host
    # for their whole length: they run on a copy thread per device (the
    # step's input is a list of futures of them).
    def step(images, flat, dark):
        with span("step", devices=len(mesh)) as meta, \
                torch.inference_mode():
            out = [one(x.result(), f, k)
                   for x, f, k in zip(images, flat, dark)]
            if meta is not None:  # the shares are known once copied
                meta["planes"] = sum(o.size(0) for o in out)
            return out

    def put(chunk):
        b = _share(chunk.shape[0], len(mesh))  # shard_planes' split
        return [_copier(dev).submit(_host_tensor(chunk[d * b:(d + 1) * b]).to,
                                    dev)
                for d, dev in enumerate(mesh)]

    def put_const(c):
        per_dev = {dev: _host_tensor(c).to(dev) for dev in dict.fromkeys(mesh)}
        return [per_dev[dev] for dev in mesh]

    def to_host(res):
        host = [_copier(r.device).submit(lambda r=r: r.cpu().numpy())
                for r in res]
        return np.concatenate([h.result() for h in host])

    step.put = put
    step.put_const = put_const
    step.to_host = to_host
    step.n_devices = len(mesh)
    return step


_COPIERS: dict = {}
_COPIERS_LOCK = threading.Lock()


def _copier(dev: torch.device) -> ThreadPoolExecutor:
    """The host thread that copies batches to and from ``dev`` for the
    plane-sharded step, one per device for the life of the process, so the
    devices' pageable copies overlap; one device's copies run in the order
    they were submitted. (Only copies: a thread per device that also
    launched the step's many small kernels would pass the interpreter lock
    back and forth at every launch.)"""
    with _COPIERS_LOCK:
        pool = _COPIERS.get(dev)
        if pool is None:
            init = (dict(initializer=torch.cuda.set_device, initargs=(dev,))
                    if dev.type == "cuda" else {})
            pool = _COPIERS[dev] = ThreadPoolExecutor(
                1, thread_name_prefix=f"destripe-copy-{dev}", **init)
        return pool


def _make_halo_step(plan, microscope_high_int, with_flatfield, mesh,
                    dual=False, crossover=100.0, dual_threshold=-1.0):
    """Device step for planes too large for one device: ROWS sharded over
    the mesh by the row-sharded route (:mod:`..parallel.halo`). Same uint16
    -> uint16 contract as the plane-sharded step. ``put`` splits each
    plane's rows evenly over the entries and pads them with zero rows to
    the mesh multiple; the step reads only the plane's own rows, and
    ``to_host`` gathers them. ``dual=True`` runs the row-sharded dual-band
    form (epilogue on the blended rows)."""
    H, W = plan.height, plan.width
    consts = halo_device_constants(plan, mesh, notch_blocks=not dual)

    def step(images, flat, dark):
        epi = (dict(flat=flat, dark=dark) if with_flatfield
               else dict(wrap=True))
        with span("step", planes=images.parts[0].size(0),
                  devices=len(mesh)), torch.inference_mode():
            if dual:
                return dual_band_destripe_y_sharded(
                    images, mesh, plan, consts, crossover=crossover,
                    threshold=dual_threshold, **epi)
            return destripe_y_sharded(
                images, mesh, plan, consts,
                microscope_high_int=microscope_high_int, **epi)

    def put_const(c):
        c = _host_tensor(np.asarray(c, np.float32))
        if tuple(c.shape[-2:]) == (H, W):  # a field: sharded like the rows
            return shard_rows(c, mesh, value=1.0)
        return c.to(mesh[0])

    step.put = lambda chunk: shard_rows(_host_tensor(chunk), mesh)
    step.put_const = put_const
    step.to_host = lambda res: res.gather("cpu").numpy()
    step.n_devices = len(mesh)
    step.shards_rows = True  # the batch need not divide the mesh; rows do
    return step


class _Journal:
    """Per-slab commit log enabling cheap resume (one JSON file in the
    output store; a slab is recomputed unless its exact geometry was
    committed under the same meta)."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.done = set()
        # commit() runs on concurrent writer threads
        self._lock = threading.Lock()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    state = json.load(f)
                if state.get("meta") == meta:
                    self.done = set(map(tuple, state.get("slabs", [])))
            except (json.JSONDecodeError, OSError, TypeError,
                    AttributeError):
                pass  # a corrupt or foreign journal means recompute

    def commit(self, slab: tuple):
        with self._lock:
            self.done.add(slab)
            snapshot = sorted(self.done)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"meta": self.meta, "slabs": snapshot}, f)
            os.replace(tmp, self.path)


class StreamingDestriper:
    """Drive one tile (3-D or 5-D Zarr array) through the device step.
    ``slab`` is the streamed Z extent, ``prefetch`` the read-ahead depth,
    ``device_batch`` the planes per dispatch, ``devices`` the mesh as in
    :func:`resolve_device`."""

    def __init__(
        self,
        input_array,
        output_array,
        plan: DestripePlan,
        flatfield: Optional[np.ndarray] = None,
        darkfield: Optional[np.ndarray] = None,
        microscope_high_int: float = 2500.0,
        slab: int = 64,
        device_batch: int = 64,
        prefetch: int = 2,
        io_threads: int = 0,
        logger: Optional[logging.Logger] = None,
        journal: bool = True,
        devices=None,
        dual: bool = False,
        crossover: float = 100.0,
        dual_threshold: float = -1.0,
    ):
        self.inp = input_array
        self.out = output_array
        self.plan = plan
        self.high_int = microscope_high_int
        self.slab = slab
        self.prefetch = max(1, prefetch)
        self.logger = logger or logging.getLogger(__name__)

        in_shape = tuple(input_array.shape)
        if len(in_shape) == 5:
            if in_shape[:2] != (1, 1):
                raise ValueError(
                    f"5-D input must be (1, 1, Z, Y, X); got {in_shape} — "
                    "destripe each channel's tile separately"
                )
            self._lead = (0, 0)
            self.zyx = in_shape[2:]
        elif len(in_shape) == 3:
            self._lead = ()
            self.zyx = in_shape
        else:
            raise ValueError(f"expected 3-D or 5-D input, got {in_shape}")
        if self.zyx[1:] != (plan.height, plan.width):
            raise ValueError(
                f"plan geometry {(plan.height, plan.width)} != data {self.zyx[1:]}"
            )

        self.with_flat = flatfield is not None
        h, w = plan.height, plan.width
        flat = (np.asarray(flatfield, np.float32) if self.with_flat
                else np.ones((1, 1), np.float32))
        if self.with_flat and darkfield is not None:
            dark = np.asarray(darkfield, np.float32)[:h, :w]
        else:
            if darkfield is not None:
                self.logger.warning(
                    "darkfield provided without a flatfield — dark "
                    "subtraction only applies inside the flat-field "
                    "correction; ignoring it (reference semantics)"
                )
            dark = np.zeros((1, 1), np.float32)
        if self.with_flat:
            if flat.shape[-2:] != (h, w):
                raise ValueError(f"flatfield shape {flat.shape} != plane {(h, w)}")
            if dark.shape[-2:] != (h, w):
                dark = np.broadcast_to(dark, (h, w)).copy()
        self._step = make_device_step(
            plan, microscope_high_int, self.with_flat, devices=devices,
            dual=dual, crossover=crossover, dual_threshold=dual_threshold,
        )
        # Plane-sharded steps: the batch rounds up to a multiple of the
        # mesh. The row-sharded step's batch is capped instead, so that one
        # dispatch's per-device working set stays under
        # DESTRIPE_HALO_BATCH_BYTES (~8 f32 planes' worth of intermediates
        # per plane, as the JAX package counts it).
        n_dev = self._step.n_devices
        if getattr(self._step, "shards_rows", False):
            cap = max(1, int(halo_batch_bytes() / (8.0 * h * w * 4 / n_dev)))
            self.device_batch = max(1, min(device_batch, cap))
        else:
            self.device_batch = -(-device_batch // n_dev) * n_dev
        self._flat = self._step.put_const(flat)
        self._dark = self._step.put_const(dark)
        self.io = ThreadPoolExecutor(
            max_workers=io_threads or min(16, (os.cpu_count() or 4))
        )

        meta = {
            "slab": slab,
            "zyx": list(self.zyx),
            "cells": str(plan.cells),
            "no_cells": str(plan.no_cells),
            "high_int": microscope_high_int,
            "with_flat": self.with_flat,
        }
        if self.with_flat:
            # a run resumed after the flats changed must not stitch slabs
            # corrected with the old fields to slabs with the new ones
            sig = hashlib.sha1(flat.tobytes())
            sig.update(dark.tobytes())
            meta["flats_sha1"] = sig.hexdigest()
        if dual:
            # a dual-band slab is not interchangeable with a classifier-
            # dispatched one; the keys appear only in dual mode, so existing
            # single-band journals keep resuming
            meta.update({
                "dual": True,
                "crossover": float(crossover),
                "dual_threshold": float(dual_threshold),
            })
        self.journal = (
            _Journal(
                os.path.join(
                    getattr(output_array, "path", "."), ".destripe_journal.json"
                ),
                meta,
            )
            if journal and hasattr(output_array, "path")
            else None
        )

    # -- IO helpers (bounded retries for flaky network stores) ------------

    def _read_slab(self, z0: int, z1: int) -> np.ndarray:
        for attempt in range(3):
            try:
                if self._lead:
                    return np.asarray(self.inp[0, 0, z0:z1])
                return np.asarray(self.inp[z0:z1])
            except OSError:
                if attempt == 2:
                    raise
                self.logger.error(f"retrying read of slab {z0}:{z1}...")
                time.sleep(0.05)

    def _write_slab(self, z0: int, z1: int, data: np.ndarray):
        for attempt in range(10):
            try:
                if len(self.out.shape) == 5:
                    self.out[0:1, 0:1, z0:z1] = data[None, None]
                else:
                    self.out[z0:z1] = data
                return
            except OSError:
                if attempt == 9:
                    raise
                self.logger.error(f"retrying write of slab {z0}:{z1}...")
                time.sleep(0.05)

    # -- device ------------------------------------------------------------

    def _process_slab(self, data: np.ndarray) -> np.ndarray:
        """Destripe a (n, H, W) numpy slab in fixed-size device batches;
        returns uint16 (n, H, W)."""
        n = data.shape[0]
        b = self.device_batch
        outs = []
        pending = deque()
        for i in range(0, n, b):
            chunk = data[i : i + b]
            if chunk.shape[0] < b:  # pad the tail to the batch size
                pad = np.zeros((b - chunk.shape[0],) + chunk.shape[1:], chunk.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            dev = self._step.put(chunk)
            pending.append((i, min(b, n - i), self._step(dev, self._flat, self._dark)))
            # at most 2 dispatches in flight
            while len(pending) > 2:
                j, k, res = pending.popleft()
                outs.append((j, self._step.to_host(res)[:k]))
        while pending:
            j, k, res = pending.popleft()
            outs.append((j, self._step.to_host(res)[:k]))
        return np.concatenate([o for _, o in outs], axis=0)

    # -- main loop ---------------------------------------------------------

    def run(self) -> PipelineStats:
        stats = PipelineStats(halo=getattr(self._step, "shards_rows", False))
        t_start = time.time()
        Z, H, W = self.zyx
        slabs = [(z0, min(z0 + self.slab, Z)) for z0 in range(0, Z, self.slab)]

        read_q: deque = deque()
        writes: deque[Future] = deque()
        # each in-flight write pins a full uint16 slab: bound them
        max_inflight_writes = self.prefetch + 1
        next_read = 0

        def schedule_reads():
            nonlocal next_read
            while next_read < len(slabs) and len(read_q) < self.prefetch:
                z0, z1 = slabs[next_read]
                if self.journal and (z0, z1) in self.journal.done:
                    read_q.append(((z0, z1), None))
                else:
                    read_q.append(
                        ((z0, z1), self.io.submit(self._read_slab, z0, z1))
                    )
                next_read += 1

        schedule_reads()
        try:
            self._run_slabs(stats, read_q, writes, schedule_reads,
                            max_inflight_writes, H, W)
            for wfut in writes:
                stats.write_s += wfut.result()
        finally:
            # leave no reads or writes racing the store after an error,
            # and nothing parked once the tile is done
            self.io.shutdown(wait=True, cancel_futures=True)
        stats.wall_s = time.time() - t_start
        self.logger.info(
            f"pipeline done: {stats.planes} planes in {stats.wall_s:.2f}s "
            f"({stats.gpix_per_s:.3f} GPix/s) read={stats.read_s:.1f}s "
            f"compute={stats.compute_s:.1f}s write={stats.write_s:.1f}s "
            f"skipped={stats.slabs_skipped}"
        )
        return stats

    def _run_slabs(self, stats, read_q, writes, schedule_reads,
                   max_inflight_writes, H, W):
        while read_q:
            (z0, z1), item = read_q.popleft()
            schedule_reads()
            if item is None:
                stats.slabs_skipped += 1
                self.logger.info(f"slab {z0}:{z1} already committed; skipping")
                continue
            t0 = time.time()
            data = item.result()
            read_wait = time.time() - t0
            stats.read_s += read_wait

            t0 = time.time()
            out = self._process_slab(data)
            compute = time.time() - t0
            stats.compute_s += compute
            stats.slab_records.append((z0, z1, read_wait, compute))

            def write(z0=z0, z1=z1, out=out):
                t0 = time.time()
                self._write_slab(z0, z1, out)
                if self.journal:
                    self.journal.commit((z0, z1))
                return time.time() - t0

            writes.append(self.io.submit(write))
            while len(writes) > max_inflight_writes:
                stats.write_s += writes.popleft().result()
            stats.slabs += 1
            stats.planes += z1 - z0
            stats.pixels += (z1 - z0) * H * W
            self.logger.info(f"slab {z0}:{z1} destriped ({z1 - z0} planes)")
