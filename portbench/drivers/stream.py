"""
Traffic driver ``stream``: tiles streamed through the production pipeline
layer, ``runtime.pipeline.StreamingDestriper``, from an on-disk OME-Zarr
store, as ``zarr_destriper.destripe_zarr`` drives it for every tile.

Set-up writes one tile of ``stored_planes`` planes made from the seed into
a Zarr store under the run's temporary directory with the port's own
writer (the capsule's chunks and blosc-zstd codec) and the flat-field and
dark frame as TIFF files, reads the fields back with the port's reader,
and warms the pipeline with a short tile. The window runs one
``StreamingDestriper`` per tile, tiles back to back: each is a view of
``tile_planes`` planes whose plane z reads stored plane z mod
``stored_planes`` through the port's ``ZarrArray`` (every read decodes),
and writes into host memory, which keeps one buffer of the stored planes'
positions. The window holds whole tiles: it closes when the tile running
at ``seconds`` has written its last slab, and the rate is the pixels of
every tile over that time (a window cut inside a tile counted a tile's
start-up in some runs and not in others). The check reads the buffer.
"""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..generator import make_fields, make_planes

__all__ = ["setup", "window", "groups", "outputs", "close"]


class CycledTile:
    """A (1, 1, planes, H, W) view of a stored (1, 1, S, H, W) array whose
    plane z is stored plane z mod S; slabs must not wrap."""

    def __init__(self, store, planes: int, spans):
        self.store, self.spans = store, spans
        self.stored = store.shape[2]
        self.shape = (1, 1, planes) + tuple(store.shape[3:])
        self.dtype = store.dtype

    def __getitem__(self, key):
        zs = key[2]
        z0, n = zs.start, zs.stop - zs.start
        s0 = z0 % self.stored
        if s0 + n > self.stored:
            raise ValueError(f"slab {z0}:{zs.stop} wraps the stored planes")
        with self.spans.span("read_slab", planes=n):
            return self.store[0, 0, s0:s0 + n]


class HostTile:
    """A (1, 1, planes, H, W) output kept in host memory: one buffer of
    the stored positions (z mod S), holding each position's last write."""

    def __init__(self, planes: int, stored: int, height: int, width: int):
        self.shape = (1, 1, planes, height, width)
        self.dtype = np.dtype(np.uint16)
        self.stored = stored
        self.buf = np.zeros((stored, height, width), np.uint16)
        self.written = np.zeros(stored, bool)

    def __setitem__(self, key, value):
        zs = key[2]
        z0, n = zs.start, zs.stop - zs.start
        s0 = z0 % self.stored
        self.buf[s0:s0 + n] = np.asarray(value).reshape((n,) + self.buf.shape[1:])
        self.written[s0:s0 + n] = True


class State:
    pass


def _tmp_root(ctx) -> Path:
    """The run's temporary directory, or the checkout's build/ without
    TMPDIR: never a fixed path outside the checkout."""
    base = (Path(tempfile.gettempdir()) if os.environ.get("TMPDIR")
            else Path(ctx.root).parent / "build")
    return base / "portbench-stream"


def _pipe(st, inp, out):
    from aind_smartspim_destripe_torch.runtime.pipeline import (
        StreamingDestriper,
    )

    cfg, tr = st.cfg, st.tr
    return StreamingDestriper(
        inp, out, st.plan, flatfield=st.flat_f, darkfield=st.dark_f,
        microscope_high_int=float(cfg["microscope_high_int"]),
        slab=int(tr["slab"]), device_batch=int(cfg["device_batch"]),
        prefetch=int(tr["prefetch"]), devices=st.devices,
        dual=bool(cfg["dual_band"]), crossover=float(cfg["crossover"]))


def setup(ctx) -> State:
    from aind_smartspim_destripe_torch.io import group, imread, imsave, open_zarr
    from aind_smartspim_destripe_torch.io.zarr import BloscCodec
    from aind_smartspim_destripe_torch.ops.filter import (
        FilterConfig,
        build_plan,
    )

    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.cfg, st.tr, st.spans = cfg, tr, ctx.spans
    st.dev = torch.device(ctx.device)
    # the capsule's devices=None (the first card) on the card
    st.devices = None if st.dev.type == "cuda" else [st.dev]
    H, W, S = cfg["height"], cfg["width"], int(tr["stored_planes"])
    st.H, st.W, st.S = H, W, S
    st.plan = build_plan(H, W, FilterConfig.from_dict(cfg["cells_config"]),
                         FilterConfig.from_dict(cfg["no_cells_config"]))
    st.vol = make_planes(ctx.seed, S, H, W, tr["data"], st.dev).cpu().numpy()

    st.dir = _tmp_root(ctx)
    shutil.rmtree(st.dir, ignore_errors=True)
    st.dir.mkdir(parents=True)
    codec = tr["codec"]
    arr = group(str(st.dir / "tile.zarr")).create_dataset(
        name=0, shape=(1, 1, S, H, W), chunks=tuple(tr["chunks"]),
        dtype=np.uint16,
        compressor=BloscCodec(cname=codec["cname"], clevel=int(codec["clevel"]),
                              shuffle=int(codec["shuffle"])),
        dimension_separator="/", overwrite=True)
    zc = int(tr["chunks"][2])
    for z0 in range(0, S, zc):
        arr[0:1, 0:1, z0:z0 + zc] = st.vol[None, None, z0:z0 + zc]
    st.flat, st.dark = make_fields(H, W, tr["data"])
    imsave(str(st.dir / "flat.tiff"), st.flat)
    imsave(str(st.dir / "dark.tiff"), st.dark)
    st.flat_f = np.asarray(imread(str(st.dir / "flat.tiff")), np.float32)
    st.dark_f = np.asarray(imread(str(st.dir / "dark.tiff")), np.float32)
    st.store = open_zarr(str(st.dir / "tile.zarr"))["0"]

    # warm-up: a tile of two slabs builds the kernels' shapes and reads
    # every stored chunk once
    warm = int(tr["slab"]) * 2
    _pipe(st, CycledTile(st.store, warm, st.spans),
          HostTile(warm, S, H, W)).run()
    st.out = HostTile(int(tr["tile_planes"]), S, H, W)
    st.spans.items.clear()
    return st


def window(st: State, seconds: float, spans) -> dict:
    planes = int(st.tr["tile_planes"])
    st.stats = []
    t0 = time.perf_counter()
    stop = t0 + seconds
    while True:
        with spans.span("tile_setup"):
            pipe = _pipe(st, CycledTile(st.store, planes, spans), st.out)
        with spans.span("tile_run"):
            st.stats.append(pipe.run())
        if time.perf_counter() >= stop:
            break
    t_end = time.perf_counter()
    done = sum(s.planes for s in st.stats)
    return {"e2e": {"stream_mpix_s": done * st.H * st.W / 1e6 / (t_end - t0)},
            "planes": done, "planes_run": done, "tiles": len(st.stats),
            "seconds": t_end - t0, "pipeline": st.stats}


def groups(st: State):
    """The stored positions of each slab, and the padded tail slab's."""
    slab, Z = int(st.tr["slab"]), int(st.tr["tile_planes"])
    grp = [(z, min(z + slab, st.S)) for z in range(0, st.S, slab)]
    tail = Z % slab
    must = ()
    if tail:
        s0 = (Z - tail) % st.S
        must = ((s0, s0 + tail),)
    return grp, must


def outputs(st: State, ids):
    return [(pid, st.vol[pid],
             st.out.buf[pid].copy() if st.out.written[pid] else None)
            for pid in ids]


def close(st: State):
    st.store = st.out = st.vol = None
    shutil.rmtree(st.dir, ignore_errors=True)
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
