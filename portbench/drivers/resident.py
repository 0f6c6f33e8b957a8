"""
Traffic driver ``resident``: the production device step on batches kept on
the card, launched back to back with the host taken out of the loop.

Set-up builds ``runtime.pipeline.make_device_step`` (flat-field epilogue,
the configuration's single-band classifier dispatch or dual-band blend)
over a ring of distinct batches made on the device from the seed, and
warms it with two steps (the set-up spans ``setup.data`` and
``setup.warmup``, each ending in a synchronize). The window launches steps
on the ring in turn until ``seconds`` have passed on the host clock and
ends with one synchronize; the rate is every finished step's pixels over
that time. The check reads the last output of every ring slot.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..generator import make_fields, make_planes

__all__ = ["setup", "window", "groups", "outputs", "close"]


class State:
    pass


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def setup(ctx) -> State:
    from aind_smartspim_destripe_torch.ops.filter import (
        FilterConfig,
        build_plan,
    )
    from aind_smartspim_destripe_torch.runtime import pipeline

    cfg, tr = ctx.config, ctx.traffic
    st = State()
    st.dev = torch.device(ctx.device)
    st.H, st.W, st.B = cfg["height"], cfg["width"], cfg["device_batch"]
    st.R = int(tr["ring"])
    plan = build_plan(st.H, st.W,
                      FilterConfig.from_dict(cfg["cells_config"]),
                      FilterConfig.from_dict(cfg["no_cells_config"]))
    st.step = pipeline.make_device_step(
        plan, float(cfg["microscope_high_int"]), True, devices=[st.dev],
        dual=bool(cfg["dual_band"]), crossover=float(cfg["crossover"]))
    with ctx.spans.span("setup.data"):
        data = make_planes(ctx.seed, st.R * st.B, st.H, st.W, tr["data"],
                           st.dev)
        st.ring = [data[i * st.B:(i + 1) * st.B] for i in range(st.R)]
        st.flat, st.dark = make_fields(st.H, st.W, tr["data"])
        st.flat_d = st.step.put_const(st.flat)
        st.dark_d = st.step.put_const(st.dark.astype(np.float32))
        _sync(st.dev)
    st.outs = [None] * st.R
    with ctx.spans.span("setup.warmup"):
        for i in range(2):  # every shape the window uses
            st.step(st.ring[i % st.R], st.flat_d, st.dark_d)
        _sync(st.dev)
    return st


def window(st: State, seconds: float, spans) -> dict:
    n = 0
    t0 = time.perf_counter()
    stop = t0 + seconds
    while True:
        i = n % st.R
        with spans.span("step"):
            st.outs[i] = st.step(st.ring[i], st.flat_d, st.dark_d)
        n += 1
        if n >= st.R and time.perf_counter() >= stop:
            break
    with spans.span("sync"):
        _sync(st.dev)
    t1 = time.perf_counter()
    px = n * st.B * st.H * st.W
    return {"e2e": {"step_mpix_s": px / 1e6 / (t1 - t0)},
            "steps": n, "planes": n * st.B, "seconds": t1 - t0}


def groups(st: State):
    """The plane ids of each ring slot (one device batch each)."""
    return [(i * st.B, (i + 1) * st.B) for i in range(st.R)], ()


def outputs(st: State, ids):
    """[(plane id, raw plane, output plane)] as host arrays."""
    items = []
    for pid in ids:
        slot, b = divmod(pid, st.B)
        raw = st.ring[slot][b].cpu().numpy()
        got = st.outs[slot]
        items.append((pid, raw, None if got is None else got[b].cpu().numpy()))
    return items


def close(st: State):
    st.step = st.ring = st.outs = st.flat_d = st.dark_d = None
    gc.collect()
    if st.dev.type == "cuda":
        torch.cuda.empty_cache()
