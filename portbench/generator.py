"""
The benchmark's inputs, made from ``--seed``: uint16 planes, the flat-field
and the dark frame, and the seeded sample of planes the check compares.

Planes follow the smoke tile of the port's bring-up (every ``bright_every``
-th plane bright, the rest dim, each with a random row profile for the
stripes and pixel noise), made on the device with one ``torch.Generator``
in a few large calls. Every seed gives the same sizes and the same bright
and dim planes; only the values change.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["seed_bits", "make_planes", "make_fields", "sample_planes"]

_MASK64 = (1 << 64) - 1


def seed_bits(seed: int, stream: int = 0) -> int:
    """A 64-bit generator seed from any whole ``seed`` and a stream id."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9
            + 0x94D049BB133111EB) & _MASK64


def make_planes(seed: int, n: int, height: int, width: int, data: dict,
                device, first: int = 0, stream: int = 0) -> torch.Tensor:
    """``n`` uint16 planes (n, height, width) on ``device``; plane ``i`` is
    bright when ``(first + i) % bright_every == bright_phase``."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed_bits(seed, stream))
    z = torch.arange(first, first + n, device=device)[:, None, None]
    base = torch.where(z % int(data["bright_every"]) == int(data["bright_phase"]),
                       float(data["bright"]), float(data["dim"]))
    vol = base + float(data["row_sigma"]) * torch.randn(
        (n, height, 1), generator=g, device=device)
    vol = vol + float(data["pixel_sigma"]) * torch.randn(
        (n, height, width), generator=g, device=device)
    return vol.clamp_(0, 65535).to(torch.int32).to(torch.uint16)


def make_fields(height: int, width: int, data: dict):
    """The retrospective flat-field (float32, 1 in the centre rising to
    ``1 + flat_rise`` in the corners) and the dark frame (uint16, a few
    counts in a three-column pattern), as host arrays."""
    yy = np.linspace(-1, 1, height, dtype=np.float32)[:, None]
    xx = np.linspace(-1, 1, width, dtype=np.float32)[None, :]
    flat = (1.0 + float(data["flat_rise"]) * (xx * xx + yy * yy) / 2).astype(
        np.float32)
    dark = (float(data["dark"]) + (np.arange(width) % 3)[None, :]
            * np.ones((height, 1))).astype(np.uint16)
    return flat, dark


def sample_planes(seed: int, groups, n: int, data: dict, must=()):
    """``n`` plane indices drawn from ``seed`` for the check: ``groups`` are
    the index ranges that went through one device batch; each pick takes
    the next group in turn and alternates the first and the second half of
    it, so every batch and both halves of it are seen; with fewer than two
    picks a group, the halves also alternate from one group to the next,
    so a second half is seen too; a quarter of the picks (at least one)
    are bright planes. ``must``: ranges from which at least one pick each
    is drawn first (a padded tail slab)."""
    rng = np.random.default_rng(seed_bits(seed, 7))
    every, phase = int(data["bright_every"]), int(data["bright_phase"])
    n_bright = max(1, n // every)
    picks = []

    def draw(pool):
        pool = [i for i in pool if i not in picks]
        if pool:
            picks.append(int(rng.choice(pool)))

    for lo, hi in must:
        draw(range(lo, hi))
    G = len(groups)
    k = 0
    while len(picks) < n:
        lo, hi = groups[k % G]
        mid = (lo + hi) // 2
        second = (k // G + (k if n < 2 * G else 0)) % 2
        half = range(mid, hi) if second else range(lo, mid)
        bright = len([p for p in picks if p % every == phase]) < n_bright
        draw([i for i in half if (i % every == phase) == bright] or half)
        k += 1
        if k > 64 * n:
            break
    return sorted(picks)
