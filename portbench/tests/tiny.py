"""Cells cut to a size the CPU tests can run."""

from __future__ import annotations

import dataclasses
import json

from portbench import harness

# ``single.stream`` is kept out of BENCHMARK.json (its runs spread more than
# the largest bound holds; PERF.md §7) but its files stay, so a later PR can
# add the cell: the tests build it from them.
STREAM = "single.stream"
CELLS = (STREAM, "single.resident", "dual.resident")


def cell(name: str) -> harness.Cell:
    """The cell ``name`` of BENCHMARK.json, or the stream cell from its
    configuration and traffic files."""
    if name != STREAM:
        return harness.load_cell(name)
    root = harness.ROOT
    return harness.Cell(
        name=name, chips=1, end_to_end=[], per_layer=[],
        config=json.loads((root / "configs" / "smartspim-single.json")
                          .read_text()),
        traffic=json.loads((root / "traffic" / "stream.json").read_text()))


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` at 48 x 64 planes in batches of 8, with 4 planes
    checked; a stream cell keeps 16 stored planes and runs tiles of 36
    (a padded tail slab of 4) in slabs of 8, a resident cell a ring of 2."""
    c = cell(name)
    cfg = dict(c.config, height=48, width=64, device_batch=8)
    tr = dict(c.traffic, check_planes=4)
    if tr["driver"] == "stream":
        tr.update(stored_planes=16, tile_planes=36, slab=8,
                  chunks=[1, 1, 8, 16, 16])
    else:
        tr.update(ring=2)
    return dataclasses.replace(c, config=cfg, traffic=tr)
