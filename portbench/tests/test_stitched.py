"""The fused-plane cell ``stitched.resident``: its files load, its
configuration states what it cut and assumed, its check sees one dim and
one bright plane, one from each batch and one from a second half, and a
rehearsal of it on the CPU at
a cut size (a banded plane, so the band kernels' twins run) comes out
correct against the reference under the cell's own limits, and not
correct with the timed path broken underneath."""

import dataclasses
import json
import time

import pytest

from portbench import check, harness
from portbench.tests.test_faults import _broken

CELL = "stitched.resident"
SPEC = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())


def _cut(cell: harness.Cell) -> harness.Cell:
    """The cell at 640 x 640 planes (level 0 banded), its batches and
    ring kept, so the same planes are checked."""
    cfg = dict(cell.config, height=640, width=640)
    return dataclasses.replace(cell, config=cfg)


def test_cell_loads():
    c = harness.load_cell(CELL)
    assert c.chips == 1
    assert (c.config["height"], c.config["width"]) == (16384, 18000)
    assert c.config["device_batch"] == 4 and not c.config["dual_band"]
    assert c.traffic["driver"] == "resident"
    assert (c.traffic["ring"], c.traffic["check_planes"]) == (2, 2)
    limits = check.load_limits(harness.ROOT, CELL)
    assert 0 < limits["rms_lsb"] and 0 < limits["max_lsb"]
    assert {m["name"] for m in c.end_to_end} == {"step_mpix_s", "setup_s"}
    assert "setup.plan_s" in {m["name"] for m in c.per_layer}


def test_configuration_states_its_cuts():
    cfg_entry = next(c for c in SPEC["configs"]
                     if c["name"] == "smartspim-stitched")
    assert "run_capsule.py" in cfg_entry["source"]
    assert cfg_entry["reduced"] == ["z_planes"]
    cfg = harness.load_cell(CELL).config
    assert cfg["reference"] == "portbench/reference/destripe_torch.py"
    assert (harness.ROOT.parent / cfg["reference"]).exists()
    assert {"height", "width", "z_planes"} <= set(cfg["assumed"])
    single = json.loads((harness.ROOT / "configs" / "smartspim-single.json")
                        .read_text())
    for key in ("cells_config", "no_cells_config", "microscope_high_int",
                "retrospective_flatfield", "dual_band", "precision"):
        assert cfg[key] == single[key], key


def test_checked_planes_are_one_dim_and_one_bright_from_each_batch():
    """Two picks from a ring of two batches: the bright plane 1 from the
    first half of the first batch and a dim plane, 6 or 7 as the seed
    draws, from the second half of the second, so a fault confined to
    the second half of a batch is seen by this cell's check."""
    from portbench.generator import sample_planes

    c = harness.load_cell(CELL)
    B, R = c.config["device_batch"], c.traffic["ring"]
    groups = [(i * B, (i + 1) * B) for i in range(R)]
    data = c.traffic["data"]
    drawn = set()
    for seed in (1, 2 ** 31 + 977, 3_000_000_011, 2 ** 31 + 4242, 17, 99):
        ids = sample_planes(seed, groups, c.traffic["check_planes"], data)
        assert ids[0] == 1 and ids[1] in (6, 7), ids
        assert [i % data["bright_every"] == data["bright_phase"]
                for i in ids] == [True, False]
        assert {i // B for i in ids} == set(range(R))
        assert any(i % B >= B // 2 for i in ids)
        drawn.add(ids[1])
    assert drawn == {6, 7}


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_at_a_cut_size(trace):
    res = harness.run_cell(_cut(harness.load_cell(CELL)), 2 ** 31 + 1977,
                           0.3, bool(trace), "cpu", time.perf_counter())
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert len(res["planes_checked"]) == 2
    assert res["metrics"] == {}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    from aind_smartspim_destripe_torch.runtime import pipeline

    monkeypatch.setattr(pipeline, "make_device_step",
                        _broken(pipeline.make_device_step, fault))
    res = harness.run_cell(_cut(harness.load_cell(CELL)), 424242, 0.3,
                           False, "cpu", time.perf_counter())
    assert not res["correct"], res["check"]
    assert res["failed"] > 0
