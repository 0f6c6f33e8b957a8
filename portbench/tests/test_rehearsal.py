"""A tiny CPU rehearsal of each traffic mix's control flow: the run comes out
correct and reports no device metric; a traced one carries the plan's
counters."""

import time

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, tiny_cell


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    res = harness.run_cell(tiny_cell(cell), 2 ** 31 + 977, 0.3, bool(trace),
                           "cpu", time.perf_counter())
    assert res["correct"], res["check"]
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"] and "breakdown" not in res
    assert res["attempted"] > 0 and res["failed"] == 0
    assert len(res["planes_checked"]) == 4
    if trace:  # the plan counters, as information beside the metrics
        assert set(res["plan"]) == set(harness.PLAN_COUNTERS)
        assert res["plan"]["plan.device_bytes"] == 0  # nothing on a card
        assert res["plan"]["plan.notch_lowrank_levels"] >= 0
        assert res["plan"]["plan.notch_fft_levels"] >= 0
    else:
        assert "plan" not in res
