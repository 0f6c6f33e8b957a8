"""A tiny CPU rehearsal of each traffic mix's control flow: the run comes out
correct and reports no device metric."""

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
