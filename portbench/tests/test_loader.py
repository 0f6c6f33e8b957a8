"""Every file the benchmark finds by name is there, BENCHMARK.json keeps to
the contract's shape, and the bound of ``step_mpix_s`` follows the runs
recorded in ``calibration/step_mpix_s.json``."""

import json
import re
import statistics

import pytest

from portbench import harness

SPEC = json.loads((harness.ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found(cell):
    c = harness.load_cell(cell)
    driver = harness.load_driver(c.traffic)
    for fn in ("setup", "window", "groups", "outputs", "close"):
        assert callable(getattr(driver, fn))
    assert (harness.ROOT / "limits" / f"{cell}.json").exists()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_reader_found(metric):
    assert callable(harness.load_reader(metric).read)


def test_names_and_units():
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] \
        + SPEC["per_layer"]
    names = [i["name"] for i in items]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        g = [i["name"] for i in SPEC[group]]
        assert len(g) == len(set(g))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["name"].endswith("_roofline") or "roofline" not in m["name"]


def test_text_fields_fit():
    texts = [c["why"] for c in SPEC["configs"] + SPEC["workloads"]]
    texts += [c["source"] for c in SPEC["configs"]]
    texts += [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    assert len((harness.ROOT.parent / "BENCHMARK.json").read_bytes()) \
        <= 64 * 1024


def test_every_config_used_and_files_under_paths():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert (harness.ROOT.parent / c["file"]).exists()
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_metric_workloads_report_what_they_move():
    per_cell = {w["name"]: {m["name"] for m in harness.load_cell(
        w["name"]).end_to_end} for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in per_cell[cell]


CALIBRATION = json.loads((harness.ROOT / "calibration" / "step_mpix_s.json")
                         .read_text())
RATE = next(m for m in SPEC["end_to_end"] if m["name"] == "step_mpix_s")


def _spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def test_step_mpix_s_bound_follows_its_calibration():
    """Each recorded set's spread is its runs' quartile spread; a set
    counts unless a run of it followed a stitched.resident process; the
    bound lies between max(1%, 5 x) and 8 x the widest spread of the
    counted sets and the ledger's."""
    for s in CALIBRATION["sets"]:
        assert len(s["runs"]) >= 6
        assert s["spread"] == pytest.approx(
            _spread([r["value"] for r in s["runs"]]), rel=1e-9)
        assert s["counted"] == all(r["after"] != "stitched.resident"
                                   for r in s["runs"])
    widest = max([s["spread"] for s in CALIBRATION["sets"] if s["counted"]]
                 + [x["spread"] for x in CALIBRATION["ledger_spreads"]])
    assert CALIBRATION["widest_spread"] == pytest.approx(widest, rel=1e-9)
    assert CALIBRATION["bound"] == RATE["bound"]
    assert max(0.01, 5 * widest) <= RATE["bound"] + 1e-12
    assert RATE["bound"] <= max(0.01, 8 * widest) + 1e-12


@pytest.mark.parametrize("cell", RATE["workloads"])
def test_step_mpix_s_calibrated_in_cell(cell):
    """Every cell that reports the rate has two counted sets or more in
    the record, on the same seeds."""
    sets = [s for s in CALIBRATION["sets"]
            if s["cell"] == cell and s["counted"]]
    assert len(sets) >= 2
    seeds = {tuple(sorted(r["seed"] for r in s["runs"])) for s in sets}
    assert len(seeds) == 1
