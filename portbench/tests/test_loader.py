"""Every file the benchmark finds by name is there, BENCHMARK.json keeps to
the contract's shape, and the bound of ``step_mpix_s`` follows the runs
recorded under ``calibration/``: the shared ``step_mpix_s.json`` and one
record a cell in ``step_mpix_s/<cell>.json``."""

import json
import re
import shutil
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


CALIBRATION = harness.ROOT / "calibration"
RATE = next(m for m in SPEC["end_to_end"] if m["name"] == "step_mpix_s")


def _spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def check_calibration(rate, folder):
    """Hold ``rate``'s bound to the records under ``folder``: the shared
    ``<metric>.json`` and one ``<metric>/<cell>.json`` for each cell of
    the rate's ``workloads``. Each set's spread is its runs' quartile
    spread; a set counts unless a run of it followed a stitched.resident
    process; each record's ``widest_spread`` is its counted sets' widest;
    every cell has two counted sets or more on the same seeds; the bound
    lies between max(1%, 5 x) and 8 x the widest spread of every record
    and of the ledger's. Returns the records by cell."""
    shared = json.loads((folder / f"{rate['name']}.json").read_text())
    records = {}
    for path in sorted((folder / rate["name"]).glob("*.json")):
        record = json.loads(path.read_text())
        cell = record["cell"]
        assert path.stem == cell, f"{path.name} holds the record of {cell}"
        assert cell in rate["workloads"], \
            f"{cell}'s record names a cell outside the rate's workloads"
        for s in record["sets"]:
            assert s["cell"] == cell, f"a set of {s['cell']} in {path.name}"
            assert len(s["runs"]) >= 6
            assert s["spread"] == pytest.approx(
                _spread([r["value"] for r in s["runs"]]), rel=1e-9)
            assert s["counted"] == all(r["after"] != "stitched.resident"
                                       for r in s["runs"])
        counted = [s for s in record["sets"] if s["counted"]]
        assert len(counted) >= 2, f"{cell} has fewer than two counted sets"
        seeds = {tuple(sorted(r["seed"] for r in s["runs"])) for s in counted}
        assert len(seeds) == 1, f"{cell}'s counted sets differ in seeds"
        assert record["widest_spread"] == pytest.approx(
            max(s["spread"] for s in counted), rel=1e-9)
        records[cell] = record
    missing = set(rate["workloads"]) - set(records)
    assert not missing, f"no record for {sorted(missing)}"
    widest = max([r["widest_spread"] for r in records.values()]
                 + [x["spread"] for x in shared["ledger_spreads"]])
    assert shared["bound"] == rate["bound"]
    assert max(0.01, 5 * widest) <= rate["bound"] + 1e-12, \
        f"the bound {rate['bound']} is under 5 x the widest spread {widest}"
    assert rate["bound"] <= max(0.01, 8 * widest) + 1e-12, \
        f"the bound {rate['bound']} is over 8 x the widest spread {widest}"
    return records


def test_step_mpix_s_bound_follows_its_calibration():
    """The bound lies between max(1%, 5 x) and 8 x the widest spread of
    the counted sets of every cell's record and of the ledger's."""
    check_calibration(RATE, CALIBRATION)


@pytest.mark.parametrize("cell", RATE["workloads"])
def test_step_mpix_s_calibrated_in_cell(cell):
    """Every cell that reports the rate has its record, with two counted
    sets or more on the same seeds."""
    assert cell in check_calibration(RATE, CALIBRATION)


NEW_CELL = "joining.resident"


def _record(cell, spreads):
    """A record with one counted set of 6 runs for each spread, all on the
    same seeds: values 1000 x (1 + d x spread / 0.7), whose quartile spread
    is ``spread``."""
    sets = []
    for i, spread in enumerate(spreads, 1):
        runs = [{"seed": 7000 + k, "value": 1000.0 * (1 + d * spread / 0.7),
                 "setup_s": 9.0, "after": cell}
                for k, d in enumerate((-0.5, -0.3, -0.1, 0.1, 0.3, 0.5))]
        values = [r["value"] for r in runs]
        sets.append({"cell": cell, "set": i, "call": "c1", "runs": runs,
                     "spread": _spread(values),
                     "median": statistics.median(values), "counted": True})
    return {"cell": cell, "widest_spread": max(s["spread"] for s in sets),
            "sets": sets}


ADMISSION = {
    # case: ({cell: the spreads of its record's sets}, what the check's
    # failure says, or None where the cell joins)
    "joins": ({NEW_CELL: (0.0115, 0.006)}, None),
    "too_noisy": ({NEW_CELL: (0.015, 0.015)}, "under 5 x the widest"),
    "no_record": ({}, "no record for"),
    "stray_record": ({NEW_CELL: (0.0115, 0.006), "stray.resident":
                      (0.006, 0.006)}, "outside the rate's workloads"),
}


@pytest.mark.parametrize("case", ADMISSION)
def test_new_cell_joins_by_its_own_record(case, tmp_path):
    """A cell added to the rate's workloads joins by a new record file
    alone when its counted sets spread by no more than bound / 5; a noisier
    cell, one with no record, and a record of a cell outside the workloads
    fail. No file already under ``calibration/`` is touched."""
    folder = tmp_path / "calibration"
    shutil.copytree(CALIBRATION, folder)
    before = {p.relative_to(folder): p.read_bytes()
              for p in folder.rglob("*.json")}
    rate = dict(RATE, workloads=RATE["workloads"] + [NEW_CELL])
    spreads, fails = ADMISSION[case]
    for cell, sets in spreads.items():
        (folder / "step_mpix_s" / f"{cell}.json").write_text(
            json.dumps(_record(cell, sets), indent=1) + "\n")
    if fails is None:
        assert NEW_CELL in check_calibration(rate, folder)
    else:
        with pytest.raises(AssertionError, match=fails):
            check_calibration(rate, folder)
    for rel, data in before.items():
        assert (folder / rel).read_bytes() == data \
            == (CALIBRATION / rel).read_bytes()
