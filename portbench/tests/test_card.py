"""On the card: a short run of each cell through the command, as the
benchmark's checker runs it. Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert out["device"]["busy_s"] > 0 and out["device"]["window_s"] > 0
        assert out["breakdown"]["device_ops"]
        parts = [out["metrics"][f"setup.{p}_s"]["value"]
                 for p in ("start", "plan", "data", "warmup")]
        assert abs(sum(parts) - out["setup_s"]) < 0.5, (parts, out["setup_s"])
        assert set(out["plan"]) == {"plan.device_bytes",
                                    "plan.notch_lowrank_levels",
                                    "plan.notch_fft_levels"}
    else:
        assert "setup_s" in out["metrics"]
    assert res.stderr.strip().splitlines()[-1].startswith("check ")
