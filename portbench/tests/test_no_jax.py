"""After importing the benchmark and the port, a fresh interpreter holds no
module whose top-level name is JAX's or the JAX package's; and the run
command fails, printing no result, without a card or without the port."""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CODE = """
import sys
sys.path.insert(0, {root!r})
import portbench.harness, portbench.check, portbench.calibrate
import portbench.reference.destripe_torch
import portbench.drivers.stream, portbench.drivers.resident
import aind_smartspim_destripe_torch
from aind_smartspim_destripe_torch.runtime import pipeline
from aind_smartspim_destripe_torch import zarr_destriper, run_capsule
from aind_smartspim_destripe_torch.ops import dual_band
bad = sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "aind_smartspim_destripe_tpu"}})
print(",".join(bad))
"""


def test_no_jax_loaded():
    res = subprocess.run([sys.executable, "-c", CODE.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "single.resident",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the card tests run the command itself
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout == ""


def test_no_result_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
