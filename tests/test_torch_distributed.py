"""Multi-host runs of the port on the CPU: ``parallel.distributed`` against
the JAX package's, and two real processes joined by gloo over a localhost
port that run ``run_capsule.run`` on a four-tile channel (8 x 32 x 48, the
channel of tests/test_distributed_multihost.py) with ``devices=[cpu]``.

Checked as the JAX package's two-process test does: disjoint round-robin
ownership that covers every tile, every tile written with levels 0-2,
``global_stats`` summing ``[pid + 1, 1]`` to ``[3, 2]``, and a second run
after two journals were removed (one per owner) that skips per owner:
intact tiles recompute no plane, the invalidated ones all of theirs. The
workers run this file's :func:`_worker` through ``python -c``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from aind_smartspim_destripe_torch.parallel import distributed as tdist  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Z, H, W = 8, 32, 48
STEMS = ["471300_461360", "471320_461360", "471340_461360", "471360_461360"]
CHANNEL = "Ex_488_Em_525"


def test_assign_tiles_matches_jax():
    from aind_smartspim_destripe_tpu.parallel.distributed import (
        assign_tiles as jax_assign_tiles,
    )

    tiles = [f"{s}.zarr" for s in reversed(STEMS)] + ["a.zarr", "b.zarr"]
    for count in (1, 2, 3, 4):
        for index in range(count):
            got = tdist.assign_tiles(tiles, process_index=index,
                                     process_count=count)
            assert got == jax_assign_tiles(tiles, index, count)
    assert tdist.assign_tiles(tiles) == sorted(tiles)  # one process: all


def test_single_process_is_a_no_op(monkeypatch):
    for var in ("DESTRIPE_COORDINATOR_ADDRESS", "DESTRIPE_NUM_PROCESSES",
                "DESTRIPE_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    v = np.array([1.5, 2.0])
    np.testing.assert_array_equal(tdist.global_stats(v), v)
    assert (tdist.rank(), tdist.world_size()) == (0, 1)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_capsule(root):
    """A capsule of one channel with four tiles on laser side 0, its flat
    and the dark frame."""
    from aind_smartspim_destripe_torch.io import group, imsave

    data = root / "data"
    (data / "derivatives").mkdir(parents=True)
    (root / "results").mkdir()
    acq = {"tiles": [{"coordinate_transformations": [
        {"type": "scale", "scale": ["1.8", "1.8", "2.0"]}]}]}
    (data / "acquisition.json").write_text(json.dumps(acq))
    (data / "laser_tiles.json").write_text(json.dumps({"0": STEMS}))
    imsave(str(data / f"estimated_flat_laser_{CHANNEL}_0.tif"),
           np.full((H, W), 1.2, np.float32), output_format=".tif")
    imsave(str(data / "derivatives" / "DarkMaster_cropped.tif"),
           np.full((H, W), 3, np.uint16), output_format=".tif")
    rng = np.random.default_rng(0)
    for stem in STEMS:
        tile = group(str(data / CHANNEL / f"{stem}.zarr"))
        lvl0 = tile.create_dataset(0, shape=(1, 1, Z, H, W),
                                   chunks=(1, 1, 8, 16, 16), dtype=np.uint16)
        vol = np.clip(300 + rng.normal(size=(Z, H, 1)) * 50
                      + rng.normal(size=(Z, H, W)) * 5, 0, 65535)
        lvl0[:] = vol.astype(np.uint16)[None, None]


def _worker(root, out_json):
    """One process of the two-process run (its rank and the coordinator
    come from the DESTRIPE_* variables): the capsule, the stats reduction,
    two journals removed by process 0 between barriers, the capsule again;
    reports what this process owned and did as JSON."""
    from aind_smartspim_destripe_torch import run_capsule, zarr_destriper

    runs = []
    real = zarr_destriper.destripe_channel

    def spy(**kw):
        runs.append(real(**kw))
        return runs[-1]

    zarr_destriper.destripe_channel = spy
    writes = []
    real_prov = run_capsule.generate_data_processing

    def prov_spy(**kw):
        writes.append(kw["channel_name"])
        return real_prov(**kw)

    run_capsule.generate_data_processing = prov_spy
    args = (f"{root}/data", f"{root}/results", f"{root}/scratch")
    run_capsule.run(*args, devices=[torch.device("cpu")])
    pid, count = tdist.rank(), tdist.world_size()
    gs = tdist.global_stats(np.array([pid + 1.0, 1.0]))

    ch_out = f"{root}/results/destriped_data/{CHANNEL}"
    invalidated = [f"{STEMS[0]}.zarr", f"{STEMS[1]}.zarr"]
    tdist.global_stats(np.array([1.0]))  # barrier: first runs on disk
    if pid == 0:
        for t in invalidated:
            os.remove(f"{ch_out}/{t}/0/.destripe_journal.json")
    tdist.global_stats(np.array([1.0]))  # barrier: removals seen by all
    run_capsule.run(*args, devices=[torch.device("cpu")])
    first, second = runs
    with open(out_json, "w") as f:
        json.dump({
            "process_id": pid,
            "process_count": count,
            "tiles": sorted(first),
            "planes": {k: v.planes for k, v in first.items()},
            "global_stats": np.asarray(gs).tolist(),
            "resume_tiles": sorted(second),
            "resume_planes": {k: v.planes for k, v in second.items()},
            "resume_skipped": {k: v.slabs_skipped for k, v in second.items()},
            "invalidated": invalidated,
            "provenance_writes": len(writes),
        }, f)


def test_two_process_capsule(tmp_path):
    _build_capsule(tmp_path)
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, DESTRIPE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   DESTRIPE_NUM_PROCESSES="2", DESTRIPE_PROCESS_ID=str(pid))
        code = ("import tests.test_torch_distributed as m; "
                f"m._worker({str(tmp_path)!r}, "
                f"{str(tmp_path / f'report_{pid}.json')!r})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        outputs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outputs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    assert all("Multi-host run: process" in out for out in outputs)

    reports = [json.load(open(tmp_path / f"report_{i}.json")) for i in (0, 1)]
    assert [r["process_id"] for r in reports] == [0, 1]
    assert all(r["process_count"] == 2 for r in reports)
    owned = [set(r["tiles"]) for r in reports]
    assert owned[0] & owned[1] == set()
    assert owned[0] | owned[1] == {f"{s}.zarr" for s in STEMS}
    assert all(len(o) == 2 for o in owned)
    assert all(p == Z for r in reports for p in r["planes"].values())
    for r in reports:
        assert r["global_stats"] == [3.0, 2.0]

    out = tmp_path / "results" / "destriped_data" / CHANNEL
    for stem in STEMS:
        for lvl in ("0", "1", "2"):
            assert (out / f"{stem}.zarr" / lvl / ".zarray").exists()
    # provenance: written by process 0 alone, once per run
    assert [r["provenance_writes"] for r in reports] == [2, 0]
    provenance = list((tmp_path / "results").glob("*processing.json"))
    assert [p.name for p in provenance] == [
        f"image_destriping_{CHANNEL}_processing.json"]

    invalidated = set(reports[0]["invalidated"])
    recomputed = []
    for r in reports:
        assert sorted(r["resume_tiles"]) == sorted(r["tiles"])
        for t in r["resume_tiles"]:
            if t in invalidated:
                assert r["resume_planes"][t] == Z
                assert r["resume_skipped"][t] == 0
            else:
                assert r["resume_planes"][t] == 0
                assert r["resume_skipped"][t] >= 1
        recomputed.append({t for t in r["resume_tiles"]
                           if r["resume_planes"][t] == Z})
    assert recomputed[0] | recomputed[1] == invalidated
    assert all(len(s) == 1 for s in recomputed)
