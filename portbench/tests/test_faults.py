"""With the timed path broken underneath, a run of each cell comes out not
correct: a step that returns its input unchanged, one that leaves the
second half of its batch out, one that alters a pixel of every plane it
produces. (One card: no exchange between cards to leave out.)"""

import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import CELLS, tiny_cell


def _broken(real, fault):
    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def bad(images, flat, dark):
            out = step(images, flat, dark)
            if fault == "unchanged":
                return images.clone()
            out = out.clone()
            if fault == "half":
                out[out.shape[0] // 2:] = 0
            else:  # an output value altered where it is produced
                v = out[:, 0, 0].to(torch.int32)
                out[:, 0, 0] = ((v + 4096) % 65536).to(torch.uint16)
            return out

        for attr in ("put", "put_const", "to_host", "n_devices"):
            setattr(bad, attr, getattr(step, attr))
        return bad

    return make


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from aind_smartspim_destripe_torch.runtime import pipeline

    monkeypatch.setattr(pipeline, "make_device_step",
                        _broken(pipeline.make_device_step, fault))
    res = harness.run_cell(tiny_cell(cell), 424242, 0.3, False, "cpu",
                           time.perf_counter())
    assert not res["correct"], res["check"]
    assert res["failed"] > 0
