"""The step's least-work counts against values worked out by hand."""

import math

import pytest

from portbench import roofline


def test_levels_small_shape():
    # 40 x 48, db3: min(floor(log2(40/5)), floor(log2(48/5))) = 3 levels;
    # coefficient lengths (n + 5) // 2
    assert roofline.levels(40, 48) == [(40, 48, 22, 26), (22, 26, 13, 15),
                                       (13, 15, 9, 10)]


def test_counts_by_hand():
    B, H, W = 2, 40, 48
    r = roofline.step_roles(B, H, W)
    px = B * H * W  # 3840
    assert r["analysis"]["bytes"] == 2 * px
    # log1p, then x lowpass (12 flops an output) and y lo + hi (24)
    an = px + B * (12 * 40 * 26 + 24 * 22 * 26) \
        + B * (12 * 22 * 15 + 24 * 13 * 15) + B * (12 * 13 * 10 + 24 * 9 * 10)
    assert r["analysis"]["flops"] == an == 3840 + 2 * (26208 + 8640 + 3720)
    assert r["histogram"]["flops"] == B * (22 * 26 + 13 * 15 + 9 * 10)
    notch = sum(B * lh * (5 * lw * math.log2(lw) + lw)
                for lh, lw in ((22, 26), (13, 15), (9, 10)))
    assert r["notch"]["flops"] == pytest.approx(notch, rel=1e-12)
    # y: 12 flops an output but 6 at the coarsest level; x: 6; exp + div
    syn = B * (12 * 40 * 26 + 6 * 40 * 48) + B * (12 * 22 * 15 + 6 * 22 * 26) \
        + B * (6 * 13 * 10 + 6 * 13 * 15) + 2 * px
    assert r["synthesis"]["flops"] == syn
    assert r["synthesis"]["bytes"] == 2 * 4 * H * W + 2 * px
    assert r["median"] == {"bytes": 0.0, "flops": 0.0}
    assert r["blend"] == {"bytes": 0.0, "flops": 0.0}


def test_dual_doubles_the_per_band_work():
    s = roofline.step_roles(2, 40, 48)
    d = roofline.step_roles(2, 40, 48, dual=True)
    assert d["analysis"] == s["analysis"]
    assert d["histogram"] == s["histogram"]
    assert d["notch"]["flops"] == 2 * s["notch"]["flops"]
    px = 2 * 40 * 48
    # the per-level passes and exp twice, the flat-field division once
    assert d["synthesis"]["flops"] == 2 * s["synthesis"]["flops"] - px
    assert d["blend"]["flops"] == 11 * px


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 16), (3, 40, 48), (64, 1600, 2000)])
def test_bounds_nonnegative(shape, dual):
    for r in roofline.step_roles(*shape, dual=dual).values():
        assert r["bytes"] >= 0 and r["flops"] >= 0
    t, by = roofline.step_bound_s(*shape, dual=dual)
    assert t > 0 and by in ("bytes", "operations")


def test_production_bound():
    # 64 planes of 1600 x 2000: 2 B in + 2 B out a pixel, flat and dark once
    t, by = roofline.step_bound_s(64, 1600, 2000)
    assert by == "bytes"
    assert t == pytest.approx((4 * 64 * 1600 * 2000 + 8 * 1600 * 2000)
                              / 3.35e12)
