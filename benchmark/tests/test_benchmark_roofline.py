"""The roofline and mfu arithmetic against hand counts at small shapes."""
import math

import pytest

from benchmark import roofline


def test_level_mlp_flops_by_hand():
    # 10 points, width 4, depth 3 (two hidden layers), 6 heads:
    # 2 * 10 * (6*4 + 2*4*4 + 4*6) = 2 * 10 * 80
    assert roofline.level_mlp_flops(10, 4, 3, 6) == 1600.0
    assert roofline.level_heads(3, "SE3", False) == 6
    assert roofline.level_heads(3, "sflow", True) == 4
    assert roofline.ndp_iteration_flops(10, 20, 4, 3, 6) == \
        3 * 1600.0 + 8 * 10 * 20


def test_nn_dual_bound_by_hand():
    b = roofline.nn_dual_bound(2, 1000, 1000)
    flops, nbytes = 8.0 * 2 * 1000 * 1000, 2 * 2000 * 25
    assert b["bound_s"] == pytest.approx(max(flops / 67e12, nbytes / 3.35e12))
    assert b["bound_by"] == "operations"


def test_flash_bounds_by_hand():
    L, src, h, d = 64, 48, 2, 8
    fwd = roofline.flash_bound(L, src, h, d)
    ops = 4.0 * L * src * h * d
    nbytes = 4.0 * (2 * L + 2 * src) * h * d
    assert fwd["bound_s"] == pytest.approx(max(3 * ops / 495e12,
                                               nbytes / 3.35e12))
    assert fwd["f32_bound_s"] == pytest.approx(max(ops / 67e12,
                                                   nbytes / 3.35e12))
    bwd = roofline.flash_bwd_bounds(L, 64, src, h, d)
    assert set(bwd) == {"dkv", "dq"}
    assert bwd["dkv"]["f32_bound_s"] >= bwd["dq"]["f32_bound_s"]


def test_transformer_attention_bound_by_hand():
    # one self and one cross layer over 30 source and 20 target rows of a
    # cap of 64: the valid query rows are the work, not the cap
    h, d, cap = 2, 8, 64
    got = roofline.transformer_attention_bound_s(
        ["self", "positioning", "cross"], 30, 20, cap, h, d, backward=False)
    want = sum(roofline.flash_bound(q, s, h, d)["bound_s"]
               for q, s in ((30, 30), (20, 20), (30, 20), (20, 30)))
    assert got == pytest.approx(want)
    both = roofline.transformer_attention_bound_s(
        ["self"], 30, 30, cap, h, d, backward=True)
    bwd = roofline.flash_bwd_bounds(30, cap, 30, h, d)
    one = roofline.flash_bound(30, 30, h, d)["bound_s"] \
        + bwd["dkv"]["bound_s"] + bwd["dq"]["bound_s"]
    assert both == pytest.approx(2 * one)


def test_shares():
    assert roofline.mfu_pct(495e12, 1.0) == pytest.approx(100.0)
    assert roofline.mfu_pct(0.0, 1.0) is None
    assert roofline.roofline_pct(1.0, 4.0) == 25.0
    assert roofline.roofline_pct(1.0, 0.0) is None
    assert math.isclose(roofline.tc_bound(0, 10.0, 10.0)["bound_s"],
                        30.0 / 495e12)
