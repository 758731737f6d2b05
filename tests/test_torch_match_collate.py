"""The port's host-side copies against the JAX package's originals, bit for
bit: the kernel-point dispositions, the KPConv collate (points, valids,
neighbors, pools, upsamples, lengths, features) and the neighbourhood
calibration on two synthetic pairs, the yaml loader, and the landmark
configuration field by field.

The JAX package's collate is pinned to its pure-numpy branch (the port has
no ``native`` module).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from deformationpyramid_tpu.data import collate as jcol
from deformationpyramid_tpu.data.synthetic import make_pair
from deformationpyramid_tpu.match import config_loader as jloader
from deformationpyramid_tpu.match import kernel_points as jkp
from deformationpyramid_tpu.match.backbone import KPFCN_ARCHITECTURE as JARCH
from deformationpyramid_tpu.match.kpconv import KPConvConfig as JKPConvConfig
from deformationpyramid_tpu.utils import config as jconfig
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.match import config_loader as tloader
from deformationpyramid_tpu_torch.match import kernel_points as tkp
from deformationpyramid_tpu_torch.match.backbone import (
    KPFCN_ARCHITECTURE as TARCH, kpfcn_plan as t_plan)
from deformationpyramid_tpu_torch.match.kpconv import (
    KPConvConfig as TKPConvConfig)
from deformationpyramid_tpu_torch.utils import config as tconfig
from deformationpyramid_tpu_torch.utils import timers
from tests.test_torch_cuda_collate import assert_same, per_array

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(first_subsampling_dl=0.05, first_feats_dim=32,
             coarse_feature_dim=96, fine_feature_dim=24)


@pytest.fixture(autouse=True)
def _numpy_collate(monkeypatch):
    # the numpy paths on both sides (the native ones:
    # tests/test_torch_native_collate.py)
    monkeypatch.setattr(jcol, "_native", lambda: None)
    monkeypatch.setattr(tcol, "_native", lambda: None)


@pytest.mark.parametrize("args", [(15, 3, "center", 1.0),
                                  (15, 3, "center", 0.125),
                                  (9, 3, "verticals", 0.3),
                                  (7, 2, "none", 2.0)])
def test_kernel_dispositions_bit_identical(args):
    a, b = jkp.kernel_dispositions(*args), tkp.kernel_dispositions(*args)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_architecture_and_plan_equal():
    from deformationpyramid_tpu.match.backbone import kpfcn_plan as j_plan

    assert tuple(JARCH) == tuple(TARCH)
    for kw in (SMALL, {}):
        jp, tp = j_plan(JKPConvConfig(**kw)), t_plan(TKPConvConfig(**kw))
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)


@pytest.mark.parametrize("seed,n", [(0, 400), (3, 700)])
def test_grid_subsample_and_radius_search_bit_identical(seed, n):
    src, _, _ = make_pair(n=n, seed=seed, deform=0.05)
    for dl in (0.05, 0.2):
        (ja, _), (ta, _) = jcol.grid_subsample(src, dl), \
            tcol.grid_subsample(src, dl)
        assert np.array_equal(ja, ta)
    sub, _ = tcol.grid_subsample(src, 0.1)
    for r, k in ((0.2, 12), (0.05, 3)):
        assert np.array_equal(jcol.radius_search(sub, src, r, k),
                              tcol.radius_search(sub, src, r, k))


@pytest.mark.parametrize("seed,n,pad", [(0, 400, None), (3, 700, "pow2")])
def test_pair_pyramid_and_calibration_bit_identical(seed, n, pad):
    src, tgt, _ = make_pair(n=n, seed=seed, deform=0.05)
    jcfg, tcfg = JKPConvConfig(**SMALL), TKPConvConfig(**SMALL)
    jl = jcol.calibrate_neighborhood_limits([(src, tgt)], jcfg, JARCH)
    tl = tcol.calibrate_neighborhood_limits([(src, tgt)], tcfg, TARCH)
    assert jl == tl and all(isinstance(v, int) for v in tl)
    jp = jcol.build_pair_pyramid(src, tgt, jcfg, JARCH, jl, pad_to=pad)
    tp = tcol.build_pair_pyramid(src, tgt, tcfg, TARCH, tl, pad_to=pad)
    assert jp.src_lengths == tp.src_lengths
    assert jp.tgt_lengths == tp.tgt_lengths
    for field in ("points", "valids", "neighbors", "pools", "upsamples"):
        ja, ta = getattr(jp, field), getattr(tp, field)
        assert len(ja) == len(ta), field
        for a, b in zip(ja, ta):
            assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert np.array_equal(jp.features, tp.features)


def test_pyramid_to_device_keeps_values():
    src, tgt, _ = make_pair(n=300, seed=1, deform=0.05)
    cfg = TKPConvConfig(**SMALL)
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], cfg, TARCH)
    pyr = tcol.build_pair_pyramid(src, tgt, cfg, TARCH, limits)
    dev = tcol.pyramid_to_device(pyr, "cpu")
    assert set(dev) == {"points", "valids", "neighbors", "pools",
                        "upsamples", "features"}
    for field in ("points", "valids", "neighbors", "pools", "upsamples"):
        for a, b in zip(getattr(pyr, field), dev[field]):
            assert np.array_equal(a, b.numpy())
    assert all(t.dtype == torch.int64 for t in dev["neighbors"])
    assert dev["valids"][0].dtype == torch.bool
    assert np.array_equal(pyr.features, dev["features"].numpy())


def _staging_pyramid(n, seed, pad, arch=TARCH):
    src, tgt, _ = make_pair(n=n, seed=seed, deform=0.05)
    cfg = TKPConvConfig(**SMALL)
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], cfg, arch)
    return tcol.build_pair_pyramid(src, tgt, cfg, arch, limits, pad_to=pad)


STAGED = {"small": (300, 1, None), "mid": (700, 3, "pow2"),
          "large": (1500, 5, "pow2"), "large-unpadded": (1500, 5, None),
          # one level, no pooling: the pools and upsamples are empty
          "no-pools": (500, 2, None, TARCH[:2])}


@pytest.mark.parametrize("case,then", [("small", "large"),
                                       ("mid", "small"),
                                       ("large", "mid"),
                                       ("large-unpadded", "no-pools"),
                                       ("no-pools", "large")])
def test_pyramid_to_device_staged_layout(case, then):
    """One byte buffer, the int32 tables widened in one ``.long()``: every
    output equals the conversion array by array in dtype, shape and bits;
    a first call's tensors keep their values after a call of another
    size; the CPU target stages nothing, so the staging counters move
    neither outside the profiler nor while it records."""
    pyr, other = (_staging_pyramid(*STAGED[c]) for c in (case, then))
    if case == "no-pools":
        assert pyr.pools == [] and pyr.upsamples == []
    counted = ("collate.staged", "collate.stage_misses")
    before = {k: timers.counters().get(k, 0) for k in counted}
    first = tcol.pyramid_to_device(pyr, "cpu")
    want = per_array(pyr, "cpu")
    assert_same(first, want)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert timers.recording()
        second = tcol.pyramid_to_device(other, "cpu")
    assert_same(second, per_array(other, "cpu"))
    assert_same(first, want)
    assert {k: timers.counters().get(k, 0) for k in counted} == before


def test_pack_plan_aligns_and_puts_int32_first():
    arrays = [np.zeros((5, 3), np.float32), np.zeros((7, 4), np.int32),
              np.zeros(9, bool), np.zeros((0, 4), np.int32),
              np.zeros((3, 2), np.int32)]
    offsets, wide, size = tcol._pack_plan(arrays)
    assert offsets == [512, 0, 768, 256, 256] and wide == 512
    assert size == 1024 and all(o % tcol._ALIGN == 0 for o in offsets)


@pytest.mark.parametrize("name", ["LNDP.yaml", "NDP.yaml",
                                  "configs/lepard.yaml",
                                  "configs/outlier_rejection.yaml",
                                  "configs/correspondence.yaml"])
def test_load_config_equal(name):
    path = str(REPO / "config" / name)
    j, t = jconfig.load_config(path), tconfig.load_config(path)
    assert dict(j) == dict(t)
    assert type(t).__name__ == "AttrDict"
    if name == "LNDP.yaml":
        assert t.exp_dir == "0.3" and t.split.test == "4DMatch-F"
        assert tconfig.load_config(path, {"m": 3}).m == 3


def test_landmark_config_from_yaml_field_by_field():
    path = str(REPO / "config" / "configs" / "correspondence.yaml")
    for kw in ({}, dict(inlier_thr=0.5, reject_outliers=False,
                        max_matches=64)):
        j = jloader.landmark_config_from_yaml(path, **kw)
        t = tloader.landmark_config_from_yaml(path, **kw)
        jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
        assert jd == td
        assert t.matcher.transformer.attention == \
            type(t.matcher.transformer.attention)(
                **dataclasses.asdict(j.matcher.transformer.attention))
    assert t.matcher.kpfcn.coarse_feature_dim == 528
    assert t.matcher.transformer.n_head == 4 and t.neco.num_layers == 9
    assert t.matcher.coarse_level == 2
