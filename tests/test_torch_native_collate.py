"""The port's native collate library (``deformationpyramid_tpu_torch/native``,
built here from its own source with the host C++ compiler) against the JAX
package's (``deformationpyramid_tpu/native`` over the library in ``cxx/``),
bit for bit: the same algorithms with the same floating-point operations
give the same outputs, on seeded clouds and on the edge cases (empty
supports, radius 0, max_k above the support count, exact ties on a grid,
where both order equidistant neighbours by index). Then the whole collate
(``build_pair_pyramid`` and the neighbourhood calibration) with the native
path on both sides, array by array, and the numpy path still equal to the
JAX package's numpy path."""
import dataclasses

import numpy as np
import pytest

from deformationpyramid_tpu import native as jnat
from deformationpyramid_tpu.data import collate as jcol
from deformationpyramid_tpu.match.backbone import KPFCN_ARCHITECTURE as JARCH
from deformationpyramid_tpu.match.kpconv import KPConvConfig as JKPConfig
from deformationpyramid_tpu_torch import native as tnat
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.match.backbone import \
    KPFCN_ARCHITECTURE as TARCH
from deformationpyramid_tpu_torch.match.kpconv import \
    KPConvConfig as TKPConfig

SMALL = dict(first_subsampling_dl=0.05, first_feats_dim=32,
             coarse_feature_dim=96, fine_feature_dim=24)


def _cloud(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * 0.3).astype(np.float32)


def _grid(step=0.05, k=9):
    g = np.arange(k, dtype=np.float32) * np.float32(step)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)


def test_both_libraries_load():
    assert jnat.has_native(), "the JAX package's cxx/ library did not load"
    assert tnat.has_native()
    assert tnat.load() is not None


@pytest.mark.parametrize("seed,n,dl", [(0, 2000, 0.05), (1, 700, 0.11),
                                       (2, 1, 0.05), (3, 0, 0.05)])
def test_grid_subsample_bit_equal(seed, n, dl):
    pts = _cloud(seed, n)
    a, b = jnat.grid_subsample(pts, dl), tnat.grid_subsample(pts, dl)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a, b)


def test_grid_subsample_on_a_grid_bit_equal():
    pts = _grid()
    for dl in (0.05, 0.1, 0.025):
        assert np.array_equal(jnat.grid_subsample(pts, dl),
                              tnat.grid_subsample(pts, dl))


@pytest.mark.parametrize("case", ["random", "grid_ties", "empty_supports",
                                  "empty_queries", "radius_0", "k_above",
                                  "k_zero"])
def test_radius_neighbors_bit_equal(case):
    q, s = _cloud(4, 300), _cloud(5, 500)
    radius, max_k = 0.12, 20
    if case == "grid_ties":
        s = _grid()
        q = s[::7] + np.float32(0.025)   # equidistant from 8 grid points
        radius = 0.06
    elif case == "empty_supports":
        s = s[:0]
    elif case == "empty_queries":
        q = q[:0]
    elif case == "radius_0":
        radius = 0.0
    elif case == "k_above":
        s, radius, max_k = s[:7], 5.0, 12
    elif case == "k_zero":
        max_k = 0
    a = jnat.radius_neighbors(q, s, radius, max_k)
    b = tnat.radius_neighbors(q, s, radius, max_k)
    assert a.dtype == b.dtype == np.int64 and a.shape == b.shape
    assert np.array_equal(a, b)
    if case == "grid_ties":
        assert (b[0, :8] < len(s)).all()     # the eight tied neighbours


def _pyramids(monkeypatch, native: bool, seed: int):
    if not native:
        monkeypatch.setattr(jcol, "_native", lambda: None)
        monkeypatch.setattr(tcol, "_native", lambda: None)
    src, tgt = _cloud(seed, 1500), _cloud(seed + 1, 1300)
    jcfg, tcfg = JKPConfig(**SMALL), TKPConfig(**SMALL)
    jl = jcol.calibrate_neighborhood_limits([(src, tgt)], jcfg, JARCH)
    tl = tcol.calibrate_neighborhood_limits([(src, tgt)], tcfg, TARCH)
    assert jl == tl
    jp = jcol.build_pair_pyramid(src, tgt, jcfg, JARCH, jl, pad_to="pow2")
    tp = tcol.build_pair_pyramid(src, tgt, tcfg, TARCH, tl, pad_to="pow2")
    return jp, tp


@pytest.mark.parametrize("native", [True, False])
def test_collate_equal_array_by_array(monkeypatch, native):
    if native:
        # the stacked helpers take the native libraries on both sides
        assert jcol._native() is not None and tcol._native() is tnat
    jp, tp = _pyramids(monkeypatch, native, 6)
    for field in dataclasses.fields(jp):
        a, b = getattr(jp, field.name), getattr(tp, field.name)
        if isinstance(a, list):
            assert len(a) == len(b), field.name
            for x, y in zip(a, b):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), \
                    field.name
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), field.name


def test_native_and_numpy_agree_up_to_tie_order(monkeypatch):
    """The two paths of the port give the same neighbour sets (they order
    equidistant neighbours differently, as the JAX package's do)."""
    src = _cloud(8, 900)
    tnat_idx = tcol.batch_radius_search(src, [900], src, [900], 0.1, 30)
    monkeypatch.setattr(tcol, "_native", lambda: None)
    np_idx = tcol.batch_radius_search(src, [900], src, [900], 0.1, 30)
    assert np.array_equal(np.sort(tnat_idx, 1), np.sort(np_idx, 1))
