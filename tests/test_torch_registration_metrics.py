"""The port's ``metrics/registration.py`` against the JAX package's, bit for
bit on seeded inputs: RANSAC (the same ``default_rng`` stream, so the same
hypotheses, the same top-64 cut and the same refit), ``to_transform``,
``transformation_error`` and ``registration_recall``. Two faults of the
original are copied as they are and pinned here, so that a fix shows as a
changed test: the residual ``inv(pred) @ gt`` and the top-64 cut's ties.
"""
import numpy as np
import pytest

from deformationpyramid_tpu.metrics import registration as jreg
from deformationpyramid_tpu_torch.metrics import registration as treg


def _rot(axis, ang):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _matches(seed, n, outliers):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(n, 3)).astype(np.float32)
    R = _rot(rng.normal(size=3), rng.uniform(0.1, 0.6))
    t = rng.uniform(-0.3, 0.3, 3)
    tgt = (src @ R.T + t).astype(np.float32)
    k = int(n * outliers)
    tgt[:k] += rng.normal(size=(k, 3)).astype(np.float32)
    tgt += rng.normal(scale=0.002, size=tgt.shape).astype(np.float32)
    return src, tgt, R, t


@pytest.mark.parametrize("seed,n,outliers,iters", [
    (0, 60, 0.3, 300),       # n <= 128: every hypothesis scored on all rows
    (1, 900, 0.5, 2000),     # the two-stage scoring with the top-64 cut
    (2, 2, 0.0, 100),        # fewer rows than a minimal sample
    (3, 400, 0.95, 500)])    # mostly outliers
def test_ransac_bit_identical(seed, n, outliers, iters):
    src, tgt, R_gt, t_gt = _matches(seed, n, outliers)
    jR, jt, jinl = jreg.ransac_rigid_from_correspondences(
        src, tgt, n_iters=iters, inlier_thr=0.05, seed=seed)
    tR, tt, tinl = treg.ransac_rigid_from_correspondences(
        src, tgt, n_iters=iters, inlier_thr=0.05, seed=seed)
    assert np.array_equal(jR, tR) and np.array_equal(jt, tt)
    assert np.array_equal(jinl, tinl)
    if n >= 60 and outliers <= 0.5:
        assert np.abs(tR - R_gt).max() < 1e-2
        assert np.abs(tt - t_gt).max() < 1e-2


def test_transformation_error_and_recall_bit_identical():
    rng = np.random.default_rng(7)
    preds, gts, covs = [], [], []
    for i in range(12):
        gt = treg.to_transform(_rot(rng.normal(size=3), rng.uniform(0, 3)),
                               rng.normal(size=3))
        assert np.array_equal(gt, jreg.to_transform(gt[:3, :3], gt[:3, 3]))
        # small and large errors, and rotations near pi (trace <= 0 branch)
        err = treg.to_transform(_rot(rng.normal(size=3),
                                     [0.01, 0.2, 3.1][i % 3]),
                                rng.normal(scale=[0.02, 0.3][i % 2], size=3))
        preds.append(gt @ err)
        gts.append(gt)
        A = rng.normal(size=(6, 6))
        covs.append(A @ A.T + 6 * np.eye(6))
    for p, g, c in zip(preds, gts, covs):
        res = np.linalg.inv(p) @ g
        assert treg.transformation_error(res, c) \
            == jreg.transformation_error(res, c)
        assert np.array_equal(treg._mat2quat(res[:3, :3]),
                              jreg._mat2quat(res[:3, :3]))
    for thr in (0.2 ** 2, 1.0):
        got = treg.registration_recall(preds, gts, covs, threshold=thr)
        assert got == jreg.registration_recall(preds, gts, covs,
                                               threshold=thr)
    assert 0 < treg.registration_recall(preds, gts, covs) < 1
    assert treg.registration_recall([], [], []) == 0.0


def test_inherited_fault_residual_is_inv_pred_at_gt():
    """registration_recall scores inv(pred) @ gt; the redwood convention
    reads inv(gt) @ pred. Under an anisotropic covariance the two disagree:
    this pair passes as copied and fails under the convention."""
    gt = treg.to_transform(_rot([1, 2, 3], 1.2), [1.0, 0.0, 0.0])
    # residual inv(pred) @ gt = X: a quarter turn about z and 0.3 along y,
    # whose inverse moves 0.3 along x
    X = treg.to_transform(_rot([0, 0, 1], np.pi / 2), [0.0, 0.3, 0.0])
    pred = gt @ np.linalg.inv(X)
    info = np.diag([1.0, 0.01, 1.0, 0.01, 0.01, 0.01])   # x counts, y barely
    copied = treg.transformation_error(np.linalg.inv(pred) @ gt, info)
    convention = treg.transformation_error(np.linalg.inv(gt) @ pred, info)
    assert copied == jreg.transformation_error(np.linalg.inv(pred) @ gt,
                                               info)
    assert treg.registration_recall([pred], [gt], [info]) \
        == jreg.registration_recall([pred], [gt], [info]) == 1.0
    assert copied < 0.2 ** 2 < convention


def test_inherited_fault_top64_cut_ties(monkeypatch):
    """The refine keeps np.argpartition's 64 best subsampled counts; where
    more hypotheses tie at the 64th count the kept set is numpy's choice.
    Both packages make the same choice on the same input; the count is
    pinned so that a tie-aware cut shows."""
    rng = np.random.default_rng(11)
    n = 300
    src = rng.normal(size=(n, 3)).astype(np.float32)
    tgt = src + rng.normal(scale=0.5, size=(n, 3)).astype(np.float32)
    # mostly outliers: many hypotheses share the same small count
    real = np.argpartition
    calls = []

    def spy(a, kth, *args, **kw):
        out = real(a, kth, *args, **kw)
        calls.append((np.asarray(a).copy(), out.copy()))
        return out

    monkeypatch.setattr(np, "argpartition", spy)
    cnts = []
    for mod in (jreg, treg):
        calls.clear()
        R, t, inl = mod.ransac_rigid_from_correspondences(
            src, tgt, n_iters=1000, inlier_thr=0.05, seed=5)
        assert len(calls) == 1
        cnts.append((calls[0], R, t, inl))
    (ja, jtop), jR, jt, jinl = cnts[0]
    (ta, ttop), tR, tt, tinl = cnts[1]
    assert np.array_equal(ja, ta) and np.array_equal(jtop[:64], ttop[:64])
    assert np.array_equal(jR, tR) and np.array_equal(jinl, tinl)
    counts = -ta
    kth = np.sort(counts)[::-1][63]
    tied = int((counts == kth).sum())
    kept = int((counts[ttop[:64]] == kth).sum())
    # more hypotheses tie at the cut than it keeps: the choice is arbitrary
    assert tied > kept > 0
