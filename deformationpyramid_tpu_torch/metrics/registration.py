"""Rigid-registration evaluation: RANSAC fitting and registration recall.

A copy of ``deformationpyramid_tpu/metrics/registration.py`` (numpy), bit
for bit: reference ``correspondence/lepard/loss.py:13-43``
(``computeTransformationErr``) and the Open3D-based RANSAC pose estimation
the reference calls for 3DMatch. A numpy Kabsch-RANSAC over
correspondences (on the host, once a pair) and the covariance-weighted
transformation error.

Two faults of the original are kept, so that both packages score a pair
alike (tests pin each):

* ``registration_recall`` scores the residual ``inv(pred) @ gt`` where the
  redwood convention's ``computeTransformationErr`` takes ``inv(gt) @
  pred``-style residuals of the estimate; the two differ in the frame the
  translation error is read in;
* the RANSAC refine keeps the top 64 hypotheses of the subsampled count
  through ``np.argpartition``, which cuts ties at the 64th count in an
  order numpy does not promise.
"""
from __future__ import annotations

import numpy as np


def _kabsch(src: np.ndarray, tgt: np.ndarray):
    ms, mt = src.mean(0), tgt.mean(0)
    H = (tgt - mt).T @ (src - ms)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    S[2, 2] = np.linalg.det(U) * np.linalg.det(Vt.T)
    R = U @ S @ Vt
    t = mt - R @ ms
    return R, t


def ransac_rigid_from_correspondences(src_pts: np.ndarray, tgt_pts: np.ndarray,
                                      n_iters: int = 5000,
                                      inlier_thr: float = 0.05,
                                      sample_size: int = 3, seed: int = 0):
    """RANSAC rigid fit over matched point pairs.

    Returns (R [3,3], t [3], inlier_mask [N]).
    """
    n = len(src_pts)
    if n < sample_size:
        return np.eye(3), np.zeros(3), np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    src32 = np.ascontiguousarray(src_pts, np.float32)
    tgt32 = np.ascontiguousarray(tgt_pts, np.float32)
    # All hypotheses batched (replaces a 5000-iteration Python loop of tiny
    # SVDs): [B, k] integer minimal samples (collision-resampled) ->
    # batched Kabsch via np.linalg.svd over [B, 3, 3] -> two-stage scoring:
    # every hypothesis on <=128 subsampled correspondences (the [B, N]
    # residual matrix is the cost on this 1-core host), then the top 64 on
    # all N. 2.7 s -> ~0.4 s at B=5000, N=900 under identical load,
    # identical recovery (stage-1 inlier-count noise at 128 samples is far
    # below the top-64 refine margin).
    idx = rng.integers(0, n, size=(n_iters, sample_size))
    if sample_size > 1:
        bad = np.zeros(n_iters, bool)
        for a in range(sample_size):
            for b in range(a + 1, sample_size):
                bad |= idx[:, a] == idx[:, b]
        while bad.any():
            idx[bad] = rng.integers(0, n, size=(int(bad.sum()), sample_size))
            bad = np.zeros(n_iters, bool)
            for a in range(sample_size):
                for b in range(a + 1, sample_size):
                    bad |= idx[:, a] == idx[:, b]
    s = src32[idx]                         # [B, k, 3]
    t_ = tgt32[idx]
    ms, mt = s.mean(1, keepdims=True), t_.mean(1, keepdims=True)
    H = np.einsum("bki,bkj->bij", t_ - mt, s - ms)
    U, _, Vt = np.linalg.svd(H)
    det = np.linalg.det(U) * np.linalg.det(Vt)
    S = np.broadcast_to(np.eye(3), (n_iters, 3, 3)).copy()
    S[:, 2, 2] = det
    R = (U @ S @ Vt).astype(np.float32)    # [B, 3, 3]
    t = mt[:, 0] - np.einsum("bij,bj->bi", R, ms[:, 0])
    thr2 = np.float32(inlier_thr) ** 2

    def _counts(Rb, tb, pts_s, pts_t):
        pred = np.matmul(pts_s, Rb.transpose(0, 2, 1)) + tb[:, None]
        diff = pred - pts_t[None]
        return ((diff * diff).sum(-1) < thr2, None)[0]

    if n > 128:
        sub = rng.choice(n, 128, replace=False)
        cnt_s = _counts(R, t, src32[sub], tgt32[sub]).sum(1)
        top = np.argpartition(-cnt_s, min(64, n_iters - 1))[:64]
    else:
        top = np.arange(n_iters)
    inl = _counts(R[top], t[top], src32, tgt32)
    j = int(np.argmax(inl.sum(1)))
    best_inl = inl[j]
    if best_inl.sum() >= sample_size:
        R, t = _kabsch(src_pts[best_inl], tgt_pts[best_inl])
    else:
        R, t = np.eye(3), np.zeros(3)
    return R, t, best_inl


def to_transform(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def _mat2quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def transformation_error(trans: np.ndarray, info: np.ndarray) -> float:
    """Covariance-weighted RMSE approximation of a relative transform error
    (``lepard/loss.py:25-43``, redwood-data convention).

    trans: residual 4x4 transform (pred^-1 @ gt); info: 6x6 covariance.
    """
    t = trans[:3, 3]
    q = _mat2quat(trans[:3, :3])
    er = np.concatenate([t, q[1:]])
    return float(er @ info @ er / info[0, 0])


def registration_recall(pred_transforms: list[np.ndarray],
                        gt_transforms: list[np.ndarray],
                        infos: list[np.ndarray],
                        threshold: float = 0.2 ** 2) -> float:
    """Fraction of pairs whose weighted transform error is below threshold
    (3DMatch registration-recall convention)."""
    ok = 0
    for pred, gt, info in zip(pred_transforms, gt_transforms, infos):
        residual = np.linalg.inv(pred) @ gt
        if transformation_error(residual, info) < threshold:
            ok += 1
    return ok / max(len(pred_transforms), 1)
