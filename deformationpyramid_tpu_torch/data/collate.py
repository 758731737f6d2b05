"""Host-side KPConv input-pyramid construction (collate).

Numpy/scipy re-design of the reference collate
(``correspondence/datasets/dataloader.py:362-637``) and its
C++ helpers (grid subsampling ``cpp_wrappers/cpp_subsampling``, radius
neighbors ``cpp_wrappers/cpp_neighbors``). Semantics preserved:

* voxel-grid **barycenter** subsampling with cell size doubling per strided
  layer (dl = 2 * r_normal / conv_radius),
* fixed-radius neighbors, distance-ordered, truncated at the calibrated
  ``neighborhood_limits``, with the shadow index == len(supports) (scipy's
  KDTree missing-neighbor convention matches the reference's shadow row),
* per-pair stacking [src ; tgt] with per-level length bookkeeping,
* neighborhood calibration by the 80th-percentile histogram rule
  (``dataloader.py:609-637``).

Every level can be padded to static bucket sizes, so that outputs compare
row for row with the JAX package's.

A copy of ``deformationpyramid_tpu/data/collate.py``, held bit-identical
to it by ``tests/test_torch_match_collate.py`` and
``tests/test_torch_native_collate.py``. As there, the stacked helpers
(:func:`batch_grid_subsample`, :func:`batch_radius_search`) run the native
C++ library (the port's own, ``native/``) by default; the numpy + scipy
functions stay, and a caller selects them by making :func:`_native` return
None. Unlike the JAX package, a native library that does not build raises
instead of falling back. Host code, as there; :func:`pyramid_to_device`
moves a built pyramid onto the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..match.kpconv import KPConvConfig


def grid_subsample(points: np.ndarray, dl: float,
                   features: np.ndarray | None = None):
    """Voxel-grid barycenter subsampling (one cloud).

    Returns (sub_points [M, 3], sub_features or None). Deterministic: voxels
    ordered by first occurrence, matching a stable insertion-order hash map.
    """
    vox = np.floor(points / dl).astype(np.int64)
    # unique voxel rows, first-occurrence order
    _, first_idx, inverse = np.unique(
        vox, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    groups = rank[inverse]                      # voxel id per point, ordered
    m = len(first_idx)
    counts = np.bincount(groups, minlength=m).astype(np.float64)
    sub = np.stack([np.bincount(groups, weights=points[:, d], minlength=m)
                    for d in range(points.shape[1])], axis=1)
    sub = (sub / counts[:, None]).astype(np.float32)
    if features is not None:
        f = np.stack([np.bincount(groups, weights=features[:, d], minlength=m)
                      for d in range(features.shape[1])], axis=1)
        return sub, (f / counts[:, None]).astype(np.float32)
    return sub, None


def _native():
    """The native library, the stacked helpers' default path (built at first
    use; a failed build raises); None selects the numpy path."""
    from .. import native
    return native


def batch_grid_subsample(points: np.ndarray, lengths: np.ndarray, dl: float):
    """Subsample each stacked cloud independently (reference ``:14-52``)."""
    nat = _native()
    subs, new_lengths = [], []
    i0 = 0
    for n in lengths:
        if nat is not None:
            s = nat.grid_subsample(points[i0:i0 + n], dl)
        else:
            s, _ = grid_subsample(points[i0:i0 + n], dl)
        subs.append(s)
        new_lengths.append(len(s))
        i0 += n
    return np.concatenate(subs, axis=0), np.array(new_lengths, np.int64)


def radius_search(queries: np.ndarray, supports: np.ndarray, radius: float,
                  max_k: int) -> np.ndarray:
    """Distance-ordered fixed-radius neighbors, shadow = len(supports).

    [Nq, max_k] int64. scipy's cKDTree.query returns index n for missing
    neighbors — exactly the shadow convention.
    """
    if len(supports) == 0:
        return np.full((len(queries), max_k), 0, np.int64)
    tree = cKDTree(supports)
    k = min(max_k, len(supports))
    dist, idx = tree.query(queries, k=k, distance_upper_bound=radius)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    idx = idx.astype(np.int64)
    if k < max_k:
        pad = np.full((len(queries), max_k - k), len(supports), np.int64)
        idx = np.concatenate([idx, pad], axis=1)
    return idx


def batch_radius_search(queries, q_lengths, supports, s_lengths, radius, max_k):
    """Per-cloud radius search on stacked arrays with global indices."""
    nat = _native()
    out = []
    qi = si = 0
    n_total = int(np.sum(s_lengths))
    for qn, sn in zip(q_lengths, s_lengths):
        if nat is not None:
            idx = nat.radius_neighbors(queries[qi:qi + qn],
                                       supports[si:si + sn], radius, max_k)
        else:
            idx = radius_search(queries[qi:qi + qn], supports[si:si + sn],
                                radius, max_k)
        shadow = idx >= sn
        idx = idx + si
        idx[shadow] = n_total           # global shadow row
        out.append(idx)
        qi += qn
        si += sn
    return np.concatenate(out, axis=0)


@dataclasses.dataclass
class PairPyramid:
    """Padded per-pair KPConv input pyramid (stacked [src ; tgt])."""

    points: list[np.ndarray]      # [L][N_l, 3]
    valids: list[np.ndarray]      # [L][N_l] bool
    neighbors: list[np.ndarray]   # [L][N_l, K_l]
    pools: list[np.ndarray]       # [L-1][N_{l+1}, K_l]
    upsamples: list[np.ndarray]   # [L-1][N_l, K_{l+1}]
    features: np.ndarray          # [N_0, C_in]
    src_lengths: list[int]        # per level
    tgt_lengths: list[int]


def pow2_cap(n: int, minimum: int = 512) -> int:
    """The power-of-two bucket (at least ``minimum``) that holds n rows: the
    JAX package's eval-suite pads and coarse caps."""
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def _layer_schedule(architecture: list[str]) -> list[dict]:
    """Which layers need conv neighbors / pooling, mirroring the collate loop."""
    sched = []
    layer_blocks: list[str] = []
    for block_i, block in enumerate(architecture):
        if "global" in block or "upsample" in block:
            break
        if not ("pool" in block or "strided" in block):
            layer_blocks.append(block)
            if block_i < len(architecture) - 1 and "upsample" not in architecture[block_i + 1]:
                continue
        sched.append({
            "conv": bool(layer_blocks),
            "deform_conv": any("deformable" in b for b in layer_blocks[:-1]),
            "pool": ("pool" in block or "strided" in block),
            "deform_pool": "deformable" in block,
        })
        layer_blocks = []
    return sched


def build_pair_pyramid(src: np.ndarray, tgt: np.ndarray, cfg: KPConvConfig,
                       architecture: list[str],
                       neighborhood_limits: list[int],
                       pad_to: list[int] | str | None = None) -> PairPyramid:
    """Build the stacked input pyramid for one (src, tgt) pair.

    ``pad_to`` optionally pads each level's point count to a static size
    (the JAX package needs it for jit); neighbor tables are padded with
    shadow indices. ``pad_to="pow2"`` computes doubling-bucket pads
    (min 512) internally: padding is pure post-processing on the built
    tables, so this costs one radius-search/subsample pass.
    """
    points = np.concatenate([src, tgt]).astype(np.float32)
    lengths = np.array([len(src), len(tgt)], np.int64)
    r_normal = cfg.first_subsampling_dl * cfg.conv_radius
    sched = _layer_schedule(architecture)

    lv_points, lv_neighbors, lv_pools, lv_ups, lv_lengths = [], [], [], [], []
    for layer, s in enumerate(sched):
        max_k = neighborhood_limits[layer]
        if s["conv"]:
            r = r_normal * (cfg.deform_radius / cfg.conv_radius
                            if s["deform_conv"] else 1.0)
            conv_i = batch_radius_search(points, lengths, points, lengths,
                                         r, max_k)
        else:
            conv_i = np.zeros((len(points), 1), np.int64)
        if s["pool"]:
            dl = 2 * r_normal / cfg.conv_radius
            pool_p, pool_b = batch_grid_subsample(points, lengths, dl)
            r = r_normal * (cfg.deform_radius / cfg.conv_radius
                            if s["deform_pool"] else 1.0)
            pool_i = batch_radius_search(pool_p, pool_b, points, lengths,
                                         r, max_k)
            up_i = batch_radius_search(points, lengths, pool_p, pool_b,
                                       2 * r, max_k)
        else:
            pool_i = np.zeros((0, 1), np.int64)
            pool_p = np.zeros((0, 3), np.float32)
            pool_b = np.zeros((2,), np.int64)
            up_i = np.zeros((0, 1), np.int64)
        lv_points.append(points)
        lv_neighbors.append(conv_i)
        lv_pools.append(pool_i)
        lv_ups.append(up_i)
        lv_lengths.append(lengths)
        points, lengths = pool_p, pool_b
        r_normal *= 2

    n_levels = len(lv_points)
    src_lengths = [int(l[0]) for l in lv_lengths]
    tgt_lengths = [int(l[1]) for l in lv_lengths]

    # ---- pad to static sizes ----
    if pad_to is None:
        pad_to = [len(p) for p in lv_points]
    elif pad_to == "pow2":
        pad_to = [pow2_cap(len(p)) for p in lv_points]
    valids = []
    for l in range(n_levels):
        n, target = len(lv_points[l]), pad_to[l]
        assert target >= n, f"level {l}: {n} > pad {target}"
        valids.append(np.arange(target) < n)
        lv_points[l] = np.concatenate(
            [lv_points[l], np.full((target - n, 3), 1e6, np.float32)])

    # remap shadows: original shadow index == true count; after padding the
    # shadow must be the padded size (the appended far-row index).
    # Tables ship as int32: the neighbor/pool/upsample matrices are the
    # bulk of the per-pair host->device bytes, and point counts are far
    # below 2^31.
    for l in range(n_levels):
        true_n = src_lengths[l] + tgt_lengths[l]
        nb = lv_neighbors[l]
        nb = np.where(nb >= true_n, pad_to[l], nb)
        out = np.full((pad_to[l], nb.shape[1]), pad_to[l], np.int32)
        out[:len(nb)] = nb
        lv_neighbors[l] = out
        if l < n_levels - 1 and lv_pools[l].shape[0] > 0:
            true_next = src_lengths[l + 1] + tgt_lengths[l + 1]
            pl = np.where(lv_pools[l] >= true_n, pad_to[l], lv_pools[l])
            outp = np.full((pad_to[l + 1], pl.shape[1]), pad_to[l], np.int32)
            outp[:len(pl)] = pl
            lv_pools[l] = outp
            up = np.where(lv_ups[l] >= true_next, pad_to[l + 1], lv_ups[l])
            outu = np.full((pad_to[l], up.shape[1]), pad_to[l + 1], np.int32)
            outu[:len(up)] = up
            lv_ups[l] = outu

    feats = np.ones((pad_to[0], cfg.in_feats_dim), np.float32)
    feats[~valids[0]] = 0.0

    return PairPyramid(points=lv_points, valids=valids,
                       neighbors=lv_neighbors,
                       pools=lv_pools[:-1] if n_levels > 1 else [],
                       upsamples=lv_ups[:-1] if n_levels > 1 else [],
                       features=feats,
                       src_lengths=src_lengths, tgt_lengths=tgt_lengths)


def calibrate_neighborhood_limits(clouds: list[tuple[np.ndarray, np.ndarray]],
                                  cfg: KPConvConfig, architecture: list[str],
                                  keep_ratio: float = 0.8,
                                  untruncated_cap: int = 200) -> list[int]:
    """80th-percentile neighbor-count calibration (``dataloader.py:609-637``).

    Runs uncapped pyramids over sample pairs, histograms neighbor counts per
    layer, returns the count covering ``keep_ratio`` of points.
    """
    sched = _layer_schedule(architecture)
    n_layers = len(sched)
    hists = [np.zeros(untruncated_cap, np.int64) for _ in range(n_layers)]
    for src, tgt in clouds:
        points = np.concatenate([src, tgt]).astype(np.float32)
        lengths = np.array([len(src), len(tgt)], np.int64)
        r_normal = cfg.first_subsampling_dl * cfg.conv_radius
        for layer, s in enumerate(sched):
            idx = batch_radius_search(points, lengths, points, lengths,
                                      r_normal, untruncated_cap)
            n_total = int(np.sum(lengths))
            counts = np.sum(idx < n_total, axis=1)
            hists[layer] += np.bincount(np.minimum(counts, untruncated_cap - 1),
                                        minlength=untruncated_cap)
            if s["pool"]:
                dl = 2 * r_normal / cfg.conv_radius
                points, lengths = batch_grid_subsample(points, lengths, dl)
            r_normal *= 2
    limits = []
    for h in hists:
        cum = np.cumsum(h)
        total = cum[-1] if cum[-1] > 0 else 1
        limits.append(int(np.searchsorted(cum, keep_ratio * total)) + 1)
    return limits


def pyramid_to_device(pyr: PairPyramid,
                      device: torch.device | str | None = None) -> dict:
    """The dict of tensors that ``match.backbone.apply_kpfcn_coarse`` takes:
    points, valids, neighbors, pools, upsamples (lists per level) and
    features, on ``device`` (the GPU unless the caller names another). The
    index tables become int64, the type PyTorch's gathers take."""
    device = torch.device("cuda" if device is None else device)

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        return t.to(device)

    return {"points": [put(p) for p in pyr.points],
            "valids": [put(v) for v in pyr.valids],
            "neighbors": [put(x) for x in pyr.neighbors],
            "pools": [put(x) for x in pyr.pools],
            "upsamples": [put(x) for x in pyr.upsamples],
            "features": put(pyr.features)}
