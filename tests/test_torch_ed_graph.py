"""The port's host copies for the ED / N-ICP path (``data/graph.py``,
``geometry/camera.py``) bit-identical to the JAX package's, and its ED
geometry (``geometry/kabsch.py``: ``ed_warp``, ``rigid_fit``;
``losses.arap_cost``) against the JAX functions, on the CPU.

Tolerances: the copies bit for bit (every array equal, dtype included);
``ed_warp`` and ``arap_cost`` 1e-6; ``rigid_fit`` R and t 1e-5 (U and V
are compared never: the SVD's sign conventions differ between libraries).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deformationpyramid_tpu import losses as jlosses
from deformationpyramid_tpu.data import graph as jgraph
from deformationpyramid_tpu.geometry import camera as jcam
from deformationpyramid_tpu.geometry import kabsch as jkabsch
from deformationpyramid_tpu_torch import losses as tlosses
from deformationpyramid_tpu_torch.data import graph as tgraph
from deformationpyramid_tpu_torch.geometry import camera as tcam
from deformationpyramid_tpu_torch.geometry import kabsch as tkabsch

K = np.array([[80.0, 0, 30], [0, 80.0, 25], [0, 0, 1]])


def _depth_mm(island=False):
    """``tests/test_eval_ed.py``'s synthetic depth map (50 x 60, mm); with
    ``island`` a small far patch whose nodes have too few neighbours, so
    that the clean-up deletes nodes and remaps ids."""
    h, w = 50, 60
    yy, xx = np.mgrid[0:h, 0:w]
    depth = 1.0 + 0.04 * np.sin(xx / 6.0) * np.cos(yy / 8.0)
    if island:
        depth[:, 40:] = 0.0
        depth[20:27, 48:55] = 1.6
    return (depth * 1000).astype(np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("remove", [True, False])
@pytest.mark.parametrize("island", [False, True])
def test_deformation_graph_copy_is_bit_identical(remove, island):
    kw = dict(max_triangle_distance=0.1, node_coverage=0.12,
              n_max_neighbors=6, remove_sparse_nodes=remove)
    ref = jgraph.build_deformation_graph_from_depth(_depth_mm(island), K, **kw)
    secs = {}
    got = tgraph.build_deformation_graph_from_depth(_depth_mm(island), K,
                                                    seconds=secs, **kw)
    for field in ("nodes", "node_indices", "edges", "edge_weights",
                  "edges_valid", "point_anchors", "anchor_weights",
                  "vertices", "vertex_pixels", "clusters"):
        _equal(getattr(got, field), getattr(ref, field))
    assert set(secs) == {"mesh", "nodes", "dijkstra", "anchors"}
    if island:                  # the island's node has no edge
        assert bool(remove) == bool(got.edges_valid.sum(1).min() > 0)


def test_graph_helpers_are_bit_identical():
    rng = np.random.default_rng(0)
    nodes = rng.uniform(-0.3, 0.3, (40, 3)).astype(np.float32)
    img = np.concatenate([rng.uniform(-0.3, 0.3, (12, 16, 2)),
                          rng.uniform(0.0, 1.0, (12, 16, 1))], -1)
    img[img[..., 2] < 0.2, 2] = 0.0
    img = img.astype(np.float32)
    _equal(tgraph.compute_edges_euclidean(nodes, 6, 0.05),
           jgraph.compute_edges_euclidean(nodes, 6, 0.05))
    pairs = [(tgraph.compute_pixel_anchors_euclidean(nodes, img, 0.1, 4, 50),
              jgraph.compute_pixel_anchors_euclidean(nodes, img, 0.1, 4, 50)),
             (tgraph.construct_regular_graph(img, 5, 4, 0.5, 0.4, 0.9),
              jgraph.construct_regular_graph(img, 5, 4, 0.5, 0.4, 0.9))]
    for got, ref in pairs:
        for x, y in zip(got, ref):
            _equal(x, y)
    keep = rng.random(40) > 0.3
    mapping = tgraph.node_id_mapping_from_mask(keep)
    _equal(mapping, jgraph.node_id_mapping_from_mask(keep))
    anchors = rng.integers(-1, 40, (30, 4))
    _equal(tgraph.update_pixel_anchors(mapping, anchors),
           jgraph.update_pixel_anchors(mapping, anchors))


def test_camera_copy_is_bit_identical():
    depth = _depth_mm() / 1000.0
    _equal(tcam.depth_to_pointcloud(depth, K), jcam.depth_to_pointcloud(depth, K))
    pts = tcam.depth_to_pointcloud(depth, K).reshape(3, -1).T.astype(np.float32)
    _equal(tcam.pointcloud_to_uv(pts, K), jcam.pointcloud_to_uv(pts, K))
    mask = np.random.default_rng(1).random((50, 60)) > 0.4
    _equal(tcam.map_pixel_to_pcd(mask), jcam.map_pixel_to_pcd(mask))


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], 1).reshape(n, 3, 3).astype(np.float32)


def test_ed_warp_and_arap_cost_match_jax():
    rng = np.random.default_rng(2)
    n, k, m, e = 300, 4, 25, 6
    x = rng.normal(size=(n, 3)).astype(np.float32)
    g = rng.normal(size=(n, k, 3)).astype(np.float32)
    R = _rot(rng, n * k).reshape(n, k, 3, 3)
    t = (rng.normal(size=(n, k, 3)) * 0.1).astype(np.float32)
    w = rng.random((n, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    ref = jkabsch.ed_warp(*map(jnp.asarray, (x, g, R, t, w)))
    got = tkabsch.ed_warp(*map(torch.from_numpy, (x, g, R, t, w)))
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) <= 1e-6

    Rn = _rot(rng, m)
    tn = (rng.normal(size=(m, 3)) * 0.1).astype(np.float32)
    gn = rng.normal(size=(m, 3)).astype(np.float32)
    edges = rng.integers(0, m, (m, e))
    ew = rng.random((m, e)).astype(np.float32)
    ev = rng.random((m, e)) > 0.3
    for valid in (None, ev):
        ref = jlosses.arap_cost(*map(jnp.asarray, (Rn, tn, gn, edges, ew)),
                                e_valid=None if valid is None
                                else jnp.asarray(valid))
        got = tlosses.arap_cost(*map(torch.from_numpy, (Rn, tn, gn, edges, ew)),
                                e_valid=None if valid is None
                                else torch.from_numpy(valid))
        assert abs(float(got) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref)))


def test_rigid_fit_matches_jax():
    rng = np.random.default_rng(3)
    b, n = 4, 200
    X = rng.normal(size=(b, n, 3)).astype(np.float32)
    R = _rot(rng, b)
    t = rng.normal(size=(b, 1, 3)).astype(np.float32)
    Y = (X @ R.transpose(0, 2, 1) + t
         + rng.normal(0, 0.01, (b, n, 3))).astype(np.float32)
    w = rng.random((b, n, 1)).astype(np.float32)
    jR, jt = jkabsch.rigid_fit(*map(jnp.asarray, (X, Y, w)))
    tR, tt = tkabsch.rigid_fit(*map(torch.from_numpy, (X, Y, w)))
    assert tR.shape == (b, 3, 3) and tt.shape == (b, 3, 1)
    assert float(np.abs(tR.numpy() - np.asarray(jR)).max()) <= 1e-5
    assert float(np.abs(tt.numpy() - np.asarray(jt)).max()) <= 1e-5
    assert float(np.abs(tR.numpy() - R).max()) < 0.01
    assert np.allclose(np.linalg.det(tR.numpy()), 1.0, atol=1e-5)
