"""Deformation-graph construction from depth maps (ED / N-ICP baseline).

A numpy / scipy copy of ``deformationpyramid_tpu/data/graph.py`` (the port
imports nothing of the JAX package; a CPU test holds the copy
bit-identical), itself a re-design of the reference MVRegC C++ module
(``cxx/cpu/image_proc.cpp:56-198``, ``graph_proc.cpp``):
depth -> triangle mesh -> erosion -> node sampling -> geodesic edges ->
per-point anchors + skinning weights.

All functions run on the host (irregular, data-dependent shapes); the
resulting fixed-K arrays feed the ED solver
(``solve/baselines.register_ed``). Two parts are slow at a full 480 x 640
depth map and are kept as they are until a measurement asks otherwise:
``sample_nodes`` is a Python loop over every valid vertex, and
``compute_edges_geodesic`` keeps a dense [nodes, vertices] float64 distance
matrix (``cli/eval_ed.py`` times the build's parts).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components, dijkstra

from ..geometry.camera import depth_to_pointcloud


@dataclasses.dataclass
class DeformationGraph:
    nodes: np.ndarray           # [M, 3]
    node_indices: np.ndarray    # [M] vertex index of each node
    edges: np.ndarray           # [M, E] neighbor node ids (-pad with self)
    edge_weights: np.ndarray    # [M, E]
    edges_valid: np.ndarray     # [M, E] bool
    point_anchors: np.ndarray   # [N, K] node ids per mesh vertex
    anchor_weights: np.ndarray  # [N, K] normalized skinning weights
    vertices: np.ndarray        # [N, 3] (eroded mesh vertices)
    vertex_pixels: np.ndarray   # [N, 2] (u, v) per vertex
    clusters: np.ndarray | None = None  # [M] connected-component label


def depth_to_mesh(depth: np.ndarray, intrinsics: np.ndarray,
                  max_triangle_distance: float = 0.06,
                  depth_scale: float = 1.0):
    """Triangulate adjacent valid depth pixels (2 triangles per quad) with a
    max-edge-length filter (``image_proc.cpp:56-198``).

    Returns (vertices [N,3], faces [F,3], vertex_pixels [N,2]).
    """
    d = depth.astype(np.float64) / depth_scale
    h, w = d.shape
    valid = d > 0
    pc = depth_to_pointcloud(d, intrinsics)            # [3, H, W]
    vid = np.full((h, w), -1, np.int64)
    vid[valid] = np.arange(valid.sum())
    vv, uu = np.nonzero(valid)
    vertices = pc[:, vv, uu].T.astype(np.float32)
    vertex_pixels = np.stack([uu, vv], 1).astype(np.int64)

    # quad corners: (y,x) (y,x+1) (y+1,x) (y+1,x+1)
    a = vid[:-1, :-1]
    b = vid[:-1, 1:]
    c = vid[1:, :-1]
    e = vid[1:, 1:]
    P = np.transpose(pc, (1, 2, 0))

    def edge_ok(p, q):
        return np.linalg.norm(p - q, axis=-1) <= max_triangle_distance

    pa, pb, pc_, pe = P[:-1, :-1], P[:-1, 1:], P[1:, :-1], P[1:, 1:]
    # triangle 1: (a, b, c); triangle 2: (b, e, c) — standard quad split
    t1_ok = (a >= 0) & (b >= 0) & (c >= 0) & \
        edge_ok(pa, pb) & edge_ok(pa, pc_) & edge_ok(pb, pc_)
    t2_ok = (b >= 0) & (e >= 0) & (c >= 0) & \
        edge_ok(pb, pe) & edge_ok(pb, pc_) & edge_ok(pe, pc_)
    f1 = np.stack([a[t1_ok], b[t1_ok], c[t1_ok]], 1)
    f2 = np.stack([b[t2_ok], e[t2_ok], c[t2_ok]], 1)
    faces = np.concatenate([f1, f2]).astype(np.int64)
    return vertices, faces, vertex_pixels


def _vertex_adjacency(n_vertices: int, faces: np.ndarray) -> csr_matrix:
    i = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2],
                        faces[:, 1], faces[:, 2], faces[:, 0]])
    j = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0],
                        faces[:, 0], faces[:, 1], faces[:, 2]])
    w = np.ones(len(i))
    adj = csr_matrix((w, (i, j)), shape=(n_vertices, n_vertices))
    adj.sum_duplicates()
    adj.data[:] = 1.0
    return adj


def erode_mesh(vertices: np.ndarray, faces: np.ndarray,
               n_iterations: int = 4, min_neighbors: int = 4) -> np.ndarray:
    """Iteratively mark boundary-ish vertices invalid
    (``graph_proc.cpp:16-79``). Returns a bool keep-mask over vertices."""
    n = len(vertices)
    adj = _vertex_adjacency(n, faces)
    keep = np.ones(n, bool)
    for _ in range(n_iterations):
        counts = adj.dot(keep.astype(np.float64))
        new_keep = keep & (counts >= min_neighbors)
        if (new_keep == keep).all():
            break
        keep = new_keep
    return keep


def sample_nodes(vertices: np.ndarray, valid: np.ndarray,
                 node_coverage: float = 0.05,
                 random_shuffle: bool = False, seed: int = 0) -> np.ndarray:
    """Coverage sampling: greedily take vertices farther than
    ``node_coverage`` from every chosen node (``graph_proc.cpp:81-143``).
    Returns vertex indices of the nodes."""
    order = np.nonzero(valid)[0]
    if random_shuffle:
        order = np.random.default_rng(seed).permutation(order)
    nodes: list[int] = []
    node_pos = np.zeros((0, 3), np.float32)
    cov2 = node_coverage ** 2
    for vi in order:
        p = vertices[vi]
        if len(nodes) == 0 or np.min(
                np.sum((node_pos - p) ** 2, axis=1)) > cov2:
            nodes.append(int(vi))
            node_pos = np.vstack([node_pos, p[None]])
    return np.array(nodes, np.int64)


def _mesh_edge_graph(vertices: np.ndarray, faces: np.ndarray) -> csr_matrix:
    i = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    j = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    d = np.linalg.norm(vertices[i] - vertices[j], axis=1)
    g = csr_matrix((np.concatenate([d, d]),
                    (np.concatenate([i, j]), np.concatenate([j, i]))),
                   shape=(len(vertices), len(vertices)))
    g.sum_duplicates()
    return g


def compute_edges_geodesic(vertices: np.ndarray, faces: np.ndarray,
                           node_indices: np.ndarray, n_max_neighbors: int = 8,
                           node_coverage: float = 0.05):
    """Geodesic kNN edges between nodes + node->vertex distances
    (``graph_proc.cpp:161-310``).

    Returns (edges [M,E], edge_weights [M,E], edges_valid [M,E],
    node_to_vertex_dist [M,N]).
    """
    g = _mesh_edge_graph(vertices, faces)
    dist = dijkstra(g, directed=False, indices=node_indices)  # [M, N]
    m = len(node_indices)
    node_dist = dist[:, node_indices]                        # [M, M]
    np.fill_diagonal(node_dist, np.inf)
    order = np.argsort(node_dist, axis=1)[:, :n_max_neighbors]
    nd = np.take_along_axis(node_dist, order, axis=1)
    valid = np.isfinite(nd)
    edges = np.where(valid, order, np.arange(m)[:, None])
    # skinning weight per edge: exp(-d^2 / (2 sigma^2)), sigma=node_coverage
    # (graph_proc.cpp compute_anchor_weight:153-158)
    w = np.where(valid, np.exp(-nd ** 2 / (2 * node_coverage ** 2)), 0.0)
    return edges.astype(np.int64), w.astype(np.float32), valid, dist


def compute_pixel_anchors_geodesic(node_to_vertex_dist: np.ndarray,
                                   n_anchors: int = 4,
                                   node_coverage: float = 0.05):
    """Per-vertex K nearest nodes by geodesic distance + normalized weights
    (``graph_proc.cpp:556-641``). Returns (anchors [N,K], weights [N,K]).
    Vertices unreachable from any node get anchor 0 / weight uniform."""
    d = node_to_vertex_dist.T                         # [N, M]
    order = np.argsort(d, axis=1)[:, :n_anchors]
    nd = np.take_along_axis(d, order, axis=1)
    valid = np.isfinite(nd)
    w = np.where(valid, np.exp(-nd ** 2 / (2 * node_coverage ** 2)), 0.0)
    wsum = w.sum(1, keepdims=True)
    uniform = np.full_like(w, 1.0 / n_anchors)
    w = np.where(wsum > 1e-12, w / np.maximum(wsum, 1e-12), uniform)
    anchors = np.where(valid, order, 0)
    return anchors.astype(np.int64), w.astype(np.float32)


def compute_edges_euclidean(node_positions: np.ndarray,
                            n_max_neighbors: int = 8,
                            max_influence: float = 0.05) -> np.ndarray:
    """Euclidean kNN edges between nodes, -1 padded
    (``graph_proc.cpp:312-407``).

    Reference quirk kept: the cutoff compares the SQUARED distance against
    ``max_influence`` un-squared (``graph_proc.cpp:338-340``), so the
    effective radius is sqrt(max_influence); the call site passes 0.05
    (``model/geometry.py:222``).
    """
    m = len(node_positions)
    k = min(n_max_neighbors, max(m - 1, 0))
    d2 = ((node_positions[:, None] - node_positions[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    d2[d2 > max_influence] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    nd2 = np.take_along_axis(d2, order, axis=1)
    edges = np.full((m, n_max_neighbors), -1, np.int64)
    edges[:, :k] = np.where(np.isfinite(nd2), order, -1)
    return edges


def compute_pixel_anchors_euclidean(nodes: np.ndarray, point_image: np.ndarray,
                                    node_coverage: float = 0.05,
                                    n_anchors: int = 4,
                                    chunk: int = 4096):
    """Per-pixel K nearest nodes by euclidean distance + skinning weights
    (``graph_proc.cpp:643-742``).

    ``point_image`` is [H, W, 3]; pixels with z <= 0 get anchors -1 /
    weights 0. Weights are exp(-d^2 / 2 sigma^2) normalized per pixel
    (uniform fallback when the sum underflows, ``graph_proc.cpp:728-734``).
    Returns (anchors [H, W, K] int, weights [H, W, K] float32).
    """
    h, w, _ = point_image.shape
    pts = point_image.reshape(-1, 3)
    valid = pts[:, 2] > 0
    n = len(pts)
    k = min(n_anchors, len(nodes))
    anchors = np.full((n, n_anchors), -1, np.int64)
    weights = np.zeros((n, n_anchors), np.float32)
    idx_valid = np.nonzero(valid)[0]
    for s in range(0, len(idx_valid), chunk):
        rows = idx_valid[s:s + chunk]
        d2 = ((pts[rows, None] - nodes[None]) ** 2).sum(-1)
        order = np.argsort(d2, axis=1, kind="stable")[:, :k]
        nd2 = np.take_along_axis(d2, order, axis=1)
        wgt = np.exp(-nd2 / (2.0 * node_coverage ** 2))
        wsum = wgt.sum(1, keepdims=True)
        wgt = np.where(wsum > 0, wgt / np.maximum(wsum, 1e-24), 1.0 / k)
        anchors[rows, :k] = order
        weights[rows, :k] = wgt
    return anchors.reshape(h, w, n_anchors), weights.reshape(h, w, n_anchors)


def update_pixel_anchors(node_id_mapping: np.ndarray,
                         pixel_anchors: np.ndarray) -> np.ndarray:
    """Remap anchor node ids after node deletion
    (``graph_proc.cpp:967-994``); -1 anchors stay -1.

    ``node_id_mapping`` is old-id -> new-id (-1 for deleted nodes).
    """
    mapping = np.asarray(node_id_mapping, np.int64)
    return np.where(pixel_anchors >= 0,
                    mapping[np.clip(pixel_anchors, 0, len(mapping) - 1)],
                    -1).astype(pixel_anchors.dtype)


def node_id_mapping_from_mask(keep: np.ndarray) -> np.ndarray:
    """old-id -> new-id array for a keep-mask; deleted nodes map to -1
    (``model/geometry.py:273-282``)."""
    mapping = np.full(len(keep), -1, np.int64)
    mapping[keep] = np.arange(int(keep.sum()))
    return mapping


def remap_edges_after_cleanup(edges: np.ndarray, edge_weights: np.ndarray,
                              edges_valid: np.ndarray, keep: np.ndarray):
    """Drop deleted nodes' rows, pack surviving neighbors left with remapped
    ids, renormalize each row's weights to sum 1
    (``model/geometry.py:284-318``).

    Returns (edges, edge_weights, edges_valid) over the kept nodes.
    """
    mapping = node_id_mapping_from_mask(keep)
    m_new = int(keep.sum())
    e = edges[keep]
    w = edge_weights[keep]
    v = edges_valid[keep]
    k = e.shape[1]
    out_e = np.full((m_new, k), -1, np.int64)
    out_w = np.zeros((m_new, k), np.float32)
    for row in range(m_new):
        ok = v[row] & keep[e[row]]
        ids = mapping[e[row][ok]]
        out_e[row, :len(ids)] = ids
        out_w[row, :len(ids)] = w[row][ok]
        s = out_w[row].sum()
        if s > 0:
            out_w[row] /= s
    out_v = out_e >= 0
    # pad invalid slots with self-loops (keeps downstream gathers in range)
    out_e = np.where(out_v, out_e, np.arange(m_new)[:, None])
    return out_e, out_w, out_v


def construct_regular_graph(point_image: np.ndarray, x_nodes: int,
                            y_nodes: int, edge_threshold: float,
                            max_point_to_node_distance: float,
                            max_depth: float):
    """Regular image-grid deformation graph (``graph_proc.cpp:744-965``).

    ``point_image`` is [H, W, 3]. Nodes sit on an x_nodes x y_nodes grid
    (nearest-pixel positions), connected to their valid 8-neighborhood
    within ``edge_threshold``; nodes with no edges are dropped and ids
    remapped. Pixel anchors are the 4 cell corners with bilinear weights,
    valid only when all corners survive and lie within
    ``max_point_to_node_distance`` of the pixel.

    Returns (nodes [M,3], edges [M,8], pixel_anchors [H,W,4],
    pixel_weights [H,W,4]).
    """
    h, w, _ = point_image.shape
    x_step = (w - 1) / (x_nodes - 1)
    y_step = (h - 1) / (y_nodes - 1)

    gy, gx = np.meshgrid(np.arange(y_nodes), np.arange(x_nodes), indexing="ij")
    px = np.round(gx * x_step).astype(np.int64)
    py = np.round(gy * y_step).astype(np.int64)
    grid_pos = point_image[py, px]                        # [yN, xN, 3]
    sampled = (grid_pos[..., 2] > 0) & (grid_pos[..., 2] <= max_depth)
    # ids in C++ scan order (y-major) over sampled nodes
    sampled_id = np.full((y_nodes, x_nodes), -1, np.int64)
    sampled_id[sampled] = np.arange(int(sampled.sum()))
    n_sampled = int(sampled.sum())
    node_pos = grid_pos[sampled]                          # [nS, 3]

    edges_s = np.full((n_sampled, 8), -1, np.int64)
    counts = np.zeros(n_sampled, np.int64)
    thr2 = edge_threshold ** 2
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            ys, xs = np.nonzero(sampled)
            yn, xn = ys + dy, xs + dx
            ok = (yn >= 0) & (yn < y_nodes) & (xn >= 0) & (xn < x_nodes)
            src_ids = sampled_id[ys[ok], xs[ok]]
            nbr_ids = sampled_id[yn[ok], xn[ok]]
            ok2 = nbr_ids >= 0
            src_ids, nbr_ids = src_ids[ok2], nbr_ids[ok2]
            d2 = ((node_pos[src_ids] - node_pos[nbr_ids]) ** 2).sum(-1)
            ok3 = d2 <= thr2
            for s_id, n_id in zip(src_ids[ok3], nbr_ids[ok3]):
                edges_s[s_id, counts[s_id]] = n_id
                counts[s_id] += 1
    connected = counts > 0

    valid_map = np.full(n_sampled, -1, np.int64)
    valid_map[connected] = np.arange(int(connected.sum()))
    nodes = node_pos[connected].astype(np.float32)
    edges = np.where(edges_s[connected] >= 0,
                     valid_map[np.clip(edges_s[connected], 0, None)], -1)

    # Bilinear pixel anchors over the grid cell containing each pixel.
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x_node = xx / x_step
    y_node = yy / y_step
    x0 = np.floor(x_node).astype(np.int64)
    y0 = np.floor(y_node).astype(np.int64)
    x1, y1 = x0 + 1, y0 + 1
    in_grid = (x0 >= 0) & (x1 < x_nodes) & (y0 >= 0) & (y1 < y_nodes)
    x0c, x1c = np.clip(x0, 0, x_nodes - 1), np.clip(x1, 0, x_nodes - 1)
    y0c, y1c = np.clip(y0, 0, y_nodes - 1), np.clip(y1, 0, y_nodes - 1)

    s00 = sampled_id[y0c, x0c]
    s01 = sampled_id[y1c, x0c]
    s10 = sampled_id[y0c, x1c]
    s11 = sampled_id[y1c, x1c]
    corners_ok = in_grid & (s00 >= 0) & (s01 >= 0) & (s10 >= 0) & (s11 >= 0)
    v00 = np.where(corners_ok, valid_map[np.clip(s00, 0, None)], -1)
    v01 = np.where(corners_ok, valid_map[np.clip(s01, 0, None)], -1)
    v10 = np.where(corners_ok, valid_map[np.clip(s10, 0, None)], -1)
    v11 = np.where(corners_ok, valid_map[np.clip(s11, 0, None)], -1)
    corners_ok &= (v00 >= 0) & (v01 >= 0) & (v10 >= 0) & (v11 >= 0)

    pz = point_image[..., 2]
    pix_ok = corners_ok & (pz > 0) & (pz <= max_depth)
    max_d2 = max_point_to_node_distance ** 2
    for s_corner in (s00, s01, s10, s11):
        cpos = node_pos[np.clip(s_corner, 0, None)]
        d2 = ((point_image - cpos) ** 2).sum(-1)
        pix_ok &= d2 <= max_d2

    dx = x_node - x0
    dy = y_node - y0
    w00 = (1 - dx) * (1 - dy)
    w01 = (1 - dx) * dy
    w10 = dx * (1 - dy)
    w11 = dx * dy
    pixel_anchors = np.where(pix_ok[..., None],
                             np.stack([v00, v01, v10, v11], -1), -1)
    pixel_weights = np.where(pix_ok[..., None],
                             np.stack([w00, w01, w10, w11], -1),
                             0.0).astype(np.float32)
    return nodes, edges.astype(np.int64), pixel_anchors.astype(np.int64), \
        pixel_weights


def node_and_edge_clean_up(edges_valid: np.ndarray,
                           min_neighbors: int = 2) -> np.ndarray:
    """Keep-mask over nodes with >= min_neighbors valid edges
    (``graph_proc.cpp:409-459``)."""
    return edges_valid.sum(1) >= min_neighbors


def compute_clusters(edges: np.ndarray, edges_valid: np.ndarray) -> np.ndarray:
    """Connected components over the node graph (``graph_proc.cpp:461-554``)."""
    m = len(edges)
    i = np.repeat(np.arange(m), edges.shape[1])[edges_valid.reshape(-1)]
    j = edges.reshape(-1)[edges_valid.reshape(-1)]
    g = csr_matrix((np.ones(len(i)), (i, j)), shape=(m, m))
    _, labels = connected_components(g, directed=False)
    return labels


def build_deformation_graph_from_depth(depth: np.ndarray, intrinsics: np.ndarray,
                                       max_triangle_distance: float = 0.06,
                                       node_coverage: float = 0.05,
                                       n_max_neighbors: int = 8,
                                       n_anchors: int = 4,
                                       erosion_iters: int = 4,
                                       erosion_min_neighbors: int = 4,
                                       depth_scale: float = 1000.0,
                                       remove_sparse_nodes: bool = True,
                                       seconds: dict | None = None
                                       ) -> DeformationGraph:
    """The whole build (``model/geometry.py:155-387`` semantics).

    With ``remove_sparse_nodes`` (the reference's
    REMOVE_NODES_WITH_NOT_ENOUGH_NEIGHBORS path, ``geometry.py:231-327``):
    nodes with <2 valid edges are deleted, edges packed/renormalized with
    remapped ids, and point anchors recomputed over surviving nodes then
    remapped (``update_pixel_anchors``, ``geometry.py:327``).

    ``seconds`` (a dict), where given, receives the host time of the
    build's parts: ``mesh`` (triangulation and erosion), ``nodes``
    (``sample_nodes``), ``dijkstra`` (``compute_edges_geodesic``) and
    ``anchors`` (the rest).
    """
    t0 = time.perf_counter()
    vertices, faces, vertex_pixels = depth_to_mesh(
        depth, intrinsics, max_triangle_distance, depth_scale)
    keep_v = erode_mesh(vertices, faces, erosion_iters, erosion_min_neighbors)
    t1 = time.perf_counter()
    node_indices = sample_nodes(vertices, keep_v, node_coverage)
    if len(node_indices) == 0:
        raise ValueError("empty node set — depth map too sparse")
    t2 = time.perf_counter()
    edges, ew, evalid, n2v = compute_edges_geodesic(
        vertices, faces, node_indices, n_max_neighbors, node_coverage)
    nodes = vertices[node_indices]
    t3 = time.perf_counter()

    keep_n = node_and_edge_clean_up(evalid) if remove_sparse_nodes else \
        np.ones(len(node_indices), bool)
    if remove_sparse_nodes and not keep_n.all():
        # anchors see only surviving nodes (reference passes
        # valid_nodes_mask into compute_pixel_anchors_geodesic,
        # geometry.py:246), then ids are remapped to the packed range
        n2v_masked = np.where(keep_n[:, None], n2v, np.inf)
        anchors, aw = compute_pixel_anchors_geodesic(
            n2v_masked, n_anchors, node_coverage)
        anchors = update_pixel_anchors(node_id_mapping_from_mask(keep_n),
                                       anchors)
        edges, ew, evalid = remap_edges_after_cleanup(edges, ew, evalid,
                                                      keep_n)
        nodes = nodes[keep_n]
        node_indices = node_indices[keep_n]
    else:
        anchors, aw = compute_pixel_anchors_geodesic(n2v, n_anchors,
                                                     node_coverage)

    clusters = compute_clusters(edges, evalid)
    if seconds is not None:
        seconds.update(mesh=t1 - t0, nodes=t2 - t1, dijkstra=t3 - t2,
                       anchors=time.perf_counter() - t3)
    return DeformationGraph(
        nodes=nodes, node_indices=node_indices,
        edges=edges, edge_weights=ew, edges_valid=evalid,
        point_anchors=anchors, anchor_weights=aw,
        vertices=vertices, vertex_pixels=vertex_pixels, clusters=clusters)
