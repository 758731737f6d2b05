"""Point-cloud visualization helpers.

A copy of ``deformationpyramid_tpu/utils/vis.py`` (numpy; matplotlib is
imported only inside the PNG writers, so the PLY exports need none). It
replaces the reference's mayavi/open3d viewers (``utils/vis.py:11-47``) with
headless-friendly outputs: matplotlib 3D scatter saved to PNG, and PLY
export for external viewers. Same call shape as the reference's
``visualize_pcds(src_pcd=..., tgt_pcd=..., warped_pcd=...)``.
"""
from __future__ import annotations

import numpy as np

_COLORS = {
    "src_pcd": "#2563eb",      # blue
    "tgt_pcd": "#dc2626",      # red
    "warped_pcd": "#16a34a",   # green
    "ldmk_s": "#f59e0b",
    "ldmk_t": "#9333ea",
}


def visualize_pcds(save_path: str | None = None, max_points: int = 5000,
                   **clouds) -> str | None:
    """Render named clouds ([N,3] arrays) to a PNG; returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    rng = np.random.default_rng(0)
    for name, pts in clouds.items():
        if pts is None:
            continue
        pts = np.asarray(pts)
        if len(pts) > max_points:
            pts = pts[rng.permutation(len(pts))[:max_points]]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5,
                   c=_COLORS.get(name, None), label=name, alpha=0.6)
    ax.legend()
    ax.set_box_aspect((1, 1, 1))
    path = save_path or "pcds.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def _conf_colors(n: int, confidence=None, inlier=None) -> np.ndarray:
    """Per-line RGB in [0,1]: GT-inlier green/red when given, else NeCo
    confidence on a red->green ramp, else neutral gray."""
    if inlier is not None:
        inl = np.asarray(inlier, bool)
        c = np.zeros((n, 3))
        c[inl] = (0.1, 0.75, 0.2)
        c[~inl] = (0.85, 0.15, 0.15)
        return c
    if confidence is not None:
        t = np.clip(np.asarray(confidence, np.float64), 0.0, 1.0)
        return np.stack([0.9 * (1 - t), 0.8 * t, 0.15 * np.ones(n)], -1)
    return np.full((n, 3), 0.55)


def visualize_correspondences(ldmk_s: np.ndarray, ldmk_t: np.ndarray,
                              confidence=None, inlier=None,
                              src_pcd=None, tgt_pcd=None,
                              save_path: str | None = None,
                              max_lines: int = 2000,
                              max_points: int = 4000) -> str:
    """Correspondence-line render: one 3D segment per landmark pair over
    faint context clouds, colored by GT-inlier mask (green/red) or NeCo
    confidence (red->green ramp).

    Headless PNG equivalent of the reference's interactive o3d
    correspondence viewer (``utils/vis.py:230-…``
    ``CustomDrawGeometryWithKeyCallback`` 'C'/'correspondences' toggles);
    the debugging tool behind ``model/registration.py``'s vis branches.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    ldmk_s = np.asarray(ldmk_s)
    ldmk_t = np.asarray(ldmk_t)
    rng = np.random.default_rng(0)
    if len(ldmk_s) > max_lines:
        sel = rng.permutation(len(ldmk_s))[:max_lines]
        ldmk_s, ldmk_t = ldmk_s[sel], ldmk_t[sel]
        confidence = None if confidence is None else np.asarray(confidence)[sel]
        inlier = None if inlier is None else np.asarray(inlier)[sel]

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for name, pts in (("src_pcd", src_pcd), ("tgt_pcd", tgt_pcd)):
        if pts is None:
            continue
        pts = np.asarray(pts)
        if len(pts) > max_points:
            pts = pts[rng.permutation(len(pts))[:max_points]]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
                   c=_COLORS[name], alpha=0.15, label=name)
    colors = _conf_colors(len(ldmk_s), confidence, inlier)
    segs = np.stack([ldmk_s, ldmk_t], axis=1)
    ax.add_collection3d(Line3DCollection(segs, colors=colors,
                                         linewidths=0.7, alpha=0.8))
    ax.scatter(ldmk_s[:, 0], ldmk_s[:, 1], ldmk_s[:, 2], s=1.5,
               c=_COLORS["ldmk_s"])
    ax.scatter(ldmk_t[:, 0], ldmk_t[:, 1], ldmk_t[:, 2], s=1.5,
               c=_COLORS["ldmk_t"])
    if src_pcd is not None or tgt_pcd is not None:
        ax.legend(loc="upper right")
    ax.set_box_aspect((1, 1, 1))
    path = save_path or "correspondences.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def export_correspondences_ply(path: str, ldmk_s: np.ndarray,
                               ldmk_t: np.ndarray, confidence=None,
                               inlier=None) -> None:
    """Colored edge-element PLY of the landmark pairs (standard
    vertex+edge layout; loads in meshlab/CC for 3D inspection)."""
    ldmk_s = np.asarray(ldmk_s)
    ldmk_t = np.asarray(ldmk_t)
    k = len(ldmk_s)
    colors = (_conf_colors(k, confidence, inlier) * 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {2 * k}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {k}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in np.concatenate([ldmk_s, ldmk_t]):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for i, (r, g, b) in enumerate(colors):
            f.write(f"{i} {i + k} {r} {g} {b}\n")


def visualize_graph(nodes: np.ndarray, edges: np.ndarray,
                    edges_valid=None, pcd=None,
                    save_path: str | None = None,
                    max_points: int = 4000) -> str:
    """Deformation-graph render: node markers + kNN edge segments over the
    faint source cloud (ED path debugging; reference analogue
    ``utils/vis.py:147-197`` node_o3d_spheres + the graph views in
    CustomDrawGeometryWithKeyCallback).

    edges: [M, E] neighbor node ids (self-padded); edges_valid: [M, E].
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    nodes = np.asarray(nodes)
    edges = np.asarray(edges)
    valid = (np.ones_like(edges, bool) if edges_valid is None
             else np.asarray(edges_valid, bool))
    m, e = edges.shape
    ii = np.repeat(np.arange(m), e)[valid.reshape(-1)]
    jj = edges.reshape(-1)[valid.reshape(-1)]
    keep = ii != jj   # drop self-padding
    segs = np.stack([nodes[ii[keep]], nodes[jj[keep]]], axis=1)

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    if pcd is not None:
        pts = np.asarray(pcd)
        if len(pts) > max_points:
            pts = pts[np.random.default_rng(0).permutation(len(pts))[:max_points]]
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3,
                   c=_COLORS["src_pcd"], alpha=0.15)
    ax.add_collection3d(Line3DCollection(segs, colors="#16a34a",
                                         linewidths=0.6, alpha=0.7))
    ax.scatter(nodes[:, 0], nodes[:, 1], nodes[:, 2], s=14,
               c="#15803d", depthshade=False, label=f"{m} nodes")
    ax.legend(loc="upper right")
    ax.set_box_aspect((1, 1, 1))
    path = save_path or "graph.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def export_graph_ply(path: str, nodes: np.ndarray, edges: np.ndarray,
                     edges_valid=None) -> None:
    """Deformation graph as a vertex+edge PLY."""
    nodes = np.asarray(nodes)
    edges = np.asarray(edges)
    valid = (np.ones_like(edges, bool) if edges_valid is None
             else np.asarray(edges_valid, bool))
    m, e = edges.shape
    ii = np.repeat(np.arange(m), e)[valid.reshape(-1)]
    jj = edges.reshape(-1)[valid.reshape(-1)]
    keep = ii != jj
    ii, jj = ii[keep], jj[keep]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(nodes)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {len(ii)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p in nodes:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for a, b in zip(ii, jj):
            f.write(f"{a} {b}\n")


def visualize_mesh(vertices: np.ndarray, triangles: np.ndarray,
                   save_path: str | None = None) -> str:
    """Headless triangle-mesh render (reference frame-mesh viewer around
    ``utils/vis.py:82-144`` construct_frame_trimesh -> o3d draw)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_trisurf(vertices[:, 0], vertices[:, 1], vertices[:, 2],
                    triangles=triangles, color="#93c5fd",
                    edgecolor="#1e40af", linewidth=0.1, alpha=0.9)
    ax.set_box_aspect((1, 1, 1))
    path = save_path or "mesh.png"
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def export_mesh_ply(path: str, vertices: np.ndarray,
                    triangles: np.ndarray) -> None:
    """Triangle mesh as an ascii PLY (vertex + face elements)."""
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(triangles)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for p in vertices:
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        for t in triangles:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def export_pcds_ply(path: str, **clouds) -> None:
    """Dump all clouds into one colored ascii PLY for external viewers."""
    palette = {"src_pcd": (60, 100, 235), "tgt_pcd": (220, 40, 40),
               "warped_pcd": (25, 165, 80)}
    rows = []
    for name, pts in clouds.items():
        if pts is None:
            continue
        r, g, b = palette.get(name, (200, 200, 200))
        for p in np.asarray(pts):
            rows.append(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {r} {g} {b}")
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(rows)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        f.write("\n".join(rows) + "\n")
