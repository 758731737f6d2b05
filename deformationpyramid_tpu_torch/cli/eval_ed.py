"""ED / N-ICP evaluation from raw depth maps.

Counterpart of ``deformationpyramid_tpu/cli/eval_ed.py`` (the reference's ED
branch, ``eval_nolearned.py:113-127``): for each pair, build a deformation
graph from the source depth map (host, ``data/graph.py``), back-project the
target depth, run the ED solver (``solve/baselines.register_ed``, its
chamfer on kernel C1), and propagate the motion to the sampled evaluation
points through the pixel map (``registration.py:461-467``). With
``use_ldmk`` in the yaml (``config/baselines/Lepard+NICP.yaml``) the
learned landmark model adds landmark terms.

Usage:
  python -m deformationpyramid_tpu_torch.cli.eval_ed \\
      --config config/baselines/NICP.yaml --data-root <split root>

Pairs without ``depth_paths`` and ``cam_intrin`` are skipped (the suites
that ``data.synthetic.write_4dmatch_suite`` writes have none). Everything
runs on ``--device`` (``cuda`` by default); pair i of a split is solved
from seed i. ``--visualize`` writes each pair's deformation graph under
``<log-dir>/vis/``: an edge PLY and a PNG (the PNG needs matplotlib).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..data.fourdmatch import FourDMatchDataset
from ..data.graph import build_deformation_graph_from_depth
from ..geometry.camera import (depth_to_pointcloud, map_pixel_to_pcd,
                               pointcloud_to_uv)
from ..metrics.flow import compute_flow_metrics
from ..solve.baselines import EDSolverConfig, register_ed
from ..utils.config import load_config
from ..utils.logging import AverageMeter
from ..utils.timers import Timers


def _read_depth(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(path), np.float32)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path), np.float32)


def _nearest_indices(query: np.ndarray, pts: np.ndarray,
                     chunk: int = 1024) -> np.ndarray:
    out = np.empty(len(query), np.int64)
    for s in range(0, len(query), chunk):
        d2 = ((query[s:s + chunk, None] - pts[None]) ** 2).sum(-1)
        out[s:s + chunk] = d2.argmin(1)
    return out


def evaluate_pair_ed(pair, cfg, scfg: EDSolverConfig,
                     key: int | torch.Generator, landmark_fn=None,
                     vis_dir: str | None = None,
                     device: torch.device | str = "cuda",
                     info: dict | None = None):
    """Returns (flow, flow_gt, overlap) on the valid evaluated points.

    ``landmark_fn(src_pts, tgt_pts) -> (ldmk_s, ldmk_t, valid)`` enables the
    landmark-guided ED path (Lepard+NICP): landmark coordinates are mapped
    to the nearest raw-cloud indices, the analogue of the reference's
    uv -> pcd-index mapping (``registration.py:81-88``). ``info`` (a dict),
    where given, receives the graph's sizes and build seconds by part, the
    solve's seconds and stats, the warped source vertices and the landmark
    indices.
    """
    # The source depth is read in mm (the graph build divides by 1000);
    # the target in m, as the JAX package and the reference read them.
    src_depth = _read_depth(pair.depth_paths[0])
    tgt_depth = _read_depth(pair.depth_paths[1]) / 1000.0
    K = pair.cam_intrin

    graph_s: dict = {}
    g = build_deformation_graph_from_depth(
        src_depth, K,
        max_triangle_distance=cfg.get("max_triangle_distance", 0.06),
        node_coverage=cfg.get("node_coverage", 0.09),
        n_max_neighbors=cfg.get("num_neighbors", 8),
        remove_sparse_nodes=cfg.get(
            "REMOVE_NODES_WITH_NOT_ENOUGH_NEIGHBORS", True),
        seconds=graph_s)

    if vis_dir is not None:
        # deformation-graph render (nodes + kNN edges over the eroded
        # source surface), edge PLY + PNG: the ED path's debugging view
        # (reference utils/vis.py node_o3d_spheres + graph draws)
        from ..utils.vis import export_graph_ply, visualize_graph

        os.makedirs(vis_dir, exist_ok=True)
        base = os.path.join(vis_dir, pair.name.replace("/", "_"))
        export_graph_ply(base + "_graph.ply", g.nodes, g.edges,
                         edges_valid=g.edges_valid)
        visualize_graph(g.nodes, g.edges, edges_valid=g.edges_valid,
                        pcd=g.vertices, save_path=base + "_graph.png")

    tgt_pc_img = depth_to_pointcloud(tgt_depth, K)
    tgt_mask = tgt_depth > 0
    tgt_pcd = tgt_pc_img.reshape(3, -1).T[tgt_mask.reshape(-1)].astype(
        np.float32)

    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ldmk_kwargs = {}
    if landmark_fn is not None:
        ldmk_s, ldmk_t, lvalid = landmark_fn(g.vertices, tgt_pcd)
        keep = np.asarray(lvalid)
        s_idx = _nearest_indices(np.asarray(ldmk_s), g.vertices)
        t_idx = _nearest_indices(np.asarray(ldmk_t), tgt_pcd)
        ldmk_kwargs = dict(src_ldmk_idx=put(s_idx), tgt_ldmk_idx=put(t_idx),
                           ldmk_valid=put(keep))

    t0 = time.perf_counter()
    warped_t, stats = register_ed(
        key, put(g.vertices), put(tgt_pcd), put(g.nodes), put(g.edges),
        put(g.edge_weights), put(g.point_anchors), put(g.anchor_weights),
        scfg, edges_valid=put(g.edges_valid), **ldmk_kwargs)
    warped = warped_t.cpu().numpy()
    solve_s = time.perf_counter() - t0
    if info is not None:
        info.update(graph_seconds=graph_s, solve_seconds=solve_s,
                    iters=int(stats["iters"]), loss=float(stats["loss"]),
                    n_vertices=len(g.vertices), n_nodes=len(g.nodes),
                    n_target=len(tgt_pcd), warped=warped_t,
                    landmarks={k: v.cpu().numpy()
                               for k, v in ldmk_kwargs.items()})

    # propagate motion to the sampled evaluation points via the pixel map
    h, w = src_depth.shape
    valid_pix = np.zeros((h, w), bool)
    valid_pix[g.vertex_pixels[:, 1], g.vertex_pixels[:, 0]] = True
    pix2pcd = map_pixel_to_pcd(valid_pix)
    uv = pointcloud_to_uv(pair.src, K)
    inside = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    sid = np.full(len(pair.src), -1, np.int64)
    sid[inside] = pix2pcd[uv[inside, 1], uv[inside, 0]]
    valid = sid > -1
    flow = warped[sid[valid]] - pair.src[valid]
    return flow, pair.flow_gt[valid], pair.overlap[valid]


def make_landmark_fn(cfg, weights: str | None = None,
                     device: torch.device | str = "cuda"):
    """Landmark provider for the Lepard+NICP path
    (``config/baselines/Lepard+NICP.yaml``): the Lepard matcher and NeCo
    outlier rejection on the raw clouds, returning (ldmk_s, ldmk_t, valid)
    as numpy arrays. Weights from seed 0 unless ``weights`` names an npz
    checkpoint of the landmark model ({matcher, neco}, either package's).
    The matcher's attention takes the streamed route (kernel C7 on the
    card) where the yaml files name the einsum route by default; the two
    agree to 1e-4. The coarse level pads to power-of-two caps, as the
    port's other landmark paths do."""
    from ..data.collate import (build_pair_pyramid,
                                calibrate_neighborhood_limits, pow2_cap,
                                pyramid_to_device)
    from ..match.backbone import KPFCN_ARCHITECTURE
    from ..match.landmark import init_landmark_model, landmark_inference
    from ..utils.checkpoint import load_pytree
    from .eval_supervised import landmark_config

    lcfg = landmark_config(cfg, inlier_thr=cfg.get("inlier_thr", 0.5))
    params = init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                 device=device)
    if weights:
        params = load_pytree(weights, params)
    state: dict = {}
    cl = lcfg.matcher.coarse_level

    @torch.no_grad()
    def landmark_fn(src_pts: np.ndarray, tgt_pts: np.ndarray):
        if "limits" not in state:
            state["limits"] = calibrate_neighborhood_limits(
                [(src_pts, tgt_pts)], lcfg.matcher.kpfcn, KPFCN_ARCHITECTURE)
        pyr = build_pair_pyramid(src_pts, tgt_pts, lcfg.matcher.kpfcn,
                                 KPFCN_ARCHITECTURE, state["limits"])
        s_len, t_len = int(pyr.src_lengths[cl]), int(pyr.tgt_lengths[cl])
        data = landmark_inference(params, pyramid_to_device(pyr, device),
                                  s_len, t_len, lcfg, s_cap=pow2_cap(s_len),
                                  t_cap=pow2_cap(t_len))
        return (data["ldmk_s"].cpu().numpy(), data["ldmk_t"].cpu().numpy(),
                data["ldmk_valid"].cpu().numpy())

    return landmark_fn


def solver_config(cfg) -> EDSolverConfig:
    """The yaml's solver keys, as the JAX CLI reads them (the decay stays
    at its default 0.999)."""
    return EDSolverConfig(
        iters=cfg.get("iters", 600), lr=cfg.get("lr", 0.02),
        max_break_count=cfg.get("max_break_count", 30),
        break_threshold_ratio=cfg.get("break_threshold_ratio", 0.01),
        samples=cfg.get("samples", 2000),
        w_cd=cfg.get("w_cd", 1.0), w_arap=cfg.get("w_arap", 0.5),
        w_ldmk=cfg.get("w_ldmk", 1.0))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--splits", nargs="*", default=["4DMatch-F", "4DLoMatch-F"])
    ap.add_argument("--data-root", default=None,
                    help="override the yaml's data_root")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the solves (default cuda)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--weights", default=None,
                    help="npz checkpoint of the landmark model")
    ap.add_argument("--visualize", action="store_true",
                    help="save per-pair deformation-graph renders "
                         "(PNG + edge PLY) under <log-dir>/vis/")
    ap.add_argument("--log-dir", default="snapshot/ed")
    return ap


def main(argv: list[str] | None = None) -> dict[str, dict]:
    """Run the sweep. Returns, per split that had pairs with depth maps,
    ``{"scores": {metric: mean over the pairs}, "pairs": n, "seconds": wall
    time, "iters": {pair name: solver iterations}, "info": [per-pair
    info of evaluate_pair_ed, the warp left out]}``."""
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config)
    if args.data_root is not None:
        cfg["data_root"] = args.data_root
    device = torch.device(args.device)
    if device.type == "cuda":
        # the kernels launch on the current device: make it the one asked for
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    landmark_fn = make_landmark_fn(cfg, args.weights, device) \
        if cfg.get("use_ldmk", False) else None
    scfg = solver_config(cfg)
    timers = Timers()

    report: dict[str, dict] = {}
    for split in args.splits:
        ds = FourDMatchDataset(cfg.data_root, split)
        if args.limit:
            ds.entries = ds.entries[: args.limit]
        meters: dict[str, AverageMeter] = {}
        iters: dict[str, int] = {}
        infos: list[dict] = []
        t_split = time.perf_counter()
        for i in range(len(ds)):
            pair = ds[i]
            if pair.depth_paths is None or pair.cam_intrin is None:
                continue
            info: dict = {}
            timers.tic("graph+registration")
            flow, flow_gt, overlap = evaluate_pair_ed(
                pair, cfg, scfg, i, landmark_fn=landmark_fn,
                vis_dir=(os.path.join(args.log_dir, "vis")
                         if args.visualize else None),
                device=device, info=info)
            timers.toc("graph+registration")
            m = compute_flow_metrics(torch.from_numpy(flow),
                                     torch.from_numpy(flow_gt),
                                     overlap=torch.from_numpy(overlap))
            for k2, v in m.items():
                meters.setdefault(k2, AverageMeter()).update(float(v))
            iters[pair.name] = info["iters"]
            info.pop("warped")
            infos.append(info)
        if iters:
            msg = f"{len(iters)} pairs: " + "\t".join(
                f"{k}: {v.avg:.3f}" for k, v in meters.items())
            print("score on", split, "\n", msg)
            report[split] = {"scores": {k: v.avg for k, v in meters.items()},
                             "pairs": len(iters),
                             "seconds": time.perf_counter() - t_split,
                             "iters": iters, "info": infos}
        else:
            print(f"[skip] {split}: no pairs with depth maps")
    for line in timers.get_strings():
        print(line)
    return report


if __name__ == "__main__":
    main()
