"""Train the multiview (correspondence-graph GAT) outlier-rejection model.

Counterpart of ``deformationpyramid_tpu/cli/train_multiview.py`` (reference
``correspondence/cycle_consistency.py``, which upstream has no runnable
entry point): per view-pair candidate matches become 6D vectors, matches
sharing a point cloud are linked into a correspondence graph
(``creat_graph_of_correspondences``, ``cycle_consistency.py:166-231``), and
the alternating attention / GAT confidence model trains with class-balanced
BCE on ground-truth inlier labels from the pairwise flows. Candidate
matches are the ground-truth correspondences with a planted outlier
fraction. The batches are built on the host by a numpy copy of the JAX
package's ``make_training_batch`` (the same seed gives the same batches);
the model and its Adam step run on ``--device``.

Usage:
  python -m deformationpyramid_tpu_torch.cli.train_multiview \\
      --data-root data/split [--split multiview-train] [--epochs 10] \\
      [--k 64] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..data.fourdmatch_multiview import FourDMatchMultiview
from ..match.losses import balanced_bce
from ..match.multiview import (MultiviewNeCoConfig, apply_multiview_neco,
                               build_correspondence_graph,
                               init_multiview_neco)
from ..match.outlier_rejection import NeCoConfig
from ..models.pyramid import tree_map
from ..train.trainer import Optimizer, TrainConfig, value_and_grad
from ..utils.checkpoint import save_pytree
from ..utils.logging import AverageMeter


def make_training_batch(sample, k: int, outlier_rate: float,
                        max_pairs: int, max_edges: int,
                        rng: np.random.Generator, edge_radius: float):
    """One multiview sample -> (vec6d [P,K,6], mask, labels, edges)."""
    n_pairs = min(len(sample.pcd_pairs), max_pairs)
    n = sample.pcds.shape[1]
    vec6d = np.zeros((max_pairs, k, 6), np.float32)
    mask = np.zeros((max_pairs, k), bool)
    labels = np.zeros((max_pairs, k), bool)
    for p in range(n_pairs):
        a, b = sample.pcd_pairs[p]
        idx = rng.permutation(n)[:k]
        src = sample.pcds[a][idx]
        tgt = src + sample.pairwise_flows[p][idx]
        out = rng.random(len(idx)) < outlier_rate
        wrong = sample.pcds[b][rng.integers(0, n, len(idx))]
        tgt = np.where(out[:, None], wrong, tgt)
        kk = len(idx)
        vec6d[p, :kk] = np.concatenate([src, tgt], 1)
        mask[p, :kk] = True
        labels[p, :kk] = ~out
    es, et, ev = build_correspondence_graph(
        vec6d, mask, sample.pcd_pairs[:n_pairs], edge_radius, max_edges)
    return vec6d, mask, labels, es, et, ev


def adam(lr: float) -> Optimizer:
    """``optax.adam(lr)``: the trainer's Adam with no weight decay and a
    constant rate."""
    return Optimizer(TrainConfig(optimizer="Adam", lr=lr, weight_decay=0.0,
                                 scheduler="MultiStepLR"), 1)


def multiview_loss(params: dict, vec6d, mask, labels, es, et, ev,
                   cfg: MultiviewNeCoConfig):
    """Balanced BCE of the confidences, and the inlier ratio of the
    candidates before and after the 0.5 cut."""
    conf = apply_multiview_neco(params, vec6d, mask, es, et, ev, cfg)
    loss = balanced_bce(conf, labels, mask)
    kept = mask & (conf > 0.5)
    ir_before = (labels & mask).sum() / mask.sum().clamp_min(1)
    ir_after = (labels & kept).sum() / kept.sum().clamp_min(1)
    return loss, {"IR_before": ir_before, "IR_after": ir_after}


def make_train_step(cfg: MultiviewNeCoConfig, opt: Optimizer):
    """(params, opt_state, *batch tensors) -> (params, opt_state, loss,
    info): one Adam step on one batch."""
    def step(params, opt_state, vec6d, mask, labels, es, et, ev):
        (loss, info), grads = value_and_grad(
            lambda p: multiview_loss(p, vec6d, mask, labels, es, et, ev, cfg),
            params)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = tree_map(torch.add, params, updates)
        return params, opt_state, loss, info

    return step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--split", default="multiview-train")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--k", type=int, default=64,
                    help="candidate matches per view pair")
    ap.add_argument("--max-pairs", type=int, default=12)
    ap.add_argument("--max-edges", type=int, default=16384)
    ap.add_argument("--outlier-rate", type=float, default=0.4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--feature-dim", type=int, default=144)
    ap.add_argument("--num-layers", type=int, default=3)
    ap.add_argument("--snapshot-dir", default="snapshot/multiview")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default cuda)")
    return ap


def main(argv: list[str] | None = None) -> list[dict]:
    """Train; returns the rows of ``history.jsonl``, each with the epoch's
    wall seconds and its mean step milliseconds added (host clock; every
    step ends in a read of its loss)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)

    ds = FourDMatchMultiview(args.data_root, args.split)
    if len(ds) == 0:
        raise SystemExit(f"no multiview data under "
                         f"{args.data_root}/{args.split}")

    cfg = MultiviewNeCoConfig(neco=NeCoConfig(
        feature_dim=args.feature_dim, num_layers=args.num_layers))
    params = tree_map(lambda t: t.to(device), init_multiview_neco(
        torch.Generator().manual_seed(args.seed), cfg))
    opt = adam(args.lr)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)

    os.makedirs(args.snapshot_dir, exist_ok=True)
    history = os.path.join(args.snapshot_dir, "history.jsonl")
    rng = np.random.default_rng(args.seed)
    best = np.inf
    rows = []
    for epoch in range(args.epochs):
        meter, irb, ira = AverageMeter(), AverageMeter(), AverageMeter()
        step_s = []
        t_epoch = time.perf_counter()
        for i in range(len(ds)):
            batch = make_training_batch(
                ds[i], args.k, args.outlier_rate, args.max_pairs,
                args.max_edges, rng, cfg.edge_search_radius)
            t0 = time.perf_counter()
            params, opt_state, loss, info = step(
                params, opt_state,
                *[torch.from_numpy(x).to(device) for x in batch])
            meter.update(float(loss))
            step_s.append(time.perf_counter() - t0)
            irb.update(float(info["IR_before"]))
            ira.update(float(info["IR_after"]))
        print(f"epoch {epoch}: loss {meter.avg:.4f} "
              f"IR {irb.avg:.3f} -> {ira.avg:.3f}")
        row = {"epoch": epoch, "loss": meter.avg, "IR_before": irb.avg,
               "IR_after": ira.avg}
        with open(history, "a") as f:
            f.write(json.dumps(row) + "\n")
        if meter.avg < best:
            best = meter.avg
            save_pytree(os.path.join(args.snapshot_dir, "model_best_loss.npz"),
                        params, meta={"epoch": epoch, "loss": best})
        rows.append(dict(row, seconds=time.perf_counter() - t_epoch,
                         step_ms=1e3 * float(np.mean(step_s))))
    save_pytree(os.path.join(args.snapshot_dir, "model_last.npz"), params,
                meta={"epoch": args.epochs - 1})
    return rows


if __name__ == "__main__":
    main()
