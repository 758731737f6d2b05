#!/usr/bin/env python3
"""Paired parity of the PyTorch port against the JAX package on fabricated
4DMatch-format pairs, for the no-learned solvers (NDP, NSFP).

    python scripts/parity_torch_nolearned.py --config config/NDP.yaml \\
        --pairs 8 [--device cpu|cuda] [--set iters=100 m=5 ...]

For each pair both packages solve the SAME problem: the subsample of the
evaluation CLI (``_prep_sample``, the per-pair CRC seed) and the JAX
package's initial weights, carried to the port by ``params_from_numpy``;
then each warps the full cloud and scores its EPE. Printed: the per-pair
EPEs (cm), and the paired difference d_p = port(p) - jax(p) with its 95%
t confidence interval (the estimator of docs/PARITY.md: a difference of
means over a few pairs is under-powered, the paired difference is not).

This is the one program that imports both packages; it runs where both are
installed. JAX runs on the CPU; the port on ``--device``. ``--set`` overrides
yaml keys (a full-size NDP solve takes the JAX CPU backend about a minute a
pair).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

from deformationpyramid_tpu.cli import eval_nolearned as jeval  # noqa: E402
from deformationpyramid_tpu.models import baselines as jbase  # noqa: E402
from deformationpyramid_tpu.models import pyramid as jpyr  # noqa: E402
from deformationpyramid_tpu.solve import baselines as jsolve  # noqa: E402
from deformationpyramid_tpu.solve import registration as jreg  # noqa: E402
from deformationpyramid_tpu_torch.cli import eval_nolearned as teval  # noqa: E402
from deformationpyramid_tpu_torch.data.fourdmatch import \
    FourDMatchDataset  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import \
    write_4dmatch_suite  # noqa: E402
from deformationpyramid_tpu_torch.models import pyramid as tpyr  # noqa: E402
from deformationpyramid_tpu_torch.utils.config import load_config  # noqa: E402


def paired_ci(diffs: np.ndarray) -> tuple[float, float]:
    """Mean of the paired differences and the half-width of its 95% t
    interval (df = n - 1)."""
    n = len(diffs)
    if n < 2:
        return float(diffs.mean()), float("nan")
    half = stats.t.ppf(0.975, n - 1) * diffs.std(ddof=1) / np.sqrt(n)
    return float(diffs.mean()), float(half)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=os.path.join(REPO, "config/NDP.yaml"))
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--sizes", type=int, nargs="*", default=[1500, 3000, 8000],
                    help="size clusters of the fabricated clouds")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="yaml overrides, e.g. iters=100 m=5")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    for item in args.set:
        k, v = item.split("=", 1)
        cfg[k] = json.loads(v) if v[:1] in "-0123456789tf[" else v
    model = cfg.get("deformation_model", "NDP")
    if model not in ("NDP", "NSFP"):
        raise SystemExit("parity covers deformation_model NDP and NSFP")
    device = torch.device(args.device)
    jscfg = jeval.solver_from_config(cfg)[0]
    tscfg = teval.solver_from_config(cfg, device)[0]
    t_solve = teval.make_fast_solver(model, tscfg, device)

    if model == "NDP":
        def j_init(key):
            return jpyr.init_pyramid_params(key, jscfg.pyramid)

        @jax.jit
        def j_solve(key, ss, sv, ts, tv, src_c):
            p, st = jreg.optimize_pyramid(key, ss, sv, ts, tv, jscfg)
            return jpyr.warp(p, src_c, jscfg.pyramid)[0], st["iters"]
    else:
        def j_init(key):
            return jbase.init_nsfp_params(key, jscfg.net)

        @jax.jit
        def j_solve(key, ss, sv, ts, tv, src_c):
            p, st = jsolve.optimize_nsfp(key, ss, sv, ts, tv, jscfg)
            return src_c + jbase.nsfp_flow(p, src_c, jscfg.net), st["iters"]

    rows = []
    with tempfile.TemporaryDirectory() as root:
        write_4dmatch_suite(root, "4DMatch-F", n_pairs=args.pairs,
                            size_clusters=tuple(args.sizes), seed=args.seed)
        ds = FourDMatchDataset(root, "4DMatch-F")
        for i in range(len(ds)):
            pair = ds[i]
            pid = teval.pair_id(pair.name)
            seed = teval.pair_seed(pid, args.seed)
            rng = np.random.default_rng([args.seed, pid])
            src_mean, tgt_mean = pair.src.mean(0), pair.tgt.mean(0)
            st = np.stack([
                teval._prep_sample(pair.src, src_mean, tscfg.samples, rng),
                teval._prep_sample(pair.tgt, tgt_mean, tscfg.samples, rng)])
            src_c = pair.src - src_mean
            delta = tgt_mean - src_mean
            key = jax.random.fold_in(jax.random.key(0), np.int32(seed))

            jw, jit_ = j_solve(key, jnp.asarray(st[0, :, :3]),
                               jnp.asarray(st[0, :, 3] > 0.5),
                               jnp.asarray(st[1, :, :3]),
                               jnp.asarray(st[1, :, 3] > 0.5),
                               jnp.asarray(src_c))
            jflow = np.asarray(jw) - src_c + delta

            init = tpyr.params_from_numpy(
                jax.tree.map(np.asarray, j_init(key)), device)
            state = t_solve[0](seed, torch.from_numpy(st).to(device), init)
            tw = t_solve[2](state, torch.from_numpy(
                np.concatenate([src_c, np.zeros((len(src_c), 4), np.float32)],
                               1)).to(device)).cpu().numpy()
            tflow = tw - src_c + delta

            epe = [100.0 * float(np.linalg.norm(f - pair.flow_gt, axis=-1)
                                 .mean()) for f in (jflow, tflow)]
            init_epe = 100.0 * float(np.linalg.norm(pair.flow_gt, axis=-1)
                                     .mean())
            rows.append(dict(pair=os.path.basename(pair.name),
                             points=len(pair.src), initial=init_epe,
                             jax=epe[0], port=epe[1],
                             jax_iters=np.asarray(jit_).reshape(-1).tolist(),
                             port_iters=state[1]["iters"].reshape(-1)
                             .tolist()))
            print(json.dumps(rows[-1]), flush=True)
    d = np.array([r["port"] - r["jax"] for r in rows])
    mean, half = paired_ci(d)
    print(json.dumps(dict(
        model=model, pairs=len(rows), port_device=str(device),
        jax_backend=jax.default_backend(),
        jax_mean_epe_cm=float(np.mean([r["jax"] for r in rows])),
        port_mean_epe_cm=float(np.mean([r["port"] for r in rows])),
        paired_diff_cm=mean, ci95_half_width_cm=half,
        fused=bool(getattr(tscfg, "use_fused_iteration", False)))))


if __name__ == "__main__":
    main()
