"""One rank of the port's sharded functions on a (data, model) mesh of CPU
processes joined by gloo, started by ``tests/test_torch_parallel.py`` with
torchrun's variables (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT):

    python tests/torch_parallel_worker.py OUT_DIR N_DATA N_MODEL

Each rank checks ``register_sharded`` bit for bit against ``register_batch``
and ``neco_train_step_sharded`` against one process's step over the whole
batch, and writes what the test compares with the JAX package to
``OUT_DIR/rank<r>.npz``. Imports no JAX: the inputs come from numpy seeds
that the test repeats on its side.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deformationpyramid_tpu_torch.data import collate  # noqa: E402
from deformationpyramid_tpu_torch.data.synthetic import (  # noqa: E402
    make_batch, make_pair)
from deformationpyramid_tpu_torch.match import (  # noqa: E402
    backbone, kpconv, landmark, matching, outlier_rejection, pipeline,
    position_encoding, transformer)
from deformationpyramid_tpu_torch.models.pyramid import (  # noqa: E402
    NDPConfig, tree_leaves, tree_map)
from deformationpyramid_tpu_torch.parallel import batched, mesh  # noqa: E402
from deformationpyramid_tpu_torch.solve.registration import (  # noqa: E402
    SolverConfig, register_batch)
from deformationpyramid_tpu_torch.train.trainer import (  # noqa: E402
    make_neco_loss_fn, value_and_grad)

# tests/test_parallel.py's TINY solver
TINY = SolverConfig(pyramid=NDPConfig(m=2, k0=-3, depth=2, width=16),
                    iters=20, samples=64)
N_PAIRS, N_PTS = 4, 64
METRIC_B, METRIC_N = 8, 32
NN_X, NN_Y = 64, 128


def metric_inputs():
    """tests/test_parallel.py's metric case."""
    rng = np.random.default_rng(1)
    flow = rng.normal(size=(METRIC_B, METRIC_N, 3)).astype(np.float32) * 0.05
    gt = flow + rng.normal(size=(METRIC_B, METRIC_N, 3)).astype(
        np.float32) * 0.01
    mask = rng.random((METRIC_B, METRIC_N)) < 0.9
    return flow, gt, mask


def nn_inputs():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(NN_X, 3)).astype(np.float32),
            rng.normal(size=(NN_Y, 3)).astype(np.float32))


def neco_case(n_pairs: int):
    """A narrow landmark model and a stacked batch of ``n_pairs`` pairs
    (the JAX package's multi-chip dry run's shapes)."""
    fd = 24
    kcfg = kpconv.KPConvConfig(first_subsampling_dl=0.2, first_feats_dim=8,
                               coarse_feature_dim=fd, fine_feature_dim=8)
    mc = matching.MatchingConfig(feature_dim=fd)
    lcfg = landmark.LandmarkConfig(
        matcher=pipeline.MatcherConfig(
            kpfcn=kcfg, matching=mc, max_matches=8,
            transformer=transformer.TransformerConfig(
                feature_dim=fd, n_head=2, matching=mc,
                vol=position_encoding.VolPEConfig(
                    feature_dim=fd, vol_origin=(-2.0, -2.0, -2.0)))),
        neco=outlier_rejection.NeCoConfig(feature_dim=12, n_head=2,
                                          num_layers=1))
    arch = backbone.KPFCN_ARCHITECTURE
    src0, tgt0, _ = make_pair(n=48, seed=0, deform=0.05)
    limits = collate.calibrate_neighborhood_limits([(src0, tgt0)], kcfg, arch)
    pad = [len(p) + 8 for p in
           collate.build_pair_pyramid(src0, tgt0, kcfg, arch, limits).points]
    pyrs, lens = [], []
    for i in range(n_pairs):
        s, t, _ = make_pair(n=48, seed=i, deform=0.05)
        p = collate.build_pair_pyramid(s, t, kcfg, arch, limits, pad_to=pad)
        pyrs.append(collate.pyramid_to_device(p, "cpu"))
        lens.append((p.src_lengths[2], p.tgt_lengths[2]))
    rng = np.random.default_rng(5)
    batch = {
        "pyramid": tree_map(lambda *ts: torch.stack(ts), *pyrs),
        "src_len_c": torch.tensor([l[0] for l in lens], dtype=torch.int32),
        "tgt_len_c": torch.tensor([l[1] for l in lens], dtype=torch.int32),
        "coarse_flow": torch.from_numpy(
            (rng.normal(size=(n_pairs, pad[2], 3)) * 0.01).astype(
                np.float32)),
        "gt_rot": torch.eye(3).repeat(n_pairs, 1, 1),
        "gt_trn": torch.zeros(n_pairs, 3, 1),
    }
    params = landmark.init_landmark_model(torch.Generator().manual_seed(0),
                                          lcfg, "cpu")
    return lcfg, params, batch


def one_process_neco_step(matcher_params, lcfg, neco_params, batch):
    """The mean loss over the whole batch in one process, then p - 1e-3 g."""
    loss_fn = make_neco_loss_fn(matcher_params, lcfg)
    n = batch["src_len_c"].shape[0]

    def whole(p):
        return torch.stack([loss_fn(
            p, tree_map(lambda t: t[b], batch["pyramid"]),
            batch["src_len_c"][b], batch["tgt_len_c"][b],
            batch["coarse_flow"][b], batch["gt_rot"][b],
            batch["gt_trn"][b])[0] for b in range(n)]).mean(), {}

    (loss, _), grads = value_and_grad(whole, neco_params)
    return tree_map(lambda p, g: p - 1e-3 * g, neco_params, grads), loss


def main():
    out_dir, n_data, n_model = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    assert mesh.initialize_distributed("cpu"), "expected a world of ranks"
    assert dist.get_backend() == "gloo"
    m = mesh.make_mesh(n_data=n_data, n_model=n_model)
    rank = dist.get_rank()
    out = {"coords": np.array([m.get_local_rank(mesh.DATA_AXIS),
                               m.get_local_rank(mesh.MODEL_AXIS)])}

    # pair-parallel registration, bit for bit against one process
    srcs, tgts, _ = make_batch(N_PAIRS, n=N_PTS, seed=0, deform=0.08)
    src, tgt = torch.from_numpy(srcs), torch.from_numpy(tgts)
    valid = torch.ones(N_PAIRS, N_PTS, dtype=torch.bool)
    keys = list(range(N_PAIRS))
    warped, stats = batched.register_sharded(m, TINY)(keys, src, tgt, valid,
                                                      valid)
    ref_w, ref_s = register_batch(keys, src, tgt, TINY, valid, valid)
    assert torch.equal(warped, ref_w), "register_sharded != register_batch"
    assert stats.keys() == ref_s.keys()
    for k in ref_s:
        assert torch.equal(stats[k], ref_s[k]), k
    out["warped"] = warped.numpy()

    # metric sums over the data axis
    flow, gt, mask = metric_inputs()
    sums = batched.aggregate_metrics_sharded(m)(
        torch.from_numpy(flow), torch.from_numpy(gt), torch.from_numpy(mask))
    for k, v in sums.items():
        out[f"sum_{k}"] = v.numpy()

    # 1-NN over the model axis
    x, y = nn_inputs()
    out["nn_min"] = batched.sharded_nn_min(m)(torch.from_numpy(x),
                                              torch.from_numpy(y)).numpy()

    # data-parallel NeCo step against one process over the whole batch
    lcfg, params, batch = neco_case(N_PAIRS)
    new, loss = batched.neco_train_step_sharded(m, params["matcher"], lcfg)(
        params["neco"], batch)
    ref_new, ref_loss = one_process_neco_step(params["matcher"], lcfg,
                                              params["neco"], batch)
    out["neco_loss"] = np.array([float(loss), float(ref_loss)])
    out["neco_rel_err"] = np.array(max(
        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
        for a, b in zip(tree_leaves(new), tree_leaves(ref_new))))
    out["neco_moved"] = np.array(max(
        float((a - b).abs().max())
        for a, b in zip(tree_leaves(new), tree_leaves(params["neco"]))))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
