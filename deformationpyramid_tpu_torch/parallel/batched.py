"""Pair-parallel (data axis) and intra-pair (model axis) sharded execution.

Counterpart of ``deformationpyramid_tpu/parallel/batched.py``. There a
mega-batch of registration problems is sharded over the mesh's data axis
inside one jitted program; here every rank of a ``torch.distributed``
group calls the same function with the same global arguments, works on its
own share on its own card, and the collectives of the JAX version
(``psum``, ``pmean``, ``pmin``) become ``all_gather`` / ``all_reduce`` over
the rank's group of that axis (``parallel/mesh.py``). The data axis takes
a contiguous slice of the B pairs a rank (rank d of D takes pairs
[d B/D, (d+1) B/D)), so B must divide by D, as in the JAX package; the
model axis a contiguous slice of the target points.

The kernels are the single-card ones: ``register_sharded`` runs the
port's ``register_batch`` (the fused iteration, C2 -> C1 -> C6 -> C3 -> C4,
on CUDA tensors), ``sharded_nn_min`` runs C14 on its slab.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..metrics.flow import metric_sums
from ..models.pyramid import tree_leaves, tree_map
from ..ops.knn import nn_argmin
from ..solve.registration import SolverConfig, register_batch
from ..train.trainer import make_neco_loss_fn, value_and_grad
from .mesh import DATA_AXIS, MODEL_AXIS

Tensor = torch.Tensor


def _shard(mesh: DeviceMesh, axis: str, n: int, what: str) -> slice:
    """This rank's contiguous share of ``n`` rows along mesh axis ``axis``."""
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"{what}: {n} rows do not divide by the {axis} "
                         f"axis of {size}")
    per = n // size
    start = mesh.get_local_rank(axis) * per
    return slice(start, start + per)


def _all_gather(t: Tensor, mesh: DeviceMesh, axis: str) -> Tensor:
    """Concatenate every rank's ``t`` of ``axis`` in the axis' order."""
    parts = [torch.empty_like(t) for _ in range(mesh[axis].size())]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts)


def register_sharded(mesh: DeviceMesh, cfg: SolverConfig):
    """A data-parallel batched registration function.

    Returns fn(keys [B], src [B,N,3], tgt [B,M,3], src_valid, tgt_valid)
    -> (warped [B,N,3], stats), the same on every rank: each rank of the
    data axis registers its slice of the pairs with ``register_batch`` and
    the slices are gathered back in pair order. Ranks that share a data
    coordinate (the model axis) solve the same pairs.
    """
    def fn(keys, src, tgt, src_valid=None, tgt_valid=None):
        sl = _shard(mesh, DATA_AXIS, src.shape[0], "register_sharded")
        warped, stats = register_batch(
            list(keys)[sl], src[sl], tgt[sl], cfg,
            None if src_valid is None else src_valid[sl],
            None if tgt_valid is None else tgt_valid[sl])
        return (_all_gather(warped, mesh, DATA_AXIS),
                {k: _all_gather(v, mesh, DATA_AXIS)
                 for k, v in stats.items()})

    return fn


def aggregate_metrics_sharded(mesh: DeviceMesh):
    """Metric sums over the data axis.

    fn(flow [B,N,3], flow_gt [B,N,3], mask [B,N]) -> dict of global sums:
    ``metric_sums`` on the rank's pairs, then one ``all_reduce(SUM)`` of
    the five sums over the data axis.
    """
    def fn(flow, flow_gt, mask):
        sl = _shard(mesh, DATA_AXIS, flow.shape[0],
                    "aggregate_metrics_sharded")
        local = metric_sums(flow[sl].reshape(-1, 3),
                            flow_gt[sl].reshape(-1, 3), mask[sl].reshape(-1))
        sums = torch.stack(list(local.values()))
        dist.all_reduce(sums, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(DATA_AXIS))
        return dict(zip(local, sums.unbind()))

    return fn


def neco_train_step_sharded(mesh: DeviceMesh, matcher_params, lcfg):
    """Data-parallel NeCo training step: the gradients of each rank's mean
    loss are averaged over the data axis (the canonical data-parallel
    collective; the registration itself needs none).

    Returns fn(neco_params, batch) -> (new_params, mean_loss), where batch
    is a dict of tensors with a leading pair axis: ``pyramid`` (the dict of
    ``data.collate.pyramid_to_device``, each tensor stacked over pairs),
    ``src_len_c``, ``tgt_len_c``, ``coarse_flow``, ``gt_rot``, ``gt_trn``.
    neco_params are the same on every rank; the step is plain gradient
    descent, p - 1e-3 g, as in the JAX package.
    """
    loss_fn = make_neco_loss_fn(matcher_params, lcfg)

    def step(neco_params, batch):
        sl = _shard(mesh, DATA_AXIS, batch["src_len_c"].shape[0],
                    "neco_train_step_sharded")

        def shard_loss(p):
            losses = [loss_fn(p, tree_map(lambda t: t[b], batch["pyramid"]),
                              batch["src_len_c"][b], batch["tgt_len_c"][b],
                              batch["coarse_flow"][b], batch["gt_rot"][b],
                              batch["gt_trn"][b])[0]
                      for b in range(sl.start, sl.stop)]
            return torch.stack(losses).mean(), {}

        (loss, _), grads = value_and_grad(shard_loss, neco_params)
        leaves = tree_leaves(grads)
        flat = torch.cat([loss.reshape(1)] + [g.reshape(-1) for g in leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=mesh.get_group(DATA_AXIS))
        flat = flat / mesh[DATA_AXIS].size()
        parts = iter(flat[1:].split([g.numel() for g in leaves]))
        grads = tree_map(lambda g: next(parts).view_as(g), grads)
        new_params = tree_map(lambda p, g: p - 1e-3 * g, neco_params, grads)
        return new_params, flat[0]

    return step


def sharded_nn_min(mesh: DeviceMesh):
    """Intra-pair sharded 1-NN: the target points split over the model axis.

    fn(x [N,3], y [M,3]) -> sq_dist [N], the global minimum: each rank
    sweeps its slab of y with ``ops/knn.py nn_argmin`` (kernel C14 on CUDA
    tensors; exact differences, not the JAX version's expanded form), then
    ``all_reduce(MIN)`` over the model axis. M must divide by that axis.
    """
    def fn(x, y):
        sl = _shard(mesh, MODEL_AXIS, y.shape[0], "sharded_nn_min")
        sq, _ = nn_argmin(x, y[sl])
        dist.all_reduce(sq, op=dist.ReduceOp.MIN,
                        group=mesh.get_group(MODEL_AXIS))
        return sq

    return fn
