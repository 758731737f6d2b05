"""Plain reference of a matcher training step (the reference program's
Lepard training: the matcher forward on the einsum attention, the focal
match loss and the rigid-motion loss of ``lepard/loss.py``, Adam with
weight decay added to the gradient and an ExpLR staircase by epoch).

``make_batch`` works the training batch out again from the raw pair (the
collate, the coarse flow blended from the raw flow, the mutual nearest
neighbours within the match radius), as the training CLI builds it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collate
from .correspondence import blend_scene_flow, mutual_nn_correspondence
from .match.backbone import KPFCN_ARCHITECTURE
from .match.losses import match_motion_loss
from .match.pipeline import apply_matcher
from .tree import tree_leaves, tree_map

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def pow2_cap(n: int, minimum: int = 512) -> int:
    cap = minimum
    while cap < n:
        cap *= 2
    return cap


def make_batch(pair, lcfg, limits, radius: float, device) -> dict:
    """The training batch of one raw pair (``pair`` has src, tgt, flow,
    rot, trans)."""
    cl = lcfg.matcher.coarse_level
    pyr = collate.build_pair_pyramid(pair.src, pair.tgt, lcfg.matcher.kpfcn,
                                     KPFCN_ARCHITECTURE, limits,
                                     pad_to="pow2")
    s_len, t_len = pyr.src_lengths[cl], pyr.tgt_lengths[cl]
    cap = pow2_cap(max(s_len, t_len))
    coarse = pyr.points[cl]
    c_src = coarse[:s_len]
    c_tgt = coarse[s_len:s_len + t_len]
    flow_gt = (pair.rot @ (pair.src + pair.flow).T + pair.trans).T \
        - pair.src
    flow_def = (pair.rot.T @ (flow_gt + pair.src - pair.trans.T).T).T \
        - pair.src
    c_flow = blend_scene_flow(c_src, pair.src, flow_def.astype(np.float32))
    warped = (pair.rot @ (c_src + c_flow).T + pair.trans).T
    corr = mutual_nn_correspondence(warped, c_tgt, search_radius=radius)
    match_gt = np.zeros((cap, 2), np.int64)
    match_gt_valid = np.zeros((cap,), bool)
    m = min(len(corr), cap)
    match_gt[:m] = corr[:m]
    match_gt_valid[:m] = True
    coarse_flow = np.zeros((cap, 3), np.float32)
    coarse_flow[:s_len] = c_flow

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.long() if t.dtype == torch.int32 else t).to(device)

    pyrd = {k: [put(a) for a in getattr(pyr, k)]
            for k in ("points", "valids", "neighbors", "pools", "upsamples")}
    pyrd["features"] = put(pyr.features)
    return {"pyramid": pyrd, "src_len_c": int(s_len), "tgt_len_c": int(t_len),
            "match_gt": put(match_gt), "match_gt_valid": put(match_gt_valid),
            "coarse_flow": put(coarse_flow), "gt_rot": put(pair.rot),
            "gt_trn": put(pair.trans), "cap": cap}


def loss_and_grads(params: dict, batch: dict, lcfg):
    """The matcher loss of one batch and its gradient by leaf."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        data = apply_matcher(p, batch["pyramid"], batch["src_len_c"],
                             batch["tgt_len_c"], lcfg.matcher,
                             s_cap=batch["cap"], t_cap=batch["cap"])
        loss, _ = match_motion_loss(data, batch["match_gt"],
                                    batch["match_gt_valid"],
                                    batch["coarse_flow"], batch["gt_rot"],
                                    batch["gt_trn"])
        leaves = tree_leaves(p)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(got)
    grads = tree_map(lambda t: next(it), p)
    grads = tree_map(lambda g, t: torch.zeros_like(t) if g is None else g,
                     grads, p)
    return loss.detach(), grads


def follow(params: dict, batches: list[dict], lcfg, lr: float,
           weight_decay: float, gamma: float, steps_per_epoch: int) -> dict:
    """Adam steps on ``batches`` from ``params``: each step's loss, the
    first step's gradient as the optimizer takes it (weight decay added)
    and the parameters after the last step."""
    mu = tree_map(torch.zeros_like, params)
    nu = tree_map(torch.zeros_like, params)
    losses, first = [], None
    p = params
    for count, batch in enumerate(batches):
        loss, g = loss_and_grads(p, batch, lcfg)
        losses.append(float(loss))
        g = tree_map(lambda gi, pi: gi + weight_decay * pi, g, p)
        if first is None:
            first = g
        t = count + 1
        rate = lr * gamma ** (count // max(steps_per_epoch, 1))
        mu = tree_map(lambda m, gi: ADAM_B1 * m + (1 - ADAM_B1) * gi, mu, g)
        nu = tree_map(lambda v, gi: ADAM_B2 * v + (1 - ADAM_B2) * gi * gi,
                      nu, g)
        c1, c2 = 1 - ADAM_B1 ** t, 1 - ADAM_B2 ** t
        p = tree_map(lambda pi, m, v: pi - rate * ((m / c1)
                                                   / (torch.sqrt(v / c2)
                                                      + ADAM_EPS)),
                     p, mu, nu)
        p = tree_map(lambda t_: t_.detach(), p)
    return {"losses": losses, "first_grad": first, "params": p}
