"""Multiview outlier rejection: correspondence-graph attention (GAT) models.

Counterpart of ``deformationpyramid_tpu/match/multiview.py`` (reference
``correspondence/outlier_rejection/cycle_consistency.py``,
``graph_attention.py:40-157`` and ``geometry_attention.py:110-197``). The
multiview model refines per-match features by alternating within-pair 6D
attention with cross-pair graph attention over a correspondence graph whose
edges connect matches that touch the same point cloud within a search
radius; NonLocalNet is the PointDSC-style single-pair alternative.

Edge lists are host-built (numpy, a copy of the JAX package's function),
padded to a static capacity and masked. The gathers are ``index_select``
(the backward of ``x[idx]`` sorts, slow on repeated indices) and the two
segment sums are ``index_add`` into [N, h] and [N, h, d_out]. Each pair's
attention carries NeCo's spatial compatibility when the config asks for it,
so it takes the einsum route of ``match/attention.py``; the P pairs run one
after another.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .attention import _xavier, apply_attention_layer, init_attention_layer
from .outlier_rejection import NeCoConfig, _torch_linear, _vol_pe_6d

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# GAT layer (edge-list attention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    feature_dim: int = 144
    n_head: int = 8
    dropout: float = 0.0   # kept for the JAX package's fields; not applied


def init_gat_layer(gen: torch.Generator, cfg: GATConfig) -> dict:
    d, h = cfg.feature_dim, cfg.n_head
    d_out = d // h
    return {
        "input_proj": _xavier(gen, (d, h * d_out)),
        "score_src": _xavier(gen, (1, h, d_out)),
        "score_tgt": _xavier(gen, (1, h, d_out)),
        "bias": torch.zeros(h * d_out),
        "skip_proj": _xavier(gen, (d, h * d_out)),
    }


def apply_gat_layer(p: dict, feat: Tensor, edge_src: Tensor, edge_tgt: Tensor,
                    edge_valid: Tensor, cfg: GATConfig) -> Tensor:
    """feat [N, D] node features; edges (src -> tgt) with a validity mask.

    Per-edge LeakyReLU(score_src + score_tgt) attention, softmax-normalised
    over each target's in-edges by a segment sum, the weighted sum of the
    sources, plus the bias. As in the JAX package the scores are shifted by
    the global max over all E edges (padded ones included) before the exp,
    and an invalid edge contributes nothing.
    """
    n, d = feat.shape
    h = cfg.n_head
    d_out = d // h
    proj = (feat @ p["input_proj"]).reshape(n, h, d_out)
    src_score = (proj * p["score_src"]).sum(dim=-1)        # [N, h]
    tgt_score = (proj * p["score_tgt"]).sum(dim=-1)

    e_src = edge_src.clamp(0, n - 1)
    e_tgt = edge_tgt.clamp(0, n - 1)
    score = F.leaky_relu(src_score.index_select(0, e_src)
                         + tgt_score.index_select(0, e_tgt), 0.2)  # [E, h]
    score = score - score.max().detach()
    exp_s = torch.where(edge_valid[:, None], torch.exp(score), 0.0)
    denom = exp_s.new_zeros((n, h)).index_add(0, e_tgt, exp_s)
    att = exp_s / (denom.index_select(0, e_tgt) + 1e-16)

    msg = proj.index_select(0, e_src) * att[..., None]     # [E, h, d_out]
    msg = torch.where(edge_valid[:, None, None], msg, 0.0)
    out = msg.new_zeros((n, h, d_out)).index_add(0, e_tgt, msg)
    return out.reshape(n, h * d_out) + p["bias"]


# ---------------------------------------------------------------------------
# Multiview Outlier_Rejection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MultiviewNeCoConfig:
    neco: NeCoConfig = dataclasses.field(default_factory=NeCoConfig)
    edge_search_radius: float = 0.1
    alternate: bool = True

    @property
    def gat(self) -> GATConfig:
        return GATConfig(self.neco.feature_dim, self.neco.n_head)


def init_multiview_neco(gen: torch.Generator,
                        cfg: MultiviewNeCoConfig) -> dict:
    n = cfg.neco.num_layers
    return {
        "in_proj": _torch_linear(gen, cfg.neco.in_dim, cfg.neco.feature_dim),
        "pair_layers": [init_attention_layer(gen, cfg.neco.attention)
                        for _ in range(n)],
        "graph_layers": [init_gat_layer(gen, cfg.gat) for _ in range(n)],
        "cls1": _torch_linear(gen, cfg.neco.feature_dim, 64),
        "cls2": _torch_linear(gen, 64, 32),
        "cls3": _torch_linear(gen, 32, 1),
    }


def _linear(x: Tensor, p: dict) -> Tensor:
    return x @ p["w"] + p["b"]


def apply_multiview_neco(params: dict, vec6d: Tensor, mask: Tensor,
                         edge_src: Tensor, edge_tgt: Tensor,
                         edge_valid: Tensor, cfg: MultiviewNeCoConfig
                         ) -> Tensor:
    """vec6d [P, K, 6] per-pair matches, mask [P, K]; edges index the
    flattened [P*K] match set. Returns confidence [P, K]."""
    ncfg = cfg.neco
    n_pairs, k, _ = vec6d.shape
    if ncfg.spatial_consistency_check:
        src, tgt = vec6d[..., :3], vec6d[..., 3:]
        d_src = torch.linalg.norm(src[:, :, None] - src[:, None], dim=-1)
        d_tgt = torch.linalg.norm(tgt[:, :, None] - tgt[:, None], dim=-1)
        compat = (1.0 - (d_src - d_tgt) ** 2 / ncfg.sigma_spat ** 2
                  ).clamp_min(0.0).detach()
    else:
        compat = [None] * n_pairs
    pe = ([None] * n_pairs if ncfg.pe_type == "none"
          else _vol_pe_6d(vec6d, ncfg))

    feat = _linear(vec6d, params["in_proj"])
    for pl_, gl in zip(params["pair_layers"], params["graph_layers"]):
        feat = torch.stack([
            apply_attention_layer(pl_, feat[i], feat[i], pe[i], pe[i],
                                  mask[i], mask[i], ncfg.attention,
                                  compatibility=compat[i])
            for i in range(n_pairs)])
        if cfg.alternate:
            flat = feat.reshape(n_pairs * k, -1)
            flat = apply_gat_layer(gl, flat, edge_src, edge_tgt, edge_valid,
                                   cfg.gat)
            feat = flat.reshape(n_pairs, k, -1)
    h = torch.relu(_linear(feat, params["cls1"]))
    h = torch.relu(_linear(h, params["cls2"]))
    conf = torch.sigmoid(_linear(h, params["cls3"]))[..., 0]
    return conf * mask


def build_correspondence_graph(vec6d: np.ndarray, mask: np.ndarray,
                               pcd_pairs: np.ndarray, edge_radius: float,
                               max_edges: int
                               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side correspondence-graph edges
    (``cycle_consistency.py:166-231``), a copy of the JAX package's: two
    matches are connected if their endpoints in a shared point cloud lie
    within ``edge_radius``.

    Returns (edge_src [E], edge_tgt [E], edge_valid [E]) padded to
    ``max_edges``; edges beyond ``max_edges`` are dropped without a word,
    as there.
    """
    n_pairs, k, _ = vec6d.shape
    corr_ids = np.arange(n_pairs * k).reshape(n_pairs, k)
    n_pcd = int(pcd_pairs.max()) + 1 if len(pcd_pairs) else 0
    srcs, tgts = [], []
    head = vec6d[..., :3]
    tail = vec6d[..., 3:]
    for p_i in range(n_pcd):
        is_head = pcd_pairs[:, 0] == p_i
        is_tail = pcd_pairs[:, 1] == p_i
        involved = is_head | is_tail
        if involved.sum() < 1:
            continue
        pos = np.where(is_head[involved][:, None, None],
                       head[involved], tail[involved]).reshape(-1, 3)
        ids = corr_ids[involved].reshape(-1)
        m = mask[involved].reshape(-1)
        d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
        ok = (d2 < edge_radius ** 2) & (m[:, None] & m[None])
        si, ti = np.nonzero(ok)
        srcs.append(ids[si])
        tgts.append(ids[ti])
    if srcs:
        es = np.concatenate(srcs)
        et = np.concatenate(tgts)
    else:
        es = et = np.zeros((0,), np.int64)
    e = len(es)
    out_s = np.zeros((max_edges,), np.int64)
    out_t = np.zeros((max_edges,), np.int64)
    valid = np.zeros((max_edges,), bool)
    take = min(e, max_edges)
    out_s[:take], out_t[:take], valid[:take] = es[:take], et[:take], True
    return out_s, out_t, valid


# ---------------------------------------------------------------------------
# NonLocalNet (PointDSC-style alternative confidence model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NonLocalNetConfig:
    in_dim: int = 6
    num_layers: int = 6
    num_channels: int = 128


def init_nonlocalnet(gen: torch.Generator,
                     cfg: NonLocalNetConfig = NonLocalNetConfig()) -> dict:
    c = cfg.num_channels
    params = {"layer0": _torch_linear(gen, cfg.in_dim, c), "blocks": []}
    for _ in range(cfg.num_layers):
        params["blocks"].append({
            "pointcn": _torch_linear(gen, c, c),
            "q": _torch_linear(gen, c, c),
            "k": _torch_linear(gen, c, c),
            "v": _torch_linear(gen, c, c),
            "msg1": _torch_linear(gen, c, c // 2),
            "msg2": _torch_linear(gen, c // 2, c // 2),
            "msg3": _torch_linear(gen, c // 2, c),
        })
    params["cls1"] = _torch_linear(gen, c, 32)
    params["cls2"] = _torch_linear(gen, 32, 32)
    params["cls3"] = _torch_linear(gen, 32, 1)
    return params


def _bn_free(x: Tensor, valid: Tensor | None, eps: float = 1e-5) -> Tensor:
    """BatchNorm1d without running statistics: normalise over the match
    axis (over the valid rows where a mask is given)."""
    if valid is None:
        mean = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
    else:
        w = valid[:, None].to(x.dtype)
        nv = w.sum().clamp_min(1.0)
        mean = (x * w).sum(dim=0, keepdim=True) / nv
        var = ((x - mean) ** 2 * w).sum(dim=0, keepdim=True) / nv
    return (x - mean) * torch.rsqrt(var + eps)


def apply_nonlocalnet(params: dict, vec6d: Tensor, mask: Tensor,
                      cfg: NonLocalNetConfig = NonLocalNetConfig()) -> Tensor:
    """vec6d [K, 6] -> confidence [K] (``geometry_attention.py:156-197``)."""
    feat = _linear(vec6d, params["layer0"])
    for blk in params["blocks"]:
        feat = torch.relu(_bn_free(_linear(feat, blk["pointcn"]), mask))
        q = _linear(feat, blk["q"])
        k_ = _linear(feat, blk["k"])
        v = _linear(feat, blk["v"])
        a = (q @ k_.T) / math.sqrt(q.shape[-1])
        a = torch.where(mask[None, :], a, -1e9)
        msg = torch.softmax(a, dim=-1) @ v
        m = torch.relu(_bn_free(_linear(msg, blk["msg1"]), mask))
        m = torch.relu(_bn_free(_linear(m, blk["msg2"]), mask))
        feat = feat + _linear(m, blk["msg3"])
    h = torch.relu(_linear(feat, params["cls1"]))
    h = torch.relu(_linear(h, params["cls2"]))
    conf = torch.sigmoid(_linear(h, params["cls3"]))[:, 0]
    return conf * mask
