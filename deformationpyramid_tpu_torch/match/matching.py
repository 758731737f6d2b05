"""Coarse feature matching: dual-softmax or Sinkhorn OT with dustbin.

Counterpart of ``deformationpyramid_tpu/match/matching.py`` (reference
``correspondence/lepard/matching.py``). Single-pair convention: feats
[S, C]/[T, C], masks [S]/[T]; the match list is a fixed-size extraction with
a validity mask, so that outputs compare row for row with the JAX
package's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .attention import matmul_f32acc
from .position_encoding import embed_pos

Tensor = torch.Tensor

_NEG = -1e9  # the reference uses -inf; a large finite value avoids NaN rows


@dataclasses.dataclass(frozen=True)
class MatchingConfig:
    feature_dim: int = 528
    confidence_threshold: float = 0.1
    dsmax_temperature: float = 0.1
    match_type: str = "dual_softmax"   # 'dual_softmax' | 'sinkhorn'
    skh_init_bin_score: float = 1.0
    skh_iters: int = 3
    # None (default) = uncapped: every mutual-max match above threshold is
    # extracted, like the reference (matching.py:71-88); an int pins a
    # fixed top-k capacity.
    max_matches: int | None = None
    # 'bfloat16': bf16 operands and f32 accumulation in the projections and
    # the dual-softmax similarity (inference); anything else float32
    compute_dtype: str = "float32"


def init_matching(gen: torch.Generator, cfg: MatchingConfig) -> dict:
    d = cfg.feature_dim
    limit = math.sqrt(6.0 / (d + d))
    p = {"src_proj": (torch.rand((d, d), generator=gen) * 2.0 - 1.0) * limit}
    if cfg.match_type == "sinkhorn":
        p["bin_score"] = torch.tensor(cfg.skh_init_bin_score,
                                      dtype=torch.float32)
    return p


def log_optimal_transport(scores: Tensor, alpha: Tensor, iters: int,
                          src_mask: Tensor, tgt_mask: Tensor) -> Tensor:
    """Log-domain sinkhorn with a learned dustbin row/col
    (``matching.py:6-38``). scores [S, T] -> log assignment [S+1, T+1]."""
    m, n = scores.shape
    ms = src_mask.sum().to(scores.dtype)
    ns = tgt_mask.sum().to(scores.dtype)
    alpha = alpha.to(scores.dtype)
    z = torch.cat([
        torch.cat([scores, alpha.expand(m, 1)], dim=1),
        torch.cat([alpha.expand(1, n), alpha.reshape(1, 1)], dim=1)], dim=0)
    norm = -torch.log(ms + ns)
    log_mu = torch.cat([norm.expand(m), (torch.log(ns) + norm)[None]])
    log_nu = torch.cat([norm.expand(n), (torch.log(ms) + norm)[None]])
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(z + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(z + u[:, None], dim=0)
    return z + u[:, None] + v[None, :] - norm


def confidence_matrix(p: dict, src_feats: Tensor, tgt_feats: Tensor,
                      src_pe: Tensor | None, tgt_pe: Tensor | None,
                      src_mask: Tensor, tgt_mask: Tensor,
                      cfg: MatchingConfig, pe_type: str = "rotary") -> Tensor:
    """[S, T] match confidence. NOTE: the reference projects BOTH clouds with
    ``src_proj`` (``matching.py:126-127`` uses self.src_proj twice — tgt_proj
    is dead weight); reproduced here for checkpoint parity. With
    ``compute_dtype='bfloat16'`` the projections and the dual-softmax
    similarity take bf16 operands with float32 accumulation, as in the JAX
    package (the Sinkhorn similarity stays float32 there too)."""
    bf16 = cfg.compute_dtype == "bfloat16"
    src = matmul_f32acc(src_feats, p["src_proj"], bf16)
    tgt = matmul_f32acc(tgt_feats, p["src_proj"], bf16)
    if src_pe is not None:
        src = embed_pos(pe_type, src, src_pe)
        tgt = embed_pos(pe_type, tgt, tgt_pe)
    c = src.shape[-1]
    src = src / c ** 0.5
    tgt = tgt / c ** 0.5

    both = src_mask[:, None] & tgt_mask[None, :]
    if cfg.match_type == "dual_softmax":
        sim = matmul_f32acc(src, tgt.T, bf16) / cfg.dsmax_temperature
        sim1 = torch.where(src_mask[:, None], sim, _NEG)
        sim2 = torch.where(tgt_mask[None, :], sim, _NEG)
        conf = torch.softmax(sim1, dim=0) * torch.softmax(sim2, dim=1)
    elif cfg.match_type == "sinkhorn":
        sim = torch.where(both, src @ tgt.T, _NEG)
        log_assign = log_optimal_transport(sim, p["bin_score"], cfg.skh_iters,
                                           src_mask, tgt_mask)
        conf = torch.exp(log_assign)[:-1, :-1]
    else:
        raise NotImplementedError(cfg.match_type)
    # zero out padded rows/cols so downstream top-k never selects them
    return conf * both


def extract_matches(conf: Tensor, thr: float, k: int,
                    mutual: bool = True) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k mutual-max matches above threshold (``matching.py:71-88``).

    Returns (idx [k, 2] (src, tgt), conf [k], valid [k]): invalid slots
    carry index 0 and valid=False. ``torch.topk`` orders exact ties in its
    own way, so the list equals the JAX package's as a set.
    """
    mask = conf > thr
    if mutual:
        mask = mask & (conf == conf.max(dim=1, keepdim=True).values)
        mask = mask & (conf == conf.max(dim=0, keepdim=True).values)
    scores = torch.where(mask, conf, -1.0).reshape(-1)
    top_scores, flat_idx = torch.topk(scores, k)
    valid = top_scores > 0.0
    t = conf.shape[1]
    idx = torch.stack([flat_idx // t, flat_idx % t], dim=-1)
    idx = torch.where(valid[:, None], idx, 0)
    return idx, torch.where(valid, top_scores, 0.0), valid


def extract_matches_all(conf: Tensor, thr: float
                        ) -> tuple[Tensor, Tensor, Tensor]:
    """ALL mutual-max matches above threshold (``matching.py:71-88``).

    A mutual-max match needs ``conf[s, t]`` to be both its row and column
    maximum, so each src row yields at most one match: capacity [S] with a
    validity mask is exact. Rows are emitted in src order (the reference
    emits nonzero() order; downstream consumers — NeCo, landmark loss,
    procrustes — are order-insensitive). Exact-tie rows keep one match
    where the reference keeps all. Padded rows/cols are all-zero, so with
    ``thr >= 0`` their best value 0 fails ``thr`` whichever index an argmax
    over equal values returns (on CUDA not always the first).

    Returns (idx [S, 2] (src, tgt), conf [S], valid [S]).
    """
    s = conf.shape[0]
    rows = torch.arange(s, device=conf.device)
    c, t_idx = conf.max(dim=1)                                     # [S]
    s_back = conf.argmax(dim=0)                                    # [T]
    mutual = s_back[t_idx] == rows
    valid = (c > thr) & mutual
    idx = torch.stack([rows, t_idx], dim=-1)
    idx = torch.where(valid[:, None], idx, 0)
    return idx, torch.where(valid, c, 0.0), valid
