"""Every function of ``match/losses.py``, port against JAX package, on the
CPU with the same numpy inputs.

Tolerances: values 1e-6 max abs (the losses are sums of a few thousand
float32 terms of order 1, divided by their count); gradients with respect
to the confidence matrix / the predicted confidences 1e-5 of the gradient's
max; 0/1 matrices, masks and labels equal.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.match import losses as jl
from deformationpyramid_tpu_torch.match import losses as tl

S, T, M = 48, 40, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=1e-6):
    t = t.detach() if isinstance(t, torch.Tensor) else t
    return abs(float(t) - float(j)) <= tol


@pytest.fixture(scope="module")
def case():
    """A padded pair: 40 / 33 valid rows, a dual-softmax-like confidence
    matrix, 20 GT matches (plus padded and out-of-range list rows), matches
    extracted by row argmax, a GT motion."""
    rng = np.random.default_rng(0)
    s_len, t_len = 40, 33
    src_mask, tgt_mask = np.arange(S) < s_len, np.arange(T) < t_len
    logits = rng.normal(size=(S, T)).astype(np.float32) * 2
    conf = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            * np.exp(logits) / np.exp(logits).sum(0, keepdims=True))
    conf = (conf * (src_mask[:, None] & tgt_mask[None])).astype(np.float32)
    match_gt = np.zeros((M, 2), np.int64)
    match_gt[:20, 0] = rng.permutation(s_len)[:20]
    match_gt[:20, 1] = rng.permutation(t_len)[:20]
    match_gt[20] = (S + 3, 1)         # beyond the matrix: dropped
    match_gt[21] = (2, T)             # column beyond: dropped, row overlaps
    match_gt[30:] = 5                 # padded rows of the list
    valid = np.arange(M) < 22
    for i, j in match_gt[:10]:        # some matches the model "found"
        conf[i, j] = 0.6
    s_pcd = rng.normal(size=(S, 3)).astype(np.float32) * src_mask[:, None]
    t_pcd = rng.normal(size=(T, 3)).astype(np.float32) * tgt_mask[:, None]
    flow = rng.normal(size=(S, 3)).astype(np.float32) * 0.05
    ang = 0.3
    rot = np.array([[np.cos(ang), -np.sin(ang), 0],
                    [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    trn = rng.normal(size=(3, 1)).astype(np.float32) * 0.1
    idx = np.stack([np.arange(S), conf.argmax(1)], 1).astype(np.int64)
    mvalid = (conf.max(1) > 0.1) & src_mask
    layer_conf = np.clip(conf * 0.8 + 0.001, 0, 1).astype(np.float32)
    r_pred = rot + rng.normal(size=(3, 3)).astype(np.float32) * 0.01
    t_pred = trn + 0.01
    data = {
        "s_pcd": s_pcd, "t_pcd": t_pcd, "src_mask": src_mask,
        "tgt_mask": tgt_mask, "conf_matrix_pred": conf, "match_idx": idx,
        "match_valid": mvalid, "R_s2t_pred": r_pred, "t_s2t_pred": t_pred,
        "position_layers": [{"conf_matrix": layer_conf,
                             "R_s2t_pred": r_pred.T.copy(),
                             "t_s2t_pred": t_pred * 2}]}
    return dict(data=data, match_gt=match_gt, valid=valid, flow=flow, rot=rot,
                trn=trn)


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree), jax.tree.map(_t, tree))


def test_matches_to_conf_gt_is_equal(case):
    j = jl.matches_to_conf_gt(jnp.asarray(case["match_gt"]),
                              jnp.asarray(case["valid"]), S, T)
    t = tl.matches_to_conf_gt(_t(case["match_gt"]), _t(case["valid"]), S, T)
    assert t.shape == (S, T) and t.dtype == torch.float32
    assert np.array_equal(t.numpy(), np.asarray(j))
    assert int(t.sum()) == 20
    none = tl.matches_to_conf_gt(_t(case["match_gt"]),
                                 torch.zeros(M, dtype=torch.bool), S, T)
    assert not none.any()


@pytest.mark.parametrize("cfg_kw", [{}, dict(focal_alpha=0.5, focal_gamma=1.0,
                                             pos_weight=2.0,
                                             neg_weight=0.5)])
def test_focal_loss_value_and_gradient(case, cfg_kw):
    conf = case["data"]["conf_matrix_pred"]
    gt = np.asarray(jl.matches_to_conf_gt(jnp.asarray(case["match_gt"]),
                                          jnp.asarray(case["valid"]), S, T))
    weight = (case["data"]["src_mask"][:, None]
              & case["data"]["tgt_mask"][None]).astype(np.float32)
    jcfg, tcfg = jl.MatchLossConfig(**cfg_kw), tl.MatchLossConfig(**cfg_kw)
    jv, jg = jax.value_and_grad(lambda c: jl.focal_correspondence_loss(
        c, jnp.asarray(gt), jnp.asarray(weight), jcfg))(jnp.asarray(conf))
    tc = _t(conf).requires_grad_(True)
    tv = tl.focal_correspondence_loss(tc, _t(gt), _t(weight), tcfg)
    tg, = torch.autograd.grad(tv, tc)
    assert _close(tv, jv)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    assert np.abs(jg).max() > 0


def test_match_recall_precision(case):
    gt = jl.matches_to_conf_gt(jnp.asarray(case["match_gt"]),
                               jnp.asarray(case["valid"]), S, T)
    d = case["data"]
    jr, jp = jl.match_recall_precision(gt, jnp.asarray(d["match_idx"]),
                                       jnp.asarray(d["match_valid"]))
    tr, tp = tl.match_recall_precision(_t(np.asarray(gt)), _t(d["match_idx"]),
                                       _t(d["match_valid"]))
    assert _close(tr, jr) and _close(tp, jp)
    assert 0.0 < float(tr) <= 1.0 and 0.0 < float(tp) <= 1.0
    # no predictions, no GT: both 0, not NaN
    zr, zp = tl.match_recall_precision(torch.zeros(S, T), _t(d["match_idx"]),
                                       torch.zeros(S, dtype=torch.bool))
    assert float(zr) == 0.0 and float(zp) == 0.0


@pytest.mark.parametrize("motion_weight", [1.0, 0.0])
def test_match_motion_loss_value_info_and_gradients(case, motion_weight):
    jd, td = _both(case["data"])
    extra = (case["match_gt"], case["valid"], case["flow"], case["rot"],
             case["trn"])
    jcfg = jl.MatchLossConfig(motion_weight=motion_weight)
    tcfg = tl.MatchLossConfig(motion_weight=motion_weight)

    def jf(conf, r_pred):
        d = dict(jd, conf_matrix_pred=conf, R_s2t_pred=r_pred)
        return jl.match_motion_loss(d, *map(jnp.asarray, extra), jcfg)

    (jv, jinfo), (jgc, jgr) = jax.value_and_grad(jf, argnums=(0, 1),
                                                 has_aux=True)(
        jd["conf_matrix_pred"], jd["R_s2t_pred"])
    tc = td["conf_matrix_pred"].requires_grad_(True)
    trp = td["R_s2t_pred"].requires_grad_(True)
    tv, tinfo = tl.match_motion_loss(
        dict(td, conf_matrix_pred=tc, R_s2t_pred=trp), *map(_t, extra), tcfg)
    assert _close(tv, jv)
    assert set(tinfo) == set(jinfo)
    for k in jinfo:
        assert _close(tinfo[k], jinfo[k]), k
    assert float(tinfo["recall_coarse"]) > 0.01     # the motion gate is open
    grads = torch.autograd.grad(tv, (tc, trp), allow_unused=True)
    jgc = np.asarray(jgc)
    assert np.abs(grads[0].numpy() - jgc).max() <= 1e-5 * np.abs(jgc).max()
    if motion_weight > 0:
        jgr = np.asarray(jgr)
        assert np.abs(grads[1].numpy() - jgr).max() \
            <= 1e-5 * np.abs(jgr).max()
    else:
        assert grads[1] is None and not np.asarray(jgr).any()


def test_match_motion_loss_gate_closed_below_one_percent_recall(case):
    """recall <= 0.01 switches the motion term off (a ``where``)."""
    jd, td = _both(dict(case["data"], match_valid=np.zeros(S, bool)))
    extra = (case["match_gt"], case["valid"], case["flow"], case["rot"],
             case["trn"])
    jv, jinfo = jl.match_motion_loss(jd, *map(jnp.asarray, extra))
    tv, tinfo = tl.match_motion_loss(td, *map(_t, extra))
    assert float(tinfo["recall_coarse"]) == 0.0 == float(
        jinfo["recall_coarse"])
    assert _close(tv, jv)
    focal_only = tl.match_motion_loss(td, *map(_t, extra),
                                      tl.MatchLossConfig(motion_weight=0.0))
    assert _close(tv, focal_only[0], 1e-7)


@pytest.fixture(scope="module")
def neco_case(case):
    rng = np.random.default_rng(1)
    d = case["data"]
    idx, valid = d["match_idx"], d["match_valid"].copy()
    valid[:12] = True
    s_warp = (case["rot"] @ (d["s_pcd"] + case["flow"]).T + case["trn"]).T
    t_matched = s_warp[idx[:, 0]] + rng.normal(size=(S, 3)) * 0.03
    vec6d = np.concatenate([d["s_pcd"][idx[:, 0]], t_matched],
                           1).astype(np.float32)
    conf = rng.uniform(0.05, 0.95, S).astype(np.float32)
    return dict(vec6d=vec6d, valid=valid, idx=idx, conf=conf)


def test_compute_inlier_mask_is_equal(case, neco_case):
    d, n = case["data"], neco_case
    for thr in (0.04, 0.1):
        j = jl.compute_inlier_mask(
            *map(jnp.asarray, (n["vec6d"], n["valid"], n["idx"], d["s_pcd"],
                               case["flow"], case["rot"], case["trn"])), thr)
        t = tl.compute_inlier_mask(
            *map(_t, (n["vec6d"], n["valid"], n["idx"], d["s_pcd"],
                      case["flow"], case["rot"], case["trn"])), thr)
        assert t.dtype == torch.bool
        assert np.array_equal(t.numpy(), np.asarray(j))
        if thr == 0.04:           # both classes present
            assert 0 < int(t.sum()) < int(n["valid"].sum())


def test_balanced_bce_value_and_gradient(neco_case):
    n = neco_case
    labels = np.random.default_rng(2).random(S) < 0.4
    for lab in (labels, np.ones(S, bool)):
        jv, jg = jax.value_and_grad(lambda c: jl.balanced_bce(
            c, jnp.asarray(lab), jnp.asarray(n["valid"])))(
                jnp.asarray(n["conf"]))
        tc = _t(n["conf"]).requires_grad_(True)
        tv = tl.balanced_bce(tc, _t(lab), _t(n["valid"]))
        tg, = torch.autograd.grad(tv, tc)
        assert _close(tv, jv)
        jg = np.asarray(jg)
        assert np.abs(tg.numpy() - jg).max() <= 1e-5 * max(np.abs(jg).max(),
                                                            1e-30)
    none = tl.balanced_bce(_t(n["conf"]), _t(labels),
                           torch.zeros(S, dtype=torch.bool))
    assert float(none) == 0.0


def test_neco_loss_value_info_and_gradient(case, neco_case):
    d, n = case["data"], neco_case
    rest = (n["vec6d"], n["valid"], n["idx"], d["s_pcd"], case["flow"],
            case["rot"], case["trn"])
    (jv, jinfo), jg = jax.value_and_grad(
        lambda c: jl.neco_loss(c, *map(jnp.asarray, rest)), has_aux=True)(
            jnp.asarray(n["conf"]))
    tc = _t(n["conf"]).requires_grad_(True)
    tv, tinfo = tl.neco_loss(tc, *map(_t, rest))
    tg, = torch.autograd.grad(tv, tc)
    assert _close(tv, jv)
    assert set(tinfo) == set(jinfo) == {"IR_lepard", "IR_neco", "n_matches"}
    for k in jinfo:
        assert _close(tinfo[k], jinfo[k]), k
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()
    assert not tg[~_t(n["valid"])].any()
