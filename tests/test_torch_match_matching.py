"""Matching, soft Procrustes, the repositioning transformer, NeCo and the
matching metrics of the port against the JAX package's, on the CPU: the same
numpy inputs and the same weights (JAX init, converted).

Tolerances (max abs, float32): confidence matrices 1e-5 (entries <= 1);
match lists as sets (``torch.topk`` and ``jax.lax.top_k`` order exact ties
differently); soft Procrustes R, t 1e-4 with JAX at ``topk_method='exact'``
on a well-conditioned confidence matrix, U and V never compared; the
transformer's features 1e-4; NeCo confidences 1e-4.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.match import matching as jm
from deformationpyramid_tpu.match import outlier_rejection as jneco
from deformationpyramid_tpu.match import position_encoding as jpe
from deformationpyramid_tpu.match import procrustes as jproc
from deformationpyramid_tpu.match import transformer as jtr
from deformationpyramid_tpu.metrics import matching as jmet
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.match import matching as tm
from deformationpyramid_tpu_torch.match import outlier_rejection as tneco
from deformationpyramid_tpu_torch.match import position_encoding as tpe
from deformationpyramid_tpu_torch.match import procrustes as tproc
from deformationpyramid_tpu_torch.match import transformer as ttr
from deformationpyramid_tpu_torch.metrics import matching as tmet

FD = 96


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _err(t, j):
    return float(np.abs(np.asarray(t.detach()) - np.asarray(j)).max())


def _clouds(seed, s=48, t=40, s_len=41, t_len=36):
    """Two padded clouds related by a small rigid motion plus noise, and
    features that carry the correspondence."""
    rng = np.random.default_rng(seed)
    s_pcd = rng.uniform(-0.4, 0.4, (s, 3)).astype(np.float32)
    ang = 0.3
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang),
                                                     np.cos(ang), 0],
                    [0, 0, 1]], np.float32)
    perm = rng.permutation(s)[:t]
    t_pcd = (s_pcd[perm] @ rot.T + np.float32([0.05, -0.02, 0.03])
             + rng.normal(0, 0.002, (t, 3))).astype(np.float32)
    base = rng.normal(size=(s, FD)).astype(np.float32)
    s_feat = base
    t_feat = (base[perm] + 0.3 * rng.normal(size=(t, FD))).astype(np.float32)
    sm, tmk = np.arange(s) < s_len, np.arange(t) < t_len
    s_pcd[~sm], t_pcd[~tmk], s_feat[~sm], t_feat[~tmk] = 0, 0, 0, 0
    return s_pcd, t_pcd, s_feat, t_feat, sm, tmk, perm, rot


VOL = dict(feature_dim=FD, vol_origin=(-2.0, -2.0, -2.0))


# ---------------- matching ----------------

@pytest.mark.parametrize("match_type", ["dual_softmax", "sinkhorn"])
@pytest.mark.parametrize("with_pe", [True, False])
def test_confidence_matrix_matches_jax(match_type, with_pe):
    s_pcd, t_pcd, s_feat, t_feat, sm, tmk, _, _ = _clouds(0)
    kw = dict(feature_dim=FD, match_type=match_type)
    jcfg, tcfg = jm.MatchingConfig(**kw), tm.MatchingConfig(**kw)
    jp = jm.init_matching(jax.random.key(1), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    assert set(tp) == set(jp)
    jpes = tpes = (None, None)
    if with_pe:
        jpes = tuple(jpe.volumetric_pe(jnp.asarray(p), jpe.VolPEConfig(**VOL))
                     for p in (s_pcd, t_pcd))
        tpes = tuple(tpe.volumetric_pe(_t(p), tpe.VolPEConfig(**VOL))
                     for p in (s_pcd, t_pcd))
    j = jm.confidence_matrix(jp, jnp.asarray(s_feat), jnp.asarray(t_feat),
                             *jpes, jnp.asarray(sm), jnp.asarray(tmk), jcfg)
    t = tm.confidence_matrix(tp, _t(s_feat), _t(t_feat), *tpes, _t(sm),
                             _t(tmk), tcfg)
    assert t.shape == (48, 40) and _err(t, j) < 1e-5
    assert float(t.max()) > 1e-3
    assert not t[~_t(sm)].any() and not t[:, ~_t(tmk)].any()


def test_log_optimal_transport_matches_jax():
    rng = np.random.default_rng(2)
    scores = rng.normal(size=(6, 8)).astype(np.float32)
    sm, tmk = np.arange(6) < 5, np.arange(8) < 8
    j = jm.log_optimal_transport(jnp.asarray(scores), jnp.float32(1.0), 30,
                                 jnp.asarray(sm), jnp.asarray(tmk))
    t = tm.log_optimal_transport(_t(scores), torch.tensor(1.0), 30, _t(sm),
                                 _t(tmk))
    assert t.shape == (7, 9) and _err(t, j) < 1e-5


def _match_set(idx, valid):
    return {(int(i), int(j)) for (i, j), v in
            zip(np.asarray(idx), np.asarray(valid)) if v}


@pytest.mark.parametrize("trial", range(4))
def test_extract_matches_equal_sets(trial):
    rng = np.random.default_rng(10 + trial)
    s, t = int(rng.integers(6, 40)), int(rng.integers(6, 40))
    conf = rng.uniform(size=(s, t)).astype(np.float32)
    conf[s - 2:, :] = 0.0
    conf[:, t - 1:] = 0.0
    for mutual in (True, False):
        ji, jc, jv = jm.extract_matches(jnp.asarray(conf), 0.5, 16,
                                        mutual=mutual)
        ti, tc, tv = tm.extract_matches(_t(conf), 0.5, 16, mutual=mutual)
        assert ti.shape == (16, 2) and tv.dtype == torch.bool
        assert _match_set(ti, tv) == _match_set(ji, jv)
        assert np.array_equal(np.sort(tc.numpy()), np.sort(np.asarray(jc)))
        assert not ti[~tv].any()
    ji, jc, jv = jm.extract_matches_all(jnp.asarray(conf), 0.5)
    ti, tc, tv = tm.extract_matches_all(_t(conf), 0.5)
    want = (conf > 0.5) & (conf == conf.max(1, keepdims=True)) \
        & (conf == conf.max(0, keepdims=True))
    assert _match_set(ti, tv) == _match_set(ji, jv) \
        == set(zip(*np.nonzero(want)))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert not tv[s - 2:].any()


# ---------------- soft Procrustes ----------------

def _well_conditioned_conf(seed):
    s_pcd, t_pcd, _, _, sm, tmk, perm, rot = _clouds(seed)
    rng = np.random.default_rng(seed + 100)
    conf = rng.uniform(0, 0.01, (48, 40)).astype(np.float32)
    for col, row in enumerate(perm):
        conf[row, col] = 0.5 + 0.4 * rng.uniform()
    conf *= sm[:, None] & tmk[None, :]
    return conf.astype(np.float32), s_pcd, t_pcd, sm, tmk, rot


@pytest.mark.parametrize("sample_rate", [1.0, 0.5])
def test_soft_procrustes_matches_jax_exact_topk(sample_rate):
    conf, s_pcd, t_pcd, sm, tmk, rot = _well_conditioned_conf(3)
    jcfg = jproc.ProcrustesConfig(sample_rate=sample_rate,
                                  topk_method="exact")
    tcfg = tproc.ProcrustesConfig(sample_rate=sample_rate)
    j = jproc.soft_procrustes(*(jnp.asarray(a) for a in
                                (conf, s_pcd, t_pcd, sm, tmk)), jcfg)
    t = tproc.soft_procrustes(*(_t(a) for a in (conf, s_pcd, t_pcd, sm, tmk)),
                              tcfg)
    for name, a, b in zip(("R", "t", "R_fwd", "t_fwd"), t[:4], j[:4]):
        assert _err(a, b) < 1e-4, name
    assert abs(float(t[4]) - float(j[4])) < 1e-3 * float(j[4])
    assert bool(t[5]) == bool(j[5]) is True
    assert np.abs(t[0].numpy() - rot).max() < 0.05      # the planted motion
    assert abs(float(torch.linalg.det(t[0])) - 1.0) < 1e-5


def test_soft_procrustes_gates_a_degenerate_fit():
    """Collinear clouds: the condition number explodes, ``ok`` is False and
    the forwarded transform is the identity, on the tensors' device."""
    line = np.linspace(-1, 1, 20, dtype=np.float32)[:, None] * \
        np.float32([[1.0, 0.5, 0.2]])
    conf = np.eye(20, dtype=np.float32) * 0.9
    ones = np.ones(20, bool)
    t = tproc.soft_procrustes(_t(conf), _t(line), _t(line + 0.1), _t(ones),
                              _t(ones))
    j = jproc.soft_procrustes(jnp.asarray(conf), jnp.asarray(line),
                              jnp.asarray(line + 0.1), jnp.asarray(ones),
                              jnp.asarray(ones),
                              jproc.ProcrustesConfig(topk_method="exact"))
    assert not bool(t[5]) and not bool(j[5])
    assert torch.equal(t[2], torch.eye(3)) and not t[3].any()
    assert torch.isfinite(t[0]).all() and torch.isfinite(t[1]).all()


def test_weighted_procrustes_recovers_a_rotation():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(30, 3)).astype(np.float32)
    from deformationpyramid_tpu_torch.geometry.rotations import euler_to_SO3

    rot = euler_to_SO3(torch.tensor([0.4, -0.3, 0.8])).numpy()
    Y = X @ rot.T + np.float32([0.3, 0.1, -0.2])
    w = rng.uniform(0.1, 1.0, (30, 1)).astype(np.float32)
    R, t, cond = tproc.weighted_procrustes_with_condition(_t(X), _t(Y), _t(w))
    jR, jt, jcond = jproc.weighted_procrustes_with_condition(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w))
    assert _err(R, jR) < 1e-5 and _err(t, jt) < 1e-5
    assert abs(float(cond) - float(jcond)) < 1e-4 * float(jcond)
    assert np.abs(R.numpy() - rot).max() < 1e-3


# ---------------- transformer ----------------

def _transformer_cfgs(**kw):
    out = []
    for mod_tr, mod_m, mod_pe, mod_pr in ((jtr, jm, jpe, jproc),
                                          (ttr, tm, tpe, tproc)):
        extra = dict(kw)
        proc = (mod_pr.ProcrustesConfig(topk_method="exact")
                if mod_pr is jproc else mod_pr.ProcrustesConfig())
        out.append(mod_tr.TransformerConfig(
            feature_dim=FD, n_head=4, vol=mod_pe.VolPEConfig(**VOL),
            matching=mod_m.MatchingConfig(feature_dim=FD), procrustes=proc,
            **extra))
    return out


@pytest.mark.parametrize("positioning,impl", [("procrustes", "xla"),
                                              ("procrustes", "flash"),
                                              ("oracle", "xla")])
def test_apply_transformer_matches_jax(positioning, impl):
    s_pcd, t_pcd, s_feat, t_feat, sm, tmk, _, rot = _clouds(5)
    jcfg, tcfg = _transformer_cfgs(positioning_type=positioning)
    tcfg = dataclasses.replace(tcfg, attention_impl=impl)
    jp = jtr.init_transformer(jax.random.key(6), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    gt = {}
    if positioning == "oracle":
        gt = dict(gt_rot=rot, gt_trn=np.float32([[0.05], [-0.02], [0.03]]))
    j = jtr.apply_transformer(
        jp, *(jnp.asarray(a) for a in (s_feat, t_feat, s_pcd, t_pcd, sm,
                                       tmk)), jcfg,
        **{k: jnp.asarray(v) for k, v in gt.items()})
    t = ttr.apply_transformer(
        tp, *(_t(a) for a in (s_feat, t_feat, s_pcd, t_pcd, sm, tmk)), tcfg,
        **{k: _t(v) for k, v in gt.items()})
    # padded query rows differ between the streamed and the einsum route
    rows = ((sm, tmk) if impl == "flash"
            else (np.ones_like(sm), np.ones_like(tmk)))
    for k, (a, b, keep) in enumerate(zip(t[:2], j[:2], rows)):
        assert _err(a[_t(keep)], np.asarray(b)[keep]) < 1e-4, k
    assert _err(t[2], j[2]) < 1e-4 and _err(t[3], j[3]) < 1e-5
    assert len(t[4]) == len(j[4]) == (1 if positioning == "procrustes" else 0)
    for tl, jl in zip(t[4], j[4]):
        assert _err(tl["conf_matrix"], jl["conf_matrix"]) < 1e-5
        cond = float(jl["condition"])
        assert abs(float(tl["condition"]) - cond) < 1e-2 * cond
        if abs(cond - 40.0) > 2.0:
            assert bool(tl["solution_mask"]) == bool(jl["solution_mask"])
            assert _err(tl["R_s2t_pred"], jl["R_s2t_pred"]) < 1e-3


def test_init_transformer_tree_and_rand_rot_pcd():
    jcfg, tcfg = _transformer_cfgs()
    jp = _np_tree(jtr.init_transformer(jax.random.key(0), jcfg))
    tp = jax.tree.map(lambda a: a.numpy(), ttr.init_transformer(
        torch.Generator().manual_seed(0), tcfg))
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert a.shape == b.shape
    gen = torch.Generator().manual_seed(1)
    rot = ttr.randSO3(gen)
    assert (rot @ rot.T - torch.eye(3)).abs().max() < 1e-5
    assert abs(float(torch.linalg.det(rot)) - 1.0) < 1e-5
    s_pcd, _, _, _, sm, _, _, _ = _clouds(7)
    out = ttr.rand_rot_pcd(gen, _t(s_pcd), _t(sm), rot=rot)
    pts = np.where(sm[:, None], s_pcd, 0.0)
    c = pts.sum(0) / sm.sum()
    want = (pts - c) @ rot.numpy().T + c
    assert np.abs(out.numpy() - want).max() < 1e-5
    again = ttr.rand_rot_pcd(torch.Generator().manual_seed(2), _t(s_pcd),
                             _t(sm))
    assert torch.isfinite(again).all()


# ---------------- NeCo ----------------

@pytest.mark.parametrize("check,pe_type", [(True, "rotary"),
                                           (False, "rotary"),
                                           (True, "sinusoidal")])
def test_apply_neco_matches_jax(check, pe_type):
    rng = np.random.default_rng(8)
    k = 40
    vec = rng.uniform(-0.3, 0.3, (k, 6)).astype(np.float32)
    vec[:, 3:] = vec[:, :3] + rng.normal(0, 0.03, (k, 3)).astype(np.float32)
    mask = np.arange(k) < 33
    vec[~mask] = 0
    kw = dict(feature_dim=48, n_head=4, num_layers=3, pe_type=pe_type,
              spatial_consistency_check=check)
    jcfg, tcfg = jneco.NeCoConfig(**kw), tneco.NeCoConfig(**kw)
    jp = jneco.init_neco(jax.random.key(9), jcfg)
    tp = tdp.params_from_numpy(_np_tree(jp))
    j = jneco.apply_neco(jp, jnp.asarray(vec), jnp.asarray(mask), jcfg)
    t = tneco.apply_neco(tp, _t(vec), _t(mask), tcfg)
    assert t.shape == (k,) and _err(t, j) < 1e-4
    assert not t[~_t(mask)].any() and float(t[_t(mask)].min()) > 0.0
    assert _err(tneco._vol_pe_6d(_t(vec), tcfg),
                jneco._vol_pe_6d(jnp.asarray(vec), jcfg)) < 1e-5
    tn = jax.tree.map(lambda a: a.numpy(), tneco.init_neco(
        torch.Generator().manual_seed(0), tcfg))
    assert jax.tree.structure(tn) == jax.tree.structure(_np_tree(jp))


# ---------------- metrics ----------------

@pytest.mark.parametrize("n_valid", [0, 2, 25])
def test_matching_metrics_match_jax(n_valid):
    rng = np.random.default_rng(11)
    k, m = 32, 50
    ls = rng.uniform(-0.3, 0.3, (k, 3)).astype(np.float32)
    flow = rng.normal(0, 0.02, (k, 3)).astype(np.float32)
    lt = (ls + flow + rng.normal(0, 0.02, (k, 3))).astype(np.float32)
    valid = np.arange(k) < n_valid
    rot = np.eye(3, dtype=np.float32)
    trn = np.zeros((3, 1), np.float32)
    j = jmet.inlier_ratio(*(jnp.asarray(a) for a in
                            (ls, lt, valid, rot, trn, flow)))
    t = tmet.inlier_ratio(*(_t(a) for a in (ls, lt, valid, rot, trn, flow)))
    assert abs(float(t) - float(j)) < 1e-6
    pts = rng.uniform(-0.3, 0.3, (m, 3)).astype(np.float32)
    gt = rng.normal(0, 0.03, (m, 3)).astype(np.float32)
    mv = np.arange(m) < 44
    for metric_valid in (None, mv):
        j = jmet.nrfmr(*(jnp.asarray(a) for a in (ls, lt, valid, pts, gt)),
                       metric_valid=None if metric_valid is None
                       else jnp.asarray(metric_valid))
        t = tmet.nrfmr(*(_t(a) for a in (ls, lt, valid, pts, gt)),
                       metric_valid=None if metric_valid is None
                       else _t(metric_valid))
        assert abs(float(t) - float(j)) < 1e-6
