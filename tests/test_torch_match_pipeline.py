"""The slice as a whole on the CPU: collate -> ``landmark_inference``
(matcher + NeCo) -> the landmark-guided solve, port against JAX package, on
one synthetic pair at a narrow width with the same weights (JAX init,
converted with ``params_from_numpy``).

Tolerances: confidence matrix 1e-4 max abs; the match and landmark sets
equal, apart from rows whose score lies within 1e-4 of a threshold; the
solver fed with each package's own landmarks from the same initial pyramid:
equal per-level iterations, level losses within 1e-4 and the full-cloud
warp within 1e-3, the criteria of tests/test_torch_registration.py for
landmark solves. The Procrustes condition number is compared to 1% and
``ok`` only where it is more than 5% from the gate at 40.

With ``attention_impl='flash'`` the port's transformer runs the plain
version of kernel C7 (CPU tensors); valid rows and everything downstream
must agree with the JAX package all the same.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.data.synthetic import make_pair
from deformationpyramid_tpu.match import kpconv as jkp
from deformationpyramid_tpu.match import landmark as jl
from deformationpyramid_tpu.match import matching as jm
from deformationpyramid_tpu.match import outlier_rejection as jneco
from deformationpyramid_tpu.match import pipeline as jpipe
from deformationpyramid_tpu.match import position_encoding as jpe
from deformationpyramid_tpu.match import procrustes as jproc
from deformationpyramid_tpu.match import transformer as jtr
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.solve import registration as jreg
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.match import backbone as tbb
from deformationpyramid_tpu_torch.match import kpconv as tkp
from deformationpyramid_tpu_torch.match import landmark as tl
from deformationpyramid_tpu_torch.match import matching as tm
from deformationpyramid_tpu_torch.match import outlier_rejection as tneco
from deformationpyramid_tpu_torch.match import pipeline as tpipe
from deformationpyramid_tpu_torch.match import position_encoding as tpe
from deformationpyramid_tpu_torch.match import procrustes as tproc
from deformationpyramid_tpu_torch.match import transformer as ttr
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.solve import registration as treg

FD = 96          # coarse width: a multiple of 4 heads and of 6
CAP = 256        # static per-cloud coarse cap
INLIER_THR = 0.57   # inside the spread of NeCo's scores at these weights
PYR = dict(m=3, k0=-8, depth=3, width=32, rotation_format="axis_angle",
           motion="SE3")
SOLVE = dict(iters=30, lr=0.01, max_break_count=15,
             break_threshold_ratio=0.001, samples=200, w_cd=0.0,
             trunc_cd=0.25)


def _t(a):
    return torch.from_numpy(np.array(a))


def landmark_cfgs(max_matches=None, impl="xla"):
    """The same narrow landmark model in both packages (JAX with the exact
    top-k, which is what the port's ``torch.topk`` is)."""
    out = []
    for mods in ((jl, jpipe, jtr, jm, jpe, jkp, jneco, jproc),
                 (tl, tpipe, ttr, tm, tpe, tkp, tneco, tproc)):
        L, P, T, M, PE, K, N, PR = mods
        kp = K.KPConvConfig(first_subsampling_dl=0.05, first_feats_dim=32,
                            coarse_feature_dim=FD, fine_feature_dim=24)
        vol = PE.VolPEConfig(feature_dim=FD, vol_origin=(-2.0, -2.0, -2.0))
        mc = M.MatchingConfig(feature_dim=FD, max_matches=max_matches)
        pr = (PR.ProcrustesConfig(topk_method="exact") if PR is jproc
              else PR.ProcrustesConfig())
        kw = dict(attention_impl=impl) if T is ttr else {}
        tr = T.TransformerConfig(feature_dim=FD, n_head=4, vol=vol,
                                 matching=mc, procrustes=pr, **kw)
        out.append(L.LandmarkConfig(
            matcher=P.MatcherConfig(kpfcn=kp, transformer=tr, matching=mc,
                                    procrustes=pr, max_matches=max_matches),
            neco=N.NeCoConfig(feature_dim=48, n_head=4, num_layers=3),
            inlier_thr=INLIER_THR))
    return out


@pytest.fixture(scope="module")
def pair():
    src, tgt, flow = make_pair(n=400, seed=0, deform=0.05)
    kp = tkp.KPConvConfig(first_subsampling_dl=0.05, first_feats_dim=32,
                          coarse_feature_dim=FD, fine_feature_dim=24)
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], kp,
                                                tbb.KPFCN_ARCHITECTURE)
    pyr = tcol.build_pair_pyramid(src, tgt, kp, tbb.KPFCN_ARCHITECTURE,
                                  limits, pad_to="pow2")
    jpyr_ = {k: ([jnp.asarray(a) for a in getattr(pyr, k)]
                 if k != "features" else jnp.asarray(pyr.features))
             for k in ("points", "valids", "neighbors", "pools", "upsamples",
                       "features")}
    jcfg, _ = landmark_cfgs()
    jparams = jl.init_landmark_model(jax.random.key(0), jcfg)
    return dict(src=src, tgt=tgt, flow=flow, pyr=pyr, jpyr=jpyr_,
                tpyr=tcol.pyramid_to_device(pyr, "cpu"), jparams=jparams,
                tparams=tdp.params_from_numpy(jax.tree.map(np.asarray,
                                                           jparams)))


def _infer(pair, max_matches, impl):
    jcfg, tcfg = landmark_cfgs(max_matches, impl)
    sl, tl_ = pair["pyr"].src_lengths[2], pair["pyr"].tgt_lengths[2]
    jout = jax.jit(lambda p, y: jl.landmark_inference(
        p, y, jnp.int32(sl), jnp.int32(tl_), jcfg, s_cap=CAP, t_cap=CAP))(
            pair["jparams"], pair["jpyr"])
    tout = tl.landmark_inference(pair["tparams"], pair["tpyr"],
                                 torch.tensor(sl), torch.tensor(tl_), tcfg,
                                 s_cap=CAP, t_cap=CAP)
    return jout, tout, sl, tl_


def _rows(idx, valid, scores, thr):
    """(src, tgt) -> score of the valid rows, and those within 1e-4 of
    ``thr``."""
    idx, valid, scores = (np.asarray(a) for a in (idx, valid, scores))
    rows = {(int(i), int(j)): float(c)
            for (i, j), v, c in zip(idx, valid, scores) if v}
    return rows, {k for k, c in rows.items() if abs(c - thr) < 1e-4}


@pytest.mark.parametrize("max_matches,impl", [(None, "xla"), (None, "flash"),
                                              (64, "xla")])
def test_landmark_inference_matches_jax(pair, max_matches, impl):
    jout, tout, sl, tl_ = _infer(pair, max_matches, impl)
    assert set(tout) == set(jout)
    conf_j = np.asarray(jout["conf_matrix_pred"])
    conf_t = tout["conf_matrix_pred"].numpy()
    assert conf_t.shape == (CAP, CAP)
    assert np.abs(conf_t - conf_j).max() < 1e-4
    assert not conf_t[sl:].any() and not conf_t[:, tl_:].any()
    for k in ("s_pcd", "t_pcd", "src_mask", "tgt_mask"):
        assert np.array_equal(tout[k].numpy(), np.asarray(jout[k])), k
    # valid rows only: the streamed route treats padded query rows otherwise
    for k, n in (("src_feats", sl), ("tgt_feats", tl_)):
        ref = np.asarray(jout[k])[:n]
        assert np.abs(tout[k].numpy()[:n] - ref).max() < 1e-4, k

    jm_, jnear = _rows(jout["match_idx"], jout["match_valid"],
                       jout["match_conf"], 0.1)
    tm_, tnear = _rows(tout["match_idx"], tout["match_valid"],
                       tout["match_conf"], 0.1)
    assert len(jm_) >= 10           # the test is not about empty sets
    assert set(jm_) - jnear - tnear == set(tm_) - jnear - tnear
    if max_matches is None:         # row order is the src order in both
        sure = np.ones(CAP, bool)   # every row but the threshold near-ties
        sure[np.array([i for i, _ in jnear | tnear], int)] = False
        assert np.array_equal(tout["match_valid"].numpy()[sure],
                              np.asarray(jout["match_valid"])[sure])
        assert np.abs(tout["vec_6d"].numpy()
                      - np.asarray(jout["vec_6d"]))[sure].max() < 1e-6

    cond = float(jout["condition"])
    assert abs(float(tout["condition"]) - cond) < 1e-2 * cond
    if abs(cond - 40.0) > 2.0:
        assert bool(tout["solution_mask"]) == bool(jout["solution_mask"])
    assert np.abs(tout["R_s2t_pred"].numpy()
                  - np.asarray(jout["R_s2t_pred"])).max() < 1e-3
    assert len(tout["position_layers"]) == 1

    # NeCo: scores by match, landmark sets apart from threshold near-ties
    def neco_by_match(out):
        idx, valid, c = (np.asarray(out[k]) for k in
                         ("match_idx", "match_valid", "neco_confidence"))
        return {(int(i), int(j)): float(s)
                for (i, j), v, s in zip(idx, valid, c) if v}

    jn, tn = neco_by_match(jout), neco_by_match(tout)
    common = set(jn) & set(tn)
    assert max(abs(jn[k] - tn[k]) for k in common) < 1e-4
    near = {k for k in common if abs(jn[k] - INLIER_THR) < 1e-4}
    jl_, _ = _rows(jout["match_idx"], jout["ldmk_valid"],
                   jout["neco_confidence"], INLIER_THR)
    tl__, _ = _rows(tout["match_idx"], tout["ldmk_valid"],
                    tout["neco_confidence"], INLIER_THR)
    skip = near | jnear | tnear
    assert set(jl_) - skip == set(tl__) - skip
    assert 3 <= len(jl_) < len(jm_)  # NeCo kept some and rejected some
    keep = tout["ldmk_valid"]
    assert not tout["ldmk_s"][~keep].any() and not tout["ldmk_t"][~keep].any()
    assert torch.equal(tout["ldmk_s"][keep], tout["vec_6d"][keep][:, :3])


def test_landmarks_then_solve_matches_jax(pair):
    """Each package's landmarks through its own landmark-only solve, from
    the same initial pyramid."""
    jout, tout, _, _ = _infer(pair, None, "flash")
    src, tgt = pair["src"], pair["tgt"]
    src_c = src - src.mean(0, keepdims=True)
    sm, tmean = src.mean(0, keepdims=True), tgt.mean(0, keepdims=True)
    t_pts = (tgt - tmean)[:SOLVE["samples"]]
    t_valid = np.ones(len(t_pts), bool)
    jcfg = jreg.SolverConfig(pyramid=jpyr.NDPConfig(**PYR), **SOLVE,
                             use_pallas=False, use_fused_iteration=False)
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE,
                             use_fused_iteration=False)
    key = jax.random.key(7)
    n_ldmk = CAP

    @jax.jit
    def jax_solve(s_l, t_l, l_valid, t, tv, src_c):
        params, stats = jreg.optimize_pyramid(
            key, s_l, l_valid, t, tv, jcfg, n_ldmk=n_ldmk, tgt_ldmk=t_l,
            ldmk_valid=l_valid)
        return jpyr.warp(params, src_c, jcfg.pyramid)[0], stats

    jv = np.asarray(jout["ldmk_valid"])
    js = np.where(jv[:, None], np.asarray(jout["ldmk_s"]) - sm, 0.0)
    jt = np.where(jv[:, None], np.asarray(jout["ldmk_t"]) - tmean, 0.0)
    jwarped, jstats = jax_solve(*map(jnp.asarray, (
        js.astype(np.float32), jt.astype(np.float32), jv, t_pts, t_valid,
        src_c)))

    tv = tout["ldmk_valid"]
    ts = torch.where(tv[:, None], tout["ldmk_s"] - _t(sm), 0.0)
    tt = torch.where(tv[:, None], tout["ldmk_t"] - _t(tmean), 0.0)
    init = jax.jit(jpyr.init_pyramid_params, static_argnums=1)(
        key, jcfg.pyramid)
    tparams, tstats = treg.optimize_pyramid(
        tpyr.params_from_numpy(jax.tree.map(np.asarray, init)), ts, tv,
        _t(t_pts), _t(t_valid), tcfg, n_ldmk, tt, tv)
    twarped, _ = tpyr.warp(tparams, _t(src_c), tcfg.pyramid)

    assert int(tv.sum()) == int(jv.sum()) >= 3
    assert tstats["iters"].tolist() == np.asarray(jstats["iters"]).tolist()
    assert np.abs(tstats["loss"].numpy() - np.asarray(jstats["loss"])
                  ).max() < 1e-4
    assert np.abs(twarped.numpy() - np.asarray(jwarped)).max() < 1e-3
    assert np.abs(twarped.numpy() - src_c).max() > 1e-4   # it moved


def test_register_pair_takes_the_landmarks(pair):
    """The entry points chained as a user chains them: ``landmark_inference``
    then ``register_pair`` with its landmarks, on the CPU."""
    _, tcfg = landmark_cfgs(None, "flash")
    pyr = pair["pyr"]
    out = tl.landmark_inference(pair["tparams"], pair["tpyr"],
                                pyr.src_lengths[2], pyr.tgt_lengths[2], tcfg,
                                s_cap=CAP, t_cap=CAP)
    cfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE,
                            use_fused_iteration=True, use_fused_ldmk=True)
    warped, stats = tdp.register_pair(
        3, _t(pair["src"]), _t(pair["tgt"]), cfg, src_ldmk=out["ldmk_s"],
        tgt_ldmk=out["ldmk_t"], ldmk_valid=out["ldmk_valid"])
    assert warped.shape == (400, 3) and torch.isfinite(warped).all()
    assert stats["iters"].shape == (3,) and (stats["iters"] >= 1).all()
    assert not any(t.requires_grad for t in
                   (out["conf_matrix_pred"], out["ldmk_s"]))


def test_init_landmark_model_tree_matches_jax(pair):
    _, tcfg = landmark_cfgs()
    gen = torch.Generator()
    tp = tl.init_landmark_model(gen.manual_seed(0), tcfg, "cpu")
    tn = jax.tree.map(lambda a: a.numpy(), tp)
    jn = jax.tree.map(np.asarray, pair["jparams"])
    assert jax.tree.structure(tn) == jax.tree.structure(jn)
    for a, b in zip(jax.tree.leaves(tn), jax.tree.leaves(jn)):
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    again = tl.init_landmark_model(gen.manual_seed(0), tcfg, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(jax.tree.leaves(tp), jax.tree.leaves(again)))
    back = tdp.params_to_numpy(pair["tparams"])
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(jn)))
