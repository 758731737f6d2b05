"""The trainers of the learned landmark model, port against JAX package, on
the CPU at narrow widths (coarse width 96 / 24, ``make_pair(n=400 / 120)``),
weights from the JAX init via ``params_from_numpy``, the JAX side at
``topk_method='exact'``.

Tolerances, each stated where it is used:

* schedules: 1e-7 of the base rate (both are float32 expressions);
* the optimizer on the SAME gradients (numpy) against the optax chain, three
  steps, weight decay on a leaf whose gradient is exactly zero included:
  parameters 1e-6 max abs;
* one training step from equal weights: loss 1e-5; every gradient leaf 1e-4
  of the leaf's max; parameters after 1 step: with SGD 1e-4 of
  ``lr * max|g|`` (the update is linear in the gradient); with Adam 1e-2 of
  ``lr`` wherever the first gradient is above 1e-3 of its leaf's max, and
  ``2 * lr`` anywhere (Adam's step is ``lr * m / sqrt(v)``: where the
  gradient is at rounding level its sign, and so the whole step, differs
  between any two float32 implementations; "the gradient" here is the one
  Adam sees, weight decay added); after 3 steps the loss 1e-3 and the
  parameters 0.1 of ``lr * max|g|`` with SGD, ``lr`` where the gradient is
  large and ``2 * lr`` a step anywhere with Adam: the second and third
  gradients are taken at weights that already differ in rounding, and the
  loss is steep (a dual softmax at temperature 0.1, a top-k selection in
  the Procrustes fit), so these bounds measure the model's sensitivity; the
  optimizer itself is held to 1e-6 over three steps by the test above it;
* the ``kernel_points`` leaves (zero gradient, moved by weight decay alone):
  1e-7 max abs after every step.
"""
import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from deformationpyramid_tpu.data.synthetic import make_pair
from deformationpyramid_tpu.match import kpconv as jkp
from deformationpyramid_tpu.match import landmark as jl
from deformationpyramid_tpu.match import losses as jloss
from deformationpyramid_tpu.match import matching as jm
from deformationpyramid_tpu.match import outlier_rejection as jneco
from deformationpyramid_tpu.match import pipeline as jpipe
from deformationpyramid_tpu.match import position_encoding as jpe
from deformationpyramid_tpu.match import procrustes as jproc
from deformationpyramid_tpu.match import transformer as jtr
from deformationpyramid_tpu.train import trainer as jtrain
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.data import collate as tcol
from deformationpyramid_tpu_torch.data.correspondence_utils import (
    blend_scene_flow, mutual_nn_correspondence)
from deformationpyramid_tpu_torch.match import backbone as tbb
from deformationpyramid_tpu_torch.match import kpconv as tkp
from deformationpyramid_tpu_torch.match import landmark as tl
from deformationpyramid_tpu_torch.match import losses as tloss
from deformationpyramid_tpu_torch.match import matching as tm
from deformationpyramid_tpu_torch.match import outlier_rejection as tneco
from deformationpyramid_tpu_torch.match import pipeline as tpipe
from deformationpyramid_tpu_torch.match import position_encoding as tpe
from deformationpyramid_tpu_torch.match import procrustes as tproc
from deformationpyramid_tpu_torch.match import transformer as ttr
from deformationpyramid_tpu_torch.models.pyramid import tree_leaves, tree_map
from deformationpyramid_tpu_torch.train import trainer as ttrain
from deformationpyramid_tpu_torch.utils.checkpoint import (load_meta,
                                                           load_pytree)

WIDE = dict(fd=96, first=32, fine=24, heads=4, dl=0.05, neco_fd=48,
            neco_heads=4, neco_layers=2, max_matches=32, n=400)
TINY = dict(fd=24, first=8, fine=8, heads=2, dl=0.1, neco_fd=12,
            neco_heads=2, neco_layers=1, max_matches=16, n=120)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(lambda a: a.detach().numpy()
                        if isinstance(a, torch.Tensor) else np.asarray(a),
                        tree)


def cfgs(fd, first, fine, heads, dl, neco_fd, neco_heads, neco_layers,
         max_matches, n, impl="xla"):
    """The same narrow landmark model in both packages."""
    out = []
    for mods in ((jl, jpipe, jtr, jm, jpe, jkp, jneco, jproc),
                 (tl, tpipe, ttr, tm, tpe, tkp, tneco, tproc)):
        L, P, T, M, PE, K, N, PR = mods
        kp = K.KPConvConfig(first_subsampling_dl=dl, first_feats_dim=first,
                            coarse_feature_dim=fd, fine_feature_dim=fine)
        vol = PE.VolPEConfig(feature_dim=fd, vol_origin=(-2.0, -2.0, -2.0))
        mc = M.MatchingConfig(feature_dim=fd)
        pr = (PR.ProcrustesConfig(topk_method="exact") if PR is jproc
              else PR.ProcrustesConfig())
        kw = dict(attention_impl=impl) if T is ttr else {}
        tr = T.TransformerConfig(feature_dim=fd, n_head=heads, vol=vol,
                                 matching=mc, procrustes=pr, **kw)
        out.append(L.LandmarkConfig(
            matcher=P.MatcherConfig(kpfcn=kp, transformer=tr, matching=mc,
                                    procrustes=pr, max_matches=max_matches),
            neco=N.NeCoConfig(feature_dim=neco_fd, n_head=neco_heads,
                              num_layers=neco_layers)))
    return out


def batch(tcfg, n, seed, radius=0.15):
    """One training batch as numpy arrays: the pyramid, coarse lengths, GT
    matches built the reference way, coarse flow, GT motion, static cap."""
    src, tgt, flow = make_pair(n=n, seed=seed, deform=0.05)
    kp = tcfg.matcher.kpfcn
    limits = tcol.calibrate_neighborhood_limits([(src, tgt)], kp,
                                                tbb.KPFCN_ARCHITECTURE)
    pyr = tcol.build_pair_pyramid(src, tgt, kp, tbb.KPFCN_ARCHITECTURE,
                                  limits)
    cl = tcfg.matcher.coarse_level
    s_len, t_len = pyr.src_lengths[cl], pyr.tgt_lengths[cl]
    coarse = pyr.points[cl]
    c_src, c_tgt = coarse[:s_len], coarse[s_len:s_len + t_len]
    c_flow = blend_scene_flow(c_src, src, flow)
    corr = mutual_nn_correspondence(c_src + c_flow, c_tgt,
                                    search_radius=radius)
    assert len(corr) > 3
    cap = max(s_len, t_len)
    match_gt = np.zeros((cap, 2), np.int64)
    match_gt_valid = np.zeros((cap,), bool)
    match_gt[:len(corr)] = corr[:cap]
    match_gt_valid[:len(corr)] = True
    coarse_flow = np.zeros((cap, 3), np.float32)
    coarse_flow[:s_len] = c_flow
    return dict(pyr=pyr, s_len=s_len, t_len=t_len, cap=cap,
                match_gt=match_gt, match_gt_valid=match_gt_valid,
                coarse_flow=coarse_flow, gt_rot=np.eye(3, dtype=np.float32),
                gt_trn=np.zeros((3, 1), np.float32))


def jax_batch(b, matcher: bool):
    pyr = b["pyr"]
    pyrd = {k: ([jnp.asarray(a) for a in getattr(pyr, k)]
                if k != "features" else jnp.asarray(pyr.features))
            for k in ("points", "valids", "neighbors", "pools", "upsamples",
                      "features")}
    mid = ((jnp.asarray(b["match_gt"]), jnp.asarray(b["match_gt_valid"]))
           if matcher else ())
    return (pyrd, jnp.int32(b["s_len"]), jnp.int32(b["t_len"]), *mid,
            jnp.asarray(b["coarse_flow"]), jnp.asarray(b["gt_rot"]),
            jnp.asarray(b["gt_trn"]))


def torch_batch(b, matcher: bool):
    mid = (_t(b["match_gt"]), _t(b["match_gt_valid"])) if matcher else ()
    return (tcol.pyramid_to_device(b["pyr"], "cpu"), torch.tensor(b["s_len"]),
            torch.tensor(b["t_len"]), *mid, _t(b["coarse_flow"]),
            _t(b["gt_rot"]), _t(b["gt_trn"]))


def as_dict(args, b):
    keys = ("pyramid", "src_len_c", "tgt_len_c", "coarse_flow", "gt_rot",
            "gt_trn")
    return dict(zip(keys, args), s_cap=b["cap"], t_cap=b["cap"])


@pytest.fixture(scope="module", params=["wide", "tiny"])
def model(request):
    shape = WIDE if request.param == "wide" else TINY
    jcfg, tcfg = cfgs(**shape)
    jparams = jl.init_landmark_model(jax.random.key(0), jcfg)
    tparams = tdp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                batch=batch(tcfg, shape["n"], seed=1), name=request.param)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = cfgs(**TINY)
    jparams = jl.init_landmark_model(jax.random.key(0), jcfg)
    tparams = tdp.params_from_numpy(jax.tree.map(np.asarray, jparams))
    # seeds whose matches hold inliers and outliers at these weights (a
    # single-class batch has a zero balanced BCE and a zero gradient)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                batches=[batch(tcfg, TINY["n"], seed=s) for s in (0, 1, 3)])


def train_cfgs(**kw):
    return jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)


# ---------------- schedules, optimizer, guard ----------------

@pytest.mark.parametrize("kw", [
    dict(scheduler="ExpLR", lr=0.01, scheduler_gamma=0.9),
    dict(scheduler="MultiStepLR", lr=1.0, lr_milestones=(2, 4),
         scheduler_gamma=0.1),
    dict(scheduler="MultiStepLR", lr=0.5)])
def test_make_schedule_matches_optax(kw):
    jc, tc = train_cfgs(**kw)
    for spe in (1, 10):
        js, ts = jtrain.make_schedule(jc, spe), ttrain.make_schedule(tc, spe)
        for count in (0, 1, 9, 10, 19, 20, 39, 40, 41, 100):
            j = float(js(jnp.int32(count)))
            for c in (count, torch.tensor(count, dtype=torch.int32)):
                t = ts(c)
                assert t.dtype == torch.float32 and t.dim() == 0
                assert abs(float(t) - j) <= 1e-7 * kw["lr"], (spe, count)
    with pytest.raises(KeyError):
        ttrain.make_schedule(ttrain.TrainConfig(scheduler="cosine"), 1)
    with pytest.raises(KeyError):
        ttrain.make_optimizer(ttrain.TrainConfig(optimizer="LBFGS"), 1)


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_matches_the_optax_chain_on_equal_gradients(opt_name, clip):
    """Three steps on the same numpy gradients; leaf ``frozen`` has a zero
    gradient every step and still moves, by weight decay, as in optax."""
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    params = {"a": {"w": f(5, 4), "b": f(4)}, "layers": [f(3), f(2, 2)],
              "frozen": f(6, 3)}
    jc, tc = train_cfgs(optimizer=opt_name, lr=0.01, weight_decay=1e-2,
                        scheduler_gamma=0.5, grad_clip=clip)
    jopt, topt = jtrain.make_optimizer(jc, 2), ttrain.make_optimizer(tc, 2)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(_t, params)
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: f(*a.shape), params)
        g["frozen"] = np.zeros((6, 3), np.float32)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(tree_map(_t, g), ts, tp)
        tp = tree_map(torch.add, tp, tu)
        for a, b in zip(jax.tree.leaves(_np(tp)), jax.tree.leaves(_np(jp))):
            assert np.abs(a - b).max() <= 1e-6, step
        assert int(ts["count"]) == step + 1
    moved = np.abs(_np(tp)["frozen"] - params["frozen"])
    assert moved.min() > 0        # weight decay alone moved every entry
    if opt_name == "Adam":        # by about lr a step against its sign
        assert moved.max() < 3.2 * 0.01
        assert np.array_equal(np.sign(_np(tp)["frozen"] - params["frozen"]),
                              -np.sign(params["frozen"]))


def test_valid_gradient_guard():
    good = {"a": torch.ones(3), "b": [torch.zeros(2, 2)]}
    bad = {"a": torch.tensor([1.0, float("nan"), 2.0]),
           "b": [torch.zeros(2, 2)]}
    inf = {"a": torch.ones(3), "b": [torch.tensor([[float("inf")]])]}
    ok = ttrain.valid_gradient(good)
    assert ok.dtype == torch.bool and ok.dim() == 0 and bool(ok)
    assert not bool(ttrain.valid_gradient(bad))
    assert not bool(ttrain.valid_gradient(inf))


def test_trainable_marks_new_leaves_and_leaves_the_tree_alone():
    tree = {"a": torch.ones(2), "b": [torch.zeros(3)]}
    marked = tl.trainable(tree)
    assert all(t.requires_grad and t.is_leaf for t in tree_leaves(marked))
    assert not any(t.requires_grad for t in tree_leaves(tree))
    assert marked["a"].data_ptr() == tree["a"].data_ptr()


# ---------------- one step, and three ----------------

def _grad_check(tg, jg):
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for (path, b), a in zip(flat, jax.tree.leaves(tg)):
        scale = float(np.abs(b).max())
        assert np.abs(a - b).max() <= 1e-4 * max(scale, 1e-30), \
            jax.tree_util.keystr(path)


WD = 1e-3


def _param_check(tp, jp, g0, p0, opt_name, lr, steps):
    """The parameter tolerances of the module docstring; ``g0`` the first
    gradient, ``p0`` the starting weights."""
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, b), a, g, p in zip(flat, jax.tree.leaves(tp),
                                  jax.tree.leaves(g0), jax.tree.leaves(p0)):
        name = jax.tree_util.keystr(path)
        err = np.abs(a - b)
        sgd_rel, adam_big = (1e-4, 1e-2) if steps == 1 else (0.1, 1.0)
        if "kernel_points" in name:
            assert not g.any() and err.max() <= 1e-7, name
            continue
        g = g + WD * p
        gmax = float(np.abs(g).max())
        if opt_name == "SGD":
            assert err.max() <= sgd_rel * lr * max(gmax, 1e-30) + 1e-7, name
        else:
            assert err.max() <= 2.0 * lr * steps, name
            big = np.abs(g) > 1e-3 * gmax
            if big.any():
                assert err[big].max() <= adam_big * lr, name


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_matcher_train_step_matches_jax(model, opt_name):
    jcfg, tcfg, b = model["jcfg"], model["tcfg"], model["batch"]
    cap = b["cap"]
    jargs, targs = jax_batch(b, True), torch_batch(b, True)
    jmp, tmp = model["jparams"]["matcher"], model["tparams"]["matcher"]

    def jloss_fn(mp):
        data = jpipe.apply_matcher(mp, *jargs[:3], jcfg.matcher, s_cap=cap,
                                   t_cap=cap)
        return jloss.match_motion_loss(data, *jargs[3:])

    def tloss_fn(mp):
        data = tpipe.apply_matcher(mp, *targs[:3], tcfg.matcher, s_cap=cap,
                                   t_cap=cap)
        return tloss.match_motion_loss(data, *targs[3:])

    (jv, _), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(jmp)
    (tv, tinfo), tg = ttrain.value_and_grad(tloss_fn, tmp)
    assert abs(float(tv) - float(jv)) <= 1e-5
    assert not tv.requires_grad and not tinfo["recall_coarse"].requires_grad
    jg, tg = _np(jg), _np(tg)
    _grad_check(tg, jg)

    lr = 1e-3
    jc, tc = train_cfgs(optimizer=opt_name, lr=lr, weight_decay=WD)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    jstep = jtrain.make_matcher_train_step(jcfg, jopt, s_cap=cap, t_cap=cap)
    tstep = ttrain.make_matcher_train_step(tcfg, topt, s_cap=cap, t_cap=cap)
    js, ts = jopt.init(jmp), topt.init(tmp)
    start = _np(tmp)
    for step in range(1, 4):
        jmp, js, jloss_v, jinfo, jok = jstep(jmp, js, *jargs)
        tmp, ts, tloss_v, tinfo, tok = tstep(tmp, ts, *targs)
        assert bool(jok) and bool(tok)
        if step == 1:
            assert abs(float(tloss_v) - float(jloss_v)) <= 1e-5
            assert abs(float(tinfo["recall_coarse"])
                       - float(jinfo["recall_coarse"])) <= 1e-6
        if step == 3:
            assert abs(float(tloss_v) - float(jloss_v)) <= 1e-3
        if step in (1, 3):
            _param_check(_np(tmp), _np(jmp), jg, start, opt_name, lr, step)
    # the kernel points moved, though no gradient reaches them
    kp0 = start["backbone"]["encoder"][0]["kpconv"]["kernel_points"]
    kp3 = _np(tmp)["backbone"]["encoder"][0]["kpconv"]["kernel_points"]
    assert np.abs(kp3 - kp0).max() > 0
    assert not any(t.requires_grad for t in tree_leaves(tmp))


@pytest.mark.parametrize("opt_name", ["SGD", "Adam"])
def test_neco_train_step_matches_jax(model, opt_name):
    jcfg, tcfg, b = model["jcfg"], model["tcfg"], model["batch"]
    jargs, targs = jax_batch(b, False), torch_batch(b, False)
    jp, tp = model["jparams"], model["tparams"]
    caps = dict(s_cap=b["cap"], t_cap=b["cap"])
    jloss_fn = jtrain.make_neco_loss_fn(jp["matcher"], jcfg, **caps)
    tloss_fn = ttrain.make_neco_loss_fn(tp["matcher"], tcfg, **caps)
    (jv, jinfo), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jp["neco"], *jargs)
    (tv, tinfo), tg = ttrain.value_and_grad(
        lambda p: tloss_fn(p, *targs), tp["neco"])
    assert abs(float(tv) - float(jv)) <= 1e-5
    assert float(tinfo["n_matches"]) == float(jinfo["n_matches"]) >= 3
    jg, tg = _np(jg), _np(tg)
    _grad_check(tg, jg)

    lr = 1e-3
    jc, tc = train_cfgs(optimizer=opt_name, lr=lr, weight_decay=WD)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    jstep = jtrain.make_neco_train_step(jp["matcher"], jcfg, jopt, **caps)
    tstep = ttrain.make_neco_train_step(tp["matcher"], tcfg, topt, **caps)
    jn, tn = jp["neco"], tp["neco"]
    js, ts = jopt.init(jn), topt.init(tn)
    before = _np(tp["matcher"])
    for step in range(1, 4):
        jn, js, jloss_v, _, jok = jstep(jn, js, *jargs)
        tn, ts, tloss_v, _, tok = tstep(tn, ts, *targs)
        assert bool(jok) and bool(tok)
        if step == 1:
            assert abs(float(tloss_v) - float(jloss_v)) <= 1e-5
        if step in (1, 3):
            _param_check(_np(tn), _np(jn), jg, _np(tp["neco"]), opt_name, lr,
                         step)
    # the frozen matcher is bit-unchanged and took no gradient
    for a, c in zip(jax.tree.leaves(_np(tp["matcher"])),
                    jax.tree.leaves(before)):
        assert np.array_equal(a, c)
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(tp["matcher"]))


# ---------------- the guard in the steps ----------------

def test_matcher_step_with_a_nan_keeps_parameters_and_state(tiny):
    """A NaN in one input feature reaches the confidence matrix, the loss
    and every gradient leaf: both packages keep the parameters AND the
    optimizer state."""
    b = dict(tiny["batches"][0])
    feats = b["pyr"].features.copy()
    feats[3] = np.nan
    b["pyr"] = dataclasses.replace(b["pyr"], features=feats)
    cap = b["cap"]
    jc, tc = train_cfgs(optimizer="Adam", lr=1e-3)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    jmp, tmp = tiny["jparams"]["matcher"], tiny["tparams"]["matcher"]
    js, ts = jopt.init(jmp), topt.init(tmp)
    jout = jtrain.make_matcher_train_step(tiny["jcfg"], jopt, s_cap=cap,
                                          t_cap=cap)(jmp, js,
                                                     *jax_batch(b, True))
    tout = ttrain.make_matcher_train_step(tiny["tcfg"], topt, s_cap=cap,
                                          t_cap=cap)(tmp, ts,
                                                     *torch_batch(b, True))
    assert not bool(jout[4]) and not bool(tout[4])
    assert tout[4].dtype == torch.bool and tout[4].dim() == 0
    for new, old in ((tout[0], tmp), (tout[1], ts)):
        assert all(torch.equal(a, c) for a, c in
                   zip(tree_leaves(new), tree_leaves(old)))
    assert int(tout[1]["count"]) == 0
    assert all(np.array_equal(a, c) for a, c in
               zip(jax.tree.leaves(_np(jout[0])), jax.tree.leaves(_np(jmp))))


def test_neco_step_with_a_nan_keeps_parameters_but_steps_the_state(tiny):
    """``make_neco_train_step`` keeps the parameters and, as the JAX package
    does, still advances the optimizer state (on a zeroed gradient). The
    NaN sits in one bias of NeCo's classifier, so the loss and every
    gradient leaf are NaN."""
    b = tiny["batches"][0]
    jc, tc = train_cfgs(optimizer="Adam", lr=1e-3)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    neco = _np(tiny["jparams"]["neco"])
    neco["cls2"]["b"] = neco["cls2"]["b"].copy()
    neco["cls2"]["b"][0] = np.nan
    jn, tn = jax.tree.map(jnp.asarray, neco), tree_map(_t, neco)
    js, ts = jopt.init(jn), topt.init(tn)
    caps = dict(s_cap=b["cap"], t_cap=b["cap"])
    jout = jtrain.make_neco_train_step(
        tiny["jparams"]["matcher"], tiny["jcfg"], jopt, **caps)(
            jn, js, *jax_batch(b, False))
    tout = ttrain.make_neco_train_step(
        tiny["tparams"]["matcher"], tiny["tcfg"], topt, **caps)(
            tn, ts, *torch_batch(b, False))
    assert not bool(jout[4]) and not bool(tout[4])
    for new, jnew, old in zip(jax.tree.leaves(_np(tout[0])),
                              jax.tree.leaves(_np(jout[0])),
                              jax.tree.leaves(neco)):
        assert np.array_equal(new, old, equal_nan=True)
        assert np.array_equal(jnew, old, equal_nan=True)
    assert int(tout[1]["count"]) == 1       # the state stepped, on 0 + wd p


def test_accum_apply_with_a_planted_nan_keeps_everything_and_clears(tiny):
    jc, tc = train_cfgs(optimizer="SGD", lr=0.05)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    jp, tp = tiny["jparams"], tiny["tparams"]
    _, japply = jtrain.make_neco_accum_fns(jp["matcher"], tiny["jcfg"], jopt)
    _, tapply = ttrain.make_neco_accum_fns(tp["matcher"], tiny["tcfg"], topt)
    rng = np.random.default_rng(0)
    accum = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), _np(jp["neco"]))
    accum["cls1"]["w"][0, 0] = np.nan          # one leaf, one entry
    js, ts = jopt.init(jp["neco"]), topt.init(tp["neco"])
    jn, js2, jacc, jok = japply(jp["neco"], js,
                                jax.tree.map(jnp.asarray, accum))
    tn, ts2, tacc, tok = tapply(tp["neco"], ts, tree_map(_t, accum))
    assert not bool(jok) and not bool(tok)
    for new, old in ((tn, tp["neco"]), (ts2, ts)):
        assert all(torch.equal(a, c) for a, c in
                   zip(tree_leaves(new), tree_leaves(old)))
    assert not any(t.any() for t in tree_leaves(tacc))
    assert all(np.array_equal(a, c) for a, c in
               zip(jax.tree.leaves(_np(jn)), jax.tree.leaves(_np(jp["neco"]))))
    assert not any(np.asarray(a).any() for a in jax.tree.leaves(jacc))


# ---------------- accumulation ----------------

def test_iter_size_accumulation_matches_summed_grads_and_jax(tiny):
    """iter_size=2 accumulation == one optimizer step on the SUM of the two
    per-batch gradients (never scaled by iter_size), and equal to the JAX
    package's accumulated step: 1e-6 max abs (SGD, lr 0.05)."""
    jc, tc = train_cfgs(optimizer="SGD", lr=0.05, momentum=0.0,
                        weight_decay=0.0)
    jopt, topt = jtrain.make_optimizer(jc, 1), ttrain.make_optimizer(tc, 1)
    jp, tp = tiny["jparams"], tiny["tparams"]
    b0, b1 = tiny["batches"][:2]
    assert b0["cap"] == b1["cap"]
    caps = dict(s_cap=b0["cap"], t_cap=b0["cap"])
    jgf, japply = jtrain.make_neco_accum_fns(jp["matcher"], tiny["jcfg"],
                                             jopt, **caps)
    tgf, tapply = ttrain.make_neco_accum_fns(tp["matcher"], tiny["tcfg"],
                                             topt, **caps)
    accum = tree_map(torch.zeros_like, tp["neco"])
    accum, l0, _ = tgf(tp["neco"], accum, *torch_batch(b0, False))
    accum, l1, info = tgf(tp["neco"], accum, *torch_batch(b1, False))
    new, state, after, ok = tapply(tp["neco"], topt.init(tp["neco"]), accum)
    assert bool(ok) and int(state["count"]) == 1
    assert not any(t.any() for t in tree_leaves(after))
    assert np.isfinite([float(l0), float(l1), float(info["IR_neco"])]).all()

    loss_fn = ttrain.make_neco_loss_fn(tp["matcher"], tiny["tcfg"], **caps)
    g0 = ttrain.value_and_grad(
        lambda p: loss_fn(p, *torch_batch(b0, False)), tp["neco"])[1]
    g1 = ttrain.value_and_grad(
        lambda p: loss_fn(p, *torch_batch(b1, False)), tp["neco"])[1]
    upd, _ = topt.update(tree_map(torch.add, g0, g1),
                         topt.init(tp["neco"]), tp["neco"])
    expect = tree_map(torch.add, tp["neco"], upd)
    assert max(float((a - c).abs().max()) for a, c in
               zip(tree_leaves(new), tree_leaves(expect))) < 1e-6
    assert max(float(g.abs().max()) for g in tree_leaves(g0)) > 0

    jacc = jax.tree.map(jnp.zeros_like, jp["neco"])
    jacc, _, _ = jgf(jp["neco"], jacc, *jax_batch(b0, False))
    jacc, _, _ = jgf(jp["neco"], jacc, *jax_batch(b1, False))
    jnew, _, _, jok = japply(jp["neco"], jopt.init(jp["neco"]), jacc)
    assert bool(jok)
    for a, c in zip(jax.tree.leaves(_np(new)), jax.tree.leaves(_np(jnew))):
        assert np.abs(a - c).max() < 1e-6


# ---------------- the loops ----------------

def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_neco_writes_the_same_history_and_snapshots(tiny, tmp_path):
    """Two epochs, iter_size 2, a val stream: the same phases, learning
    rates (1e-9) and files as the JAX package's loop; losses 1e-4 (the second
    epoch has an Adam step behind it)."""
    kw = dict(optimizer="Adam", lr=1e-3, iter_size=2, max_epoch=2,
              scheduler_gamma=0.5)
    jc = jtrain.TrainConfig(snapshot_dir=str(tmp_path / "j"), **kw)
    tc = ttrain.TrainConfig(snapshot_dir=str(tmp_path / "t"), **kw)
    bs = tiny["batches"]
    jb = [as_dict(jax_batch(b, False), b) for b in bs]
    tb = [as_dict(torch_batch(b, False), b) for b in bs]
    jp, tp = tiny["jparams"], tiny["tparams"]
    jtrain.train_neco(jp["matcher"], jp["neco"], tiny["jcfg"], jc,
                      lambda: iter(jb[:2]), steps_per_epoch=2,
                      val_batches=lambda: iter(jb[2:]),
                      log_fn=lambda *_: None)
    logged = []
    out = ttrain.train_neco(tp["matcher"], tp["neco"], tiny["tcfg"], tc,
                            lambda: iter(tb[:2]), steps_per_epoch=2,
                            val_batches=lambda: iter(tb[2:]),
                            log_fn=logged.append)
    assert max(float((a - c).abs().max()) for a, c in
               zip(tree_leaves(out), tree_leaves(tp["neco"]))) > 0
    jrows, trows = _rows(tmp_path / "j" / "history.jsonl"), _rows(
        tmp_path / "t" / "history.jsonl")
    assert [r["phase"] for r in trows] == ["train", "val", "train", "val"]
    assert [(r["epoch"], r["phase"], sorted(r)) for r in trows] == \
        [(r["epoch"], r["phase"], sorted(r)) for r in jrows]
    for a, c in zip(trows, jrows):
        assert abs(a["lr"] - c["lr"]) <= 1e-9
        assert abs(a["loss"] - c["loss"]) <= 1e-4
        assert abs(a["IR_neco"] - c["IR_neco"]) <= 1e-6
    assert trows[0]["lr"] == pytest.approx(5e-4) and len(logged) == 4
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "history.jsonl", "model_best_loss.npz", "model_last.npz"]
    last = load_pytree(str(tmp_path / "t" / "model_last.npz"), tp["neco"])
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves(last), tree_leaves(out)))
    meta = load_meta(str(tmp_path / "t" / "model_best_loss.npz"))
    assert meta["loss"] == pytest.approx(min(r["loss"] for r in trows
                                             if r["phase"] == "val"))


def test_train_matcher_writes_the_same_history_and_snapshots(tiny, tmp_path):
    """Two epochs of two steps through both loops: the same rows and files;
    epoch losses within 2e-3 of their value (every step but the first has
    Adam steps on a steep loss behind it, see the module docstring)."""
    kw = dict(optimizer="Adam", lr=1e-4, max_epoch=2)
    jc = jtrain.TrainConfig(snapshot_dir=str(tmp_path / "j"), **kw)
    tc = ttrain.TrainConfig(snapshot_dir=str(tmp_path / "t"), **kw)
    keys = ("pyramid", "src_len_c", "tgt_len_c", "match_gt", "match_gt_valid",
            "coarse_flow", "gt_rot", "gt_trn")
    bs = tiny["batches"][:2]
    jb = [dict(zip(keys, jax_batch(b, True)), s_cap=b["cap"], t_cap=b["cap"])
          for b in bs]
    tb = [dict(zip(keys, torch_batch(b, True)), s_cap=b["cap"],
               t_cap=b["cap"]) for b in bs]
    jtrain.train_matcher(tiny["jparams"]["matcher"], tiny["jcfg"], jc,
                         lambda: iter(jb), steps_per_epoch=2,
                         log_fn=lambda *_: None)
    out = ttrain.train_matcher(tiny["tparams"]["matcher"], tiny["tcfg"], tc,
                               lambda: iter(tb), steps_per_epoch=2,
                               log_fn=lambda *_: None)
    jrows, trows = _rows(tmp_path / "j" / "history.jsonl"), _rows(
        tmp_path / "t" / "history.jsonl")
    assert [sorted(r) for r in trows] == [sorted(r) for r in jrows]
    assert [r["epoch"] for r in trows] == [0, 1]
    for a, c in zip(trows, jrows):
        assert abs(a["loss"] - c["loss"]) <= 2e-3 * c["loss"]
        assert 0.0 <= a["recall_coarse"] <= 1.0
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "history.jsonl", "matcher_best_loss.npz", "matcher_last.npz"]
    last = load_pytree(str(tmp_path / "t" / "matcher_last.npz"),
                       tiny["tparams"]["matcher"])
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves(last), tree_leaves(out)))
    assert load_meta(str(tmp_path / "t" / "matcher_last.npz"))["epoch"] == 1


def test_flash_route_trains_like_the_einsum_route_on_the_cpu(tiny):
    """``attention_impl='flash'`` under autograd (on CPU tensors the plain
    versions of C7-C9's function): the same loss (1e-5) and gradients (1e-4
    of each leaf's max) as the einsum route. The two differ on padded query
    rows only, which every consumer masks."""
    _, tflash = cfgs(**TINY, impl="flash")
    b = dict(tiny["batches"][0])
    cap = b["cap"] + 5                # padded query and source rows
    b["coarse_flow"] = np.pad(b["coarse_flow"], ((0, 5), (0, 0)))
    targs = torch_batch(b, True)

    def loss_fn(cfg):
        def f(mp):
            data = tpipe.apply_matcher(mp, *targs[:3], cfg.matcher,
                                       s_cap=cap, t_cap=cap)
            return tloss.match_motion_loss(data, *targs[3:])
        return f

    (v0, _), g0 = ttrain.value_and_grad(loss_fn(tiny["tcfg"]),
                                         tiny["tparams"]["matcher"])
    (v1, _), g1 = ttrain.value_and_grad(loss_fn(tflash),
                                         tiny["tparams"]["matcher"])
    assert abs(float(v0) - float(v1)) <= 1e-5
    _grad_check(_np(g1), _np(g0))
