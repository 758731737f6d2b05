"""Parity of the port's baseline models and solvers (NSFP, Nerfies,
Sinkhorn: ``models/baselines.py``, ``losses``, ``ops/sinkhorn.py``,
``solve/baselines.py``, ``geometry/rotations.exp_se3``) with the JAX
package, on the CPU: the same numpy inputs and the JAX init's weights
(carried across by ``params_from_numpy``) through both.

Tolerances: model functions and losses 1e-6 on values (1e-5 on gradients
and on the Jacobian, which chains nine float32 layers in forward mode);
the sinkhorn divergence 1e-5 on value and gradient; a 20-iteration solve at
width 32: equal iteration count, loss 1e-5, parameters 1e-4 where Adam's
step is no coin toss (see ``_close_params``); the Sinkhorn descent 1e-4.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu import losses as jloss
from deformationpyramid_tpu.geometry import rotations as jrot
from deformationpyramid_tpu.models import baselines as jbase
from deformationpyramid_tpu.models import pyramid as jpyr
from deformationpyramid_tpu.ops import sinkhorn as jsink
from deformationpyramid_tpu.solve import baselines as jsolve
from deformationpyramid_tpu.utils import reporting as jreport
from deformationpyramid_tpu_torch import losses as tloss
from deformationpyramid_tpu_torch.geometry import rotations as trot
from deformationpyramid_tpu_torch.models import baselines as tbase
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import sinkhorn as tsink
from deformationpyramid_tpu_torch.solve import baselines as tsolve
from deformationpyramid_tpu_torch.solve.loop import LoopConfig, run_adam_loop
from deformationpyramid_tpu_torch.utils import reporting as treport
from deformationpyramid_tpu_torch.utils import logging as tlog
from deformationpyramid_tpu_torch.utils.timers import Timers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast as many,
    and parallel test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cloud(n, seed, scale=0.4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * scale).astype(np.float32)


def _max_err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


def test_exp_se3_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((50, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    v = rng.standard_normal((50, 3)).astype(np.float32)
    theta = rng.uniform(0.01, 2.0, (50, 1)).astype(np.float32)
    jR, jt = jrot.exp_se3(jnp.asarray(w), jnp.asarray(v), jnp.asarray(theta))
    R, t = trot.exp_se3(_t(w), _t(v), _t(theta))
    assert R.shape == (50, 3, 3) and t.shape == (50, 3, 1)
    assert _max_err(R, jR) < 1e-6 and _max_err(t, jt) < 1e-6


@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_nsfp_flow_matches_jax(act):
    jcfg = jbase.NSFPConfig(width=32, n_layers=5, act=act)
    tcfg = tbase.NSFPConfig(width=32, n_layers=5, act=act)
    params = _np(jbase.init_nsfp_params(jax.random.key(1), jcfg))
    x = _cloud(100, 1)
    ref = jbase.nsfp_flow(params, jnp.asarray(x), jcfg)
    got = tbase.nsfp_flow(tpyr.params_from_numpy(params), _t(x), tcfg)
    assert _max_err(got, ref) < 1e-6


def test_init_shapes_and_bounds():
    """The port's inits draw torch's default Linear init (U(+-1/sqrt(fan_in)))
    with the JAX trees' shapes, from an explicit generator."""
    gen = torch.Generator().manual_seed(3)
    tn = tbase.init_nsfp_params(gen, tbase.NSFPConfig())
    jn = jax.eval_shape(lambda k: jbase.init_nsfp_params(k), jax.random.key(0))
    assert [tuple(p["w"].shape) for p in tn] == [p["w"].shape for p in jn]
    assert float(tn[0]["w"].abs().max()) <= 3 ** -0.5
    assert float(tn[1]["w"].abs().max()) <= 128 ** -0.5
    tf = tbase.init_nerfies_params(gen, tbase.NerfiesConfig())
    jf = jax.eval_shape(lambda k: jbase.init_nerfies_params(k),
                        jax.random.key(0))
    assert tuple(tf["input"]["w"].shape) == jf["input"]["w"].shape == (39, 128)
    assert len(tf["hidden"]) == len(jf["hidden"]) == 6
    assert tuple(tf["w"]["w"].shape) == tuple(tf["v"]["w"].shape) == (128, 3)
    again = tbase.init_nsfp_params(torch.Generator().manual_seed(3),
                                   tbase.NSFPConfig())
    assert torch.equal(again[4]["w"], tn[4]["w"])


NERF_KW = dict(depth=4, width=32, m_bands=6, k0=-3, max_iter=50)


@pytest.mark.parametrize("it", [0, 7, 29, 49])
def test_nerfies_posenc_warp_jacobian_match_jax(it):
    jcfg, tcfg = jbase.NerfiesConfig(**NERF_KW), tbase.NerfiesConfig(**NERF_KW)
    assert tcfg.dim_in == jcfg.dim_in and tcfg.n_coarse == jcfg.n_coarse
    params = _np(jbase.init_nerfies_params(jax.random.key(2), jcfg))
    tparams = tpyr.params_from_numpy(params)
    x = _cloud(60, 2)
    jit_ = jnp.int32(it)
    tit = torch.tensor(it, dtype=torch.int32)
    assert _max_err(tbase.nerfies_posenc(_t(x), tit, tcfg),
                    jbase.nerfies_posenc(jnp.asarray(x), jit_, jcfg)) < 1e-6
    assert _max_err(tbase.nerfies_warp(tparams, _t(x), tit, tcfg),
                    jbase.nerfies_warp(params, jnp.asarray(x), jit_,
                                       jcfg)) < 1e-6
    J = tbase.nerfies_jacobian(tparams, _t(x), tit, tcfg)
    assert J.shape == (60, 3, 3)
    assert _max_err(J, jbase.nerfies_jacobian(params, jnp.asarray(x), jit_,
                                              jcfg)) < 1e-5


def test_nerfies_posenc_uses_the_literal_pi():
    """pi = 3.14, the reference's literal: the first band of a point at 1.0
    is sin(2**k0 * 3.14), not sin(2**k0 * pi)."""
    cfg = tbase.NerfiesConfig(**NERF_KW)
    enc = tbase.nerfies_posenc(torch.ones(1, 3), 10 ** 6, cfg)
    assert abs(float(enc[0, 3]) - np.sin(2.0 ** -3 * 3.14)) < 1e-6
    assert abs(float(enc[0, 3]) - np.sin(2.0 ** -3 * np.pi)) > 1e-4


def test_nerfies_regularization_matches_jax():
    rng = np.random.default_rng(4)
    J = (np.eye(3) + rng.standard_normal((80, 3, 3)) * 0.3).astype(np.float32)
    J[0] = np.eye(3)                      # the nearly-spherical branch
    ref, gref = jax.value_and_grad(jloss.nerfies_regularization)(
        jnp.asarray(J))
    Jt = _t(J).requires_grad_(True)
    got = tloss.nerfies_regularization(Jt)
    (g,) = torch.autograd.grad(got, Jt)
    assert abs(float(got) - float(ref)) < 1e-6
    assert _max_err(g, gref) < 1e-5
    A = np.einsum("nji,njk->nik", J, J)
    eig = tloss._sym3x3_max_eigval(_t(A))
    assert _max_err(eig, jloss._sym3x3_max_eigval(jnp.asarray(A))) < 1e-5
    assert _max_err(eig, np.linalg.eigvalsh(A.astype(np.float64))[:, -1]) \
        < 1e-4


def test_nerfies_regularization_gradient_is_finite_at_equal_eigenvalues():
    """Where two singular values of J are equal the JAX form's gradient is
    NaN (clip, then arccos at +-1); the port's is finite and, where the
    largest singular value is simple, equal to the SVD's."""
    J = np.stack([np.diag([1.0, 1.0, 2.0]), np.diag([2.0, 2.0, 1.0]),
                  np.diag([1.3, 1.3, 1.3]), np.eye(3),
                  np.diag([0.5, 0.9, 1.7])]).astype(np.float32)
    assert not np.isfinite(np.asarray(jax.grad(
        jloss.nerfies_regularization)(jnp.asarray(J[:1])))).all()
    Jt = _t(J).requires_grad_(True)
    (g,) = torch.autograd.grad(tloss.nerfies_regularization(Jt), Jt)
    assert bool(torch.isfinite(g).all())
    Js = _t(J).requires_grad_(True)
    sig = torch.linalg.svdvals(Js)[:, 0]
    (gs,) = torch.autograd.grad(torch.mean(torch.log(sig) ** 2), Js)
    for i in (0, 4):                       # a simple largest singular value
        assert _max_err(g[i], gs[i]) < 1e-6


def test_landmark_cost_and_bce_match_jax():
    rng = np.random.default_rng(5)
    x, y = _cloud(40, 5), _cloud(40, 6)
    valid = rng.random(40) > 0.3
    p = rng.uniform(0.0, 1.0, 40).astype(np.float32)
    p[0] = 1.0                            # the -100 clamp
    for v in (None, valid):
        jv = None if v is None else jnp.asarray(v)
        tv = None if v is None else _t(v)
        assert abs(float(tloss.landmark_cost(_t(x), _t(y), tv))
                   - float(jloss.landmark_cost(jnp.asarray(x), jnp.asarray(y),
                                               jv))) < 1e-6
        a = float(tloss.bce_with_zeros_target(_t(p), tv))
        b = float(jloss.bce_with_zeros_target(jnp.asarray(p), jv))
        assert abs(a - b) < 1e-5 * max(abs(b), 1.0)


@pytest.mark.parametrize("reach", [1.0, None])
def test_sinkhorn_divergence_value_and_gradient_match_jax(reach):
    x, y = _cloud(70, 7), _cloud(90, 8) + 0.1
    kw = dict(blur=0.1, reach=reach, n_iters=20)
    ref, gref = jax.value_and_grad(
        lambda a: jsink.sinkhorn_divergence(a, jnp.asarray(y), **kw))(
            jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    got = tsink.sinkhorn_divergence(xt, _t(y), **kw)
    (g,) = torch.autograd.grad(got, xt)
    assert abs(float(got) - float(ref)) < 1e-5
    assert _max_err(g, gref) < 1e-5
    same = tsink.sinkhorn_divergence(_t(x), _t(x), **kw)
    assert abs(float(same)) < 1e-6


def test_sinkhorn_descent_matches_register_sinkhorn():
    """JAX's ``register_sinkhorn`` at samples >= n moves a permutation of
    the source: the port's descent on the same rows agrees to 1e-4; the
    port's own ``register_sinkhorn`` returns the same kind of outputs."""
    src, tgt = _cloud(120, 9), _cloud(100, 10) + 0.05
    jcfg = jsolve.SinkhornSolverConfig(samples=200, n_steps=4)
    tcfg = tsolve.SinkhornSolverConfig(samples=200, n_steps=4)
    moved, s_valid, s_idx, jst = jsolve.register_sinkhorn(
        jax.random.key(0), jnp.asarray(src), jnp.asarray(tgt), jcfg)
    s_idx = np.asarray(s_idx)
    assert np.asarray(s_valid).all()
    got = tsolve.sinkhorn_descent(_t(src[s_idx]), _t(tgt), tcfg)
    assert _max_err(got, moved) < 1e-4
    assert float(np.abs(np.asarray(moved) - src[s_idx]).max()) > 1e-3
    m2, v2, i2, st = tsolve.register_sinkhorn(0, _t(src), _t(tgt), tcfg)
    assert m2.shape == (120, 3) and bool(v2.all()) and int(st["iters"]) == 4
    assert sorted(i2.tolist()) == list(range(120))
    again = tsolve.sinkhorn_descent(_t(src)[i2], _t(tgt), tcfg)
    assert _max_err(m2, again) < 1e-5


def _close_params(got, ref, start, lr, tol=1e-4):
    """Leaves within ``tol``, except entries where Adam's normalised step
    was a coin toss: an entry whose gradient is ~0 in float32 moves by
    +-lr on the sign of rounding noise in one package and not in the other.
    Such entries are those that moved less than 1.5 steps in total in
    either package; at most 1% of a solve's entries may be excused."""
    excused = total = 0
    for g, r, s in zip(tpyr.tree_leaves(got), tpyr.tree_leaves(ref),
                       tpyr.tree_leaves(start)):
        bad = (g - r).abs() > tol
        toss = ((g - s).abs() < 1.5 * lr) | ((r - s).abs() < 1.5 * lr)
        assert not bool((bad & ~toss).any()), float((g - r).abs().max())
        excused += int(bad.sum())
        total += g.numel()
    assert excused <= 0.01 * total, (excused, total)


def _solve_inputs(seed):
    src, tgt = _cloud(150, seed), _cloud(140, seed + 1)
    tgt = (tgt * 0.2 + src[:140] * 0.9).astype(np.float32)
    return src, tgt, np.ones(150, bool), np.ones(140, bool)


def test_optimize_nsfp_matches_jax():
    s, t, sv, tv = _solve_inputs(11)
    net = dict(width=32, n_layers=4)
    kw = dict(iters=20, lr=0.01, max_break_count=70,
              break_threshold_ratio=0.001, samples=150)
    jcfg = jsolve.NSFPSolverConfig(net=jbase.NSFPConfig(**net),
                                   use_pallas=False, **kw)
    tcfg = tsolve.NSFPSolverConfig(net=tbase.NSFPConfig(**net), **kw)
    key = jax.random.key(11)
    jp, jst = jax.jit(lambda k: jsolve.optimize_nsfp(
        k, jnp.asarray(s), jnp.asarray(sv), jnp.asarray(t), jnp.asarray(tv),
        jcfg))(key)
    init = tpyr.params_from_numpy(_np(jbase.init_nsfp_params(key, jcfg.net)))
    tp, tst = tsolve.optimize_nsfp(init, _t(s), _t(sv), _t(t), _t(tv), tcfg)
    assert int(tst["iters"]) == int(jst["iters"]) == 20
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-5
    _close_params(tp, tpyr.params_from_numpy(_np(jp)), init, 0.01)


def test_optimize_nerfies_matches_jax():
    """Five iterations, cap 5 (the window opens two bands in that time):
    equal iteration count, loss 1e-5, parameters 1e-4. Beyond ~8 iterations
    the two packages' float32 trajectories part (1e-3 at 8, 4e-2 at 12 on
    this input): the elastic term's closed-form eigenvalue is ill
    conditioned while J^T J is near a multiple of the identity, so rounding
    noise decides Adam's +-lr steps. The per-step parity behind the horizon
    is ``test_nerfies_objective_gradient_matches_jax``."""
    s, t, sv, tv = _solve_inputs(12)
    net = dict(depth=3, width=32)
    kw = dict(iters=5, lr=0.01, max_break_count=70,
              break_threshold_ratio=0.001, samples=150)
    jcfg = jsolve.NerfiesSolverConfig(net=jbase.NerfiesConfig(**net),
                                      use_pallas=False, **kw)
    tcfg = tsolve.NerfiesSolverConfig(net=tbase.NerfiesConfig(**net), **kw)
    key = jax.random.key(12)
    jp, jst = jax.jit(lambda k: jsolve.optimize_nerfies(
        k, jnp.asarray(s), jnp.asarray(sv), jnp.asarray(t), jnp.asarray(tv),
        jcfg))(key)
    jnet = dataclasses.replace(jcfg.net, max_iter=5)
    assert tsolve.nerfies_net(tcfg).n_coarse == jnet.n_coarse == 3.0
    init = tpyr.params_from_numpy(_np(jbase.init_nerfies_params(key, jnet)))
    tp, tst = tsolve.optimize_nerfies(init, _t(s), _t(sv), _t(t), _t(tv),
                                      tcfg)
    assert int(tst["iters"]) == int(jst["iters"]) == 5
    assert abs(float(tst["loss"]) - float(jst["loss"])) < 1e-5
    _close_params(tp, tpyr.params_from_numpy(_np(jp)), init, 0.01)


@pytest.mark.parametrize("it", [0, 5, 15])
def test_nerfies_objective_gradient_matches_jax(it):
    """The Nerfies objective (chamfer + 0.001 x the elastic term of the
    forward-mode Jacobian) at iteration ``it`` of a 20-iteration schedule:
    both terms 1e-6, every parameter gradient 1e-5 of its max."""
    from deformationpyramid_tpu.ops.chamfer import truncated_chamfer as jcd
    from deformationpyramid_tpu_torch.ops.chamfer import \
        truncated_chamfer as tcd

    s, t, _, _ = _solve_inputs(12)
    net = dict(depth=3, width=32, max_iter=20)
    jnet, tnet = jbase.NerfiesConfig(**net), tbase.NerfiesConfig(**net)
    jp = jbase.init_nerfies_params(jax.random.key(12), jnet)

    def jterms(p):
        w = jbase.nerfies_warp(p, jnp.asarray(s), jnp.int32(it), jnet)
        J = jbase.nerfies_jacobian(p, jnp.asarray(s), jnp.int32(it), jnet)
        return (jcd(w, jnp.asarray(t), trunc=1e9, use_pallas=False),
                jloss.nerfies_regularization(J))

    jcd_v, jreg_v = jterms(jp)
    jgrad = jax.grad(lambda p: jterms(p)[0] + 0.001 * jterms(p)[1])(jp)
    tp = tpyr.params_from_numpy(_np(jp))
    leaves = [l.requires_grad_(True) for l in tpyr.tree_leaves(tp)]
    it_t = torch.tensor(it, dtype=torch.int32)
    cd = tcd(tbase.nerfies_warp(tp, _t(s), it_t, tnet), _t(t), trunc=1e9)
    reg = tloss.nerfies_regularization(
        tbase.nerfies_jacobian(tp, _t(s), it_t, tnet))
    grads = torch.autograd.grad(cd + 0.001 * reg, leaves)
    assert abs(float(cd) - float(jcd_v)) < 1e-6
    assert abs(float(reg) - float(jreg_v)) < 1e-6
    ref = tpyr.tree_leaves(tpyr.params_from_numpy(_np(jgrad)))
    for g, r in zip(grads, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("model", ["nsfp", "nerfies"])
def test_register_baseline_runs_and_stops_early(model):
    """The whole single-pair entry points on a pair that converges: finite
    output of the full cloud's shape, the early stop fires before the cap,
    and the flow error falls below half of what the initial weights give
    (a one-iteration solve; the Nerfies field starts far from identity)."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair

    src, tgt, flow = make_pair(n=260, seed=3, deform=0.05)

    def run(iters):
        kw = dict(iters=iters, samples=128, max_break_count=5,
                  break_threshold_ratio=0.05)
        if model == "nsfp":
            cfg = tsolve.NSFPSolverConfig(
                net=tbase.NSFPConfig(width=32, n_layers=4), **kw)
            warped, st = tsolve.register_nsfp(0, _t(src), _t(tgt), cfg)
        else:
            cfg = tsolve.NerfiesSolverConfig(
                net=tbase.NerfiesConfig(depth=3, width=32), **kw)
            warped, st = tsolve.register_nerfies(0, _t(src), _t(tgt), cfg)
        assert warped.shape == (260, 3) and bool(torch.isfinite(warped).all())
        epe = float((warped - _t(src) - _t(flow)).norm(dim=-1).mean())
        return epe, int(st["iters"]), float(st["loss"])

    first, one, loss_first = run(1)
    epe, iters, loss = run(120)
    assert one == 1 and 5 <= iters < 120
    assert epe < 0.5 * first and loss < loss_first


def test_run_adam_loop_passes_the_iteration_index():
    seen = []

    def loss_fn(p, it):
        seen.append((it.dtype, int(it)))
        return (p["a"] ** 2).sum() + 1.0, None

    params, aux, st = run_adam_loop(loss_fn, {"a": torch.ones(3)},
                                    LoopConfig(iters=4))
    assert seen == [(torch.int32, i) for i in range(4)]
    assert aux is None and int(st["iters"]) == 4
    assert float(params["a"][0]) < 1.0


def test_warp_numpy_matches_warp_and_jax():
    for motion in ("SE3", "Sim3", "sflow"):
        kw = dict(m=3, k0=-6, width=16, motion=motion)
        jcfg, tcfg = jpyr.NDPConfig(**kw), tpyr.NDPConfig(**kw)
        params = _np(jpyr.init_pyramid_params(jax.random.key(5), jcfg))
        x = _cloud(70, 13)
        got = tpyr.warp_numpy(params, x, tcfg)
        assert np.array_equal(got, jpyr.warp_numpy(params, x, jcfg))
        ref = tpyr.warp(tpyr.params_from_numpy(params), _t(x), tcfg)[0]
        assert _max_err(got, ref) < 1e-6
    with pytest.raises(ValueError):
        tpyr.warp_numpy({}, x, tpyr.NDPConfig(rotation_format="euler"))


def test_reporting_timers_and_logger(tmp_path):
    stamps = [0.0, 0.5, 0.9, 1.6, 2.0]
    assert treport.split_summary("ndp_suite", "4DMatch-F", stamps, 4, 2.0) \
        == jreport.split_summary("ndp_suite", "4DMatch-F", stamps, 4, 2.0)
    assert treport._bms([3.0, 1.0, 2.0]) == jreport._bms([3.0, 1.0, 2.0])
    timers = Timers()
    with timers.span("a", sync=True):
        pass
    timers.tic("b")
    assert timers.toc("b") >= 0.0 and timers.toc("never") == 0.0
    assert len(timers.get_strings()) == 3
    assert timers.timers["a"].count == 1
    log = tlog.Logger(str(tmp_path / "sub" / "x.log"))
    log.write("one\n")
    log.close()
    assert (tmp_path / "sub" / "x.log").read_text() == "one\n"
    cfg = tmp_path / "c.yaml"
    cfg.write_text("a: 1\n")
    tlog.write_run_provenance(str(tmp_path / "snap"), str(cfg), device="cpu")
    assert (tmp_path / "snap" / "c.yaml").read_text() == "a: 1\n"
    assert (tmp_path / "snap" / "provenance.json").exists()
