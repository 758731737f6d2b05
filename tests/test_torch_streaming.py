"""The port's continuous-batching solver (``solve/streaming.py``) against
the JAX package's, on the CPU, where the slot-batched 1-NN runs the plain
version of kernel C1.

* ``_pair_step`` on one slot-batched state made with numpy, through the
  port and through JAX's vmapped step (``use_pallas=False``), for 1-3
  iterations: a slot mid-level, a slot forced into its level transition
  (the iteration cap reached), a slot at its last level that finishes, and
  a frozen done slot. A single iteration matches to ~1e-6 of a tensor's
  max (float32 on both sides, sums in another order): the loss within
  1e-6 relative, the gradient-fed moments m within 1e-6 and v within 2e-6
  of each tensor's max (measured: 1e-7 and 2.3e-7). Adam's step is
  lr * m_hat / (sqrt(v_hat) + eps), at most lr = 1e-2 in size, so the
  params may move apart by lr times the step's relative error a step:
  3 steps x 1e-2 x 1e-4 = 3e-6 of each tensor's max (1e-4 covers the
  step's conditioning where v_hat is small beside m_hat^2; measured 9e-8);
  the warped points within 1e-6 of their max, every integer and flag
  equal.
* ``register_stream`` against ``register_pair`` pair by pair, at
  ``tests/test_streaming.py``'s configuration and bounds (max 2e-2, mean
  5e-3, the same iteration count);
* the six-pair throughput case of ``tests/test_streaming.py``;
* the slot-batched plain 1-NN bit-equal, slot by slot, to the one-pair
  plain version.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.models.pyramid import NDPConfig as JNDPConfig
from deformationpyramid_tpu.models.pyramid import \
    init_pyramid_params as j_init
from deformationpyramid_tpu.solve import streaming as jstream
from deformationpyramid_tpu.solve.registration import \
    SolverConfig as JSolverConfig
from deformationpyramid_tpu_torch.data.synthetic import make_batch
from deformationpyramid_tpu_torch.models.pyramid import NDPConfig, tree_map
from deformationpyramid_tpu_torch.ops import knn as tknn
from deformationpyramid_tpu_torch.solve import streaming as tstream
from deformationpyramid_tpu_torch.solve.registration import (SolverConfig,
                                                             register_pair)

PYR = dict(m=3, k0=-4, depth=2, width=32)
CFG = SolverConfig(pyramid=NDPConfig(**PYR), iters=40, samples=128)
STEP_TOL = {"loss": 1e-6, "adam_m": 1e-6, "adam_v": 2e-6, "params": 3e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread is as fast as many,
    and parallel test workers do not fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed: int, b: int = 4, n: int = 96, m: int = 80,
           nonrigid: bool = False):
    """A slot-batched numpy state: slot 0 mid-level 0, slot 1 at level 1
    one iteration before the cap (its transition), slot 2 at the last level
    one iteration before the cap (it finishes), slot 3 done (frozen)."""
    rng = np.random.default_rng(seed)
    pcfg = JNDPConfig(**PYR, nonrigidity_est=nonrigid)
    params = [jax.tree.map(np.asarray, j_init(jax.random.key(seed + s), pcfg))
              for s in range(b)]
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    params = jax.tree.map(stack, *params)
    moments = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32),
        params)
    second = jax.tree.map(
        lambda a: (rng.random(a.shape) * 1e-6).astype(np.float32), params)
    pts = (rng.standard_normal((b, n, 3)) * 0.3).astype(np.float32)
    t_sample = pts[:, :m] + (rng.standard_normal((b, m, 3)) * 0.05
                             ).astype(np.float32)
    pts_valid = rng.random((b, n)) > 0.1
    t_valid = rng.random((b, m)) > 0.1
    return {
        "params": params, "adam_m": moments, "adam_v": second,
        "adam_t": np.array([3, 7, 2, 5], np.int32)[:b],
        "pts": pts, "pts_valid": pts_valid,
        "t_sample": t_sample, "t_valid": t_valid,
        "level": np.array([0, 1, 2, 1], np.int32)[:b],
        "loss_prev": np.array([0.3, 0.2, 0.25, 0.1], np.float32)[:b],
        "counter": np.array([2, 0, 1, 3], np.int32)[:b],
        "it": np.array([5, 39, 39, 4], np.int32)[:b],
        "done": np.array([False, False, False, True])[:b],
        "loss": np.full((b,), np.inf, np.float32),
        "total_iters": np.array([5, 80, 120, 60], np.int32)[:b],
        "src_c": pts * 1.5, "src_valid": np.ones((b, n), bool),
        "tgt_mean": (rng.standard_normal((b, 3))).astype(np.float32),
    }


def _leaf_err(name, a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "biu":
        assert np.array_equal(a, b), name
        return 0.0
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a.astype(np.float64) - b).max()) / scale


@pytest.mark.parametrize("steps,nonrigid", [(1, False), (3, False),
                                             (2, True)])
def test_pair_step_matches_jax(steps, nonrigid):
    st = _state(steps, nonrigid=nonrigid)
    w_reg = 0.3 if nonrigid else 0.0
    jcfg = JSolverConfig(pyramid=JNDPConfig(**PYR, nonrigidity_est=nonrigid),
                         iters=40, samples=128, w_reg=w_reg,
                         use_pallas=False)
    tcfg = dataclasses.replace(
        CFG, w_reg=w_reg, pyramid=NDPConfig(**PYR, nonrigidity_est=nonrigid))
    jstep = jax.jit(jax.vmap(lambda s: jstream._pair_step(s, jcfg)))
    js = jax.tree.map(jnp.asarray, st)
    ts = tree_map(lambda a: torch.from_numpy(np.array(a)), st)
    for _ in range(steps):
        js = jstep(js)
        ts = tstream._pair_step(ts, tcfg)
    js = jax.tree.map(np.asarray, js)
    # the forced transition and the finish happened on both sides
    assert list(js["level"]) == [0, 2, 2, 1]
    assert list(js["done"]) == [False, False, True, True]
    for key in js:
        if key in ("params", "adam_m", "adam_v"):
            errs = [_leaf_err(key, t.numpy(), j) for t, j in zip(
                jax.tree.leaves(ts[key]), jax.tree.leaves(js[key]))]
            assert max(errs) <= STEP_TOL[key], (key, errs)
        elif key == "loss":
            assert np.allclose(ts[key].numpy(), js[key], rtol=1e-6, atol=0)
        elif key == "pts":
            assert _leaf_err(key, ts[key].numpy(), js[key]) <= 1e-6
        else:
            got = ts[key].numpy()
            assert got.dtype.kind == js[key].dtype.kind, key
            assert _leaf_err(key, got, js[key]) <= 1e-6, key
    # the frozen slot did not move at all
    for t, a in zip(jax.tree.leaves(ts["params"]),
                    jax.tree.leaves(st["params"])):
        assert np.array_equal(t[3].numpy(), a[3])


def test_stream_matches_register_pair():
    srcs, tgts, _ = make_batch(2, n=128, seed=3, deform=0.1)
    pairs = [(srcs[i], tgts[i]) for i in range(2)]
    res = tstream.register_stream(pairs, CFG, n_slots=1, k_inner=16,
                                  gen=torch.Generator().manual_seed(7),
                                  device="cpu")
    gen = torch.Generator().manual_seed(7)
    multi_step, _, harvest, init_one = tstream.make_stream_fns(CFG, 16)
    for i, (s, t) in enumerate(pairs):
        w_pair, stats = register_pair(gen, torch.from_numpy(s),
                                      torch.from_numpy(t), CFG)
        diff = (res[i] - w_pair).abs()
        assert float(diff.max()) < 2e-2 and float(diff.mean()) < 5e-3
    # the iteration count, through the primitives as tests/test_streaming.py
    st = tstream.stack_states([init_one(torch.Generator().manual_seed(7),
                                        torch.from_numpy(srcs[0]),
                                        torch.from_numpy(tgts[0]))])
    for _ in range(40):
        st = multi_step(st)
        if bool(st["done"][0]):
            break
    w_stream, total = harvest(st, 0)
    w_pair, stats = register_pair(7, torch.from_numpy(srcs[0]),
                                  torch.from_numpy(tgts[0]), CFG)
    assert torch.equal(w_stream, res[0])
    assert int(total) == int(stats["iters"].sum())


def test_streaming_throughput_path_many_pairs():
    srcs, tgts, flows = make_batch(6, n=128, seed=0, deform=0.1)
    pairs = [(srcs[i], tgts[i]) for i in range(6)]
    res = tstream.register_stream(pairs, CFG, n_slots=3, k_inner=16,
                                  device="cpu")
    for i, r in enumerate(res):
        r = r.numpy()
        assert r.shape == srcs[i].shape and np.isfinite(r).all()
        epe0 = np.linalg.norm(flows[i], axis=1).mean()
        epe = np.linalg.norm((r - srcs[i]) - flows[i], axis=1).mean()
        assert epe < 0.6 * epe0, (i, epe0, epe)


@pytest.mark.parametrize("masked", [False, True])
def test_batched_plain_nn_bit_equal_per_slot(masked):
    rng = np.random.default_rng(5)
    b, n, m = 4, 150, 110
    x = torch.from_numpy((rng.standard_normal((b, n, 3)) * 0.4
                          ).astype(np.float32))
    y = torch.from_numpy((rng.standard_normal((b, m, 3)) * 0.4
                          ).astype(np.float32))
    # grid points give exact ties across the database
    y[1] = torch.round(y[1] * 4) / 4
    x[1] = torch.round(x[1] * 4) / 4
    xv = torch.from_numpy(rng.random((b, n)) > 0.2) if masked else None
    yv = torch.from_numpy(rng.random((b, m)) > 0.2) if masked else None
    if masked:
        yv[2] = False      # a slot with no valid database row
    out = tknn.nn_argmin_dual(x, y, xv, yv)
    for s in range(b):
        ref = tknn.nn_argmin_dual(x[s], y[s], None if xv is None else xv[s],
                                  None if yv is None else yv[s])
        for got, want in zip(out, ref):
            assert torch.equal(got[s], want)
