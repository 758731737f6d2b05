"""``compute_dtype='bfloat16'`` (the yaml's ``inference_dtype``) in the port
against the JAX package on the CPU, with the JAX init's weights.

Both sides round every product's operands to bfloat16 (8 significant bits:
a rounding moves a value by at most 2^-8 of it) and accumulate in float32,
so each product's terms are the same numbers and only their summation order
differs (~1e-7 relative). Where an intermediate lies within that float32
noise of a bfloat16 rounding boundary, the two sides round it to
neighbouring bf16 values, 2^-7 of it apart; such an element moves the next
product by at most 2^-7 of one of its terms. The bounds are set from that
step:

* the attention layer ('xla' route): within 2^-8 of the output's max,
  and on average 2^-16 of it (a few flipped roundings among ~10^5 terms);
  the float32 layer, for scale, differs from the bf16 one by far more;
* ``confidence_matrix`` (dual softmax at temperature 0.1, whose logits
  amplify a similarity's error 10x): within 2^-8 of the matrix's max;
* a narrow ``landmark_inference`` (the landmark model of
  ``tests/test_torch_match_pipeline.py`` at bf16). Through a stack of
  layers the flips compound: a flipped element perturbs every later
  rounding, so the two sides' bf16 noise decorrelates (a chain of six
  self-attention layers parts from 2e-6 of the max after the first to 4e-4
  after the fifth, against 2e-3 between bf16 and float32), and the dual
  softmax at temperature 0.1 amplifies a similarity's error 10x. So the
  confidence matrix is held within 2^-5 of its max, and no farther from
  the JAX package's than twice the port's own float32 matrix is (bf16's
  distance from float32); the mutual matches are the same apart from
  entries within 2^-5 of the threshold or of their row's or column's
  runner-up;
* the port's flash route (kernel C7's plain version here, float32 q / k /
  v as the JAX package's TPU flash route takes them) against its own bf16
  einsum route: within 2^-6 of the output's max, the bf16 roundings of q,
  k, the probabilities and v (2^-8 each) being the difference. Off the
  TPU the JAX package has no flash route.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deformationpyramid_tpu.match import attention as jatt
from deformationpyramid_tpu.match import landmark as jl
from deformationpyramid_tpu.match import matching as jm
import deformationpyramid_tpu_torch as tdp
from deformationpyramid_tpu_torch.match import attention as tatt
from deformationpyramid_tpu_torch.match import landmark as tl
from deformationpyramid_tpu_torch.match import matching as tm

from tests.test_torch_match_pipeline import CAP, landmark_cfgs, pair  # noqa: F401

D, L, S = 96, 200, 170
BF16_STEP = 2.0 ** -8


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


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, D)).astype(np.float32)
    s = rng.standard_normal((S, D)).astype(np.float32)
    xpe = rng.standard_normal((L, D, 2)).astype(np.float32)
    spe = rng.standard_normal((S, D, 2)).astype(np.float32)
    return x, s, xpe, spe, np.arange(L) < 180, np.arange(S) < 150


def _layer(dtype, impl, seed):
    jc = jatt.AttentionConfig(feature_dim=D, n_head=4, compute_dtype=dtype)
    tc = tatt.AttentionConfig(feature_dim=D, n_head=4, compute_dtype=dtype,
                              attention_impl=impl)
    jp = jatt.init_attention_layer(jax.random.key(seed), jc)
    tp = tdp.params_from_numpy(jax.tree.map(np.asarray, jp))
    args = _layer_inputs(seed)
    return jp, tp, jc, tc, args


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_layer_bf16_matches_jax(seed):
    jp, tp, jc, tc, args = _layer("bfloat16", "xla", seed)
    jo = np.asarray(jatt.apply_attention_layer(jp, *args, jc))[:180]
    to = tatt.apply_attention_layer(tp, *map(_t, args), tc).numpy()[:180]
    scale = np.abs(jo).max()
    err = np.abs(to - jo)
    assert err.max() <= BF16_STEP * scale, err.max() / scale
    assert err.mean() <= BF16_STEP ** 2 * scale, err.mean() / scale
    # the bf16 products are what is compared: float32 lies far off
    f32 = tatt.apply_attention_layer(
        tp, *map(_t, args), dataclasses.replace(tc, compute_dtype="float32")
    ).numpy()[:180]
    assert np.abs(f32 - jo).mean() > 10 * err.mean()


def test_other_dtypes_are_float32():
    _, tp, _, tc, args = _layer("float32", "xla", 0)
    ref = tatt.apply_attention_layer(tp, *map(_t, args), tc)
    for dtype in ("float16", "fp32", "bf16"):
        out = tatt.apply_attention_layer(
            tp, *map(_t, args), dataclasses.replace(tc, compute_dtype=dtype))
        assert torch.equal(out, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_confidence_matrix_bf16_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jc = jm.MatchingConfig(feature_dim=D, compute_dtype="bfloat16")
    tc = tm.MatchingConfig(feature_dim=D, compute_dtype="bfloat16")
    jp = jm.init_matching(jax.random.key(seed), jc)
    tp = tdp.params_from_numpy(jax.tree.map(np.asarray, jp))
    sf = rng.standard_normal((L, D)).astype(np.float32)
    tf = rng.standard_normal((S, D)).astype(np.float32)
    spe = rng.standard_normal((L, D, 2)).astype(np.float32)
    tpe = rng.standard_normal((S, D, 2)).astype(np.float32)
    sm, tmask = np.arange(L) < 190, np.arange(S) < 160
    args = (sf, tf, spe, tpe, sm, tmask)
    jo = np.asarray(jm.confidence_matrix(jp, *args, jc))
    to = tm.confidence_matrix(tp, *map(_t, args), tc).numpy()
    scale = np.abs(jo).max()
    assert np.abs(to - jo).max() <= BF16_STEP * scale


def _bf16(cfg):
    mc = dataclasses.replace(cfg.matcher.matching, compute_dtype="bfloat16")
    tr = dataclasses.replace(cfg.matcher.transformer,
                             compute_dtype="bfloat16", matching=mc)
    return dataclasses.replace(cfg, matcher=dataclasses.replace(
        cfg.matcher, transformer=tr, matching=mc))


def test_landmark_inference_bf16_matches_jax(pair):  # noqa: F811
    jcfg, tcfg = (_bf16(c) for c in landmark_cfgs())
    sl, tl_ = pair["pyr"].src_lengths[2], pair["pyr"].tgt_lengths[2]
    jout = jax.jit(lambda p, y: jl.landmark_inference(
        p, y, jnp.int32(sl), jnp.int32(tl_), jcfg, s_cap=CAP, t_cap=CAP))(
            pair["jparams"], pair["jpyr"])
    tout = tl.landmark_inference(pair["tparams"], pair["tpyr"],
                                 torch.tensor(sl), torch.tensor(tl_), tcfg,
                                 s_cap=CAP, t_cap=CAP)
    conf_j = np.asarray(jout["conf_matrix_pred"])
    conf_t = tout["conf_matrix_pred"].numpy()
    conf_f32 = tl.landmark_inference(
        pair["tparams"], pair["tpyr"], torch.tensor(sl), torch.tensor(tl_),
        landmark_cfgs()[1], s_cap=CAP, t_cap=CAP)["conf_matrix_pred"].numpy()
    scale = np.abs(conf_j).max()
    err = np.abs(conf_t - conf_j).max()
    assert np.isfinite(conf_t).all()
    assert err <= 8 * BF16_STEP * scale, err / scale
    assert err <= 2 * np.abs(conf_f32 - conf_j).max()
    thr = tcfg.matcher.matching.confidence_threshold
    rows = {}
    for tag, out in (("j", jout), ("t", tout)):
        idx = np.asarray(out["match_idx"])
        valid = np.asarray(out["match_valid"])
        rows[tag] = {(int(i), int(j)) for (i, j), v in zip(idx, valid) if v}
    tol = 8 * BF16_STEP * scale

    def near_tie(i, j):
        """Within ``tol`` of the threshold, or of another entry of its row
        or column (the mutual maximum), on either side."""
        for conf in (conf_j, conf_t):
            c = conf[i, j]
            others = max(np.delete(conf[i], j).max(),
                         np.delete(conf[:, j], i).max())
            if abs(c - thr) < tol or abs(c - others) < tol:
                return True
        return False

    near = {k for k in rows["j"] ^ rows["t"] if near_tie(*k)}
    assert len(rows["j"]) >= 10     # the test is not about empty sets
    assert rows["j"] ^ rows["t"] <= near


@pytest.mark.parametrize("seed", [0, 3])
def test_flash_route_matches_bf16_einsum_route(seed):
    _, tp, _, tc, args = _layer("bfloat16", "xla", seed)
    einsum = tatt.apply_attention_layer(tp, *map(_t, args), tc).numpy()
    flash = tatt.apply_attention_layer(
        tp, *map(_t, args), dataclasses.replace(tc, attention_impl="flash")
    ).numpy()
    einsum, flash = einsum[:180], flash[:180]
    scale = np.abs(einsum).max()
    assert np.abs(flash - einsum).max() <= 4 * BF16_STEP * scale
