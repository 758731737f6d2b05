"""The error budget of kernel C3's tensor-core route, on the CPU.

C3 (``csrc/level_tile_tc.cuh``) computes the level's width x width
products (the recomputed hidden layers h W, the weight gradients h^T dz
and the cotangents dz W^T) as 3xTF32: each operand split toward zero into
hi + lo (``tc_split_rz``), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi. Its
input layer, heads and motion VJP stay float32 on the FMA units. Here the
same split is emulated in torch (the hidden layers through an autograd
function whose forward and backward products take TF32 operands) and the
gradient is held against ``level_warp_bwd_plain`` in float64 and in
float32, at width 128 / depth 3 on points and weights from a numpy seed.
Three passes stay well inside the budget that the card's tests hold C3 to
(1e-4 of each tensor's max |g|, ``tests/test_torch_cuda_kernels.py``): they
move no tensor by more than 2e-5 of its max from the float32 VJP (1.3e-6
to 9.8e-6 here), nor more than 2e-5 further from the float64 one than the
float32 VJP itself is. One pass misses the budget (2e-2 to 2e-1). And one
TF32 pass on the head products alone, at the rotation angles ~1e-3 that
mlp_scale gives, takes the gradient past the budget (the trunk's
gradients ~1e-3 of their max, through the cotangent gh W_head^T): why the
heads stay on the FMA units.

Float32 itself sits up to ~1e-4 of a tensor's max from float64 here: the
axis-angle VJP divides by theta ~ 1e-3 (rot 1.0e-4 at 192 points), and
with 64 points the nonrigidity head's gradient, a sum of terms of either
sign, cancels to where float32 is 1.4e-4 off (the 6D + head case runs at
256 points, where it is 3e-6). Those are the float32 function's own
rounding, C3's and the plain version's alike; the checks below measure
what the TF32 split adds to it.
"""
import numpy as np
import pytest
import torch

from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi

from tests.test_torch_flash_backward import _tf32_rz

BUDGET = 1e-4   # of each tensor's max |g|, as C3 is held on the card


def _tf32_matmul(a, b, passes):
    """a @ b on TF32 operands split toward zero: one pass (a and b
    truncated) or C3's three (each part truncated as the tensor cores read
    it), summed in float32."""
    ah, bh = _tf32_rz(a), _tf32_rz(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_rz(a - ah), _tf32_rz(b - bh)
    return al @ bh + ah @ bl + ah @ bh


class _Hidden(torch.autograd.Function):
    """h @ w with TF32 operands in the forward and in both backward
    products (dz w^T, h^T dz), as C3 computes them."""

    @staticmethod
    def forward(ctx, h, w, passes):
        ctx.save_for_backward(h, w)
        ctx.passes = passes
        return _tf32_matmul(h, w, passes)

    @staticmethod
    def backward(ctx, dz):
        h, w = ctx.saved_tensors
        return (_tf32_matmul(dz, w.T, ctx.passes),
                _tf32_matmul(h.T, dz, ctx.passes), None)


class _Head(torch.autograd.Function):
    """A head's fea @ w with one TF32 pass in its forward and backward."""

    @staticmethod
    def forward(ctx, fea, w):
        ctx.save_for_backward(fea, w)
        return _tf32_matmul(fea, w, 1)

    @staticmethod
    def backward(ctx, g):
        fea, w = ctx.saved_tensors
        return _tf32_matmul(g, w.T, 1), _tf32_matmul(fea.T, g, 1)


def _patch(monkeypatch, hidden_passes, head_pass=False):
    """The plain warp with C3's products: the trunk's hidden layers on
    TF32 operands (``hidden_passes``), the input layer in float32 (K = 6,
    FMA in C3); with ``head_pass`` the heads on one TF32 pass."""
    def features(p, x, level, cfg):
        fea = torch.relu(tpyr.posenc(x, level, cfg.k0) @ p["input"]["w"]
                         + p["input"]["b"])
        for i in range(p["hidden"]["w"].shape[0]):
            fea = torch.relu(_Hidden.apply(fea, p["hidden"]["w"][i],
                                           hidden_passes)
                             + p["hidden"]["b"][i])
        return fea

    monkeypatch.setattr(tpyr, "level_features", features)
    if head_pass:
        monkeypatch.setattr(tpyr, "_head",
                            lambda fea, p: _Head.apply(fea, p["w"]) + p["b"])


def _case(cfg, n, seed):
    """A level's flat parameters (Xavier-uniform weights, torch-default
    biases), points at the bench's spread and a chamfer-sized cotangent,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = tpyr.level_shapes(cfg)
    params = {}
    for key in sorted(shapes):
        w_shape = shapes[key]["w"]
        lim = (6.0 / (w_shape[-2] + w_shape[-1])) ** 0.5
        params[key] = {
            "w": rng.uniform(-lim, lim, w_shape),
            "b": rng.uniform(-w_shape[-2] ** -0.5, w_shape[-2] ** -0.5,
                             shapes[key]["b"])}
    flat = tpyr.ravel(tpyr.params_from_numpy(params))
    x = torch.from_numpy(rng.normal(0.0, 0.3, (n, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0.0, 1.0 / n, (n, 3)).astype(np.float32))
    g_nr = torch.from_numpy(rng.normal(0.0, 1.0 / n, n).astype(np.float32))
    return flat, x, g, g_nr


def _grad(flat, x, g, g_nr, level, cfg):
    f = flat.clone().requires_grad_(True)
    out, nr = tfi._plain_warp_nr(f, x, level, cfg)
    loss = (out * g).sum()
    if nr is not None:
        loss = loss + (nr * g_nr).sum()
    return torch.autograd.grad(loss, f)[0]


def _worst(got, ref, cfg):
    """The largest error of any parameter tensor over its own max |g|."""
    shapes = tpyr.level_shapes(cfg)
    got_t, ref_t = tpyr.unravel(got.double(), shapes), tpyr.unravel(ref,
                                                                    shapes)
    return max(float((got_t[k][kk] - ref_t[k][kk]).abs().max()
                     / ref_t[k][kk].abs().max().clamp_min(1e-300))
               for k in ref_t for kk in ref_t[k])


CASES = {
    "SE3-axis_angle": (dict(), 4, 192),
    "Sim3-euler": (dict(motion="Sim3", rotation_format="euler"), 4, 256),
    "SE3-6D-nonrigid": (dict(rotation_format="6D", nonrigidity_est=True),
                        1, 256),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_three_pass_tf32_keeps_c3_within_its_budget(monkeypatch, name):
    """C3's 3xTF32 hidden-layer products move every parameter tensor's
    gradient by less than 2e-5 of its max |g| from the float32 VJP and
    leave it no more than 2e-5 further from the float64 VJP than float32
    is; one TF32 pass misses the 1e-4 budget against both."""
    kw, level, n = CASES[name]
    cfg = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128, **kw)
    flat, x, g, g_nr = _case(cfg, n, seed=11)
    ref = tfi.level_warp_bwd_plain(flat.double(), x.double(), g.double(),
                                   level, cfg, g_nr.double())[0]
    f32 = _grad(flat, x, g, g_nr, level, cfg).double()
    f32_err = _worst(f32, ref, cfg)
    errs = {}
    for passes in (1, 3):
        with monkeypatch.context() as m:
            _patch(m, passes)
            got = _grad(flat, x, g, g_nr, level, cfg)
        errs[passes] = (_worst(got, ref, cfg), _worst(got, f32, cfg))
    assert errs[3][1] < 2e-5 and errs[3][0] < f32_err + 2e-5, (errs, f32_err)
    assert min(errs[1]) > BUDGET, (errs, f32_err)


def test_one_tf32_pass_on_the_heads_breaks_axis_angle(monkeypatch):
    """With the hidden layers on 3xTF32, one TF32 pass on the head
    products (forward and backward) at rotation angles ~1e-3 takes the
    gradient past C3's 1e-4 budget against the float32 VJP: the heads stay
    float32 FMAs."""
    cfg = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128)
    flat, x, g, g_nr = _case(cfg, 192, seed=11)
    p = tpyr.unravel(flat, tpyr.level_shapes(cfg))
    theta = (cfg.mlp_scale * tpyr._head(tpyr.level_features(p, x, 4, cfg),
                                        p["rot"])).norm(dim=-1)
    assert 1e-4 < float(theta.median()) < 1e-2
    f32 = _grad(flat, x, g, g_nr, 4, cfg).double()
    errs = {}
    for head_pass in (False, True):
        with monkeypatch.context() as m:
            _patch(m, 3, head_pass)
            errs[head_pass] = _worst(_grad(flat, x, g, g_nr, 4, cfg), f32,
                                     cfg)
    assert errs[False] < 2e-5 and errs[True] > BUDGET, errs


# The forward alone, as kernel C2 computes it since it runs C3's tile
# (``c3_forward``): the level warp at its path's shapes, held to 1e-5 max
# abs of the plain float32 warp on the card (``chip_smoke.py``).
C2_TOL = 1e-5
FWD_CASES = {
    "SE3-axis_angle": (dict(), 4),
    "Sim3-euler": (dict(motion="Sim3", rotation_format="euler"), 4),
    "nonrigid-level-1": (dict(nonrigidity_est=True), 1),
}


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_three_pass_tf32_keeps_c2_within_its_tolerance(monkeypatch, name):
    """C2's warp (and, with the head, its nonrigidity) with the hidden
    layers' products on three TF32 passes stays below 1e-7 max abs of the
    plain float32 warp at 2000 points: found 3e-8 to 6e-8, about one ulp of
    the coordinates, ~170x inside C2's 1e-5. A level moves the points by
    only ~3e-4 (mlp_scale 1e-3), so one pass (3.6e-7 to 8.3e-7) would stay
    inside the tolerance too, but ~10x further from float32: the next test
    holds C2 where the tolerance tells them apart."""
    kw, level = FWD_CASES[name]
    cfg = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128, **kw)
    flat, x, _, _ = _case(cfg, 2000, seed=12)
    ref = tfi._plain_warp_nr(flat, x, level, cfg)
    errs = {}
    for passes in (1, 3):
        with monkeypatch.context() as m:
            _patch(m, passes)
            got = tfi._plain_warp_nr(flat, x, level, cfg)
        errs[passes] = max(float((a - b).abs().max())
                           for a, b in zip(got, ref) if b is not None)
    assert errs[3] < 1e-7 < errs[1] < C2_TOL, errs


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_c2_tolerance_sees_one_pass_at_mlp_scale_1(monkeypatch, name):
    """The same cases with mlp_scale 1, where the hidden layers' rounding
    reaches the warp unshrunk (a level moves a point by ~0.3): three TF32
    passes stay below 1e-6 max abs of the plain float32 warp (found 2.7e-7
    to 4.8e-7, 20x inside C2's 1e-5), one pass lands beyond 5e-5 (found
    3.8e-4 to 8.6e-4). So C2's 1e-5, held at mlp_scale 1 on the card
    (``chip_smoke.C2_UNSCALED_CASES``), tells three passes from one."""
    kw, level = FWD_CASES[name]
    cfg = tpyr.NDPConfig(m=9, k0=-8, depth=3, width=128, mlp_scale=1.0,
                         **kw)
    flat, x, _, _ = _case(cfg, 2000, seed=12)
    ref = tfi._plain_warp_nr(flat, x, level, cfg)
    errs = {}
    for passes in (1, 3):
        with monkeypatch.context() as m:
            _patch(m, passes)
            got = tfi._plain_warp_nr(flat, x, level, cfg)
        errs[passes] = max(float((a - b).abs().max())
                           for a, b in zip(got, ref) if b is not None)
    assert errs[3] < C2_TOL / 10 and errs[1] > 5 * C2_TOL, errs
