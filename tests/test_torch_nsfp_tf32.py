"""The error budget of kernels C10 / C11's tensor-core route, on the CPU.

C10 ``nsfp_fwd`` and C11 ``nsfp_bwd`` (``csrc/nsfp.cu``) compute the NSFP
net's hidden layers on C3's tile: the products h W (forward), dz W^T and
h^T dz (backward) as 3xTF32, each operand split toward zero into hi + lo
(``tc_split_rz``), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi. The 3 -> w
input layer and the w -> 3 head stay float32 on the FMA units. Here the
same split is emulated in torch on the 7 hidden layers of the 9 x 128 net
(an autograd function whose forward and backward products take TF32
operands), at 2000 points and torch-default weights from a numpy seed, and
held to the budgets the card holds the kernels to (``chip_smoke.py``
``nsfp_kernel_phase``, ``tests/test_torch_cuda_kernels.py``): the warp
within ``FWD_TOL`` = 2e-5 max abs of the plain float32 warp, the
gradient within 1e-4 of each tensor's max |g| of the float64 VJP.

The chain is nine layers deep and has no ``mlp_scale`` to shrink it, so
one TF32 pass shows: it moves the gradient by 1.3e-2 to 2.2e-2 of a
tensor's max from float64 (three passes: 2.0e-6 to 2.3e-6; float32 itself
4.2e-7 to 4.6e-7). The warp moves less: the net's flow is only 0.05 to
0.11 at this init, so one pass lands at 1.3e-5 to 1.7e-5, inside
``FWD_TOL``, but over 100x further from float32 than three passes
(1.2e-7): the gradient's budget is the one that tells the two apart.

The cotangent is a smooth field over the points (random ones cancel in
the sums over points, where float32 itself parts from float64), zero at the
few points whose pre-activations lie within 1e-6 of a ReLU kink in a
float64 forward (two float32 computations may take either side there:
``chip_smoke.nsfp_off_kinks``).
"""
import numpy as np
import pytest
import torch

from deformationpyramid_tpu_torch.models import baselines as tbase
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi

from tests.test_torch_level_warp_tf32 import _Hidden

BUDGET = 1e-4   # of each tensor's max |g|, as C11 is held on the card
FWD_TOL = 2e-5  # max abs, as C10 is held on the card
NCFG = tbase.NSFPConfig()   # 9 layers x 128, 116,483 parameters
N = 2000


def _patch(monkeypatch, passes):
    """``nsfp_flow`` with C10 / C11's products: the hidden layers on TF32
    operands (``passes`` 1 or 3, forward and backward), the input layer and
    the head in float32."""
    def flow(params, x, cfg):
        h = x
        for i, p in enumerate(params):
            hidden = 0 < i < len(params) - 1
            h = (_Hidden.apply(h, p["w"], passes) if hidden
                 else h @ p["w"]) + p["b"]
            if i < len(params) - 1:
                h = torch.relu(h)
        return h

    monkeypatch.setattr(tbase, "nsfp_flow", flow)


def _case(seed):
    """Flat torch-default weights (uniform +-1/sqrt(fan_in), biases too),
    points at the spread of the path's centred clouds, and a smooth
    chamfer-sized cotangent off the ReLU kinks, from a numpy seed."""
    rng = np.random.default_rng(seed)
    dims = tbase.nsfp_dims(NCFG)
    params = []
    for i in range(NCFG.n_layers):
        lim = dims[i] ** -0.5
        params.append({
            "w": rng.uniform(-lim, lim, (dims[i], dims[i + 1])),
            "b": rng.uniform(-lim, lim, dims[i + 1])})
    flat = tfi.nsfp_params_to_flat(tpyr.params_from_numpy(params))
    x = torch.from_numpy(rng.normal(0.0, 0.5, (N, 3)).astype(np.float32))
    a = torch.from_numpy(rng.normal(0.0, 1.0, (3, 3)).astype(np.float32))
    g = torch.tanh(x @ a) / N
    h, near = x.double(), torch.zeros(N, dtype=torch.bool)
    for p in tfi.nsfp_flat_to_params(flat.double(), NCFG)[:-1]:
        z = h @ p["w"] + p["b"]
        near |= (z.abs() < 1e-6).any(-1)
        h = torch.relu(z)
    return flat, x, g * (~near)[:, None]


def _grad(flat, x, g):
    f = flat.clone().requires_grad_(True)
    out = tfi.nsfp_fwd_plain(f, x, NCFG)
    return torch.autograd.grad((out * g).sum(), f)[0]


def _worst(got, ref):
    """The largest error of any parameter tensor over its own max |g|."""
    shapes = tfi.nsfp_shapes(NCFG)
    pairs = zip(tpyr.tree_leaves(tpyr.unravel(got.double(), shapes)),
                tpyr.tree_leaves(tpyr.unravel(ref, shapes)))
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
               for a, b in pairs)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_pass_tf32_keeps_c11_within_its_budget(monkeypatch, seed):
    """Three TF32 passes on the hidden layers move no parameter tensor's
    gradient by 2e-5 of its max from the float32 VJP and leave it no more
    than 2e-5 further from the float64 VJP than float32 is; one pass misses
    the 1e-4 budget against both."""
    flat, x, g = _case(seed)
    ref = tfi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                             NCFG)[0]
    f32 = _grad(flat, x, g).double()
    f32_err = _worst(f32, ref)
    errs = {}
    for passes in (1, 3):
        with monkeypatch.context() as m:
            _patch(m, passes)
            got = _grad(flat, x, g)
        errs[passes] = (_worst(got, ref), _worst(got, f32))
    assert f32_err < 1e-5, f32_err
    assert errs[3][1] < 2e-5 and errs[3][0] < f32_err + 2e-5, (errs, f32_err)
    assert min(errs[1]) > BUDGET, (errs, f32_err)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_pass_tf32_keeps_c10_within_its_tolerance(monkeypatch, seed):
    """C10's warp with the hidden layers on three TF32 passes stays below
    1e-6 max abs of the plain float32 warp (found 1.2e-7, ~170x inside
    ``FWD_TOL``); one pass lands over 10x further (found 1.3e-5 to 1.7e-5,
    inside ``FWD_TOL`` only because the flow is small at this init)."""
    flat, x, _ = _case(seed)
    ref = tfi.nsfp_fwd_plain(flat, x, NCFG)
    errs = {}
    for passes in (1, 3):
        with monkeypatch.context() as m:
            _patch(m, passes)
            errs[passes] = float((tfi.nsfp_fwd_plain(flat, x, NCFG)
                                  - ref).abs().max())
    assert errs[3] < 1e-6 and errs[1] > 10 * errs[3], errs
    assert errs[3] < FWD_TOL / 10, errs

