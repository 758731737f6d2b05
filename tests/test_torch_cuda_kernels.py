"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA device. Marked ``cuda``: without a card every test here skips (the
decision is taken in a fixture, never at import). On the card run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q``
(``--noconftest`` where JAX, which tests/conftest.py imports, is absent).

Tolerances: C1 indices equal up to near-ties < 3e-4 relative and
distances 1e-5; C2 warped points 1e-5; C3 gradients 1e-4 of each tensor's
max |g|; C4 moments 1e-6 of their max and ``hold`` bit-exact; C5 warped
rows 1e-5, loss 1e-6 relative, counter and done equal, moments 1e-6 of
their max, params 1e-6 where |g| > 1e-3 max|g|, a held step bit-exact; C6
bit-equal to index_add_ on the CPU. The fused level repeats bit for bit
(the glue's scatter has a fixed order).
C2 and C3 are checked for SE3 + axis_angle and Sim3 + euler.
"""
import pytest
import torch

from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.ops import knn as tknn

pytestmark = pytest.mark.cuda

CFG = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64)
CONFIGS = {"SE3-axis_angle": CFG,
           "Sim3-euler": tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64,
                                        motion="Sim3",
                                        rotation_format="euler")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert torch.get_float32_matmul_precision() == "highest"
    return torch.device("cuda")


def _level(dev, seed=0, n=333, cfg=CFG):
    gen = torch.Generator().manual_seed(seed)
    params = tpyr.init_pyramid_params(gen, cfg)
    flat = tpyr.ravel(tpyr.level_params(params, 2)).to(dev)
    x = (torch.randn(n, 3, generator=gen) * 0.5).to(dev)
    g = (torch.randn(n, 3, generator=gen) * 0.1).to(dev)
    return flat, x, g


def test_nn_dual_matches_plain(dev):
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(517, 3, generator=gen).to(dev)
    y = torch.randn(389, 3, generator=gen).to(dev)
    xv = (torch.rand(517, generator=gen) > 0.1).to(dev)
    yv = (torch.rand(389, generator=gen) > 0.1).to(dev)
    got = tknn.nn_argmin_dual(x, y, xv, yv)
    ref = tknn.nn_argmin_dual_plain(x, y, xv, yv)
    torch.cuda.synchronize()
    for q, db, (d, i), (rd, ri) in ((x, y, got[:2], ref[:2]),
                                    (y, x, got[2:], ref[2:])):
        assert (d - rd).abs().max() < 1e-5
        flips = i != ri
        if flips.any():
            dg = ((q[flips] - db[i[flips]]) ** 2).sum(-1)
            dr = ((q[flips] - db[ri[flips]]) ** 2).sum(-1)
            assert ((dg - dr).abs() / dr.clamp_min(1e-30)).max() < 3e-4
    assert yv[got[1]].all() and xv[got[3]].all()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_level_warp_fwd_matches_plain(dev, name):
    cfg = CONFIGS[name]
    flat, x, _ = _level(dev, cfg=cfg)
    got = tfi.level_warp_fwd(flat, x, 2, cfg)
    ref = tfi._plain_warp(flat, x, 2, cfg)
    assert (got - ref).abs().max() < 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_level_warp_bwd_matches_vjp(dev, name):
    cfg = CONFIGS[name]
    flat, x, g = _level(dev, cfg=cfg)
    got = tfi.level_warp_bwd(flat, x, g, 2, cfg).sum(0)
    ref = tfi.level_warp_bwd_plain(flat, x, g, 2, cfg)[0]
    shapes = tpyr.level_shapes(cfg)
    got_t, ref_t = tpyr.unravel(got, shapes), tpyr.unravel(ref, shapes)
    for k in ref_t:
        for kk in ref_t[k]:
            scale = ref_t[k][kk].abs().max().clamp_min(1e-30)
            err = (got_t[k][kk] - ref_t[k][kk]).abs().max() / scale
            assert err < 1e-4, (k, kk, float(err))


def test_adam_step_matches_plain_and_holds(dev):
    flat, x, g = _level(dev)
    partials = tfi.level_warp_bwd(flat, x, g, 2, CFG)
    outs = []
    for fn in (tfi.adam_step, tfi.adam_step_plain):
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        fn(p, m, v, partials, torch.zeros((), device=dev),
           torch.zeros((), device=dev), 0.01)
        outs.append((p, m, v))
    (p, m, v), (rp, rm, rv) = outs
    assert (m - rm).abs().max() <= 1e-6 * rm.abs().max()
    assert (v - rv).abs().max() <= 1e-6 * rv.abs().max()
    big = partials.sum(0).abs() > 1e-3 * partials.sum(0).abs().max()
    assert (p - rp)[big].abs().max() < 1e-6

    held = flat.clone()
    m0, v0 = torch.ones_like(flat), torch.ones_like(flat)
    tfi.adam_step(held, m0, v0, partials, torch.zeros((), device=dev),
                  torch.ones((), device=dev), 0.01)
    assert torch.equal(held, flat) and (m0 == 1).all() and (v0 == 1).all()


def test_fused_level_matches_cpu_plain(dev):
    """A whole fused level on the card against the same level on the CPU
    (plain versions): equal iteration counts, warped points within 1e-3."""
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    gen = torch.Generator().manual_seed(3)
    params = tpyr.level_params(tpyr.init_pyramid_params(gen, CFG), 1)
    pts = torch.randn(180, 3, generator=gen) * 0.4
    tgt = torch.randn(200, 3, generator=gen) * 0.4
    ones = lambda n: torch.ones(n, dtype=torch.bool)
    lcfg = LoopConfig(iters=25)
    outs = [tfi.run_fused_level(
        tpyr.tree_map(lambda t: t.to(d), params), pts.to(d), ones(180).to(d),
        tgt.to(d), ones(200).to(d), 1, CFG, lcfg) for d in (dev, "cpu")]
    (_, w, st), (_, rw, rst) = outs
    assert int(st["iters"]) == int(rst["iters"])
    assert (w.cpu() - rw).abs().max() < 1e-3


def _ldmk_inputs(dev, n=333):
    flat, x, g = _level(dev, n=n)
    gen = torch.Generator().manual_seed(5)
    tgt = x + (torch.randn(n, 3, generator=gen) * 0.05).to(dev)
    mask = (torch.rand(n, generator=gen) > 0.2).to(torch.float32).to(dev)
    return flat, x, tgt, mask, mask.sum().clamp_min(1.0)


@pytest.mark.parametrize("loss_eps", [1e-4, 1e9])
def test_ldmk_iteration_matches_plain(dev, loss_eps):
    """C5 against its plain version: one step, and (loss_eps 1e9) a step
    that the early stop holds, bit-exact."""
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    flat, x, tgt, mask, count = _ldmk_inputs(dev)
    outs = []
    for fn in ("kernel", "plain"):
        stop = tfi.EarlyStop(LoopConfig(iters=10, loss_eps=loss_eps), dev)
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        aux = torch.zeros_like(x)
        if fn == "kernel":
            tfi.ldmk_iteration(p, m, v, x, tgt, mask, count, stop, aux, 2,
                               CFG, 0.01)
        else:
            tfi.ldmk_iteration_plain(p, m, v, x, tgt, mask, count, stop, aux,
                                     2, CFG, 0.01)
        outs.append((p, m, v, aux, stop))
    torch.cuda.synchronize()
    (p, m, v, aux, st), (rp, rm, rv, raux, rst) = outs
    assert (aux - raux).abs().max() < 1e-5
    assert abs(float(st.loss) - float(rst.loss)) <= 1e-6 * float(rst.loss)
    for k in ("counter", "done", "it", "applied"):
        assert float(getattr(st, k)) == float(getattr(rst, k)), k
    if loss_eps > 1.0:
        assert bool(st.done) and torch.equal(p, flat)
        assert not m.any() and not v.any()
        return
    assert (m - rm).abs().max() <= 1e-6 * rm.abs().max()
    assert (v - rv).abs().max() <= 1e-6 * rv.abs().max()
    big = rm.abs() > 1e-3 * rm.abs().max()
    assert (p - rp)[big].abs().max() < 1e-6


def test_ldmk_iteration_halted_is_a_no_op(dev):
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    flat, x, tgt, mask, count = _ldmk_inputs(dev)
    stop = tfi.EarlyStop(LoopConfig(iters=10), dev)
    stop.done.fill_(True)
    p, m, v = flat.clone(), torch.ones_like(flat), torch.ones_like(flat)
    aux = torch.zeros_like(x)
    tfi.ldmk_iteration(p, m, v, x, tgt, mask, count, stop, aux, 2, CFG, 0.01)
    torch.cuda.synchronize()
    assert torch.equal(p, flat) and (m == 1).all() and not aux.any()
    assert int(stop.it) == 0


def test_scatter_rows_matches_cpu_index_add(dev):
    """C6 against its plain version, index_add_ on the CPU: bit-equal, and
    the same on a second run."""
    gen = torch.Generator().manual_seed(6)
    idx = torch.randint(0, 40, (20000,), generator=gen)
    src = torch.randn(20000, 3, generator=gen) * 1e-3
    dst = torch.randn(50, 3, generator=gen) * 1e-3
    ref = tfi.scatter_add_rows(dst.clone(), idx, src)
    runs = [tfi.scatter_add_rows(dst.to(dev), idx.to(dev), src.to(dev))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), ref)


def test_fused_level_repeats_exactly(dev):
    """The same fused level twice on the card: equal iteration counts and
    bit-equal warped points."""
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    gen = torch.Generator().manual_seed(4)
    params = tpyr.level_params(tpyr.init_pyramid_params(gen, CFG), 1)
    pts = (torch.randn(900, 3, generator=gen) * 0.4).to(dev)
    tgt = (torch.randn(1000, 3, generator=gen) * 0.4).to(dev)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=dev)
    runs = [tfi.run_fused_level(tpyr.tree_map(lambda t: t.to(dev), params),
                                pts, ones(900), tgt, ones(1000), 1, CFG,
                                LoopConfig(iters=120)) for _ in range(2)]
    (_, w, st), (_, w2, st2) = runs
    assert int(st["iters"]) == int(st2["iters"])
    assert torch.equal(w, w2)
