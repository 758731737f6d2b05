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
C14 distances 1e-6 relative and indices equal up to near-ties, at ragged
tiles and with no valid row. C2 and C3 are checked for SE3 + axis_angle, Sim3 + euler, sflow, and SE3 and
Sim3 with the quaternion and 6D formats. C10 warped points 2e-5; C11
gradients 1e-4 of each tensor's max |g| against the plain version in float64
(nine float32 layers deep, two float32 gradients differ by more), bit-equal
on a second launch, at a ragged last tile and at width 32; the fused NSFP
loop against the CPU's plain loop. C7 against its
plain version 2e-5 max abs (outputs are convex combinations of N(0, 1)
values; the two sum S terms in different orders), at the matcher's shape,
at an awkward one, with an empty source prefix, and inside a layer. C8 and
C9 against ``flash_attention_bwd_plain`` 2e-5 max abs on the same inputs
and a unit-scale upstream gradient, bit-equal on a second launch, zero
beyond the prefix, and through autograd inside a layer against the einsum
route (1e-4 of each gradient's max). C12 against its plain version: sums
and cgrad 2e-5 of their max, rmin 2e-5, rarg equal up to near-ties, the
query gradient 1e-4 of its max, bit-equal on a second launch; C13
bit-equal to the block-order sum, 1e-6 of the float64 sum's max; C2 / C3
with the nonrigidity head at levels 0 and 1 as C2 / C3; the opt-in routes'
small solves on the card against the CPU: equal iterations, warp 1e-3.
"""
import pytest
import torch

from deformationpyramid_tpu_torch.match import attention as tatt
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops import fused_iteration as tfi
from deformationpyramid_tpu_torch.ops import knn as tknn

pytestmark = pytest.mark.cuda

CFG = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64)
CONFIGS = {"SE3-axis_angle": CFG,
           "Sim3-euler": tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64,
                                        motion="Sim3",
                                        rotation_format="euler")}
CONFIGS.update({
    f"{motion}-{fmt}": tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64,
                                      motion=motion, rotation_format=fmt)
    for motion, fmt in (("sflow", "axis_angle"), ("SE3", "quaternion"),
                        ("SE3", "6D"), ("Sim3", "quaternion"),
                        ("Sim3", "6D"))})


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


@pytest.mark.parametrize("n,m,mask", [(2000, 2000, None),
                                       (777, 1333, "random"),
                                       (130, 65, "none valid")])
def test_nn_argmin_matches_plain(dev, n, m, mask):
    """C14 against its plain version: 64-point tiles, so 777 / 1333 / 130
    / 65 leave ragged last tiles; distances 1e-6 relative, indices equal up
    to near-ties, one launch a call; with no valid row (+inf, 0)."""
    gen = torch.Generator().manual_seed(n + m)
    centre = torch.tensor([0.2, -0.1, 1.5])
    x = (torch.randn(n, 3, generator=gen) * 0.3 + centre).to(dev)
    y = (torch.randn(m, 3, generator=gen) * 0.3 + centre).to(dev)
    yv = None
    if mask == "random":
        yv = (torch.rand(m, generator=gen) > 0.3).to(dev)
    elif mask == "none valid":
        yv = torch.zeros(m, dtype=torch.bool, device=dev)
    before = tknn.NN_ARGMIN.launches
    sq, idx = tknn.nn_argmin(x, y, yv)
    rsq, ridx = tknn.nn_argmin_plain(x, y, yv)
    torch.cuda.synchronize()
    assert tknn.NN_ARGMIN.launches == before + 1
    assert sq.dtype == torch.float32 and idx.dtype == torch.int64
    if mask == "none valid":
        assert torch.isinf(sq).all() and (idx == 0).all()
        return
    assert ((sq - rsq).abs() <= 1e-6 * rsq).all()
    flips = idx != ridx
    if flips.any():
        dg = ((x[flips] - y[idx[flips]]) ** 2).sum(-1)
        dr = ((x[flips] - y[ridx[flips]]) ** 2).sum(-1)
        assert ((dg - dr).abs() / dr.clamp_min(1e-30)).max() < 3e-4
    if yv is not None:
        assert yv[idx].all()


def test_register_ed_repeats_on_the_card(dev):
    """The ED solve draws its resamples from a generator on the card and
    its gathers' backward is sort-based: one seed gives equal iterations
    and a bit-equal warp; its chamfer runs C1."""
    from deformationpyramid_tpu_torch.solve import baselines as tsolve
    gen = torch.Generator().manual_seed(5)
    src = torch.rand(3000, 3, generator=gen)
    tgt = src + torch.tensor([0.05, -0.02, 0.03])
    nodes = src[:40]
    d = ((nodes[:, None] - nodes[None]) ** 2).sum(-1)
    d.fill_diagonal_(float("inf"))
    edges = d.argsort(1)[:, :6]
    anchors = ((src[:, None] - nodes[None]) ** 2).sum(-1).argsort(1)[:, :4]
    args = [t.to(dev) for t in (src, tgt, nodes, edges,
                                torch.full((40, 6), 1 / 6), anchors,
                                torch.full((3000, 4), 0.25))]
    cfg = tsolve.EDSolverConfig(iters=60, samples=1000)
    before = tknn.NN_DUAL.launches
    a, sa = tsolve.register_ed(7, *args, cfg)
    b, sb = tsolve.register_ed(7, *args, cfg)
    torch.cuda.synchronize()
    assert tknn.NN_DUAL.launches - before >= 2 * int(sa["iters"])
    assert int(sa["iters"]) == int(sb["iters"]) and torch.equal(a, b)
    assert torch.isfinite(a).all()


def test_nn_argmin_refuses_mixed_devices(dev):
    x = torch.rand(10, 3, device=dev)
    with pytest.raises(ValueError):
        tknn.nn_argmin(x, torch.rand(12, 3))


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


def _nsfp(dev, ncfg, n, seed=0):
    from deformationpyramid_tpu_torch.models import baselines as tbase

    gen = torch.Generator().manual_seed(seed)
    flat = tfi.nsfp_params_to_flat(tbase.init_nsfp_params(gen, ncfg)).to(dev)
    x = (torch.randn(n, 3, generator=gen) * 0.5).to(dev)
    g = (torch.randn(n, 3, generator=gen) * 0.1).to(dev)
    return flat, x, g


NSFP_CASES = {"9x128-2000": (dict(), 2000), "9x128-ragged": (dict(), 333),
              "4x32": (dict(width=32, n_layers=4), 50),
              "2x64": (dict(width=64, n_layers=2), 17)}


@pytest.mark.parametrize("name", sorted(NSFP_CASES))
def test_nsfp_fwd_and_bwd_match_plain(dev, name):
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    kw, n = NSFP_CASES[name]
    ncfg = NSFPConfig(**kw)
    flat, x, g = _nsfp(dev, ncfg, n)
    got = tfi.nsfp_fwd(flat, x, ncfg)
    assert (got - tfi.nsfp_fwd_plain(flat, x, ncfg)).abs().max() < 2e-5
    part = tfi.nsfp_bwd(flat, x, g, ncfg)
    assert part.shape == (-(-n // tfi.NSFP_TILE), flat.numel())
    assert torch.equal(part, tfi.nsfp_bwd(flat, x, g, ncfg))
    ref = tfi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                             ncfg)[0].float()
    shapes = tfi.nsfp_shapes(ncfg)
    for a, b in zip(tpyr.tree_leaves(tpyr.unravel(part.sum(0), shapes)),
                    tpyr.tree_leaves(tpyr.unravel(ref, shapes))):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-30)


def test_nsfp_kernels_refuse_what_they_do_not_cover(dev):
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    ncfg = NSFPConfig(width=32, n_layers=4)
    flat, x, g = _nsfp(dev, ncfg, 20)
    with pytest.raises(ValueError):
        tfi.nsfp_fwd(flat, x, NSFPConfig(width=32, n_layers=4, act="sigmoid"))
    with pytest.raises(ValueError):
        tfi.nsfp_fwd(flat[:-1].contiguous(), x, ncfg)
    with pytest.raises(ValueError):
        tfi.nsfp_bwd(flat, x, g[:10].contiguous(), ncfg)
    with pytest.raises(ValueError):
        tfi.nsfp_fwd(flat, x.cpu(), ncfg)


def test_fused_nsfp_matches_cpu_plain_and_repeats(dev):
    """The fused NSFP loop on the card (C10, C1, C6, C11, C4) against the
    same loop on the CPU (plain versions) over 5 iterations: equal
    iteration count, loss 1e-4, parameters 2e-2 (Adam's +-lr steps on
    rounding noise; the band of the CPU parity tests); twice on the card
    bit-equal."""
    from deformationpyramid_tpu_torch.models import baselines as tbase
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    ncfg = tbase.NSFPConfig(width=64, n_layers=5)
    gen = torch.Generator().manual_seed(4)
    params = tbase.init_nsfp_params(gen, ncfg)
    pts = torch.randn(180, 3, generator=gen) * 0.4
    tgt = torch.randn(200, 3, generator=gen) * 0.4
    ones = lambda n: torch.ones(n, dtype=torch.bool)
    outs = [tfi.run_fused_nsfp(
        tpyr.tree_map(lambda t: t.to(d), params), pts.to(d), ones(180).to(d),
        tgt.to(d), ones(200).to(d), LoopConfig(iters=5), ncfg)
        for d in (dev, dev, "cpu")]
    (p1, st1), (p2, st2), (pc, stc) = outs
    assert int(st1["iters"]) == int(stc["iters"]) == 5
    assert abs(float(st1["loss"]) - float(stc["loss"])) < 1e-4
    for a, b, c in zip(tpyr.tree_leaves(p1), tpyr.tree_leaves(p2),
                       tpyr.tree_leaves(pc)):
        assert torch.equal(a, b)
        assert (a.cpu() - c).abs().max() < 2e-2


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


@pytest.mark.parametrize("L,S,src_len,h,d", [(2048, 2048, 1500, 4, 132),
                                             (777, 1333, 1000, 4, 132),
                                             (777, 1333, 0, 4, 132),
                                             (130, 70, 70, 8, 18),
                                             (1, 1, 1, 1, 144)])
def test_flash_attention_matches_plain(dev, L, S, src_len, h, d):
    gen = torch.Generator().manual_seed(7)
    q = torch.randn(L, h, d, generator=gen).to(dev)
    k = torch.randn(S, h, d, generator=gen).to(dev)
    v = torch.randn(S, h, d, generator=gen).to(dev)
    scale = d ** -0.5
    n = torch.tensor(src_len, dtype=torch.int32, device=dev)
    before = tatt.FLASH_ATTENTION.launches
    got = tatt.flash_attention(q, k, v, n, scale)
    ref = tatt.flash_attention_plain(q, k, v, n, scale)
    torch.cuda.synchronize()
    assert tatt.FLASH_ATTENTION.launches == before + 1
    assert got.shape == q.shape and torch.isfinite(got).all()
    assert (got - ref).abs().max() <= 2e-5
    if src_len == 0:
        assert not got.any()
    mask = torch.arange(S, device=dev) < src_len
    assert torch.equal(tatt.flash_attention(q, k, v, mask, scale), got)
    if src_len == S:
        assert torch.equal(tatt.flash_attention(q, k, v, None, scale), got)


def test_flash_attention_ignores_rows_beyond_the_prefix(dev):
    gen = torch.Generator().manual_seed(8)
    q = torch.randn(100, 4, 132, generator=gen).to(dev)
    k = torch.randn(200, 4, 132, generator=gen).to(dev)
    v = torch.randn(200, 4, 132, generator=gen).to(dev)
    n = torch.tensor(90, dtype=torch.int32, device=dev)
    a = tatt.flash_attention(q, k, v, n, 0.1)
    k[90:], v[90:] = torch.nan, torch.inf
    b = tatt.flash_attention(q, k, v, n, 0.1)
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_flash_attention_raises_instead_of_falling_back(dev):
    q = torch.zeros(4, 2, 160, device=dev)
    with pytest.raises(ValueError):
        tatt.flash_attention(q, q, q, None, 1.0)
    with pytest.raises(ValueError):
        tatt.flash_attention(q[:, :, :8], q[:, :, :8].cpu(), q[:, :, :8],
                             None, 1.0)
    q = q[:, :, :8].contiguous()
    lse = torch.zeros(4, 2, device=dev)
    with pytest.raises(ValueError):
        tatt.flash_attention_bwd_cuda(q, q, q, q, lse[:3], q, None, 1.0)
    with pytest.raises(ValueError):
        tatt.flash_attention_bwd_cuda(q, q, q, q, lse, q.cpu(), None, 1.0)


@pytest.mark.parametrize("L,S,src_len,h,d", [(2048, 2048, 1500, 4, 132),
                                             (777, 1333, 1000, 4, 132),
                                             (777, 1333, 0, 4, 132),
                                             (300, 200, 130, 4, 24),
                                             (130, 70, 70, 8, 18),
                                             (1, 1, 1, 1, 144)])
@pytest.mark.parametrize("nan_pad", [False, True])
def test_flash_attention_backward_matches_plain(dev, L, S, src_len, h, d,
                                                nan_pad):
    gen = torch.Generator().manual_seed(10)
    q, k, v, do = (torch.randn(n, h, d, generator=gen).to(dev)
                   for n in (L, S, S, L))
    if nan_pad:
        k[src_len:], v[src_len:] = torch.nan, torch.inf
    scale = d ** -0.5
    n = torch.tensor(src_len, dtype=torch.int32, device=dev)
    o, lse = tatt.flash_attention_cuda(q, k, v, n, scale, return_lse=True)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, n, scale,
                                                return_lse=True)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(lse_ref))
    if src_len:
        assert (lse - lse_ref).abs().max() <= 2e-5
    counts = (tatt.FLASH_ATTENTION_BWD_DKV.launches,
              tatt.FLASH_ATTENTION_BWD_DQ.launches)
    got = tatt.flash_attention_bwd_cuda(q, k, v, o, lse, do, n, scale)
    again = tatt.flash_attention_bwd_cuda(q, k, v, o, lse, do, n, scale)
    ref = tatt.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, n,
                                         scale)
    torch.cuda.synchronize()
    assert (tatt.FLASH_ATTENTION_BWD_DKV.launches,
            tatt.FLASH_ATTENTION_BWD_DQ.launches) == (counts[0] + 2,
                                                      counts[1] + 2)
    for a, b, r in zip(got, again, ref):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert torch.equal(a, b)
        assert (a - r).abs().max() <= 2e-5
    assert not got[1][src_len:].any() and not got[2][src_len:].any()
    if src_len == 0:
        assert not got[0].any()


def test_flash_attention_autograd_launches_the_backward_kernels(dev):
    """Under autograd the wrapper saves the log-sum-exp and its backward
    launches C8 and C9 once each; without a gradient it launches C7 alone."""
    gen = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(n, 4, 132, generator=gen).to(dev)
                   for n in (200, 260, 260, 200))
    mask = torch.arange(260, device=dev) < 222
    kernels = (tatt.FLASH_ATTENTION, tatt.FLASH_ATTENTION_BWD_DKV,
               tatt.FLASH_ATTENTION_BWD_DQ)
    for kern in kernels:
        kern.launches = 0
    plain = tatt.flash_attention(q, k, v, mask, 0.1)
    assert [kern.launches for kern in kernels] == [1, 0, 0]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = tatt.flash_attention(*leaves, mask, 0.1)
    assert torch.equal(out, plain)
    grads = torch.autograd.grad(out, leaves, do)
    assert [kern.launches for kern in kernels] == [2, 1, 1]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(
        tatt.flash_attention_plain(*ref_leaves, mask, 0.1), ref_leaves, do)
    for a, r in zip(grads, ref):
        assert (a - r).abs().max() <= 2e-5


def test_attention_layer_flash_matches_xla_on_valid_rows(dev):
    """One attention layer at the matcher's width on the card: the streamed
    route against the einsum route, valid query rows, 1e-4 of the scale."""
    cfg = {impl: tatt.AttentionConfig(528, 4, "rotary", attention_impl=impl)
           for impl in ("flash", "xla")}
    gen = torch.Generator().manual_seed(9)
    p = tpyr.tree_map(lambda t: t.to(dev),
                      tatt.init_attention_layer(gen, cfg["xla"]))
    x = torch.randn(300, 528, generator=gen).to(dev)
    src = torch.randn(260, 528, generator=gen).to(dev)
    xm = torch.arange(300, device=dev) < 280
    sm = torch.arange(260, device=dev) < 200
    outs = {impl: tatt.apply_attention_layer(p, x, src, None, None, xm, sm, c)
            for impl, c in cfg.items()}
    err = (outs["flash"][xm] - outs["xla"][xm]).abs().max()
    assert err <= 1e-4 * outs["xla"][xm].abs().max()

    # and the gradients of both routes, the cotangent zero on padded rows
    ct = torch.randn(300, 528, generator=gen).to(dev) * xm[:, None]
    grads = {}
    for impl, c in cfg.items():
        leaves = tpyr.tree_map(lambda t: t.detach().requires_grad_(True),
                               dict(p, x=x, src=src))
        lp = {k: v for k, v in leaves.items() if k not in ("x", "src")}
        out = tatt.apply_attention_layer(lp, leaves["x"], leaves["src"], None,
                                         None, xm, sm, c)
        flat = tpyr.tree_leaves(leaves)
        grads[impl] = torch.autograd.grad(out, flat, ct)
    for a, r in zip(grads["flash"], grads["xla"]):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()


# -- the solver's opt-in routes: C12, C13, C2 / C3 with the nonrigidity head

NR_CFG = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=64, nonrigidity_est=True)


@pytest.mark.parametrize("trunc", [1e9, 0.05])
def test_chamfer_fused_matches_plain_and_repeats(dev, trunc):
    """C12 against its plain version: the sums and cgrad within 2e-5 of
    their max, rmin 2e-5 on valid rows, rarg equal up to near-ties, the
    query gradient within 1e-4 of its max against the CPU; a second launch
    bit-equal."""
    from deformationpyramid_tpu_torch.ops import chamfer_fused as tcf

    gen = torch.Generator().manual_seed(4)
    w = (torch.randn(777, 3, generator=gen) * 0.5).to(dev)
    y = (torch.randn(1033, 3, generator=gen) * 0.5).to(dev)
    wv = (torch.rand(777, generator=gen) > 0.1).to(dev)
    yv = (torch.rand(1033, generator=gen) > 0.1).to(dev)
    got = tcf.chamfer_fused(w, y, wv, yv, trunc)
    again = tcf.chamfer_fused(w, y, wv, yv, trunc)
    ref = tcf.chamfer_fused_plain(w, y, wv, yv, trunc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    (sums, cgrad, rmin, rarg), (rs, rc, rm, ra) = got, ref
    assert ((sums - rs).abs() / rs.abs()).max() < 2e-5
    assert (cgrad - rc).abs().max() < 2e-5 * rc.abs().max()
    assert (rmin - rm)[wv].abs().max() < 2e-5
    flips = (rarg != ra) & wv
    if flips.any():
        dg = ((w[flips] - y[rarg[flips]]) ** 2).sum(-1)
        dr = ((w[flips] - y[ra[flips]]) ** 2).sum(-1)
        assert ((dg - dr).abs() / dr.clamp_min(1e-30)).max() < 3e-4
    wq = w.clone().requires_grad_(True)
    tcf.chamfer_l1_fused(wq, y, wv, yv, trunc=trunc).backward()
    wc = w.cpu().requires_grad_(True)
    tcf.chamfer_l1_fused(wc, y.cpu(), wv.cpu(), yv.cpu(),
                         trunc=trunc).backward()
    assert (wq.grad.cpu() - wc.grad).abs().max() < 1e-4 * wc.grad.abs().max()


def test_sum_partials_is_the_block_order_sum(dev):
    """C13 on C3's partial rows: bit-equal to a sum in block order and on a
    second launch, within 1e-6 of the float64 sum's max."""
    flat, x, g = _level(dev, n=1000)
    partials = tfi.level_warp_bwd(flat, x, g, 2, CFG)
    got = tfi.sum_partials(partials)
    order = partials[0].clone()
    for b in range(1, partials.shape[0]):
        order = order + partials[b]
    f64 = partials.double().sum(0)
    assert torch.equal(got, order)
    assert torch.equal(got, tfi.sum_partials(partials))
    assert (got.double() - f64).abs().max() <= 1e-6 * f64.abs().max()


@pytest.mark.parametrize("level", [0, 1])
def test_level_warp_nonrigid_matches_plain(dev, level):
    """C2 / C3 with the nonrigidity head: the warped points and nr within
    1e-5, the gradient for (g, g_nr) within 1e-4 of each tensor's max |g|;
    at level 0 nr is all ones and its head's gradient exactly 0."""
    flat, x, g = _level(dev, cfg=NR_CFG)
    g_nr = (torch.randn(x.shape[0], generator=torch.Generator()
                        .manual_seed(5)) * 0.1).to(dev)
    w, nr = tfi.level_warp_fwd_nr(flat, x, level, NR_CFG)
    rw, rnr = tfi._plain_warp_nr(flat, x, level, NR_CFG)
    assert (w - rw).abs().max() < 1e-5 and (nr - rnr).abs().max() < 1e-5
    got = tfi.level_warp_bwd(flat, x, g, level, NR_CFG, g_nr).sum(0)
    ref = tfi.level_warp_bwd_plain(flat, x, g, level, NR_CFG, g_nr)[0]
    shapes = tpyr.level_shapes(NR_CFG)
    got_t, ref_t = tpyr.unravel(got, shapes), tpyr.unravel(ref, shapes)
    for k in ref_t:
        for kk in ref_t[k]:
            scale = ref_t[k][kk].abs().max().clamp_min(1e-30)
            err = (got_t[k][kk] - ref_t[k][kk]).abs().max() / scale
            assert err < 1e-4, (k, kk, float(err))
    if level == 0:
        assert (nr == 1.0).all()
        assert not got_t["nr"]["w"].any() and not got_t["nr"]["b"].any()


@pytest.mark.parametrize("transposed", [False, True])
def test_fused_level_warp_launches_c2_c3_c13(dev, transposed):
    """The standalone level warp under autograd: C2 forward, C3 then C13
    backward, one launch each; the gradient as the plain warp's within
    1e-4 of each tensor's max |g|."""
    from deformationpyramid_tpu_torch.ops import fused_level as tfl

    flat, x, g = _level(dev)
    p = tpyr.tree_map(lambda t: t.clone().requires_grad_(True),
                      tpyr.unravel(flat, tpyr.level_shapes(CFG)))
    before = [k.launches for k in (tfi.LEVEL_WARP_FWD, tfi.LEVEL_WARP_BWD,
                                   tfi.SUM_PARTIALS)]
    if transposed:
        out = tfl.fused_level_warp_t(p, x.T.contiguous(), 2, CFG).T
    else:
        out = tfl.fused_level_warp(p, x, 2, CFG)
    (out * g).sum().backward()
    after = [k.launches for k in (tfi.LEVEL_WARP_FWD, tfi.LEVEL_WARP_BWD,
                                  tfi.SUM_PARTIALS)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    ref = tpyr.unravel(tfi.level_warp_bwd_plain(flat, x, g, 2, CFG)[0],
                       tpyr.level_shapes(CFG))
    for k in ref:
        for kk in ref[k]:
            scale = ref[k][kk].abs().max().clamp_min(1e-30)
            assert (p[k][kk].grad - ref[k][kk]).abs().max() < 1e-4 * scale


@pytest.mark.parametrize("opts", [dict(use_fused=True, use_fused_chamfer=True),
                                  dict(use_fused_iteration=True,
                                       sweep_reuse=4),
                                  dict(use_fused_iteration=True, w_reg=0.2)])
def test_optin_routes_match_cpu(dev, opts):
    """A small solve through each opt-in route on the card against the same
    solve on the CPU (the kernels' plain versions): equal per-level
    iterations and the warp within 1e-3."""
    import dataclasses

    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.solve.registration import (
        SolverConfig, register_pair)

    pyr = tpyr.NDPConfig(m=3, k0=-6, depth=3, width=32,
                         nonrigidity_est="w_reg" in opts)
    cfg = SolverConfig(pyramid=pyr, iters=30, samples=256, **opts)
    src, tgt, _ = make_pair(n=300, seed=2, deform=0.1)
    outs = []
    for d in (dev, torch.device("cpu")):
        w, st = register_pair(0, torch.from_numpy(src).to(d),
                              torch.from_numpy(tgt).to(d),
                              dataclasses.replace(cfg))
        outs.append((w.cpu(), st["iters"].cpu()))
    assert torch.equal(outs[0][1], outs[1][1])
    assert (outs[0][0] - outs[1][0]).abs().max() < 1e-3
