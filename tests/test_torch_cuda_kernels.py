"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA device. Marked ``cuda``: without a card every test here skips (the
decision is taken in a fixture, never at import). On the card run
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda -q``
(``--noconftest`` where JAX, which tests/conftest.py imports, is absent).

Tolerances: C1 indices equal up to near-ties < 3e-4 relative and
distances 1e-5; C2 warped points 1e-5; C3 gradients 1e-4 of each tensor's
max |g|; C4 moments 1e-6 of their max and ``hold`` bit-exact; C5 warped
rows 1e-5, loss 1e-6 relative, counter and done equal, m / (1 - b1) and
v / (1 - b2) within 1e-4 / 2e-4 of each tensor's max (its VJP is C3's
3xTF32 code; rows at a ReLU's kink masked out of the inputs), params 1e-6
where |m| > 1e-3 max|m|, a held step bit-exact, for the nine layouts at 1
to 4096 rows, with every, no, first-tile and last-tile rows valid (only
the blocks whose tile holds a valid row run a VJP), a masked row with a
NaN target (its tile keeps its VJP) and more tiles than the card holds
blocks (each block loops over its tiles); C6
bit-equal to index_add_ on the CPU, on a repeat, at the solver's and the
shape-transfer demo's sizes and with every source on one row. The fused
level repeats bit for bit
(the glue's scatter has a fixed order).
C14 distances 1e-6 relative and indices equal up to near-ties, at ragged
tiles and with no valid row. C2 and C3 are checked for SE3 + axis_angle, Sim3 + euler, sflow, and SE3 and
Sim3 with the quaternion and 6D formats. C10 warped points 2e-5; C11
gradients 1e-4 of each tensor's max |g| against the plain version in float64
(nine float32 layers deep, two float32 gradients differ by more; points at
a ReLU kink given zero cotangents), bit-equal on a second launch, both on
C3's tensor-core tile: at 9 x 128, 2 layers (no hidden product), widths
20, 32, 36, 64 and 256, a ragged last tile, 1 and 7 points; C11 at tiles
of 16, 32 and 48 points, with its buffers in device memory bit-equal to
shared memory, and at 100 layers of 20; C10 bit-equal at every tile; the
fused NSFP loop against the CPU's plain loop. C7 against its
plain version 2e-5 max abs (outputs are convex combinations of N(0, 1)
values; C7 computes its products as 3xTF32 on the tensor cores, ~1e-6 off
f32), bit-equal on a second launch, at the matcher's shapes (caps 1024 and
2048), at an awkward one, with an empty source prefix, with its source
rows cut into chunks (a prefix that ends inside the first chunk, an empty
one), and inside a layer. C8 and
C9 against ``flash_attention_bwd_plain`` 2e-5 max abs on the same inputs
and a unit-scale upstream gradient (both compute their products as 3xTF32
on the tensor cores, ~1e-6 off f32), bit-equal on a second launch, zero
beyond the prefix, at head widths 1, 18, 24, 132 and 144 and prefixes of
0, 1 and S rows, NaN in the padded rows or not (one valid source row
takes all the probability, so dv sums all L upstream rows and its size,
with the plain version's own float32 rounding, grows with L: those cases
keep L small), and through autograd inside a layer against the einsum
route (1e-4 of each gradient's max). C12 against its plain version: sums
and cgrad 2e-5 of their max, rmin 2e-5, rarg equal up to near-ties, the
query gradient 1e-4 of its max, bit-equal on a second launch; C13
bit-equal to the block-order sum, 1e-6 of the float64 sum's max; C2 / C3
with the nonrigidity head at levels 0 and 1 as C2 / C3; the opt-in routes'
small solves on the card against the CPU: equal iterations, warp 1e-3.
C3 on the tensor cores (3xTF32) at width 128 for every (motion, format)
pair with and without the nonrigidity head, at 1, 31, 33, 2000 and 6000
points: its rows, a second launch bit-equal, the gradient within 1e-4 of
each tensor's max (smooth cotangents, none at a ReLU's kink), the head's
gradient exactly 0 at level 0, every tile alike, C13 bit-equal to the
block-order sum of its rows; C3's partial rows bit-equal (sha256) to
what they were before C5 took C3's VJP code, C2's outputs to what its
tensor-core design gave, C5's to what its tensor-core design gives. C2 on
C3's tile for every (motion, format) pair with and without the head, at 1
to 6000 points, widths 32, 100, 128 and 256, depths 2 to 5: 1e-5 max abs,
a second launch and every tile bit-equal; at mlp_scale 1 too, where the
tolerance tells three TF32 passes from one. C1 on its edge cases (exact ties
across the database's slices, slices without a valid row, +inf rows)
bit-equal to the plain version, and its outputs on pinned inputs
bit-equal to those of the design it replaced (chip_smoke.C1_DIGESTS).
C14 on the x -> y half of C1's edge cases bit-equal to its plain version
and to C1's x -> y half, on pinned inputs to the design it replaced
(chip_smoke.C14_DIGESTS); C12 on its edge cases (chip_smoke.C12_EDGE_CASES)
bit-equal to its plain version on the CPU in cgrad, rmin and rarg (the
sums 1e-5 relative), on pinned inputs to the design it replaced
(chip_smoke.C12_DIGESTS).
"""
import pytest
import torch

import chip_smoke
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


@pytest.mark.parametrize("tag", sorted(chip_smoke.C1_EDGE_CASES))
def test_nn_dual_edge_cases_bit_equal_to_plain(dev, tag):
    """C1 on its edge cases (points on a 1/32 grid, every distance exact):
    exact ties across the database's slices, slices and whole clouds
    without a valid row, +inf rows, sizes 1 to 2000 with n != m; both
    directions' distances and indices bit-equal to the plain version on
    the CPU, one launch a call."""
    args = chip_smoke.c1_edge_input(dev, tag)
    before = tknn.NN_DUAL.launches
    got = tknn.nn_argmin_dual(*args)
    assert tknn.NN_DUAL.launches == before + 1
    ref = tknn.nn_argmin_dual_plain(*(a.cpu() for a in args))
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)


def test_nn_dual_bits_pinned(dev):
    """C1 gives, on the pinned inputs (2000 x 2000, 6000 x 6000 and a
    masked grid with ties), the bits of the one-query-a-thread design it
    replaced."""
    assert chip_smoke.c1_digests(dev) == chip_smoke.C1_DIGESTS


@pytest.mark.parametrize("n,m,mask", [(2000, 2000, None),
                                       (777, 1333, "random"),
                                       (130, 65, "none valid")])
def test_nn_argmin_matches_plain(dev, n, m, mask):
    """C14 against its plain version: 16 or 32 slices of the database a
    query, so 777 / 1333 / 130 / 65 leave ragged slices; distances 1e-6
    relative, indices equal up to near-ties, one launch a call; with no
    valid row (+inf, 0)."""
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


@pytest.mark.parametrize("tag", sorted(chip_smoke.C1_EDGE_CASES))
def test_nn_argmin_edge_cases_bit_equal_to_plain_and_c1(dev, tag):
    """C14 on the x -> y half of C1's edge cases, with y's mask and
    without one: bit-equal to its plain version on the CPU and to C1's
    x -> y half on the card, one launch a call."""
    x, y, xv, yv = chip_smoke.c1_edge_input(dev, tag)
    for mask in (yv, None):
        before = tknn.NN_ARGMIN.launches
        got = tknn.nn_argmin(x, y, mask)
        assert tknn.NN_ARGMIN.launches == before + 1
        ref = tknn.nn_argmin_plain(x.cpu(), y.cpu(),
                                   None if mask is None else mask.cpu())
        half = tknn.nn_argmin_dual(x, y, xv, mask)[:2]
        for a, b, c in zip(got, ref, half):
            assert torch.equal(a.cpu(), b) and torch.equal(a, c)


def test_nn_argmin_bits_pinned_and_c1s_half(dev):
    """C14 gives, on the pinned inputs (C1's, x -> y, and 40159 x 37417
    clouds), the bits of the one-query-a-thread design it replaced, and
    those of C1's x -> y half."""
    assert chip_smoke.c14_digests(dev) == chip_smoke.C14_DIGESTS
    for x, y, yv in chip_smoke.c14_digest_inputs(dev).values():
        xv = torch.ones(len(x), dtype=torch.bool, device=dev)
        got, half = tknn.nn_argmin(x, y, yv), tknn.nn_argmin_dual(x, y, xv,
                                                                  yv)
        assert torch.equal(got[0], half[0]) and torch.equal(got[1], half[1])


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
              "9x128-below-an-m-tile": (dict(), 7),
              "9x128-one-point": (dict(), 1),
              "4x32": (dict(width=32, n_layers=4), 50),
              "2x64": (dict(width=64, n_layers=2), 17),
              "2x20": (dict(width=20, n_layers=2), 40),
              "3x20": (dict(width=20, n_layers=3), 45),
              "5x36": (dict(width=36, n_layers=5), 100),
              "4x256": (dict(width=256, n_layers=4), 300),
              "9x256": (dict(width=256, n_layers=9), 2000)}


def _nsfp_check(flat, x, g, ncfg):
    """C10 against its plain version (2e-5 max abs) and C11 against the
    plain VJP in float64 (1e-4 of each tensor's max |g|, the cotangents of
    points at a ReLU kink zeroed), a second C11 launch bit-equal; returns
    C11's partial rows."""
    got = tfi.nsfp_fwd(flat, x, ncfg)
    assert (got - tfi.nsfp_fwd_plain(flat, x, ncfg)).abs().max() < 2e-5
    g = g * chip_smoke.nsfp_off_kinks(flat, x, ncfg)[:, None]
    part = tfi.nsfp_bwd(flat, x, g, ncfg)
    assert torch.equal(part, tfi.nsfp_bwd(flat, x, g, ncfg))
    ref = tfi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                             ncfg)[0].float()
    shapes = tfi.nsfp_shapes(ncfg)
    for a, b in zip(tpyr.tree_leaves(tpyr.unravel(part.sum(0), shapes)),
                    tpyr.tree_leaves(tpyr.unravel(ref, shapes))):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp_min(1e-30)
    return part


@pytest.mark.parametrize("name", sorted(NSFP_CASES))
def test_nsfp_fwd_and_bwd_match_plain(dev, name):
    """C10 / C11 on C3's tensor-core tile at the path's 9 x 128, at no
    hidden product (2 layers), at widths that are no multiple of 16 (the
    padded columns) and at 256, at a ragged last tile and below one
    m-tile; one partial row a block of ``nsfp_bwd_tile`` points."""
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    kw, n = NSFP_CASES[name]
    ncfg = NSFPConfig(**kw)
    flat, x, g = _nsfp(dev, ncfg, n)
    part = _nsfp_check(flat, x, g, ncfg)
    assert part.shape == (-(-n // tfi.nsfp_bwd_tile(n, ncfg)), flat.numel())


@pytest.mark.parametrize("tile,rows", [(16, 125), (32, 63), (48, 42)])
def test_nsfp_bwd_tiles_agree(dev, monkeypatch, tile, rows):
    """Any tile of whole m-tiles gives C11 the same gradient within its
    budget (the rows differ, their sum does not): 2000 points as 125 rows
    of 16, 63 of 32 (the last block half full) and 42 of 48."""
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    ncfg = NSFPConfig()
    flat, x, g = _nsfp(dev, ncfg, 2000, seed=1)
    monkeypatch.setattr(tfi, "nsfp_bwd_tile", lambda n, cfg: tile)
    assert _nsfp_check(flat, x, g, ncfg).shape[0] == rows


@pytest.mark.parametrize("tile", [16, 32, 64, 208])
def test_nsfp_fwd_does_not_depend_on_its_tile(dev, monkeypatch, tile):
    """A point's warp depends on its own row alone: C10 at any tile gives
    the bits of its own rule's tile."""
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    ncfg = NSFPConfig()
    flat, x, _ = _nsfp(dev, ncfg, 777, seed=2)
    want = tfi.nsfp_fwd(flat, x, ncfg)
    monkeypatch.setattr(tfi, "nsfp_fwd_tile", lambda n, cfg: tile)
    assert torch.equal(tfi.nsfp_fwd(flat, x, ncfg), want)


def test_nsfp_bwd_scratch_gives_the_shared_memory_bits(dev, monkeypatch):
    """C11 with its layer buffers in device memory (where they do not fit a
    block's shared memory) gives the bits of its shared-memory run, and a
    net too deep for shared memory (width 20, 100 layers) runs that way
    and repeats."""
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig

    ncfg = NSFPConfig()
    flat, x, g = _nsfp(dev, ncfg, 500, seed=3)
    want = tfi.nsfp_bwd(flat, x, g, ncfg)
    with monkeypatch.context() as m:
        m.setattr(tfi, "nsfp_bwd_smem", lambda cfg, tile=16: 1 << 30)
        assert torch.equal(tfi.nsfp_bwd(flat, x, g, ncfg), want)
    deep = NSFPConfig(width=20, n_layers=100)
    assert tfi.nsfp_bwd_smem(deep) > tfi.SMEM_LIMIT
    flat, x, g = _nsfp(dev, deep, 50, seed=3)
    part = tfi.nsfp_bwd(flat, x, g, deep)
    assert torch.isfinite(part).all()
    assert torch.equal(part, tfi.nsfp_bwd(flat, x, g, deep))


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
    that the early stop holds, bit-exact. The step's moments are held as
    C3's gradient (C5's VJP is C3's 3xTF32 code): m / (1 - b1) and
    v / (1 - b2) within 1e-4 / 2e-4 of each tensor's max, the rows at a
    ReLU's kink masked out of the inputs (``chip_smoke.off_kinks``)."""
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    flat, x, tgt, mask, count = _ldmk_inputs(dev)
    mask = mask * chip_smoke.off_kinks(flat, x, 2, CFG)
    count = mask.sum().clamp_min(1.0)
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
    _moments_close(m, v, rm, rv, CFG)
    big = rm.abs() > 1e-3 * rm.abs().max()
    assert (p - rp)[big].abs().max() < 1e-6


def _moments_close(m, v, rm, rv, cfg):
    """One Adam step's moments from zero: m / (1 - b1) (the gradient) and
    v / (1 - b2) (its square) within 1e-4 / 2e-4 of each parameter
    tensor's max of the plain version's."""
    c1, c2 = 1.0 - tfi.ADAM_B1, 1.0 - tfi.ADAM_B2
    _grad_close(m / c1, rm / c1, cfg, chip_smoke.C5_M_TOL)
    _grad_close(v / c2, rv / c2, cfg, chip_smoke.C5_V_TOL)


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


@pytest.mark.parametrize("n,m,rows", [(50, 20000, 40), (2000, 2000, 2000),
                                      (6000, 6000, 6000), (2000, 2000, 1),
                                      (777, 0, 777), (1, 333, 1),
                                      (5000, 4100, 3)])
def test_scatter_rows_matches_cpu_index_add(dev, n, m, rows):
    """C6 against its plain version, index_add_ on the CPU: bit-equal, and
    the same on a second run, one launch a call (none when there is nothing
    to add). ``rows``: the indices fall on the first ``rows`` rows, 1 puts
    every source on one row; at 5000 x 4100 the index list spans two of
    the kernel's 2048-source chunks."""
    gen = torch.Generator().manual_seed(6)
    idx = torch.randint(0, rows, (m,), generator=gen)
    src = torch.randn(m, 3, generator=gen) * 1e-3
    dst = torch.randn(n, 3, generator=gen) * 1e-3
    ref = tfi.scatter_add_rows(dst.clone(), idx, src)
    before = tfi.SCATTER_ROWS.launches
    runs = [tfi.scatter_add_rows(dst.to(dev), idx.to(dev), src.to(dev))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tfi.SCATTER_ROWS.launches == before + (2 if m else 0)
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
                                             (1024, 1024, 900, 4, 132),
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
    assert torch.equal(tatt.flash_attention(q, k, v, n, scale), got)
    if src_len == 0:
        assert not got.any()
    mask = torch.arange(S, device=dev) < src_len
    assert torch.equal(tatt.flash_attention(q, k, v, mask, scale), got)
    if src_len == S:
        assert torch.equal(tatt.flash_attention(q, k, v, None, scale), got)


@pytest.mark.parametrize("src_len,splits", [(100, 4), (0, 4), (1000, 3),
                                            (640, 8), (900, 2)])
def test_flash_attention_source_chunks_match_plain(dev, src_len, splits):
    """C7 with the source rows cut into chunks (one launch of the wrapper,
    counted once): a prefix that ends inside the first chunk, an empty one,
    the whole source, against the plain version's o and lse, bit-equal on
    a second launch and with or without the lse output; NaN beyond the
    prefix does not leak."""
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(n, 4, 132, generator=gen).to(dev)
               for n in (200, 1000, 1000))
    k[src_len:], v[src_len:] = torch.nan, torch.inf
    n = torch.tensor(src_len, dtype=torch.int32, device=dev)
    scale = 132 ** -0.5
    before = tatt.FLASH_ATTENTION.launches
    o, lse = tatt._flash_attention_launch(q, k, v, n, scale, True, splits)
    o2, lse2 = tatt._flash_attention_launch(q, k, v, n, scale, True, splits)
    alone = tatt._flash_attention_launch(q, k, v, n, scale, False, splits)
    o_ref, lse_ref = tatt.flash_attention_plain(q, k, v, n, scale,
                                                return_lse=True)
    torch.cuda.synchronize()
    assert tatt.FLASH_ATTENTION.launches == before + 3
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, alone)
    assert torch.isfinite(o).all() and (o - o_ref).abs().max() <= 2e-5
    assert torch.equal(torch.isfinite(lse), torch.isfinite(lse_ref))
    if src_len:
        assert (lse - lse_ref).abs().max() <= 2e-5
    else:
        assert not o.any()


def test_flash_attention_splits_at_small_caps(dev):
    """On a card of 132 SMs, C7's 64 blocks (64 query rows, a head, one
    an SM) at 1024 query rows and 4 heads would leave half the SMs idle:
    the wrapper cuts the source in two; at 2048 and 4096 rows it does
    not."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    got = [tatt.flash_fwd_splits(n, n, 4, sms) for n in (1024, 2048, 4096)]
    if sms == 132:
        assert got == [2, 1, 1]
    assert got[0] > 1


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
                                             (1024, 1024, 900, 4, 132),
                                             (777, 1333, 1000, 4, 132),
                                             (777, 1333, 0, 4, 132),
                                             (300, 200, 130, 4, 24),
                                             (130, 70, 70, 8, 18),
                                             (1, 1, 1, 1, 144),
                                             (77, 45, 1, 2, 1),
                                             (333, 97, 97, 3, 1),
                                             (33, 45, 1, 2, 132),
                                             (61, 45, 45, 2, 144),
                                             (95, 1000, 999, 2, 18)])
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


@pytest.mark.parametrize("tag", sorted(chip_smoke.C12_EDGE_CASES))
def test_chamfer_fused_edge_cases_bit_equal_to_cpu_plain(dev, tag):
    """C12 on its edge cases (points on a 1/32 grid, every distance exact:
    ties across slices, every row or column invalid, invalid queries
    against valid candidates, every column won by row 0): cgrad, rmin and
    rarg bit-equal to the plain version on the CPU (index_add_ there adds
    in index order, on CUDA by atomics), the sums within 1e-5 relative,
    one launch a call."""
    from deformationpyramid_tpu_torch.ops import chamfer_fused as tcf

    args = chip_smoke.c12_edge_input(dev, tag)
    before = tcf.CHAMFER_FUSED.launches
    got = tcf.chamfer_fused(*args, chip_smoke.C12_EDGE_TRUNC)
    assert tcf.CHAMFER_FUSED.launches == before + 1
    ref = tcf.chamfer_fused_plain(*(a.cpu() for a in args),
                                  chip_smoke.C12_EDGE_TRUNC)
    for a, b in zip(got[1:], ref[1:]):
        assert torch.equal(a.cpu(), b)
    assert ((got[0].cpu() - ref[0]).abs() <= 1e-5 * ref[0].abs()).all()


def test_chamfer_fused_bits_pinned(dev):
    """C12 gives, on the pinned inputs (C1's, at trunc 1e9 and at the
    median), the bits of the one-query-a-thread sweep and row walk it
    replaced: sums, cgrad, rmin and rarg."""
    assert chip_smoke.c12_digests(dev) == chip_smoke.C12_DIGESTS


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


# -- C3 on the tensor cores (3xTF32): every layout, ragged tiles, repeats

C3_LAYOUTS = ([("SE3", f) for f in ("axis_angle", "euler", "quaternion",
                                    "6D")]
              + [("Sim3", f) for f in ("axis_angle", "euler", "quaternion",
                                       "6D")]
              + [("sflow", "axis_angle")])


def _smooth_field(x, seed, cols=3):
    """A smooth field over the points, 0.1 tanh(x A) with A from a seed,
    as the solver's chamfer gradient is: random cotangents cancel in the
    sums over points (at 31 points Sim3's scale.b gradient is 7.7e-6 for
    terms ~1e-4), where float32 itself is 3e-5 of the max from float64."""
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(3, cols, generator=gen).to(x.device)
    return 0.1 * torch.tanh(x @ a)


def _grad_close(got, ref, cfg, tol=1e-4):
    """Each parameter tensor's gradient within ``tol`` of its max |g|."""
    shapes = tpyr.level_shapes(cfg)
    got_t, ref_t = tpyr.unravel(got, shapes), tpyr.unravel(ref, shapes)
    for k in ref_t:
        for kk in ref_t[k]:
            scale = ref_t[k][kk].abs().max().clamp_min(1e-30)
            err = (got_t[k][kk] - ref_t[k][kk]).abs().max() / scale
            assert err < tol, (k, kk, float(err))


@pytest.mark.parametrize("n", [1, 31, 33, 2000, 6000])
@pytest.mark.parametrize("nonrigid", [False, True])
@pytest.mark.parametrize("motion,fmt", C3_LAYOUTS)
def test_c3_every_layout_matches_vjp_and_repeats(dev, motion, fmt, nonrigid,
                                                 n):
    """C3 at width 128 / depth 3 for the nine (motion, format) pairs with
    and without the nonrigidity head (gated, level 2), at 1 to 6000 points
    (ragged last tiles; 6000 points take tiles of 48): one partial row per
    tile of ``bwd_tile`` points, a second launch bit-equal, each tensor's
    gradient within 1e-4 of its max |g| of the plain VJP, for smooth
    cotangents (``_smooth_field``) away from the ReLUs' kinks
    (``chip_smoke.off_kinks``)."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128, motion=motion,
                         rotation_format=fmt, nonrigidity_est=nonrigid)
    flat, x, _ = _level(dev, seed=n, n=n, cfg=cfg)
    keep = chip_smoke.off_kinks(flat, x, 2, cfg)
    g = _smooth_field(x, n) * keep[:, None]
    g_nr = (_smooth_field(x, n + 1, 1)[:, 0] * keep) if nonrigid else None
    part = tfi.level_warp_bwd(flat, x, g, 2, cfg, g_nr)
    again = tfi.level_warp_bwd(flat, x, g, 2, cfg, g_nr)
    ref = tfi.level_warp_bwd_plain(flat, x, g, 2, cfg, g_nr)[0]
    assert part.shape == (-(-n // tfi.bwd_tile(n, cfg)), flat.numel())
    assert torch.equal(part, again)
    _grad_close(part.sum(0), ref, cfg)


@pytest.mark.parametrize("n", [1, 33, 2000, 6000])
@pytest.mark.parametrize("nonrigid", [False, True])
@pytest.mark.parametrize("motion,fmt", C3_LAYOUTS)
def test_c2_every_layout_matches_plain_and_repeats(dev, motion, fmt,
                                                   nonrigid, n):
    """C2 on C3's tile at width 128 / depth 3 for the nine (motion, format)
    pairs with and without the nonrigidity head (gated, level 2), at 1 to
    6000 points (ragged last tiles; 6000 points take tiles of 48): the warp
    and the nonrigidity within 1e-5 max abs of the plain version, a second
    launch bit-equal, one launch a call."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128, motion=motion,
                         rotation_format=fmt, nonrigidity_est=nonrigid)
    flat, x, _ = _level(dev, seed=n, n=n, cfg=cfg)
    before = tfi.LEVEL_WARP_FWD.launches
    got = tfi._warp_launch(flat, x, 2, cfg)
    again = tfi._warp_launch(flat, x, 2, cfg)
    assert tfi.LEVEL_WARP_FWD.launches == before + 2
    ref = tfi._plain_warp_nr(flat, x, 2, cfg)
    assert (got[1] is None) == (ref[1] is None) == (not nonrigid)
    for a, b, r in zip(got, again, ref):
        if r is not None:
            assert (a - r).abs().max() < 1e-5
            assert torch.equal(a, b)


@pytest.mark.parametrize("nonrigid", [False, True])
@pytest.mark.parametrize("motion,fmt", C3_LAYOUTS)
def test_c2_at_mlp_scale_1_matches_plain(dev, motion, fmt, nonrigid):
    """C2 with mlp_scale 1, where the hidden layers' rounding reaches the
    warp unshrunk (at 1e-3 even one TF32 pass would stay within 1e-5):
    every layout and the head within 1e-5 max abs of the plain version.
    On these inputs the CPU emulation of tests/test_torch_level_warp_tf32.py
    reads three passes at 2.4e-7 to 2.2e-6, one pass at 2.2e-4 to 3.0e-3."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128, motion=motion,
                         rotation_format=fmt, nonrigidity_est=nonrigid,
                         mlp_scale=1.0)
    flat, x, _ = _level(dev, n=2000, cfg=cfg)
    got = tfi._warp_launch(flat, x, 2, cfg)
    ref = tfi._plain_warp_nr(flat, x, 2, cfg)
    for a, r in zip(got, ref):
        if r is not None:
            assert (a - r).abs().max() < 1e-5


@pytest.mark.parametrize("width,depth", [(32, 2), (100, 2), (256, 5)])
def test_c2_widths_and_depths_match_plain(dev, width, depth):
    """C2 at widths that are not a multiple of 16 (padded columns) and at
    the widest, deepest level the kernels cover: within 1e-5 max abs."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=depth, width=width)
    flat, x, _ = _level(dev, n=2000, cfg=cfg)
    got = tfi.level_warp_fwd(flat, x, 2, cfg)
    assert (got - tfi._plain_warp(flat, x, 2, cfg)).abs().max() < 1e-5


@pytest.mark.parametrize("tile", [16, 32, 48, 64])
def test_c2_tiles_give_the_same_bits(dev, monkeypatch, tile):
    """A point's warp depends on its own row alone: any tile of whole
    m-tiles gives the same bits as ``fwd_tile``'s, the nonrigidity too."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128,
                         nonrigidity_est=True)
    flat, x, _ = _level(dev, n=777, cfg=cfg)
    ref = tfi.level_warp_fwd_nr(flat, x, 1, cfg)
    monkeypatch.setattr(tfi, "fwd_tile", lambda n, pcfg: tile)
    got = tfi.level_warp_fwd_nr(flat, x, 1, cfg)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("motion,fmt", C3_LAYOUTS)
def test_c3_nonrigid_level0_head_gets_exactly_zero(dev, motion, fmt):
    """At level 0 the warp is ungated: C3 gives the nonrigidity head's
    weights and bias exactly zero gradient, whatever g_nr is."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128, motion=motion,
                         rotation_format=fmt, nonrigidity_est=True)
    flat, x, g = _level(dev, n=2000, cfg=cfg)
    g_nr = torch.ones(2000, device=dev)
    got = tpyr.unravel(tfi.level_warp_bwd(flat, x, g, 0, cfg, g_nr).sum(0),
                       tpyr.level_shapes(cfg))
    assert not got["nr"]["w"].any() and not got["nr"]["b"].any()
    assert got["trn"]["w"].any()


@pytest.mark.parametrize("n", [2000, 6000])
def test_sum_partials_on_c3_rows_is_the_block_order_sum(dev, n):
    """C13 on C3's rows at the bench's and the shape-transfer demo's point
    counts (125 rows of 16 and of 48 points): bit-equal to a sum in block
    order and on a second launch."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128)
    flat, x, g = _level(dev, n=n, cfg=cfg)
    partials = tfi.level_warp_bwd(flat, x, g, 2, cfg)
    assert partials.shape[0] == 125
    order = partials[0].clone()
    for b in range(1, partials.shape[0]):
        order = order + partials[b]
    got = tfi.sum_partials(partials)
    assert torch.equal(got, order)
    assert torch.equal(got, tfi.sum_partials(partials))


@pytest.mark.parametrize("tile", [16, 32, 48, 64])
def test_c3_tiles_agree(dev, monkeypatch, tile):
    """Any tile of whole m-tiles gives the same gradient within 1e-4 of
    each tensor's max |g| (the rows differ, their sum does not)."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128)
    flat, x, g = _level(dev, n=777, cfg=cfg)
    g = g * chip_smoke.off_kinks(flat, x, 2, cfg)[:, None]
    monkeypatch.setattr(tfi, "bwd_tile", lambda n, pcfg: tile)
    part = tfi.level_warp_bwd(flat, x, g, 2, cfg)
    assert part.shape[0] == -(-777 // tile)
    _grad_close(part.sum(0), tfi.level_warp_bwd_plain(flat, x, g, 2, cfg)[0],
                cfg)


# -- C5 on C3's tile: every layout, masks, the loop over tiles

def _c5_inputs(dev, cfg, n, seed, valid=None):
    """Landmark rows, a smooth residual (targets = rows - 0.1 tanh(x A):
    random residuals cancel in the sums over rows, where float32 itself
    is ~3e-5 of a tensor's max off float64) and a mask (``valid``, else
    80% of the rows), the rows at a ReLU's kink masked out."""
    flat, x, _ = _level(dev, seed=seed, n=n, cfg=cfg)
    tgt = x - _smooth_field(x, seed)
    if valid is None:
        gen = torch.Generator().manual_seed(seed)
        valid = torch.rand(n, generator=gen) > 0.2
    mask = (valid.to(dev) & chip_smoke.off_kinks(flat, x, 2, cfg)).float()
    return flat, x, tgt, mask


def _c5_pair(dev, cfg, flat, x, tgt, mask, loss_eps=1e-4):
    """C5 (twice, the second on its own scratch) and its plain version on
    the same inputs from fresh state: ((p, m, v, aux, stop, scratch) of
    the kernel, of its repeat and of the plain version)."""
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    count = mask.sum().clamp_min(1.0)
    outs = []
    for fn in ("kernel", "kernel", "plain"):
        stop = tfi.EarlyStop(LoopConfig(iters=10, loss_eps=loss_eps), dev)
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        aux = torch.zeros_like(x)
        scratch = None
        if fn == "kernel":
            scratch = tfi.ldmk_scratch(x.shape[0], cfg, dev)
            tfi.ldmk_iteration(p, m, v, x, tgt, mask, count, stop, aux, 2,
                               cfg, 0.01, scratch)
        else:
            tfi.ldmk_iteration_plain(p, m, v, x, tgt, mask, count, stop, aux,
                                     2, cfg, 0.01)
        outs.append((p, m, v, aux, stop, scratch))
    torch.cuda.synchronize()
    return outs


def _c5_gates(got, again, ref, cfg, exact=None):
    """The C5 gates: warped rows 1e-5, loss 1e-6 relative, the stop state
    equal, the moments as ``_moments_close``, p 1e-6 where |m| > 1e-3
    max|m|; the repeat bit-equal. With ``exact`` (the warped rows and the
    loss of the plain version in float64) the warped rows and the loss are
    held to it instead: within the gate plus the plain float32 version's
    own distance from it."""
    p, m, v, aux, st, _ = got
    rp, rm, rv, raux, rst, _ = ref
    for a, b in zip(got[:4], again[:4]):
        assert torch.equal(a, b)
    assert torch.equal(st.loss, again[4].loss)
    if exact is None:
        assert (aux - raux).abs().max() < 1e-5
        assert abs(float(st.loss) - float(rst.loss)) \
            <= 1e-6 * float(rst.loss)
    else:
        w64, loss64 = exact
        own = float((raux.double() - w64).abs().max())
        assert float((aux.double() - w64).abs().max()) < 1e-5 + own
        own = abs(float(rst.loss) - loss64)
        assert abs(float(st.loss) - loss64) <= 1e-6 * loss64 + own
    for k in ("counter", "done", "it", "applied"):
        assert float(getattr(st, k)) == float(getattr(rst, k)), k
    _moments_close(m, v, rm, rv, cfg)
    if rm.any():
        big = rm.abs() > 1e-3 * rm.abs().max()
        assert (p - rp)[big].abs().max() < 1e-6
    else:
        assert torch.equal(p, rp)


C5_CFG = {(motion, fmt): tpyr.NDPConfig(m=4, k0=-6, depth=3, width=128,
                                        motion=motion, rotation_format=fmt)
          for motion, fmt in C3_LAYOUTS}


@pytest.mark.parametrize("n", [1, 31, 33, 333, 2048, 4096])
@pytest.mark.parametrize("motion,fmt", C3_LAYOUTS)
def test_c5_every_layout_matches_plain_and_repeats(dev, motion, fmt, n):
    """C5 on C3's tile at width 128 / depth 3 for the nine (motion, format)
    pairs at 1 to 4096 rows (ragged last tiles; 4096 rows take 128 tiles of
    32), 80% of the rows valid: the C5 gates against the plain version,
    a second launch bit-equal, one partial row a block. The warped rows
    and the loss are held to the plain version in float64, within the
    gates plus float32's own distance from it: at a few rows float32
    itself reaches the gates (Sim3 at 1 row: the loss of one residual 4%
    of its coordinates is 1.1e-6 relative off float64; Sim3 + 6D at 31
    rows: the warp 6.4e-6, where 6D orthonormalises two head outputs of
    ~1e-3 that are nearly parallel)."""
    cfg = C5_CFG[(motion, fmt)]
    flat, x, tgt, mask = _c5_inputs(dev, cfg, n, seed=n)
    got, again, ref = _c5_pair(dev, cfg, flat, x, tgt, mask)
    w64 = tfi._plain_warp(flat.double(), x.double(), 2, cfg)
    d64 = (w64 - tgt.double()) * mask.double()[:, None]
    loss64 = float((d64 * d64).sum() / mask.double().sum().clamp_min(1.0))
    _c5_gates(got, again, ref, cfg, exact=(w64, loss64))
    tiles = -(-n // tfi.ldmk_tile(n, cfg))
    assert got[5]["partial"].shape == (tiles, flat.numel())


@pytest.mark.parametrize("rows", [2048, 4096])
@pytest.mark.parametrize("where", ["all", "none", "first tile",
                                   "last tile"])
def test_c5_masks_and_the_tiles_that_skip_their_vjp(dev, where, rows):
    """Every row valid, none (the count clamps to 1, the gradient is
    zero), the valid rows in the first tile only and in the last tile
    only: the C5 gates against the plain version (the early stop's loss
    floor off, so every case steps), and exactly the blocks whose tile
    holds a valid row mark their row full."""
    cfg = C5_CFG[("SE3", "axis_angle")]
    tile = tfi.ldmk_tile(rows, cfg)
    idx = torch.arange(rows)
    valid = {"all": idx >= 0, "none": idx < 0,
             "first tile": idx < tile - 3,
             "last tile": idx >= rows - tile + 3}[where]
    flat, x, tgt, mask = _c5_inputs(dev, cfg, rows, seed=7, valid=valid)
    got, again, ref = _c5_pair(dev, cfg, flat, x, tgt, mask, loss_eps=0.0)
    _c5_gates(got, again, ref, cfg)
    tiles = -(-rows // tile)
    full = got[5]["full"].cpu()
    want = (mask.cpu().reshape(tiles, tile) != 0).any(1).to(torch.int32)
    assert torch.equal(full, want), (where, int(full.sum()))
    assert int(full.sum()) == {"all": tiles, "none": 0}.get(where, 1)


def test_c5_masked_row_with_a_non_finite_target_keeps_its_vjp(dev):
    """A row of mask 0 whose target is NaN, in a tile where every row is
    masked: (warped - tgt) * mask is NaN there, as in the plain version,
    so that tile runs its VJP and the NaN reaches the loss and the
    moments in both."""
    cfg = C5_CFG[("SE3", "axis_angle")]
    rows = 2048
    tile = tfi.ldmk_tile(rows, cfg)
    valid = torch.arange(rows) < tile
    flat, x, tgt, mask = _c5_inputs(dev, cfg, rows, seed=9, valid=valid)
    tgt[rows - 5, 1] = float("nan")
    got, _, ref = _c5_pair(dev, cfg, flat, x, tgt, mask)
    assert torch.isnan(got[4].loss) and torch.isnan(ref[4].loss)
    assert (got[3] - ref[3]).abs().max() < 1e-5
    assert int(got[5]["full"][-1]) == 1 and int(got[5]["full"][0]) == 1
    assert int(got[5]["full"].sum()) == 2
    assert torch.isnan(got[1]).any() and torch.isnan(ref[1]).any()


def test_c5_loops_over_its_tiles_where_one_wave_does_not_hold_them(dev):
    """At width 256 a block holds 32 rows at most, so 9000 rows are 282
    tiles, more than the card holds blocks at once: each block adds the
    VJPs of its tiles into its row in tile order. The C5 gates against the
    plain version, and a repeat bit-equal."""
    cfg = tpyr.NDPConfig(m=4, k0=-6, depth=3, width=256)
    n = 9000
    tiles = -(-n // tfi.ldmk_tile(n, cfg))
    blocks = tfi.ldmk_blocks(n, cfg, dev)
    assert blocks == torch.cuda.get_device_properties(
        dev).multi_processor_count < tiles
    flat, x, tgt, mask = _c5_inputs(dev, cfg, n, seed=11)
    got, again, ref = _c5_pair(dev, cfg, flat, x, tgt, mask)
    _c5_gates(got, again, ref, cfg)


# sha256 of C2's, C3's and C5's outputs on chip_smoke.c2_c5_digests' inputs
# on an H100 80GB HBM3 (scripts/check_torch_level_warp.py and
# scripts/check_torch_ldmk_iteration.py through scripts/ab_kernels.sh):
# C2's as C2 gives them since it runs C3's tile (3xTF32 hidden layers);
# C3's partial rows as they were before C5 took C3's VJP code (c3_backward,
# split out of c3_tile without a change of bits); C5's as its tensor-core
# design gives them, which changed its arithmetic by design.
C2_C5_DIGESTS = {
    "C2 SE3+axis_angle 2000":
        "ee1b2442f69bb83b88df728d9a8e4d28646c444beba3fc91bd1bb6639a315a8c",
    "C2 Sim3+euler 6000":
        "5220eabe3c40e190000383a9931266cab580ae82e307f2b444a20d54dd350e2d",
    "C2 nonrigid level 1":
        "4e7b25c8b2ad4d7f09c6f696ffa7c9383c2105534f3f8c9e35b35f725042c97e",
    "C3 SE3+axis_angle 2000":
        "f3429a0ce04d94b015d29fc9cc67de6b061c84dc90330a99918f5ee6fe8569d0",
    "C3 Sim3+euler 6000":
        "aad31f495f83387a905e8bc1a51540ba4823f22b80a8f5c0e28680ad50c9b21f",
    "C3 nonrigid level 1":
        "92ec34390d6b1d9411e72e27ad908eb1a955e4ca031ce0009b2708b2b9ae3947",
    "C5 one step":
        "b37fabf8ef9bf5c7d644f389c8be5e39dae1e673127891460b6321ccebc0cce0",
}


def test_c2_c5_bits_unchanged(dev):
    """C2 gives the bits of its tensor-core design, C3 those it gave
    before its VJP became C5's too, C5 those of its tensor-core design."""
    assert chip_smoke.c2_c5_digests(dev) == C2_C5_DIGESTS
