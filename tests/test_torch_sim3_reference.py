"""The port's Sim(3) shape transfer against the benchmark's plain reference
(``benchmark/reference/ndp_sim3.py``), on the CPU at small sizes, with
seeded random weights; and ``transfer_meshes``, the entry point the
benchmark drives, against ``main()`` and under the profiler.

The reference is plain torch written apart from the port, so where the two
compute the same products in the same order they agree to the last bits
and where they do not, to float32 rounding: the level warp within 2e-6
(points of size ~1); a two-iteration level within 1e-5 of its loss and
5e-5 of each parameter (Adam's first steps move a value by ~lr whatever
its gradient's size); whole solves with equal iteration counts and the
level losses within 1e-3 relative (see the test). Nothing here imports
JAX.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import ndp_sim3 as ref
from deformationpyramid_tpu_torch.cli import shape_transfer as tst
from deformationpyramid_tpu_torch.data import ply as tply
from deformationpyramid_tpu_torch.models import pyramid as tpyr
from deformationpyramid_tpu_torch.ops.fused_iteration import SYNC_EVERY
from deformationpyramid_tpu_torch.solve import registration as treg
from deformationpyramid_tpu_torch.utils import timers

# as tests/test_torch_shape_transfer.py
PYR = dict(m=3, k0=-6, depth=3, width=64, rotation_format="euler",
           motion="Sim3")
SOLVE = dict(iters=30, lr=0.01, max_break_count=15,
             break_threshold_ratio=0.001, samples=240)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    timers.reset_counters()
    try:
        yield
    finally:
        torch.set_num_threads(prev)
        timers.reset_counters()


def _cfgs(mlp_scale=1e-3, **solve):
    """The reference's configuration dict and the port's SolverConfig."""
    s = dict(SOLVE, **solve)
    rcfg = dict(m=PYR["m"], k0=PYR["k0"], depth=PYR["depth"],
                width=PYR["width"], motion_type="Sim3",
                rotation_format="euler", mlp_scale=mlp_scale,
                iters=s["iters"], lr=s["lr"],
                max_break_count=s["max_break_count"],
                break_threshold_ratio=s["break_threshold_ratio"],
                loss_eps=1e-4, trunc_chamfer=1e9)
    tcfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR,
                                                    mlp_scale=mlp_scale),
                             **s)
    return rcfg, tcfg


def _params(rcfg, seed=5):
    return ref.init_params(torch.Generator().manual_seed(seed), rcfg)


def _sheet(nx=14, ny=12):
    """A wavy sheet and, as its target, a rotated, scaled, bent copy."""
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, nx),
                       np.linspace(-0.5, 0.5, ny), indexing="ij")
    verts = np.stack([u, v, 0.15 * np.sin(3 * u) * np.cos(2 * v)],
                     -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], -1),
                            np.stack([a, d, c], -1)]).astype(np.int32)
    ang = 0.2
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    bent = verts + np.stack([0 * verts[:, 0], 0 * verts[:, 0],
                             0.1 * verts[:, 0] ** 2], -1)
    tgt = (1.1 * bent @ rot.T + [0.05, -0.02, 0.03]).astype(np.float32)
    return tply.PlyMesh(verts, faces), tply.PlyMesh(tgt, faces)


def _clouds(n=240):
    src, tgt = _sheet()
    x = torch.from_numpy(tply.sample_points_uniformly(src, n, seed=0))
    y = torch.from_numpy(tply.sample_points_uniformly(tgt, n, seed=1))
    return x - x.mean(0), y - y.mean(0)


@pytest.mark.parametrize("seed", [0, 2**40 + 3])
def test_surface_samples_match_the_port(seed):
    """The reference's sampler draws the port's samples bit for bit, on
    the source's faces and on the bent target's."""
    for mesh in _sheet():
        want = tply.sample_points_uniformly(mesh, 500, seed=seed)
        got = ref.sample_surface(mesh.vertices, mesh.faces, 500, seed)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mlp_scale", [1e-3, 1.0])
def test_level_and_pyramid_warp_match(mlp_scale):
    """Each level's Sim3 + euler warp and the whole pyramid's; at
    mlp_scale 1 the heads give rotations of ~1 rad and scales far from 1."""
    rcfg, tcfg = _cfgs(mlp_scale)
    params = _params(rcfg)
    x, _ = _clouds()
    x = x * 4.0
    for lvl in range(rcfg["m"]):
        got, _ = tpyr.level_warp(tpyr.level_params(params, lvl), x, lvl,
                                 tcfg.pyramid)
        want = ref.level_warp(ref.level(params, lvl), x, lvl, rcfg)
        assert (got - x).abs().max() > 1e-3 * mlp_scale
        assert (got - want).abs().max() < 2e-6 * 4.0
    got, _ = tpyr.warp(params, x, tcfg.pyramid)
    assert (got - ref.warp(params, x, rcfg)).abs().max() < 2e-6 * 4.0


@pytest.mark.parametrize("fused", [False, True])
def test_chamfer_level_at_two_iterations(fused):
    """One chamfer-mode level of the port (the autograd loop, or the fused
    iteration's plain twins on the CPU) against the reference's."""
    rcfg, tcfg = _cfgs(iters=2, use_fused_iteration=fused)
    params = _params(rcfg)
    x, y = _clouds()
    valid = torch.ones(len(x), dtype=torch.bool)
    lvl = 1
    p_out, x_out, stats = treg._solve_level(
        tpyr.level_params(params, lvl), lvl, x, valid, y, valid, tcfg)
    want = ref.chamfer_level(ref.level(params, lvl), lvl, x, y, rcfg)
    assert int(stats["iters"]) == want["iters"] == 2
    assert abs(float(stats["loss"]) - want["last_loss"]) < 1e-5
    assert (x_out - want["points"]).abs().max() < 2e-6
    moved = 0.0
    for k, kk in ref.LEAVES:
        a, b = p_out[k][kk], want["params"][k][kk]
        assert (a - b).abs().max() < 5e-5, (k, kk)
        moved = max(moved, float((b - params[k][kk][lvl]).abs().max()))
    assert moved > 1e-3          # two steps of lr 0.01 moved the level


@pytest.mark.parametrize("fused", [False, True])
def test_register_meshes_matches_the_reference(fused):
    """A whole solve, each level with its own early stop, against the
    reference's: equal iteration counts and level losses within 1e-3
    relative (a level of few iterations moves the values whose gradient
    cancels by the whole rate, either way: there the float32 reference
    parts from its float64 self and from the port by ~1e-2 in the
    parameters, and by ~1e-5 in the loss); the vertex warp against the
    reference's warp of the port's own final pyramid."""
    rcfg, tcfg = _cfgs(use_fused_iteration=fused)
    params = _params(rcfg)
    src, tgt = _sheet()
    s_pts = tply.sample_points_uniformly(src, SOLVE["samples"], seed=0)
    t_pts = tply.sample_points_uniformly(tgt, SOLVE["samples"], seed=1)
    levels = []
    warped, stats = tst.register_meshes(
        s_pts, t_pts, src.vertices, tcfg, device="cpu", params=params,
        on_level=lambda lvl, p_in, x_in, out: levels.append(out[0]))
    xs, ys = torch.from_numpy(s_pts), torch.from_numpy(t_pts)
    _, rstats = ref.solve(params, xs - xs.mean(0), ys - ys.mean(0), rcfg)
    assert stats["iters"].tolist() == rstats["iters"]
    assert (stats["iters"] < SOLVE["iters"]).any()   # a level stopped early
    loss = np.array(rstats["loss"])
    assert np.abs(stats["loss"].numpy() - loss).max() < 1e-3 * loss.max()
    final = {k: {kk: torch.stack([p[k][kk] for p in levels]) for kk in v}
             for k, v in levels[0].items()}
    want = ref.warp(final, torch.from_numpy(src.vertices) - xs.mean(0),
                    rcfg) + ys.mean(0)
    assert (warped - want).abs().max() < 1e-5
    before = np.abs(src.vertices - tgt.vertices).mean()
    assert np.abs(warped.numpy() - tgt.vertices).mean() < 0.5 * before


def test_transfer_meshes_matches_main(tmp_path, monkeypatch):
    """``main()`` is ``transfer_meshes`` at seed 0 between loading and
    saving: the PLY it writes holds the same vertices (to the file's six
    decimals)."""
    src, tgt = _sheet()
    tply.save_ply(str(tmp_path / "s.ply"), src.vertices, src.faces)
    tply.save_ply(str(tmp_path / "t.ply"), tgt.vertices, tgt.faces)
    cfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR), **SOLVE)
    monkeypatch.setattr(tst, "DEMO_CFG", cfg)
    tst.main(["-s", str(tmp_path / "s.ply"), "-t", str(tmp_path / "t.ply"),
              "-o", str(tmp_path / "o.ply"), "--samples", "200",
              "--device", "cpu"])
    written = tply.load_ply(str(tmp_path / "o.ply")).vertices
    import dataclasses
    got, stats = tst.transfer_meshes(
        tply.load_ply(str(tmp_path / "s.ply")),
        tply.load_ply(str(tmp_path / "t.ply")),
        dataclasses.replace(cfg, samples=200), seed=0, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == src.vertices.shape
    assert np.abs(got - written).max() <= 5.1e-7
    assert int(stats["iters"].sum()) > PYR["m"]


def test_transfer_spans_and_noops_under_the_profiler():
    """Under the profiler a transfer opens ``dp::shape_transfer.sample``
    and then ``dp::solve``, one each and not nested; the fused iteration's
    loops (their plain twins here) count the calls they issued after each
    level's stop as ``early_stop.noops``; the answer is bit-equal with the
    profiler off; the loops count their blocks of up to SYNC_EVERY calls
    as ``fused_level.blocks``."""
    src, tgt = _sheet()
    cfg = treg.SolverConfig(pyramid=tpyr.NDPConfig(**PYR),
                            **dict(SOLVE, iters=4 * SYNC_EVERY),
                            use_fused_iteration=True)
    off, _ = tst.transfer_meshes(src, tgt, cfg, seed=3, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on, stats = tst.transfer_meshes(src, tgt, cfg, seed=3, device="cpu")
    ranges = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("dp::")), key=lambda r: r[1])
    assert [r[0] for r in ranges] == ["dp::shape_transfer.sample",
                                      "dp::solve"]
    assert ranges[0][2] <= ranges[1][1]
    iters = stats["iters"].numpy()
    issued = np.minimum(-(-iters // SYNC_EVERY) * SYNC_EVERY, cfg.iters)
    assert (iters < cfg.iters).any()
    assert timers.counters() == {
        "early_stop.noops": int((issued - iters).sum()),
        "fused_level.blocks": int((-(-issued // SYNC_EVERY)).sum())}
    assert np.array_equal(off, on)
