"""The ``sim3.transfer`` cell on the CPU at a size the CPU holds: a sound
run is ``correct``, and each of its checks fails with the timed path broken
underneath it, or with the control (the reference one precision below
float32, TF32, in the program's place; on the CPU the operand rounding of
``precision`` stands in for the card's tensor cores). The bounds of
``roofline_ndp`` equal ``chip_smoke.py``'s at the cell's 6000-point Sim3 +
euler shapes."""
import numpy as np
import pytest
import torch

from benchmark import core, roofline, roofline_ndp
from benchmark.drivers import shape_transfer as drv

CPU = torch.device("cpu")
# a blob and a torus of 1500 vertices; 500 samples, 100 iterations a level
SMALL = dict(traffic_overrides=dict(vertices=[1500]),
             config_overrides=dict(iters=100, samples=500))


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def small_run(trace=False, control=None, seed=2**31 + 11, seconds=2.0):
    return core.run_cell("sim3.transfer", seed, seconds, trace, device=CPU,
                         control=control, **SMALL)


def test_sound_run_is_correct():
    result = small_run(trace=True, seconds=4.0)
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == set(drv.LIMITS)
    per_pair = result["diag"]["per_pair"]
    assert len(per_pair) == 2        # every pool pair checked once
    # every level of every pair followed
    assert all([lv[0] for lv in p["levels"]] == list(range(9))
               for p in per_pair)
    got = result["metrics"]
    assert got["iters_per_pair"]["value"] > 9
    assert got["sample_ms"]["value"] > 0
    assert "nn_dual_roofline" not in got      # no card, no kernel


def _patch_solve_level(monkeypatch, fn):
    from deformationpyramid_tpu_torch.solve import registration
    inner = registration._solve_level

    def solve_level(lvl_params, lvl, *a, **kw):
        return fn(lvl_params, lvl, *inner(lvl_params, lvl, *a, **kw))
    monkeypatch.setattr(registration, "_solve_level", solve_level)


def test_unchanged_solve_fails_the_follow(monkeypatch):
    """A solve that returns each level's input parameters."""
    _patch_solve_level(monkeypatch, lambda p_in, lvl, p, x, st: (p_in, x, st))
    result = small_run()
    assert not result["correct"]
    assert result["checks"]["follow_change"]["value"] >= 0.5


def test_unchanged_after_level_0_fails_the_follow(monkeypatch):
    _patch_solve_level(monkeypatch, lambda p_in, lvl, p, x, st:
                       (p_in if lvl > 0 else p, x, st))
    result = small_run()
    check = result["checks"]["follow_change"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("frozen", [("scale",), ("trn", "rot", "scale")])
def test_frozen_heads_fail_the_follow(monkeypatch, frozen):
    """The solve's gradient of the heads in ``frozen`` dropped at every
    level (as a C3 that loses them, or a C4 that misses the tail of the
    values): the heads keep their initial values, the warps and losses
    stay consistent with what comes out, and only the follow sees it."""
    from deformationpyramid_tpu_torch.solve import registration
    inner = registration.run_adam_loop

    def run_adam_loop(loss_fn, params, *a, **kw):
        def frozen_loss(p, *b, **c):
            p = dict(p, **{k: {kk: v.detach() for kk, v in p[k].items()}
                           for k in frozen})
            return loss_fn(p, *b, **c)
        return inner(frozen_loss, params, *a, **kw)
    monkeypatch.setattr(registration, "run_adam_loop", run_adam_loop)
    result = small_run()
    checks = result["checks"]
    assert not result["correct"]
    assert checks["follow_change"]["value"] >= 0.99
    for name in ("level_loss", "level_warp", "answer"):
        assert checks[name]["value"] <= checks[name]["limit"], name


def test_sampler_off_area_fails_the_warp(monkeypatch):
    """The port's surface samples drawn with every face equally likely,
    not by its area: level 0's input is not the reference's samples."""
    from deformationpyramid_tpu_torch.cli import shape_transfer

    def by_face(mesh, n, seed=0):
        rng = np.random.default_rng(seed)
        tri = mesh.vertices[mesh.faces[rng.integers(0, len(mesh.faces), n)]]
        r1 = np.sqrt(rng.random(n))[:, None]
        r2 = rng.random(n)[:, None]
        return ((1 - r1) * tri[:, 0] + r1 * (1 - r2) * tri[:, 1]
                + r1 * r2 * tri[:, 2]).astype(np.float32)
    monkeypatch.setattr(shape_transfer, "sample_points_uniformly", by_face)
    check = small_run()["checks"]["level_warp"]
    assert check["value"] > check["limit"]


def test_zeroed_scale_head_fails_the_warp_and_answer(monkeypatch):
    """The program's warp with the Sim3 scale head zeroed (every scale 1)
    in the solve and the vertex warp alike."""
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.solve import registration
    inner = pyramid.level_warp

    def level_warp(p, x, level, cfg):
        p = dict(p, scale={k: torch.zeros_like(v)
                           for k, v in p["scale"].items()})
        return inner(p, x, level, cfg)
    monkeypatch.setattr(pyramid, "level_warp", level_warp)
    monkeypatch.setattr(registration, "level_warp", level_warp)
    result = small_run()
    checks = result["checks"]
    assert not result["correct"]
    for name in ("level_warp", "answer"):
        assert checks[name]["value"] > checks[name]["limit"], name


def test_altered_loss_fails_the_level_loss(monkeypatch):
    """Each level's reported loss off by a part in 1e4."""
    _patch_solve_level(monkeypatch, lambda p_in, lvl, p, x, st: (
        p, x, dict(st, loss=st["loss"] * 1.0001)))
    check = small_run()["checks"]["level_loss"]
    assert check["value"] > check["limit"]


def test_poor_answer_fails_the_quality(monkeypatch):
    """Warped vertices left where the source put them, the solve intact."""
    from deformationpyramid_tpu_torch.cli import shape_transfer
    inner = shape_transfer.register_meshes

    def register(src, tgt, verts, *a, **kw):
        warped, stats = inner(src, tgt, verts, *a, **kw)
        return torch.as_tensor(verts), stats
    monkeypatch.setattr(shape_transfer, "register_meshes", register)
    checks = small_run()["checks"]
    assert checks["quality"]["value"] > checks["quality"]["limit"]
    assert checks["answer"]["value"] > checks["answer"]["limit"]


def test_control_fails():
    result = small_run(control="tf32")
    assert not result["correct"], result["checks"]


def test_bounds_equal_chip_smoke():
    """At the cell's shapes (6000 x 6000, Sim3 + euler, width 128, depth
    3): C2, C3 and C4 as ``chip_smoke.level_bounds``, C6 as its
    ``scatter_case`` counts, C1 as ``roofline.nn_dual_bound``."""
    import chip_smoke
    from deformationpyramid_tpu_torch.cli.shape_transfer import DEMO_CFG
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    pcfg, n = DEMO_CFG.pyramid, 6000
    heads = roofline.level_heads(3, "Sim3", False)
    n_params = fi.level_param_count(pcfg)
    want = chip_smoke.level_bounds(n, pcfg, n_params, rows=375)
    got = roofline_ndp.iteration_bounds(n, n, pcfg.width, pcfg.depth, heads,
                                        n_params)
    for name, key in (("level_warp_fwd", "level_warp_fwd"),
                      ("level_warp_bwd", "level_warp_bwd"),
                      ("adam_step", "adam")):
        assert got[key] == pytest.approx(want[name]["bound_ms"] * 1e-3)
    assert got["scatter_rows"] == pytest.approx(
        chip_smoke.bound(n * 24 + n * (8 + 12), 3.0 * n)["bound_ms"] * 1e-3)
    assert got["nn_dual"] == roofline.nn_dual_bound(1, n, n)["bound_s"]
    # the driver's count of a level's values is the port's
    run = core.Run(trace=False)
    d = drv.Driver(run, core.Spec().config("sim3"), {}, 0, CPU)
    d.done, d.pool = [], []
    d.after_window()
    assert run.counters["bound_s.adam"] == pytest.approx(got["adam"])


def test_readers_on_a_made_up_trace():
    """The kernel shares count the calls launched inside ``dp::solve``
    only, and ``launches_per_iter.transfer`` every device operation there
    over the traced transfers' iterations."""
    from benchmark import tracing
    from benchmark.tracing import DeviceOp, HostRange

    solve = [HostRange("dp::solve", 100, 200, 1),
             HostRange("dp::solve", 300, 400, 1)]
    ops = [DeviceOp("void nn_dual_kernel(float const*)", 110, 130, 105, 1),
           DeviceOp("nn_dual_kernel", 310, 320, 305, 1),
           DeviceOp("nn_dual_kernel", 250, 290, 250, 1),     # outside
           DeviceOp("adam_step_kernel", 330, 335, 320, 1)]
    run = core.Run(trace=True)
    run.trace = tracing.DeviceTrace([], solve, ops,
                                    HostRange("bench::window", 0, 500, 1))
    run.counters.update({"bound_s.nn_dual": 3e-9, "traced_iters": 2.0})
    got = core.metric_reader("nn_dual_roofline")(run)
    assert got == pytest.approx(100.0 * 2 * 3e-9 / 30e-9)
    assert core.metric_reader("adam_roofline")(run) is None   # no bound
    assert core.metric_reader("launches_per_iter.transfer")(run) == 1.5
    assert core.metric_reader("solve_idle_ms")(run) == \
        pytest.approx((200 - 35) / 2 / 1e6)
