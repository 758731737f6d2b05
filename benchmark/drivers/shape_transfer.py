"""NDP's Sim(3) shape transfer, one transfer at a time, as the CLI runs it.

Per transfer the port's ``cli/shape_transfer.transfer_meshes``: 6000
surface samples of each mesh, the 9-level Sim3 + euler pyramid fitted by
truncated chamfer (the fused iteration: C2, C1, the glue with C6, C3, C4),
every source vertex warped, the warped vertices copied to the host. The
mesh pairs are a pool fabricated from the traffic's ``data_seed``
(``traffic/meshes.py``); ``--seed`` draws the order the pool is cycled in.
Each transfer samples with a seed of its own, drawn from the data seed,
the pool pair and how often the window has visited it, so that every
``--seed`` does the same work. Closed loop, one transfer at a time.

``pairs_per_s``: transfers finished in the window over the window, which
ends once the last of them has its warped vertices on the host.

What decides ``correct``, on the first transfer of each pool pair that the
window finishes, from what the program handed each level and took from it
(``register_meshes``' ``on_level``), against the plain reference
(``reference/ndp_sim3.py``; the samples drawn again by the reference's
own sampler with the transfer's seed, and centred by their own means):

* ``level_loss``: each level's reported loss against the reference's
  chamfer of the level's warped output; ``level_warp``: each level's warped
  output against the reference's warp of its input through its
  parameters (at a level that stopped before the cap, whose last step was
  withheld), and each level's input against the reference's centred
  samples (level 0: the port's sampler and centring) or the last level's
  output. Neither depends on how chaotic the solve is;
* ``follow_change``: each level followed by the reference from the
  program's input for the program's iteration count (the early stop is a
  decision that rounding can flip): the gap between the norm of the
  program's change of the level's values and the reference's, over the
  larger of the reference's and one Adam step's (``_change_gaps``), for
  the level's values together and for each leaf (a layer's weights or
  biases, a head's); the larger of the worst level's whole change and the
  worst leaf at its median level, over the checked transfers. At 6000 x
  6000 the solve is chaotic at every level (Adam moves each value whose
  gradient cancels by the whole rate, either way; the float32 reference
  parts from its float64 self in every level of the pool, PERF.md), so
  values are not compared one by one, and a small leaf's change can part
  by most of itself at a level or two: the median over the levels is what
  tells a leaf that the solve never moves (a head whose gradient is lost,
  a tail of the values that Adam misses), which reads 1, as does a level
  left unchanged;
* ``answer``: the reference's warp of every source vertex through the
  program's final pyramid against the program's warped vertices;
* ``quality``: the mean distance from the warped vertices to the target's
  surface over the same from the source's vertices moved onto the
  target's mean (each vertex's exact distance to its nearest triangle;
  the offset is free to a solve that centres both clouds, so it is taken
  out of the yardstick): the warp closes at least 5x of it, the check of
  ``chip_smoke.py``'s shape phase.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from benchmark import core, roofline, roofline_ndp
from benchmark.drivers.lndp_register import _tf32
from benchmark.reference import ndp_sim3 as ref
from benchmark.reference import precision
from benchmark.traffic.meshes import mesh_pool

LIMITS = {"level_loss": 1e-5, "level_warp": 2e-5, "follow_change": 0.28,
          "answer": 1e-4, "quality": 0.2}


def program_solver_config(cfg: dict, device: torch.device):
    from deformationpyramid_tpu_torch.models.pyramid import NDPConfig
    from deformationpyramid_tpu_torch.solve.registration import SolverConfig

    return SolverConfig(
        pyramid=NDPConfig(m=cfg["m"], k0=cfg["k0"], depth=cfg["depth"],
                          width=cfg["width"],
                          rotation_format=cfg["rotation_format"],
                          motion=cfg["motion_type"],
                          mlp_scale=cfg["mlp_scale"]),
        iters=cfg["iters"], lr=cfg["lr"],
        max_break_count=cfg["max_break_count"],
        break_threshold_ratio=cfg["break_threshold_ratio"],
        samples=cfg["samples"], w_reg=cfg["w_reg"],
        trunc_chamfer=cfg["trunc_chamfer"], loss_eps=cfg["loss_eps"],
        use_fused_iteration=device.type == "cuda")


@dataclasses.dataclass
class Item:
    """One transfer of the window; its levels are kept for the checked
    transfers only."""

    index: int                  # position in the pool
    seed: int
    kept: bool = False
    levels: list | None = None  # each level's input and output
    warped: np.ndarray | None = None
    iters: np.ndarray | None = None


class Driver:
    def __init__(self, run: core.Run, cfg: dict, traffic: dict, seed: int,
                 device: torch.device, control: str | None = None):
        self.run, self.cfg, self.traffic = run, cfg, traffic
        self.seed, self.device, self.control = seed, device, control
        self.attempted = 0
        self.failed = 0

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        from deformationpyramid_tpu_torch.cli.shape_transfer import \
            transfer_meshes
        from deformationpyramid_tpu_torch.data import ply

        self.transfer_meshes = transfer_meshes
        t, cfg = self.traffic, self.cfg
        self.scfg = program_solver_config(cfg, self.device)
        self.pool = mesh_pool(t["kinds"], t["vertices"], int(t["data_seed"]),
                              tuple(t["rotation_rad"]), tuple(t["scale"]),
                              tuple(t["offset"]), tuple(t["bend"]))
        self.meshes = [(ply.PlyMesh(p.src, p.faces),
                        ply.PlyMesh(p.tgt, p.faces)) for p in self.pool]
        self.order = np.random.default_rng(self.seed).permutation(
            len(self.pool)).tolist()
        # every shape once: each pool pair through a transfer of its own
        for i in range(len(self.pool)):
            self._transfer(Item(i, self._seed(i, 0)))

    def _seed(self, index: int, visit: int) -> int:
        """The seed of a pool pair's transfer: its samples (the target's
        from the seed + 1) and its initial weights. Visit 0 is set-up's."""
        state = np.random.SeedSequence(
            [int(self.traffic["data_seed"]), index, visit]).generate_state(1)
        return int(state[0] >> 2)

    def _transfer(self, item: Item) -> None:
        src, tgt = self.meshes[item.index]
        levels = [] if item.kept else None

        def on_level(lvl, p_in, x_in, out):
            # the program's own tensors, which it does not touch again
            levels.append((lvl, p_in, x_in, out))

        item.warped, stats = self.transfer_meshes(
            src, tgt, self.scfg, seed=item.seed, device=self.device,
            on_level=on_level if item.kept else None)
        item.iters = stats["iters"].cpu().numpy().astype(int)
        item.levels = levels

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float) -> None:
        run = self.run
        visits = [0] * len(self.pool)
        trace_pairs = int(self.traffic.get("trace_pairs", 2))
        traced_iters, traced = 0, 0
        self.done: list[Item] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        k = 0
        while time.perf_counter() < deadline:
            i = self.order[k % len(self.order)]
            k += 1
            visits[i] += 1
            item = Item(i, self._seed(i, visits[i]), kept=visits[i] == 1)
            if self.done and traced == 0:
                run.start_trace()
            self.attempted += 1
            self._transfer(item)
            self.done.append(item)
            if run.tracing:
                traced += 1
                traced_iters += int(item.iters.sum())
                if traced >= trace_pairs:
                    run.stop_trace()
        run.stop_trace()
        self.window_s = time.perf_counter() - t0
        run.window_s = self.window_s
        run.counters["iters_finished"] = float(
            sum(int(it.iters.sum()) for it in self.done))
        run.counters["pairs_finished"] = float(len(self.done))
        run.counters["traced_iters"] = float(traced_iters)

    def after_window(self) -> None:
        """The counters the traced run's readers need: each kernel's bound
        a call, and the FLOPs of the window's transfers (``register_flops``,
        which ``mfu.register`` reads)."""
        run, cfg = self.run, self.cfg
        n = m = int(cfg["samples"])
        heads = roofline.level_heads(3, cfg["motion_type"], False)
        width, depth = int(cfg["width"]), int(cfg["depth"])
        # one level's values: the input layer, the hidden layers, the heads
        n_params = 7 * width + (depth - 1) * (width + width * width) \
            + heads * (width + 1)
        for key, b in roofline_ndp.iteration_bounds(
                n, m, width, depth, heads, n_params).items():
            run.counters[f"bound_s.{key}"] = b
        per_iter = roofline.ndp_iteration_flops(n, m, width, depth, heads)
        run.counters["register_flops"] = sum(
            int(it.iters.sum()) * per_iter + cfg["m"] * roofline
            .level_mlp_flops(len(self.pool[it.index].src), width, depth,
                             heads) for it in self.done)

    def end_to_end(self) -> dict:
        return {"pairs_per_s": len(self.done) / self.window_s}

    def diagnostics(self) -> dict:
        return {"window_s": self.window_s, "pairs": len(self.done),
                "iters": [int(it.iters.sum()) for it in self.done[:16]],
                "span_ms": {k: 1e3 * float(np.mean(v))
                            for k, v in self.run.spans.items()},
                "per_pair": getattr(self, "per_pair", None)}

    # -- the check -----------------------------------------------------------

    def check(self) -> list[core.Check]:
        kept = [it for it in self.done if it.kept]
        self.per_pair = []
        if not kept:
            return [core.Check("answer", math.inf, LIMITS["answer"])]
        rows = [self._check_transfer(it) for it in kept]
        self.failed = sum(
            any(not (math.isfinite(r[k]) and r[k] <= LIMITS[k])
                for k in LIMITS) for r in rows)
        return [core.Check(k, max(r[k] if math.isfinite(r[k]) else math.inf
                                  for r in rows), LIMITS[k])
                for k in LIMITS]

    def _check_transfer(self, it: Item) -> dict:
        cfg, dev, ctrl = self.cfg, self.device, self.control
        pair = self.pool[it.index]
        # the program's input, drawn again by the reference
        x0, y0 = (torch.from_numpy(ref.sample_surface(
            v, pair.faces, cfg["samples"], seed)).to(dev)
            for v, seed in ((pair.src, it.seed), (pair.tgt, it.seed + 1)))
        src_mean, tgt_mean = x0.mean(0, keepdim=True), y0.mean(0, keepdim=True)
        y = y0 - tgt_mean
        out = dict.fromkeys(LIMITS, 0.0)
        levels = it.levels or []
        if [lv[0] for lv in levels] != list(range(cfg["m"])):
            # the port's level loop was not seen: nothing to compare
            return dict.fromkeys(LIMITS, math.inf)
        final, by_level, expect = [], [], x0 - src_mean
        for lvl, p_in, x_in, (p_out, x_out, stats) in levels:
            n, loss = int(stats["iters"]), float(stats["loss"])
            final.append(p_out)
            with precision.mode("f32"):
                out["level_warp"] = max(out["level_warp"], _gap(x_in, expect))
                expect = x_out
                # the level's reported loss and output, recomputed
                ref_loss = float(ref.chamfer(x_out, y, cfg["trunc_chamfer"]))
                got_w, got_loss = x_out, loss
                if ctrl:
                    with _tf32(ctrl):
                        got_w = ref.level_warp(p_out, x_in, lvl, cfg)
                        got_loss = float(ref.chamfer(
                            got_w, y, cfg["trunc_chamfer"]))
                out["level_loss"] = max(out["level_loss"],
                                        abs(got_loss - ref_loss) / ref_loss)
                if n < cfg["iters"]:
                    out["level_warp"] = max(out["level_warp"], _gap(
                        got_w, ref.level_warp(p_out, x_in, lvl, cfg)))
                # the level followed from the program's input
                ref_l = ref.chamfer_level(p_in, lvl, x_in, y, cfg, n)
            got_p = p_out
            if ctrl:
                with _tf32(ctrl):
                    ctl = ref.chamfer_level(p_in, lvl, x_in, y, cfg, n)
                got_p, loss = ctl["params"], ctl["last_loss"]
            gaps = _change_gaps(p_in, got_p, ref_l["params"], cfg["lr"])
            by_level.append([lvl, n, gaps, abs(loss - ref_l["last_loss"])
                             / ref_l["first_loss"]])
        gaps = np.array([row[2] for row in by_level])
        # the worst level's whole change, and the worst leaf at its median
        # level
        out["follow_change"] = max(float(gaps[:, 0].max()),
                                   float(np.median(gaps[:, 1:], 0).max()))
        # the answer: the reference's warp of the program's final pyramid
        final = {k: {kk: torch.stack([p[k][kk] for p in final]) for kk in v}
                 for k, v in final[0].items()}
        verts = torch.from_numpy(pair.src).to(dev)
        with precision.mode("f32"):
            want = ref.warp(final, verts - src_mean, cfg) + tgt_mean
        got = torch.from_numpy(it.warped).to(dev)
        if ctrl:
            with _tf32(ctrl):
                got = ref.warp(final, verts - src_mean, cfg) + tgt_mean
        out["answer"] = float((got - want).abs().max())
        tgt = pair.tgt.astype(np.float64)
        src = pair.src.astype(np.float64)
        before = surface_distance(src - src.mean(0) + tgt.mean(0), tgt,
                                  pair.faces)
        after = surface_distance(it.warped.astype(np.float64), tgt,
                                 pair.faces)
        out["quality"] = after / before
        self.per_pair.append({"kind": pair.kind, "vertices": len(pair.src),
                              "iters": it.iters.tolist(),
                              # [level, iterations, the gaps of its whole
                              # change and of each leaf's, the gap of its
                              # last losses over its first]
                              "levels": by_level,
                              "nn_before": before, "nn_after": after, **out})
        return out


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def surface_distance(pts: np.ndarray, verts: np.ndarray, faces: np.ndarray,
                     k: int = 16, chunk: int = 8192) -> float:
    """Mean distance (float64) from each row of ``pts`` to the surface of
    the triangles ``faces`` of ``verts``: the exact distance to each of
    the ``k`` triangles whose centroids lie nearest it, the least of
    them."""
    tri = verts[faces]
    _, near = cKDTree(tri.mean(1)).query(pts, k=k)
    total = 0.0
    for at in range(0, len(pts), chunk):
        t = tri[near[at:at + chunk]]                        # [p, k, 3, 3]
        p = pts[at:at + chunk, None, :]
        total += float(_point_triangle(p, t[..., 0, :], t[..., 1, :],
                                       t[..., 2, :]).min(1).sum())
    return total / len(pts)


def _point_triangle(p, a, b, c):
    """Distance from ``p`` to the triangle ``a b c`` (broadcast rows): to
    its plane where the foot falls inside it, else to its nearest edge."""
    ab, ac, ap = b - a, c - a, p - a
    d00, d01, d11 = (ab * ab).sum(-1), (ab * ac).sum(-1), (ac * ac).sum(-1)
    d20, d21 = (ap * ab).sum(-1), (ap * ac).sum(-1)
    den = d00 * d11 - d01 * d01
    ok = den > 1e-30 * d00 * d11
    den = np.where(ok, den, 1.0)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    inside = ok & (v >= 0) & (w >= 0) & (v + w <= 1)
    foot = a + v[..., None] * ab + w[..., None] * ac
    edge = np.minimum(np.minimum(_point_segment(p, a, b),
                                 _point_segment(p, b, c)),
                      _point_segment(p, c, a))
    return np.where(inside, np.linalg.norm(p - foot, axis=-1), edge)


def _point_segment(p, a, b):
    ab = b - a
    t = np.clip(((p - a) * ab).sum(-1) / np.maximum((ab * ab).sum(-1), 1e-300),
                0.0, 1.0)
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)


def _change_gaps(p0: dict, prog: dict, want: dict, step: float
                 ) -> list[float]:
    """A level's change of its values: the gap between the norm of the
    program's change and the reference's, over the larger of the
    reference's and one Adam step's (``step``, the rate: Adam's first step
    moves each value by it, either way, times the root of the number of
    values; a smaller change, a bias that steps back and forth, is as much
    the sign of a cancelling gradient as of the fit), in float64; first of
    all the level's values together, then of each leaf in ``ref.LEAVES``'
    order. A change left out where the reference makes one larger than a
    step reads 1."""
    def gap(a: list, b: list, size: int) -> float:
        got = float(torch.cat(a).norm())
        ref_n = float(torch.cat(b).norm())
        return abs(got - ref_n) / max(ref_n, step * math.sqrt(size), 1e-30)

    got, ref_d = [], []
    for k, kk in ref.LEAVES:
        start = p0[k][kk].double()
        got.append((prog[k][kk].double() - start).flatten())
        ref_d.append((want[k][kk].double() - start).flatten())
    return [gap(got, ref_d, sum(g.numel() for g in got))] + [
        gap([g], [r], g.numel()) for g, r in zip(got, ref_d)]
