#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure raises, so the script exits
non-zero and never prints the closing ``{"ok": true, ...}`` line:

0. machine  the first line: the card's name, driver version, power limit and
            compute capability (nvidia-smi), torch.version.cuda and the
            nvcc --version line;
1. device   the card's name and power limit (nvidia-smi); float32 matmuls
            at "highest" precision and no TF32 anywhere;
2. build    nvcc compiles deformationpyramid_tpu_torch/csrc/*.cu for sm_90a,
            one process per source, all at once, into build/torch_kernels/
            (the time is printed), and the host C++ compiler the native
            collate (native/native_ops.cpp) into build/torch_native/, and
            ptxas's registers and spill bytes of
            C3's 18 instantiations, C5's 9, C10 / C11, and of the kernels
            on the split-database sweep and the bucket pass (C1, C14 with
            one and two slices a warp, C12's two, C6: no spills);
3. kernels  each kernel at its path's shapes against its plain PyTorch
            version on the same inputs, with the tolerance stated, and the
            device time of each, by CUDA events (median of 30 calls): C1
            nn_dual, C2 level_warp_fwd, C6 scatter_rows, C3
            level_warp_bwd (C2 and C3 compute their width x width
            products as 3xTF32 on the tensor cores: timed against that
            bound and the f32 one), C4
            adam_step at the bench shapes (2000 points,
            width 128, depth 3, SE3 + axis_angle, a mid level); C2 again
            at mlp_scale 1 (C2_UNSCALED_CASES: there its 1e-5 tells three
            TF32 passes from one); C1 again at
            6000 x 6000, its outputs on pinned inputs bit-equal to
            C1_DIGESTS and its edge cases (exact ties across the
            database's slices, slices without a valid row, +inf rows)
            bit-equal to the plain version; C6 again at
            the shape-transfer demo's 6000 x 6000 and with all 2000
            sources on one row (bit-equal to index_add_ on the CPU and on
            a repeat, one launch a call); C2 and C3
            again at the shape-transfer shapes (6000 points, Sim3 + euler);
            C5 ldmk_iteration (C3's tensor-core tile: its VJP is C3's
            code) at 2048 landmark rows (2000 valid) and at the lndp
            path's 4096 rows (30 valid, the first), one step, a repeat
            bit-equal and a held step, and a step at SE3 + quaternion (the
            warped rows 1e-5, the loss 1e-6 relative, m / (1 - b1) and
            v / (1 - b2) within 1e-4 / 2e-4 of each tensor's max, rows at
            a ReLU's kink masked out of the inputs); C2 and C3 at
            the bench shapes for SE3 + quaternion, SE3 + 6D and sflow
            (timed) and Sim3 + quaternion, Sim3 + 6D; C10 nsfp_fwd and C11
            nsfp_bwd at 2000 points, 9 layers x 128 (both on C3's
            tensor-core tile, their bounds 3xTF32 with the f32 one beside;
            C11 against its plain version in float64, the points at a
            ReLU kink given zero cotangents, a repeat bit-equal; ptxas
            without spills), C4 at the partial rows C11 hands it and C11 +
            C4 back to back; C7 flash_attention_fwd at L = S = 2048, 4 heads
            of 132, 1500 valid source rows, and at L = 777, S = 1333 with
            1000 and with 0 valid rows; C8 flash_attention_bwd_dkv and C9
            flash_attention_bwd_dq at 2048 / 1500 and 4096 / 2836 rows
            (timed, C8 with its share of its 3xTF32 tensor-core bound and of
            the f32 FMA bound) and at edge cases: head widths 1, 18, 24,
            132, 144, prefixes of 0, 1 and all rows, NaN in the padded
            rows; C12 chamfer_fused at 2000 x 2000
            with masks and the truncation at the median against its plain
            version on the CPU (rmin and rarg bit-equal, cgrad within 2e-5
            of its max and the sums 2e-5 relative, the gradient within
            1e-4 of its max, a repeat bit-equal; beside it the time of C1 +
            glue + C6, the work it replaces), its outputs on pinned inputs bit-equal to
            C12_DIGESTS and its edge cases (C12_EDGE_CASES: ties across
            slices, every row or column invalid, invalid queries, every
            column on one row) bit-equal to the plain version on the CPU
            in cgrad, rmin and rarg (the sums 1e-5 relative); C13
            sum_partials on C3's 125 partial rows of 34,694 and of 34,823
            (with the nonrigidity head): bit-equal to
            a sum in block order and on a repeat, within 1e-6 of a float64
            sum; C3's checks give zero cotangents to the points at a ReLU's
            kink (off_kinks); C2 /
            C3 with the nonrigidity head at levels 0 and 1 (at level 0 nr
            is all ones and its head's gradient exactly 0). Beside each
            kernel the one PyTorch
            call that computes the same function, where there is one
            (index_add_, the fused torch.optim.Adam step,
            scaled_dot_product_attention, torch.cdist without the matmul
            form and its min for C1, C12 and C14), timed here and used
            nowhere in the port, and the least time the card could take
            (bound_ms);
4. fused    the bench configuration (9 levels, width 128, 500 iterations,
            2000 samples, SE3/axis_angle, fused iteration) on
            make_batch(4, n=2000, seed=100, deform=0.12) through
            register_pair, the first pair as warm-up: finite output, sane
            per-level iteration counts, full-cloud EPE >= 10x below the
            initial flow, and every kernel's launch count > 0;
5. repeat   one bench pair fused twice: equal per-level iterations and
            bit-equal warped output (the glue's scatter has a fixed order);
6. unfused  one pair with use_fused_iteration=False (plain warp, autograd,
            truncated_chamfer on C1): the same checks, and C1 launched;
7. shape    the Sim(3) shape-transfer demo (cli/shape_transfer.py
            register_meshes at DEMO_CFG: 9 levels, width 128, Sim3 + euler,
            6000 samples) on a synthetic torus mesh of 10,000 vertices and
            a Sim3 transform of it plus a smooth bend, each written with
            save_ply and read back with load_ply: finite output, sane
            per-level iterations, the mean nearest-neighbour distance from
            the warped vertices to the target >= 5x below the initial one,
            C1-C4 and C6 launched;
8. landmark config/LNDP.yaml's solver (10 levels, SE3, axis_angle, w_cd 0)
            on make_pair pairs with 2000 landmarks from the ground-truth
            flow plus 0.002 noise, padded to 2048 rows: fused through C5,
            then unfused, then w_cd 1.0 (trunc 0.25) fused through C1-C4;
            EPE >= 10x below the initial flow, each path's kernels
            launched, and C5's ms/iter against the unfused loop's; then
            C5 against the unfused loop with the early stop off at 2
            iterations a level (the warped source within 1e-3 cm, each
            level's final loss within 1e-5 relative);
9. lndp     the learned landmark path at full width (config/LNDP.yaml ->
            config/configs/lepard.yaml and outlier_rejection.yaml: matcher
            528 wide, 4 heads, 15 kernel points, first_feats_dim 256; NeCo
            144 wide, 8 heads, 9 layers; attention_impl 'flash'; weights
            from seed 0) on make_pair(n=8000, deform=0.08) pairs, one as
            warm-up and two timed: calibrate_neighborhood_limits ->
            build_pair_pyramid -> landmark_inference with power-of-two caps
            -> register_pair with the landmarks (m = 10, SE3, axis_angle,
            w_cd 0, C5, padded to 2048 rows). Every output finite; C7
            launched 8 times a pair; the same pair with attention_impl 'xla'
            gives a confidence matrix within 1e-4 and the same matches on
            every row that is no near-tie; the same pair twice gives a
            bit-equal confidence matrix. With weights from a seed the model
            finds ~0 landmarks: the count is printed, not gated;
10. train   the training path of the learned landmark model at full width
            (the yaml files of phase 9, attention_impl 'flash', weights
            from seed 0): write_4dmatch_suite fabricates 4 train and 2 val
            pairs of ~6000 points; FourDMatchDataset reads them;
            train_matcher through cli/train_matcher.py's cached batch
            stream for 3 epochs of 4 steps (Adam, ExpLR): every gradient
            finite, the epoch mean loss falls, exactly 8 launches each of
            C7, C8 and C9 a step, snapshots and history written; one step
            from the same start on the einsum route: loss within 1e-4 and
            every gradient leaf within 1e-2 of its max and below what a
            one-ulp move of the weights does to it, both routes' step
            time and peak memory printed; train_neco on the matcher loaded
            back from its checkpoint (1 epoch, iter_size 2, a val stream):
            finite losses above 0, NeCo moved, the matcher bit-equal, C7 alone
            launched; the combined {matcher, neco} checkpoint round-trips
            and landmark_inference from it equals the in-memory model's;
            then C7-C9 at the shape this path gave them;
11. nolearned the no-learned evaluation CLI (cli/eval_nolearned.py, through
            its argument parser) on fabricated 4DMatch-F (the first 4 pairs
            of write_4dmatch_suite's default stream, 1.4k-29k points) and
            4DLoMatch-F (2 pairs, partial 0.40, seed 1), at the yaml files'
            widths: config/NDP.yaml as it stands (both splits), --resume on
            the finished run (solves nothing, the same scores), --no-fast
            on the first two pairs (their EPEs printed: with the early stop
            on, single solves are chaotic) and, with the early stop off,
            the fast path against --no-fast on pair 1 (2 iterations a
            level, before the solve turns chaotic: the flows within 1e-3
            cm, each level's final loss within 1e-5 relative); the yaml
            with rotation_format quaternion, 6D and motion_type sflow (2
            pairs each); config/baselines/NSFP.yaml with
            use_fused_iteration at its 5000-iteration cap (2 pairs, the
            first again: a bit-equal ledger row) and without (1 pair);
            Nerfies.yaml with its cap cut to 300 iterations and
            Sinkhorn.yaml (1 pair each). Every metric finite; full EPE >= 5x
            below the initial flow's for NDP as it stands and with sflow,
            >= 1.5x for NSFP, whose two routes agree within 15% on pair 0
            (quaternion and 6D start every point from an
            arbitrary rotation and do not converge, in the unfused loop
            neither: printed, not gated); iteration counts in
            [1, cap] and not all at either end; C2 = C3 = C4 launches for
            every NDP run; C11 = C1 = C6 = C4 = C10 less one a pair (the
            full-cloud warp) for fused NSFP, within 7 a solve of its
            iterations; pairs/s, ms/iter and the score line of each;
12. optin   the solver's opt-in routes at the bench configuration on one
            bench pair, each with its own launch counts: the unfused loop
            (control), use_fused (C2, C3, C13 under autograd),
            use_fused_chamfer (C12 once an iteration), both, and use_fused
            + transposed; EPE >= 10x below the initial flow,
            iterations in [1, cap], ms/iter and pairs/s of each; then
            cli/eval_nolearned.py with config/NDP.yaml at w_reg 0.2 on two
            fabricated 4DMatch-F pairs: fused (C2 / C3 with the nonrigidity
            head), unfused and --no-fast; finite metrics below the initial
            flow, the fused route's EPE within 2x of the unfused one's;
13. ed      ED / N-ICP from depth maps (cli/eval_ed.py): two fabricated
            480 x 640 depth pairs (tests/depth_pairs.py: a bumpy surface
            of ~40k pixels at 1.3-1.7 m, the target its bent and moved copy
            z-buffered with numpy, fx = fy ~ 500); render_depth_silhouette
            on the card equal to that numpy z-buffer, silhouette_cost
            within 1e-5 of the CPU's; config/baselines/NICP.yaml as it
            stands through eval_ed.main (600 iterations, lr 0.02 decaying
            0.999, 2000 samples, node coverage 0.09, 8 neighbours): every
            metric finite, full EPE <= 0.5x the initial flow, iterations in
            [1, 600], C1 and C4 launched, the graph build's seconds by part
            and the solve's ms/iter printed; pair 0 twice: equal
            iterations, a bit-equal warp; config/baselines/Lepard+NICP.yaml
            on one pair with the landmark model from seed 0: it finishes,
            its landmarks are raw-cloud indices, its metrics finite, C7
            launched (accuracy not gated); C14 nn_argmin against its plain
            version on the warped source vertices against the target cloud
            (~40k x ~37k), without and with a mask, and at 2000 x 2000 and
            6000 x 6000 beside C1 (indices equal up to near-ties,
            distances 1e-6 relative; the times, the bound and torch.cdist's
            time), its outputs on pinned inputs bit-equal to C14_DIGESTS and
            to C1's x -> y half, and on C1's edge cases also to its plain
            version on the CPU; point_2_plane_distance on those clouds with
            the meshes' vertex normals: within 1e-5 of the plain 1-NN's
            value, C14
            launched twice;
14. small   small solves on the card against the same solves on the CPU,
            where every kernel's plain version runs (SE3 + axis_angle,
            Sim3 + euler, sflow, SE3 + quaternion, Sim3 + 6D, both landmark
            modes; the two renormalised formats over 5 iterations a level
            at 1e-2): equal per-level iteration
            counts and warped points within 1e-3; and a narrow landmark
            model on the card (C7 at head width 24) against the CPU: the
            confidence matrix within 1e-4.
15. supervised the LNDP evaluation CLI (cli/eval_supervised.py, through its
            argument parser) at config/LNDP.yaml's widths, the landmark
            model of seed 0: the first 3 pairs of write_4dmatch_suite's
            4DMatch-F stream (every metric of the ledger finite, C7 launched
            8 times a pair, C5 once an iteration of the solves, each
            level's count rounded up to a multiple of SYNC_EVERY by the
            launches that hold the state after the stop), --resume on
            the finished run (nothing solved or launched, the same scores),
            --stage-timers --oracle-filter (each stage's ms a pair; IR 1
            wherever a landmark survives), and bench_lndp_torch.py on 2
            pairs, 1 repetition;
16. threedmatch the 3DMatch rigid evaluation (cli/eval_3dmatch.py through
            its argument parser) on 4 fragment pairs of write_3dmatch_suite
            at its defaults (6300-point fragments), the same model, with
            NeCo and with --no-reject-outliers: finite rows, recall in
            [0, 1], C7 launched 8 times a pair, the host RANSAC's seconds;
17. multiview the multiview GAT stack: write_multiview_suite at its defaults
            (4 sequences x 4 views x 500 points, 12 view pairs each) and
            cli/train_multiview.py at its defaults (144 wide, 8 heads, 3
            layers, k 64, 12 pairs, 16384 edges, 10 epochs) on the card:
            every value finite, the loss falls from the first epoch to the
            last, IR after > IR before at the last, history.jsonl as the
            run, both checkpoints read back bit-equal; ms a step and
            seconds an epoch; apply_multiview_neco on one batch at those
            widths and apply_nonlocalnet at its defaults (6 x 128) on
            K = 1024 matches, the card against the CPU with the same
            weights (1e-4 of the max: index_add_ adds by atomics on the
            card); port_matcher / port_neco on reference-layout state dicts
            fabricated at full width (every leaf mapped, only the dead
            tgt_proj weights skipped), then landmark_inference on the card
            with the ported weights (C7 8 launches);
18. parallel parallel/ on the one card: a world of 1 under NCCL
            (init_process_group with a local address) and a (1, 1) mesh:
            register_sharded on 2 bench pairs (iteration cap cut to 100 a
            level) bit-equal to register_batch with C1-C4 and C6 counted,
            aggregate_metrics_sharded equal to metric_sums, sharded_nn_min
            at 6000 x 6000 bit-equal to one C14 call, one
            neco_train_step_sharded step at full width on 2 pairs (finite,
            C7 16 launches), eval_nolearned on one fabricated pair under
            torchrun's variables for a world of 1 writing the plain run's
            ledger row; then two ranks on the same card under gloo (NCCL
            takes one rank a card; gloo takes the collectives' CUDA
            tensors): register_sharded one pair a rank and sharded_nn_min
            over a model axis of 2, bit-equal to the one-process results,
            the metric sums within 1e-6, C1-C4, C6 and C14 launched on each
            rank;
19. streaming the continuous-batching solver (solve/streaming.py) through
            bench_torch.py --streaming at its defaults (bench.py's
            main_streaming: 16 timed pairs of 2000 points after a warm-up
            on 4, 4 slots, 100 iterations between two polls of the done
            flags): every pair's EPE below 0.6x its initial flow, C1 the
            one kernel launched (one launch an iteration for all slots),
            pairs/s; then C1 with its slot axis at the bench's 4 x 2000 x
            2000 (ragged masks, exact ties, a slot without a valid row):
            one launch, every slot bit-equal to the one-pair C1, timed
            against four one-pair launches, the plain version, batched
            cdist and the bound;
20. native   the collate of the lndp pair through the port's native C++
            library (native/, built at first use with the host compiler)
            and through numpy + cKDTree: points equal at every level,
            neighbour tables equal as sets up to ties at the cut-off,
            seconds of each;
21. bf16     landmark_inference at config/LNDP.yaml's widths with
            inference_dtype bfloat16 against float32 (flash route, weights
            from seed 0, the lndp pair): every output finite, the
            confidence matrices within 2^-5 of the float32 one's max,
            matches and landmarks counted, the match sets' overlap, ms of
            each; the bf16 products in the 'out_dtype' form, held to the
            upcast form within their summation bound.

Then one JSON line with every kernel's launches, error, times and bound,
the nvidia-smi line, and last the JSON result line. The script needs a CUDA
device and the repository around it, and uses no network.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

BENCH_PYRAMID = dict(m=9, k0=-8, depth=3, width=128,
                     rotation_format="axis_angle", motion="SE3")
BENCH_SOLVER = dict(iters=500, lr=0.01, max_break_count=15,
                    break_threshold_ratio=0.001, samples=2000)
MID_LEVEL = 4
REPS = 30


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of ``fn``, by CUDA events.

    Before each timed call the stream is kept busy by a spin kernel for
    longer than the host takes to enqueue the call, so the events measure
    the call's kernels back to back on the device, not the host's launch
    latency (which the slice's ms/iter includes)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (2.0 * host_s + 1e-3)))  # ~2 GHz cycles
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Published peaks of one H100 SXM: device memory, float32 outside the
# tensor cores (the kernels' other arithmetic, in exact float32), and
# dense TF32 on the tensor cores (the 3xTF32 products of C3 and C7-C9).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def bound(nbytes: float, flops: float,
          flop_per_s: float = F32_FLOP_PER_S) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate and its operations over the rate of their type
    (float32 outside the tensor cores unless ``flop_per_s`` says other)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / flop_per_s * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def cdist_nn(x: torch.Tensor, y: torch.Tensor, both: bool = True):
    """The library's exact-difference 1-NN, timed beside C1, C12 and C14
    and used nowhere in the port: ``torch.cdist`` without the matmul form,
    then ``min`` (each way where the kernel computes both directions). It
    returns the root of the distance, so its index equals the kernel's
    except where the root's rounding merges a near-tie."""
    d = torch.cdist(x, y, compute_mode="donot_use_mm_for_euclid_dist")
    return (d.min(1), d.min(0)) if both else d.min(1)


def level_mlp_flops(n: int, cfg, heads: int) -> float:
    """Multiply-adds of one level's MLP over n points, as flops: 6 -> width,
    depth - 1 hidden layers, width -> heads."""
    w = cfg.width
    return 2.0 * n * (6 * w + (cfg.depth - 1) * w * w + w * heads)


def tc_bound(nbytes: float, flops: float, wide: float) -> dict:
    """The bound of a function whose ``wide`` flops (its width x width
    products) a kernel computes as 3xTF32 on the tensor cores: three passes
    of that share at the TF32 rate, the rest of ``flops`` at the f32 one;
    ``f32_bound_ms`` beside it counts all of it in f32."""
    tc_ms = (3.0 * wide / TF32_FLOP_PER_S
             + (flops - wide) / F32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, tc_ms),
                bound_by="bytes" if bytes_ms >= tc_ms else "operations",
                f32_bound_ms=bound(nbytes, flops)["bound_ms"])


def level_bounds(n: int, cfg, n_params: int, rows: int,
                 valid: int | None = None) -> dict:
    """Bounds of C2, C3, C4 and C5 at n points, each for the function and
    not for this design's intermediates. The forward is the MLP; it reads
    the parameters and the points and writes the warp. The backward is the
    recomputed forward, the weight gradients and the hidden-activation
    gradients (3x the forward); it reads the parameters, the points and the
    upstream gradient and writes one gradient. Adam on a summed gradient
    reads p, m, v, g and writes p, m, v. The landmark iteration is all
    three in one launch: the forward of its n rows (it writes every warped
    row), the weight gradients and cotangents of the ``valid`` rows (all
    of them where not given: a row of zero cotangent needs no VJP) and
    Adam's arithmetic; it reads the rows, targets and mask and p, m, v and
    writes the warp and p, m, v. C2, C3 and C5 compute their width x width
    products (the hidden layers forward, and in C3 / C5 their weight
    gradients and cotangents) as 3xTF32 on the tensor cores (``tc_bound``;
    the all-f32 bound beside it as ``f32_bound_ms``). The ``rows`` partial
    gradient rows that C3 hands to C4 are the design's own traffic: C4's
    ``design_bound_ms`` counts them, no ``bound_ms`` does (operations bind
    C3 with or without them).
    """
    heads = ((0 if cfg.motion == "sflow" else cfg.rot_dim) + 3
             + (1 if cfg.motion == "Sim3" else 0)
             + (1 if cfg.nonrigidity_est else 0))
    fwd = level_mlp_flops(n, cfg, heads)
    wide = 2.0 * n * (cfg.depth - 1) * cfg.width ** 2
    valid = n if valid is None else valid
    p4 = 4.0 * n_params
    adam_design = bound(6.0 * p4 + rows * p4, (rows + 12.0) * n_params)
    return {
        "level_warp_fwd": tc_bound(p4 + 24.0 * n, fwd, wide),
        "level_warp_bwd": tc_bound(2.0 * p4 + 36.0 * n, 3.0 * fwd,
                                   3.0 * wide),
        "adam_step": dict(bound(7.0 * p4, 12.0 * n_params),
                          design_bound_ms=adam_design["bound_ms"]),
        "ldmk_iteration": tc_bound(
            6.0 * p4 + 40.0 * n,
            fwd + 2.0 * level_mlp_flops(valid, cfg, heads) + 12.0 * n_params,
            wide * (1.0 + 2.0 * valid / n)),
    }


def numpy_level_params(shapes: dict, seed: int) -> dict:
    """Xavier-uniform weights and torch-default biases for one level, made
    with numpy in the JAX package's layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for key in sorted(shapes):
        w_shape = shapes[key]["w"]
        fan_in, fan_out = w_shape[-2], w_shape[-1]
        lim = (6.0 / (fan_in + fan_out)) ** 0.5
        out[key] = {
            "w": rng.uniform(-lim, lim, w_shape).astype(np.float32),
            "b": rng.uniform(-fan_in ** -0.5, fan_in ** -0.5,
                             shapes[key]["b"]).astype(np.float32),
        }
    return out


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def near_ties(q, db, idx, ref_idx, what):
    """Index flips between two 1-NN results only where the two candidates'
    squared distances agree to 3e-4 relative."""
    flips = idx != ref_idx
    if bool(flips.any()):
        dg = ((q[flips] - db[idx[flips]]) ** 2).sum(-1)
        dr = ((q[flips] - db[ref_idx[flips]]) ** 2).sum(-1)
        rel = float(((dg - dr).abs() / dr.clamp_min(1e-30)).max())
        check(rel < 3e-4, f"{what}: index flip beyond a near-tie: rel {rel}")
    return int(flips.sum())


def c1_case(x, y, xv, yv) -> dict:
    """C1 against its plain version (distances 1e-5, indices equal up to
    near-ties, an invalid row never wins), then its time, the plain
    version's, the library call's (cdist both ways) and the bound: ~8 flops
    a pair of points; the points, the masks and both outputs once."""
    from deformationpyramid_tpu_torch.ops import knn

    got = knn.nn_argmin_dual(x, y, xv, yv)
    ref = knn.nn_argmin_dual_plain(x, y, xv, yv)
    torch.cuda.synchronize()
    err = 0.0
    for q, db, dbv, (d, i), (rd, ri) in ((x, y, yv, got[:2], ref[:2]),
                                         (y, x, xv, got[2:], ref[2:])):
        err = max(err, float((d - rd).abs().max()))
        near_ties(q, db, i, ri, "C1")
        if dbv is not None:
            check(bool(dbv[i].all()), "C1: an invalid row won")
    check(err <= 1e-5, f"C1 nn_dual distance err {err} > 1e-5")
    n, m = x.shape[0], y.shape[0]
    return dict(
        err=err, shape=f"{n} x {m}",
        ms=cuda_ms(lambda: knn.nn_argmin_dual(x, y, xv, yv)),
        plain_ms=cuda_ms(lambda: knn.nn_argmin_dual_plain(x, y, xv, yv)),
        library_ms=cuda_ms(lambda: cdist_nn(x, y)),
        **bound((n + m) * (12 + 1 + 4 + 8), 8.0 * n * m),
        tol="indices equal up to near-ties < 3e-4 rel; distances 1e-5")


def sha256_of(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def c1_digest_inputs(dev) -> dict:
    """Inputs on which C1's outputs are pinned (``C1_DIGESTS``), made with
    numpy: clouds of N(0, 0.3) at 2000 x 2000 and 6000 x 6000, and 1777 x
    1333 points on a grid of 1/32 (many exact ties) with ~30% of each cloud
    masked out."""
    rng = np.random.default_rng(2026)

    def cloud(k):
        return torch.from_numpy(rng.normal(0.0, 0.3, (k, 3)).astype(
            np.float32)).to(dev)

    def grid(k):
        return torch.from_numpy((rng.integers(-32, 33, (k, 3)) / 32.0)
                                .astype(np.float32)).to(dev)

    def mask(k):
        return torch.from_numpy(rng.random(k) > 0.3).to(dev)

    out = {"C1 2000 x 2000": (cloud(2000), cloud(2000), None, None),
           "C1 6000 x 6000": (cloud(6000), cloud(6000), None, None)}
    out["C1 masked 1777 x 1333 grid"] = (grid(1777), grid(1333), mask(1777),
                                         mask(1333))
    return out


def c1_digests(dev) -> dict:
    """sha256 of C1's four outputs (both directions' distances and
    indices) on ``c1_digest_inputs``."""
    from deformationpyramid_tpu_torch.ops import knn

    return {tag: sha256_of(*knn.nn_argmin_dual(*args))
            for tag, args in c1_digest_inputs(dev).items()}


# C1's edge cases (tag: n, m, kind), on a grid of 1/32 (1/2 for "ties"),
# where every distance is exact in float32 in any summation order:
# "random" masks ~20% of each cloud out; "ties" has 125 distinct points
# (exact ties across every slice boundary); "invalid run" masks rows 0-699
# of both clouds out (whole slices without a valid row); "none valid"
# masks out everything; "inf rows" puts a third of y's rows at +inf
# (valid: they never win as candidates, and as queries they find only
# +inf); "only inf" puts every row of y there.
C1_EDGE_CASES = {
    "1 x 1": (1, 1, "random"), "1 x 63": (1, 63, "random"),
    "63 x 1": (63, 1, "random"), "63 x 777": (63, 777, "random"),
    "777 x 2000": (777, 2000, "random"), "2000 x 777": (2000, 777, "random"),
    "ties 2000 x 2000": (2000, 2000, "ties"),
    "invalid run 777 x 2000": (777, 2000, "invalid run"),
    "none valid 63 x 777": (63, 777, "none valid"),
    "inf rows 777 x 2000": (777, 2000, "inf rows"),
    "only inf 63 x 63": (63, 63, "only inf"),
}


def c1_edge_input(dev, tag: str):
    """(x, y, x_valid, y_valid) of ``C1_EDGE_CASES[tag]``, made with numpy
    from a seed."""
    n, m, kind = C1_EDGE_CASES[tag]
    rng = np.random.default_rng(n * 10007 + m)
    levels = 2 if kind == "ties" else 32

    def grid(k):
        return (rng.integers(-levels, levels + 1, (k, 3)) / levels).astype(
            np.float32)

    x, y = grid(n), grid(m)
    xv, yv = rng.random(n) > 0.2, rng.random(m) > 0.2
    if kind == "invalid run":
        xv[:700] = yv[:700] = False
    elif kind == "none valid":
        xv[:] = yv[:] = False
    elif kind in ("inf rows", "only inf"):
        xv[:] = yv[:] = True
        y[rng.random(m) < 1 / 3 if kind == "inf rows" else slice(None)] = \
            np.inf
    return tuple(torch.from_numpy(a).to(dev) for a in (x, y, xv, yv))


def c1_edge_check(dev) -> int:
    """C1 on every edge case bit-equal to its plain version on the CPU
    (``torch.min`` takes the first index of a tie): distances and indices
    both ways. Returns the number of cases."""
    from deformationpyramid_tpu_torch.ops import knn

    for tag in C1_EDGE_CASES:
        args = c1_edge_input(dev, tag)
        got = knn.nn_argmin_dual(*args)
        ref = knn.nn_argmin_dual_plain(*(a.cpu() for a in args))
        for name, a, b in zip(("d_xy", "i_xy", "d_yx", "i_yx"), got, ref):
            check(torch.equal(a.cpu(), b), f"C1 [{tag}]: {name} differs "
                  "from the plain version")
    return len(C1_EDGE_CASES)


# C1's outputs on c1_digest_inputs as the one-query-a-thread C1 that the
# database-split design replaced gave them on an H100 80GB HBM3
# (scripts/check_torch_nn_dual.py through scripts/ab_kernels.sh): the
# redesign keeps every bit.
C1_DIGESTS = {
    "C1 2000 x 2000":
        "1b0da6d39ef9254c66f8bbe822e00b2b12891435b2f92561e2a2cdfdfef05194",
    "C1 6000 x 6000":
        "77e27b3798efb7eb1c738f0ed9a0b6d8a8a99f833bb4c8cf93efea1044b6fad6",
    "C1 masked 1777 x 1333 grid":
        "4497c07fac4b70c2e6ac96308c6aad6626b0ecc0c43865c1102d0b80a96e4596",
}



def c12_digests(dev) -> dict:
    """sha256 of C12's four outputs (sums, cgrad, rmin, rarg) on
    ``c1_digest_inputs``, each at trunc 1e9 and at the median of the valid
    rows' rmin (from the trunc 1e9 call, so both trees take the same
    median where their rmin agree)."""
    from deformationpyramid_tpu_torch.ops import chamfer_fused as cf

    out = {}
    for tag, (x, y, xv, yv) in c1_digest_inputs(dev).items():
        tag = tag.replace("C1", "C12")
        first = cf.chamfer_fused(x, y, xv, yv, 1e9)
        rmin = first[2] if xv is None else first[2][xv]
        out[f"{tag}, trunc 1e9"] = sha256_of(*first)
        out[f"{tag}, trunc median"] = sha256_of(*cf.chamfer_fused(
            x, y, xv, yv, float(rmin.median())))
    return out


def c14_digest_inputs(dev) -> dict:
    """Inputs on which C14's outputs are pinned: ``c1_digest_inputs``'
    x -> y halves (x, y, y_valid) and clouds of N(0, 0.3) at 40159 x 37417
    (the ED pair's shape), made with numpy, every row valid (y_valid
    None)."""
    out = {tag.replace("C1", "C14"): (x, y, yv)
           for tag, (x, y, _, yv) in c1_digest_inputs(dev).items()}
    rng = np.random.default_rng(2027)
    out["C14 40159 x 37417"] = tuple(
        torch.from_numpy(rng.normal(0.0, 0.3, (k, 3)).astype(np.float32))
        .to(dev) for k in (40159, 37417)) + (None,)
    return out


def c14_digests(dev) -> dict:
    """sha256 of C14's outputs (distances and indices) on
    ``c14_digest_inputs``."""
    from deformationpyramid_tpu_torch.ops import knn

    return {tag: sha256_of(*knn.nn_argmin(*args))
            for tag, args in c14_digest_inputs(dev).items()}


def c14_edge_check(dev) -> int:
    """C14 on the x -> y half of every C1 edge case, with y's mask and
    without one, bit-equal to its plain version on the CPU and to C1's
    x -> y half on the card; and equal to C1's x -> y half on
    ``c14_digest_inputs``. Returns the number of comparisons."""
    from deformationpyramid_tpu_torch.ops import knn

    done = 0
    for tag in C1_EDGE_CASES:
        x, y, xv, yv = c1_edge_input(dev, tag)
        for mask in (yv, None):
            got = knn.nn_argmin(x, y, mask)
            ref = knn.nn_argmin_plain(x.cpu(), y.cpu(),
                                      None if mask is None else mask.cpu())
            half = knn.nn_argmin_dual(x, y, xv, mask)[:2]
            for name, a, b, c in zip(("d", "i"), got, ref, half):
                check(torch.equal(a.cpu(), b), f"C14 [{tag}]: {name} "
                      "differs from the plain version")
                check(torch.equal(a, c), f"C14 [{tag}]: {name} differs "
                      "from C1's x -> y half")
            done += 1
    for tag, (x, y, yv) in c14_digest_inputs(dev).items():
        xv = torch.ones(len(x), dtype=torch.bool, device=dev)
        got, half = knn.nn_argmin(x, y, yv), knn.nn_argmin_dual(x, y, xv, yv)
        check(torch.equal(got[0], half[0]) and torch.equal(got[1], half[1]),
              f"C14 [{tag}]: differs from C1's x -> y half")
        done += 1
    return done


# C12's edge cases (tag: n, m, kind), on a grid of 1/32 (1/2 for "ties"),
# where every distance is exact in float32: "random" masks ~20% of each
# cloud out; "ties" has 125 distinct points (exact ties across every slice
# boundary); "rows invalid" / "columns invalid" mask out every row / every
# column (each query then meets BIG terms only: ties at 3e38, or +inf where
# BIG + BIG overflows); "invalid queries" masks out rows 0-699 and columns
# 0-1299, so invalid queries meet valid candidates (every one at 3e38) and
# the first valid index, in a later slice, must win; "one row" puts every
# row on one point, so every column's argmin is row 0 (the bucket pass's
# serial chain of M adds). Truncation at C12_EDGE_TRUNC.
C12_EDGE_CASES = {
    "1 x 1": (1, 1, "random"), "63 x 777": (63, 777, "random"),
    "777 x 2000": (777, 2000, "random"), "2000 x 777": (2000, 777, "random"),
    "ties 2000 x 2000": (2000, 2000, "ties"),
    "rows invalid 777 x 2000": (777, 2000, "rows invalid"),
    "columns invalid 2000 x 777": (2000, 777, "columns invalid"),
    "invalid queries 777 x 2000": (777, 2000, "invalid queries"),
    "one row 2000 x 2000": (2000, 2000, "one row"),
}
C12_EDGE_TRUNC = 0.25


def c12_edge_input(dev, tag: str):
    """(w, y, w_valid, y_valid) of ``C12_EDGE_CASES[tag]``, made with numpy
    from a seed."""
    n, m, kind = C12_EDGE_CASES[tag]
    rng = np.random.default_rng(n * 10007 + m + 12)
    levels = 2 if kind == "ties" else 32

    def grid(k):
        return (rng.integers(-levels, levels + 1, (k, 3)) / levels).astype(
            np.float32)

    w, y = grid(n), grid(m)
    wv, yv = rng.random(n) > 0.2, rng.random(m) > 0.2
    if kind == "rows invalid":
        wv[:] = False
    elif kind == "columns invalid":
        yv[:] = False
    elif kind == "invalid queries":
        wv[:] = yv[:] = True
        wv[:700] = yv[:1300] = False
    elif kind == "one row":
        w[:] = w[0]
        wv[:] = yv[:] = True
    return tuple(torch.from_numpy(a).to(dev) for a in (w, y, wv, yv))


def c12_edge_check(dev) -> int:
    """C12 on every edge case against its plain version on the CPU (where
    index_add_ adds in index order; on CUDA it adds by atomics): cgrad,
    rmin and rarg bit-equal, the two sums within 1e-5 relative (the plain
    version sums in another order). Returns the number of cases."""
    from deformationpyramid_tpu_torch.ops import chamfer_fused as cf

    for tag in C12_EDGE_CASES:
        args = c12_edge_input(dev, tag)
        got = cf.chamfer_fused(*args, C12_EDGE_TRUNC)
        ref = cf.chamfer_fused_plain(*(a.cpu() for a in args),
                                     C12_EDGE_TRUNC)
        for name, a, b in zip(("cgrad", "rmin", "rarg"), got[1:], ref[1:]):
            check(torch.equal(a.cpu(), b), f"C12 [{tag}]: {name} differs "
                  "from the plain version")
        check(bool(((got[0].cpu() - ref[0]).abs()
                    <= 1e-5 * ref[0].abs()).all()),
              f"C12 [{tag}]: sums {got[0].tolist()} against the plain "
              f"version's {ref[0].tolist()}")
    return len(C12_EDGE_CASES)


# C12's and C14's outputs on their pinned inputs (c12_digests,
# c14_digests) as the one-query-a-thread kernels that the split-database
# designs replaced gave them on an H100 80GB HBM3
# (scripts/check_torch_chamfer_fused.py and scripts/check_torch_nn_argmin.py
# through scripts/ab_kernels.sh): the redesigns keep every bit.
C12_DIGESTS = {
    "C12 2000 x 2000, trunc 1e9":
        "75e40370a5296614bd1e7e0810cb979803712cf3bc1d49278292dc66a2ca5e07",
    "C12 2000 x 2000, trunc median":
        "9b5e2777995362cbe06b7539ae82070dc362f80bd000bd21f4fef195e03487e6",
    "C12 6000 x 6000, trunc 1e9":
        "c77ac21a7d8d96a97be6bd596b441bd6366b05980c92ef3423547fa789135234",
    "C12 6000 x 6000, trunc median":
        "bd841675c866ed71f6ac34cfcb75502e66b3ab46d6e895b82f26af8ae5f3f723",
    "C12 masked 1777 x 1333 grid, trunc 1e9":
        "1c9df6596f940a076c9f274884bb33591b97012fd79ff3c0ef0df252bb0df4e6",
    "C12 masked 1777 x 1333 grid, trunc median":
        "3c9601a0e47f5ece7d3d6060675babc00bef51f24d4bc6fa82bfe53743531e30",
}
C14_DIGESTS = {
    "C14 2000 x 2000":
        "54de70a1f13495f1a374166c403c70ea4d27fd6d2de10792f7755a66292d7238",
    "C14 6000 x 6000":
        "fb43fc8dc6baca2d44273a83b5beaa5a56535378a8000c1bf863734e83c9387c",
    "C14 masked 1777 x 1333 grid":
        "8c1e0298bb7feb4d209ec91ae080af5417a87e360e6af4ed88cf21392dd3cdd8",
    "C14 40159 x 37417":
        "b53b3efb69d048c501d75971190616b4fa5d472870b3c5affd5b609e8f022547",
}

# C2 at mlp_scale 1 (tag: pyramid config, points, level). At the yaml's
# 1e-3 a level moves a point by ~3e-4, which shrinks any error of the MLP
# 1000x before it reaches the warp: one TF32 pass on the hidden layers
# would read 3.6e-7 to 8.3e-7 there, inside C2's 1e-5. At mlp_scale 1 the
# CPU emulation of C2's three passes reads 2.7e-7 to 4.8e-7 and one pass
# 3.8e-4 to 8.6e-4 (tests/test_torch_level_warp_tf32.py).
C2_UNSCALED_CASES = {
    "SE3+axis_angle 2000": (BENCH_PYRAMID, 2000, MID_LEVEL),
    "Sim3+euler 6000": (dict(BENCH_PYRAMID, motion="Sim3",
                             rotation_format="euler"), 6000, MID_LEVEL),
    "nonrigid level 1 2000": (dict(BENCH_PYRAMID, nonrigidity_est=True),
                              2000, 1),
}


def c2_unscaled_check(dev) -> dict:
    """C2 on ``C2_UNSCALED_CASES`` against the plain version: the warp and
    the nonrigidity within 1e-5 max abs. Returns each case's error."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    errs = {}
    for tag, (kw, n, level) in C2_UNSCALED_CASES.items():
        cfg = pyramid.NDPConfig(**kw, mlp_scale=1.0)
        flat = pyramid.ravel(pyramid.params_from_numpy(numpy_level_params(
            pyramid.level_shapes(cfg), seed=0), device=dev)).contiguous()
        src = make_pair(n=n, seed=0, deform=0.12)[0]
        x = torch.from_numpy(src - src.mean(0)).to(dev)
        got = fi._warp_launch(flat, x, level, cfg)
        ref = fi._plain_warp_nr(flat, x, level, cfg)
        errs[tag] = max(float((a - b).abs().max())
                        for a, b in zip(got, ref) if b is not None)
        check(errs[tag] <= 1e-5, f"C2 at mlp_scale 1 [{tag}]: max abs err "
              f"{errs[tag]} > 1e-5")
    return errs


def kernel_phase(dp, dev):
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.ops import knn

    cfg = pyramid.NDPConfig(**BENCH_PYRAMID)
    src, tgt, _ = make_pair(n=2000, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    lvl = pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=0), device=dev)
    flat = pyramid.ravel(lvl).contiguous()
    check(flat.numel() == 34694, f"flat level has {flat.numel()} values")
    xv = torch.ones(2000, dtype=torch.bool, device=dev)
    results = {}

    # C2: the level warp
    warped = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
    ref_w = fi._plain_warp(flat, x, MID_LEVEL, cfg)
    torch.cuda.synchronize()
    err = float((warped - ref_w).abs().max())
    check(err <= 1e-5, f"C2 level_warp_fwd max abs err {err} > 1e-5")
    results["level_warp_fwd"] = dict(
        err=err,
        ms=cuda_ms(lambda: fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)),
        plain_ms=cuda_ms(lambda: fi._plain_warp(flat, x, MID_LEVEL, cfg)),
        library_ms=None, tol="max abs 1e-5")

    results["level_warp_fwd"]["err_mlp_scale_1"] = c2_unscaled_check(dev)
    phase("kernels", "level_warp_fwd at mlp_scale 1 (the hidden layers' "
          "rounding unshrunk): max_abs_err " + ", ".join(
              f"{k} {v:.3e}" for k, v in
              results["level_warp_fwd"]["err_mlp_scale_1"].items())
          + " (max abs 1e-5; one TF32 pass would read 3.8e-4 to 8.6e-4)")

    # C1: both 1-NN directions, on the warped points as in the solver; at
    # the shape-transfer demo's 6000 x 6000; its bits on pinned inputs
    got = knn.nn_argmin_dual(warped, y, xv, xv)
    results["nn_dual"] = c1_case(warped, y, xv, xv)
    src6, tgt6, _ = make_pair(n=6000, seed=3, deform=0.12)
    results["nn_dual"]["at_6000"] = c1_case(
        torch.from_numpy(src6 - src6.mean(0)).to(dev),
        torch.from_numpy(tgt6 - tgt6.mean(0)).to(dev), None, None)
    digests = c1_digests(dev)
    check(digests == C1_DIGESTS, f"C1 outputs differ from the pinned bits: "
          f"{digests}")
    results["nn_dual"]["digests"] = "equal to C1_DIGESTS"
    n_edge = c1_edge_check(dev)
    r6 = results["nn_dual"]["at_6000"]
    phase("kernels", f"nn_dual [6000 x 6000]: max_abs_err {r6['err']:.3e}; "
          f"kernel {r6['ms']:.4f} ms, plain {r6['plain_ms']:.4f} ms, library "
          f"call {r6['library_ms']:.4f} ms, bound {r6['bound_ms']:.5f} ms "
          f"({r6['bound_by']}); outputs on {len(digests)} pinned inputs "
          f"bit-equal to C1_DIGESTS; {n_edge} edge cases (ties across "
          "slices, slices without a valid row, +inf rows) bit-equal to the "
          "plain version")

    # C6: the glue's y->x scatter, on the sweep's indices
    rarg = got[3]
    results["scatter_rows"] = scatter_case(
        dev, (warped - y) * 1e-3, rarg, (y - warped[rarg]) * 1e-3,
        "2000 x 2000, the sweep's indices")
    results["scatter_rows"].update(scatter_extra_cases(dev))

    # The chamfer gradient of the main path feeds C3.
    n_len = torch.tensor(2000.0, device=dev)
    _, g = fi._chamfer_glue(warped, got[1], got[3], y, xv, xv, n_len, n_len,
                            1e9)
    g = g * off_kinks(flat, x, MID_LEVEL, cfg)[:, None]

    # C3: the parameter VJP, partials summed
    partials = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)
    ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
    got_g = partials.sum(0)
    torch.cuda.synchronize()
    worst = rel_grad_err(got_g, ref_g, pyramid.level_shapes(cfg), "C3")
    results["level_warp_bwd"] = dict(
        err=float((got_g - ref_g).abs().max()),
        ms=cuda_ms(lambda: fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)),
        plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(flat, x, g,
                                                         MID_LEVEL, cfg)),
        library_ms=None, rows=partials.shape[0],
        tol=f"1e-4 of each tensor's max|g| (worst {worst:.2e})")

    # C4: one Adam step from zero moments, then a held step
    zero = torch.zeros((), device=dev)
    outs = []
    for fn in (fi.adam_step, fi.adam_step_plain):
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        fn(p, m, v, partials, zero, zero, 0.01)
        outs.append((p, m, v))
    torch.cuda.synchronize()
    (p, m, v), (rp, rm, rv) = outs
    for name, a, b in (("m", m, rm), ("v", v, rv)):
        e = float((a - b).abs().max())
        check(e <= 1e-6 * float(b.abs().max()),
              f"C4 {name} err {e} > 1e-6 of max")
    big = got_g.abs() > 1e-3 * got_g.abs().max()
    err = float((p - rp)[big].abs().max())
    check(err <= 1e-6, f"C4 p err {err} > 1e-6 where |g| > 1e-3 max|g|")
    held = [flat.clone(), m.clone(), v.clone()]
    fi.adam_step(*held, partials, zero, torch.ones((), device=dev), 0.01)
    torch.cuda.synchronize()
    check(torch.equal(held[0], flat) and torch.equal(held[1], m)
          and torch.equal(held[2], v), "C4 did not hold with done = 1")
    pa, ma, va = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    # the library's step: fused Adam on one flat tensor whose gradient is
    # already summed (C4 also sums the partial rows and reads the done gate)
    lib_p = flat.clone().requires_grad_(True)
    lib_p.grad = got_g.clone()
    lib_opt = torch.optim.Adam([lib_p], lr=0.01, fused=True)
    results["adam_step"] = dict(
        err=err,
        ms=cuda_ms(lambda: fi.adam_step(pa, ma, va, partials, zero, zero,
                                        0.01)),
        plain_ms=cuda_ms(lambda: fi.adam_step_plain(pa, ma, va, partials,
                                                    zero, zero, 0.01)),
        library_ms=cuda_ms(lib_opt.step),
        tol="m, v 1e-6 of max; p 1e-6 where |g| > 1e-3 max|g|; hold exact")
    for name, b in level_bounds(2000, cfg, flat.numel(),
                                partials.shape[0]).items():
        if name in results:
            results[name].update(b)
    for name, r in results.items():
        print_kernel(name, r)
    return results


def scatter_case(dev, dst, idx, src, tag: str) -> dict:
    """C6 against its plain version, index_add_ on the CPU: bit-equal, the
    same bits on a second launch, one launch a call. plain_ms and library_ms
    are index_add_ on the card, which adds with float atomics."""
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    before = fi.SCATTER_ROWS.launches
    out = fi.scatter_add_rows(dst.clone(), idx, src)
    again = fi.scatter_add_rows(dst.clone(), idx, src)
    ref = fi.scatter_add_rows(dst.cpu(), idx.cpu(), src.cpu())
    torch.cuda.synchronize()
    check(fi.SCATTER_ROWS.launches == before + 2,
          f"C6 [{tag}]: not one launch a call")
    err = float((out.cpu() - ref).abs().max())
    check(torch.equal(out.cpu(), ref), f"C6 [{tag}]: differs from index_add_ "
          f"on the CPU by {err}")
    check(torch.equal(out, again), f"C6 [{tag}]: differs on a second launch")
    buf = dst.clone()
    index_add_ms = cuda_ms(lambda: buf.index_add_(0, idx, src))
    n, m = dst.shape[0], src.shape[0]
    res = dict(err=err, shape=tag,
               ms=cuda_ms(lambda: fi.scatter_add_rows(buf, idx, src)),
               plain_ms=index_add_ms, library_ms=index_add_ms,
               # dst read and written, idx (int64) and src read; one add a
               # value
               **bound(n * 24 + m * (8 + 12), 3.0 * m),
               tol="bit-equal to index_add_ on the CPU and on a repeat")
    print_kernel(f"scatter_rows [{tag}]", res)
    return res


def scatter_extra_cases(dev) -> dict:
    """C6 at the shape-transfer demo's 6000 x 6000 (the sweep's y->x indices
    of a 6000-point pair) and with all 2000 sources on one row."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.ops import knn

    src, tgt, _ = make_pair(n=6000, seed=1, deform=0.12)
    x = torch.from_numpy(src).to(dev)
    y = torch.from_numpy(tgt).to(dev)
    ones = torch.ones(6000, dtype=torch.bool, device=dev)
    rarg = knn.nn_argmin_dual(x, y, ones, ones)[3]
    out = {"at_6000": scatter_case(dev, (x - y) * 1e-3, rarg,
                                   (y - x[rarg]) * 1e-3, "6000 x 6000")}
    gen = torch.Generator().manual_seed(66)
    one = torch.full((2000,), 1234, dtype=torch.int64, device=dev)
    out["one_row"] = scatter_case(
        dev, (torch.randn(2000, 3, generator=gen) * 1e-3).to(dev), one,
        (torch.randn(2000, 3, generator=gen) * 1e-3).to(dev),
        "2000 sources on one row of 2000")
    return {k: {key: r[key] for key in SHAPE_KEYS} for k, r in out.items()}


def print_kernel(name: str, r: dict) -> None:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    phase("kernels", f"{name}: max_abs_err {r['err']:.3e} ({r['tol']}); "
          f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
          f"call {lib}, bound {r['bound_ms']:.5f} ms ({r['bound_by']})"
          + (f", f32 bound {r['f32_bound_ms']:.5f} ms"
             if "f32_bound_ms" in r else "")
          + (f", with this design's partial rows "
             f"{r['design_bound_ms']:.5f} ms"
             if "design_bound_ms" in r else ""))


def solve_checks(tag, warped, src, flow, stats, iters_cap):
    check(bool(torch.isfinite(warped).all()), f"{tag}: non-finite output")
    it = stats["iters"].cpu()
    check(bool(((it >= 1) & (it <= iters_cap)).all()),
          f"{tag}: level iterations {it.tolist()} outside [1, {iters_cap}]")
    check(not bool((it <= 2).all()), f"{tag}: every level stopped at once")
    check(not bool((it == iters_cap).all()), f"{tag}: early stop never fired")
    epe = float((warped - src - flow).norm(dim=-1).mean())
    init = float(flow.norm(dim=-1).mean())
    check(epe * 10.0 <= init, f"{tag}: EPE {epe} not 10x below {init}")
    return epe, init, it.tolist()


def slice_phase(dp, dev, kernels, fused: bool, n_pairs: int):
    from deformationpyramid_tpu_torch.data.synthetic import make_batch

    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**BENCH_PYRAMID),
                          **BENCH_SOLVER, use_fused_iteration=fused)
    srcs, tgts, flows = make_batch(n_pairs + 1, n=2000, seed=100,
                                   deform=0.12)
    data = [tuple(torch.from_numpy(a[i]).to(dev) for a in (srcs, tgts, flows))
            for i in range(n_pairs + 1)]
    dp.register_pair(0, data[0][0], data[0][1], cfg)     # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    outs = [dp.register_pair(i, s, t, cfg) for i, (s, t, _) in
            enumerate(data[1:], start=1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    total_iters = 0
    tag = "fused" if fused else "unfused"
    for i, ((warped, stats), (s, _, f)) in enumerate(zip(outs, data[1:])):
        epe, init, it = solve_checks(tag, warped, s, f, stats,
                                     BENCH_SOLVER["iters"])
        total_iters += sum(it)
        phase(tag, f"pair {i + 1}: EPE {epe:.5f} (initial flow {init:.5f}), "
              f"iterations per level {it}")
    return dict(pairs_per_s=n_pairs / dt, ms_per_iter=dt * 1e3 / total_iters,
                seconds=dt, iters=total_iters, launches=launches)


def leaf_names(shapes, prefix="") -> list[str]:
    """Names of a shape tree's leaves in the order of ``pyramid.unravel``."""
    if isinstance(shapes, dict):
        return [n for k in sorted(shapes)
                for n in leaf_names(shapes[k], f"{prefix}{k}.")]
    if isinstance(shapes, list):
        return [n for i, v in enumerate(shapes)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix.rstrip(".")]


def rel_grad_err(got, ref, shapes, what, tol=1e-4):
    """Largest error of each parameter tensor's gradient relative to that
    tensor's max |g|; fails above ``tol``."""
    from deformationpyramid_tpu_torch.models import pyramid

    gl = pyramid.tree_leaves(pyramid.unravel(got, shapes))
    rl = pyramid.tree_leaves(pyramid.unravel(ref, shapes))
    worst, at = 0.0, ""
    for name, g, r in zip(leaf_names(shapes), gl, rl):
        scale = float(r.abs().max())
        rel = float((g - r).abs().max()) / max(scale, 1e-30)
        if rel > worst:
            worst, at = rel, name
    check(worst <= tol, f"{what} {at}: err {worst} of max|g| > {tol}")
    return worst


def off_kinks(flat, x, level, cfg, tol=1e-6):
    """The points away from the level MLP's ReLU kinks: False where a
    pre-activation lies within ``tol`` of 0 in a float64 forward. The
    warp's gradient jumps there, and two float32 computations of the trunk
    (C3's 3xTF32 products, the plain version's) may take either side: at
    the bench shapes, SE3 + 6D, one point with z = -1.2e-8 moves hidden.b
    by 1.0e-4 of its max. C3's checks give those points zero cotangents."""
    from deformationpyramid_tpu_torch.models import pyramid

    p = pyramid.unravel(flat.double(), pyramid.level_shapes(cfg))
    z = pyramid.posenc(x.double(), level, cfg.k0) @ p["input"]["w"] \
        + p["input"]["b"]
    near = (z.abs() < tol).any(-1)
    for i in range(p["hidden"]["w"].shape[0]):
        z = torch.relu(z) @ p["hidden"]["w"][i] + p["hidden"]["b"][i]
        near |= (z.abs() < tol).any(-1)
    return ~near


def sim3_kernel_phase(dp, dev):
    """C2 and C3 at the shape-transfer shapes: 6000 points, Sim3 + euler."""
    from deformationpyramid_tpu_torch.cli.shape_transfer import DEMO_CFG
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    cfg = DEMO_CFG.pyramid
    src, _, flow = make_pair(n=6000, seed=3, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    shapes = pyramid.level_shapes(cfg)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(shapes, seed=1), device=dev)).contiguous()
    check(flat.numel() == fi.level_param_count(cfg),
          f"Sim3 flat level has {flat.numel()} values")
    g = (torch.from_numpy(flow) * 1e-3).to(dev).contiguous()
    g = g * off_kinks(flat, x, MID_LEVEL, cfg)[:, None]
    out = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
    ref = fi._plain_warp(flat, x, MID_LEVEL, cfg)
    part = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg).sum(0)
    ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f"C2 Sim3+euler max abs err {err} > 1e-5")
    worst = rel_grad_err(part, ref_g, shapes, "C3 Sim3+euler")
    res = {
        "level_warp_fwd": dict(
            err=err, tol="max abs 1e-5",
            ms=cuda_ms(lambda: fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)),
            plain_ms=cuda_ms(lambda: fi._plain_warp(flat, x, MID_LEVEL,
                                                    cfg))),
        "level_warp_bwd": dict(
            err=float((part - ref_g).abs().max()),
            tol=f"1e-4 of each tensor's max|g| (worst {worst:.2e})",
            ms=cuda_ms(lambda: fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)),
            plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(
                flat, x, g, MID_LEVEL, cfg)))}
    rows = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg).shape[0]
    for name, b in level_bounds(6000, cfg, flat.numel(), rows).items():
        if name in res:
            res[name].update(b)
    for name, r in res.items():
        phase("kernels", f"{name} [Sim3+euler, 6000 points]: max_abs_err "
              f"{r['err']:.3e} ({r['tol']}); kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}; f32 {r['f32_bound_ms']:.5f} ms)")
    return res


# (motion, rotation format) pairs beyond SE3|Sim3 x axis_angle|euler; the
# first three are timed, C5 runs at the first.
NEW_FORMATS = (("SE3", "quaternion"), ("SE3", "6D"), ("sflow", "axis_angle"),
               ("Sim3", "quaternion"), ("Sim3", "6D"))
FWD_TOL = 2e-5


def format_kernel_phase(dp, dev):
    """C2 and C3 at the bench shapes (2000 points, width 128, depth 3, a mid
    level) for the sflow motion and the quaternion and 6D formats, each
    against its plain version: forward 2e-5 max abs, gradient 1e-4 of each
    tensor's max |g|."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    src, _, flow = make_pair(n=2000, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    g_flow = (torch.from_numpy(flow) * 1e-3).to(dev).contiguous()
    out = {}
    for i, (motion, fmt) in enumerate(NEW_FORMATS):
        cfg = pyramid.NDPConfig(**dict(BENCH_PYRAMID, motion=motion,
                                       rotation_format=fmt))
        tag = f"{motion}+{fmt}"
        check(fi.supports_fused_iteration(cfg, 0.0), f"{tag}: not covered")
        shapes = pyramid.level_shapes(cfg)
        flat = pyramid.ravel(pyramid.params_from_numpy(
            numpy_level_params(shapes, seed=10 + i), device=dev)).contiguous()
        check(flat.numel() == fi.level_param_count(cfg),
              f"{tag}: flat level has {flat.numel()} values")
        g = g_flow * off_kinks(flat, x, MID_LEVEL, cfg)[:, None]
        warped = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
        ref = fi._plain_warp(flat, x, MID_LEVEL, cfg)
        part = fi.level_warp_bwd(flat, x, g, MID_LEVEL, cfg)
        ref_g = fi.level_warp_bwd_plain(flat, x, g, MID_LEVEL, cfg)[0]
        torch.cuda.synchronize()
        err = float((warped - ref).abs().max())
        check(err <= FWD_TOL, f"C2 {tag} max abs err {err} > {FWD_TOL}")
        worst = rel_grad_err(part.sum(0), ref_g, shapes, f"C3 {tag}")
        res = {"level_warp_fwd": dict(err=err),
               "level_warp_bwd": dict(
                   err=float((part.sum(0) - ref_g).abs().max()),
                   rel_err=worst)}
        if i < 3:
            res["level_warp_fwd"].update(
                ms=cuda_ms(lambda: fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)),
                plain_ms=cuda_ms(lambda: fi._plain_warp(flat, x, MID_LEVEL,
                                                        cfg)))
            res["level_warp_bwd"].update(
                ms=cuda_ms(lambda: fi.level_warp_bwd(flat, x, g, MID_LEVEL,
                                                     cfg)),
                plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(
                    flat, x, g, MID_LEVEL, cfg)))
            for name, b in level_bounds(2000, cfg, flat.numel(),
                                        part.shape[0]).items():
                if name in res:
                    res[name].update(b)
        out[tag] = res
        timing = ("" if i >= 3 else
                  f"; C2 {res['level_warp_fwd']['ms']:.4f} ms (plain "
                  f"{res['level_warp_fwd']['plain_ms']:.4f}, bound "
                  f"{res['level_warp_fwd']['bound_ms']:.5f}, f32 "
                  f"{res['level_warp_fwd']['f32_bound_ms']:.5f}), C3 "
                  f"{res['level_warp_bwd']['ms']:.4f} ms (plain "
                  f"{res['level_warp_bwd']['plain_ms']:.4f}, bound "
                  f"{res['level_warp_bwd']['bound_ms']:.5f})")
        phase("kernels", f"C2 / C3 [{tag}, 2000 points, {flat.numel()} "
              f"parameters]: forward max_abs_err {err:.3e} (<= {FWD_TOL}), "
              f"gradient worst {worst:.2e} of a tensor's max|g| (<= 1e-4)"
              + timing)
    return out


def numpy_nsfp_params(ncfg, seed: int) -> list:
    """torch-default Linear weights for the NSFP layer list, made with numpy
    in the JAX package's layout."""
    from deformationpyramid_tpu_torch.models.baselines import nsfp_dims

    rng = np.random.default_rng(seed)
    dims = nsfp_dims(ncfg)
    out = []
    for i in range(ncfg.n_layers):
        lim = dims[i] ** -0.5
        out.append({"w": rng.uniform(-lim, lim, (dims[i], dims[i + 1])
                                     ).astype(np.float32),
                    "b": rng.uniform(-lim, lim, dims[i + 1]
                                     ).astype(np.float32)})
    return out


def nsfp_off_kinks(flat, x, ncfg, tol=1e-6):
    """The points away from the NSFP net's ReLU kinks: False where a
    pre-activation lies within ``tol`` of 0 in a float64 forward (as
    :func:`off_kinks` for a level). Two float32 computations of the trunk
    (C11's 3xTF32 products, the plain version's) may take either side
    there, and the gradient then differs by a whole point's term; the
    gradient check gives those points zero cotangents."""
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    h, near = x.double(), torch.zeros(x.shape[0], dtype=torch.bool,
                                      device=x.device)
    for p in fi.nsfp_flat_to_params(flat.double(), ncfg)[:-1]:
        z = h @ p["w"] + p["b"]
        near |= (z.abs() < tol).any(-1)
        h = torch.relu(z)
    return ~near


def nsfp_bounds(n: int, ncfg, n_params: int) -> dict:
    """Bounds of C10 and C11 at n points, for the function: the forward is
    the MLP (3 -> w, L - 2 hidden layers, w -> 3); it reads the parameters
    and the points and writes the warp. The backward is the recomputed
    forward, the weight gradients and the cotangents (3x the forward); it
    reads the parameters, the points and the upstream gradient and writes
    one gradient. Both compute their hidden layers' products as 3xTF32 on
    the tensor cores (``tc_bound``; the all-f32 bound beside it)."""
    w, nl = ncfg.width, ncfg.n_layers
    fwd = 2.0 * n * (3 * w + (nl - 2) * w * w + 3 * w)
    wide = 2.0 * n * (nl - 2) * w * w
    p4 = 4.0 * n_params
    return {"nsfp_fwd": tc_bound(p4 + 24.0 * n, fwd, wide),
            "nsfp_bwd": tc_bound(2.0 * p4 + 36.0 * n, 3.0 * fwd, 3.0 * wide)}


def nsfp_kernel_phase(dp, dev):
    """C10 and C11 at the NSFP path's shapes (2000 points, 9 layers x 128,
    116,483 parameters) against their plain versions, C4 at the partial
    rows C11 hands it, and C11 + C4 back to back, as the fused NSFP
    iteration runs them."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.models.baselines import NSFPConfig
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.ops import knn

    ncfg = NSFPConfig()
    n = 2000
    src, tgt, _ = make_pair(n=n, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    flat = fi.nsfp_params_to_flat(pyramid.params_from_numpy(
        numpy_nsfp_params(ncfg, seed=3), device=dev))
    check(flat.numel() == 116483, f"flat NSFP has {flat.numel()} values")
    shapes = fi.nsfp_shapes(ncfg)
    xv = torch.ones(n, dtype=torch.bool, device=dev)

    warped = fi.nsfp_fwd(flat, x, ncfg)
    ref = fi.nsfp_fwd_plain(flat, x, ncfg)
    torch.cuda.synchronize()
    err = float((warped - ref).abs().max())
    check(err <= FWD_TOL, f"C10 nsfp_fwd max abs err {err} > {FWD_TOL}")
    # the chamfer gradient of the main path feeds C11, zero at the points
    # next to a ReLU kink (nsfp_off_kinks)
    _, cidx, _, rarg = knn.nn_argmin_dual(warped, y, xv, xv)
    n_len = torch.tensor(float(n), device=dev)
    _, g = fi._chamfer_glue(warped, cidx, rarg, y, xv, xv, n_len, n_len, 1e9)
    off = nsfp_off_kinks(flat, x, ncfg)
    g = g * off[:, None]
    partials = fi.nsfp_bwd(flat, x, g, ncfg)
    # Nine layers deep, two float32 gradients differ by more than either
    # is wrong: the plain version runs in float64 on the same inputs, and
    # its float32 run is held to the same tolerance beside the kernel.
    ref_g = fi.nsfp_bwd_plain(flat.double(), x.double(), g.double(),
                              ncfg)[0].float()
    plain_g = fi.nsfp_bwd_plain(flat, x, g, ncfg)[0]
    got_g = partials.sum(0)
    torch.cuda.synchronize()
    worst = rel_grad_err(got_g, ref_g, shapes, "C11")
    plain_worst = rel_grad_err(plain_g, ref_g, shapes, "C11's plain version",
                               tol=1.0)
    again = fi.nsfp_bwd(flat, x, g, ncfg)
    check(torch.equal(again, partials), "C11 does not repeat bit for bit")

    w, nl = ncfg.width, ncfg.n_layers
    p4 = 4.0 * flat.numel()
    bounds = nsfp_bounds(n, ncfg, flat.numel())
    res = {
        "nsfp_fwd": dict(
            err=err, tol=f"max abs {FWD_TOL}", library_ms=None,
            ms=cuda_ms(lambda: fi.nsfp_fwd(flat, x, ncfg)),
            plain_ms=cuda_ms(lambda: fi.nsfp_fwd_plain(flat, x, ncfg)),
            **bounds["nsfp_fwd"]),
        "nsfp_bwd": dict(
            err=float((got_g - ref_g).abs().max()), library_ms=None,
            tol=f"1e-4 of each tensor's max|g| against the plain version in "
            f"float64 (worst {worst:.2e}; the plain version in float32 "
            f"{plain_worst:.2e}; {n - int(off.sum())} points at a ReLU kink "
            f"given zero cotangents); a repeat bit-equal",
            ms=cuda_ms(lambda: fi.nsfp_bwd(flat, x, g, ncfg)),
            plain_ms=cuda_ms(lambda: fi.nsfp_bwd_plain(flat, x, g, ncfg)),
            **bounds["nsfp_bwd"])}
    for name, r in res.items():
        print_kernel(f"{name} [{n} points, {nl} x {w}]", r)
    # C4 at this path's shape: C11's partial rows of 116,483
    pa, ma, va = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
    zero = torch.zeros((), device=dev)
    outs = []
    for fn in (fi.adam_step, fi.adam_step_plain):
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        fn(p, m, v, partials, zero, zero, 0.01)
        outs.append((p, m))
    torch.cuda.synchronize()
    e = float((outs[0][1] - outs[1][1]).abs().max())
    check(e <= 1e-6 * float(outs[1][1].abs().max()),
          f"C4 at the NSFP shape: m err {e}")
    rows = partials.shape[0]
    # the library's work for the same function: the rows summed, then one
    # fused Adam step on the flat parameters (the done gate aside)
    lib_p = flat.clone().requires_grad_(True)
    lib_opt = torch.optim.Adam([lib_p], lr=0.01, fused=True)

    def library():
        lib_p.grad = partials.sum(0)
        lib_opt.step()

    adam = dict(
        rows=rows, params=flat.numel(),
        ms=cuda_ms(lambda: fi.adam_step(pa, ma, va, partials, zero, zero,
                                        0.01)),
        plain_ms=cuda_ms(lambda: fi.adam_step_plain(pa, ma, va, partials,
                                                    zero, zero, 0.01)),
        library_ms=cuda_ms(library),
        **bound(7.0 * p4, 12.0 * flat.numel()),
        design_bound_ms=bound(6.0 * p4 + rows * p4,
                              (rows + 12.0) * flat.numel())["bound_ms"])
    phase("kernels", f"adam_step [NSFP: {rows} partial rows of "
          f"{flat.numel()}]: kernel {adam['ms']:.4f} ms, plain "
          f"{adam['plain_ms']:.4f} ms, library (partials.sum(0) + a fused "
          f"torch.optim.Adam step) {adam['library_ms']:.4f} ms, bound "
          f"{adam['bound_ms']:.5f} ms (bytes), with this design's partial "
          f"rows {adam['design_bound_ms']:.5f} ms")
    res["adam_step_at_nsfp"] = adam
    # C11 + C4 as the iteration runs them: the rows C11 writes and C4 reads
    # are the pair's own traffic
    pair = dict(
        rows=rows, rows_bytes=rows * p4,
        ms=cuda_ms(lambda: fi.adam_step(pa, ma, va,
                                        fi.nsfp_bwd(flat, x, g, ncfg), zero,
                                        zero, 0.01)))
    phase("kernels", f"nsfp_bwd + adam_step [{n} points, {nl} x {w}]: "
          f"{pair['ms']:.4f} ms, {rows} partial rows = "
          f"{pair['rows_bytes'] / 1e6:.1f} MB written and read back")
    res["nsfp_bwd"]["with_adam"] = pair
    res["inputs"] = (flat, x, g)
    return res


LNDP_PYRAMID = dict(m=10, k0=-8, depth=3, width=128,
                    rotation_format="axis_angle", motion="SE3")
LNDP_SOLVER = dict(iters=500, lr=0.01, max_break_count=15,
                   break_threshold_ratio=0.001, samples=2000, w_cd=0.0,
                   trunc_cd=0.25)
N_LDMK, LDMK_ROWS = 2000, 2048
# C5's second shape: the lndp path's 4096 padded rows with ~30 valid
# landmarks (28-34 from the seed-0 model), here the first rows.
LNDP_ROWS, LNDP_VALID = 4096, 30
# the kernels of a fused chamfer-mode iteration
CHAMFER_KERNELS = ("nn_dual", "level_warp_fwd", "scatter_rows",
                   "level_warp_bwd", "adam_step")


def landmark_rows(seed: int, n: int = 4000, rows: int = LDMK_ROWS,
                  n_valid: int = N_LDMK):
    """A make_pair pair of n points with ``n_valid`` landmarks from the
    ground-truth flow plus 0.002 noise, padded to ``rows`` rows (the
    padding rows invalid): (src, tgt, flow, src_ldmk, tgt_ldmk,
    ldmk_valid), numpy."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair

    src, tgt, flow = make_pair(n=n, seed=seed, deform=0.12)
    rng = np.random.default_rng(seed)
    li = rng.permutation(n)[:rows]
    s_l = src[li]
    t_l = (src[li] + flow[li]
           + rng.normal(0.0, 0.002, (rows, 3))).astype(np.float32)
    return src, tgt, flow, s_l, t_l, np.arange(rows) < n_valid


# C5 against its plain version: the warped rows (max abs), the loss
# (relative), the held step and p (where |m| > 1e-3 max|m|) as C5 always
# was; m / (1 - b1) and v / (1 - b2), the step's gradient and its square,
# within these shares of each parameter tensor's max, as C3's gradient
# (C5's VJP is C3's 3xTF32 code), with the landmark rows at a ReLU's kink
# (off_kinks) masked out of the check's inputs.
C5_M_TOL, C5_V_TOL = 1e-4, 2e-4
C5_TOL = ("rows 1e-5; loss 1e-6 rel; counter/done/it/applied equal; m / "
          "(1 - b1) 1e-4 and v / (1 - b2) 2e-4 of each tensor's max; p 1e-6 "
          "where |m| > 1e-3 max|m|; held step exact")


def ldmk_case(dev, cfg, rows: int, n_valid: int, seed: int,
              timed: bool) -> dict:
    """C5 at ``rows`` landmark rows (``n_valid`` valid, the first ones),
    ``cfg``'s pyramid, a mid level: one step from fresh state and a held
    step against its plain version under the C5 gates; a second launch
    bit-equal; with ``timed`` the device times and the bound."""
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    src, _, _, s_l, t_l, valid = landmark_rows(
        seed=seed, n=max(4000, rows + 1000), rows=rows, n_valid=n_valid)
    mean = src.mean(0)
    x = torch.from_numpy(s_l - mean).to(dev)
    tgt = torch.from_numpy(t_l - mean).to(dev)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=2),
        device=dev)).contiguous()
    keep = off_kinks(flat, x, MID_LEVEL, cfg)
    mask = (torch.from_numpy(valid).to(dev) & keep).float()
    count = mask.sum().clamp_min(1.0)
    shapes = pyramid.level_shapes(cfg)

    def run(fn, lcfg):
        stop = fi.EarlyStop(lcfg, dev)
        p, m, v = flat.clone(), torch.zeros_like(flat), torch.zeros_like(flat)
        aux = x.clone()
        fn(p, m, v, x, tgt, mask, count, stop, aux, MID_LEVEL, cfg, 0.01)
        return p, m, v, aux, stop

    lcfg = LoopConfig(iters=500)
    (p, m, v, aux, st), (rp, rm, rv, raux, rst) = (
        run(fi.ldmk_iteration, lcfg), run(fi.ldmk_iteration_plain, lcfg))
    again = run(fi.ldmk_iteration, lcfg)
    torch.cuda.synchronize()
    tag = f"C5 [{cfg.motion}+{cfg.rotation_format}, {rows} rows]"
    check(all(torch.equal(a, b) for a, b in zip(
        (p, m, v, aux, st.loss), (*again[:4], again[4].loss))),
          f"{tag}: a second launch differs")
    err = float((aux - raux).abs().max())
    check(err <= 1e-5, f"{tag} warped rows err {err} > 1e-5")
    lerr = abs(float(st.loss) - float(rst.loss))
    check(lerr <= 1e-6 * float(rst.loss), f"{tag} loss err {lerr}")
    for k in ("counter", "done", "it", "applied"):
        check(float(getattr(st, k)) == float(getattr(rst, k)),
              f"{tag} {k} {float(getattr(st, k))} vs "
              f"{float(getattr(rst, k))}")
    check(not bool(st.done) and int(st.applied) == 1, f"{tag} did not step")
    c1, c2 = 1.0 - fi.ADAM_B1, 1.0 - fi.ADAM_B2
    m_err = rel_grad_err(m / c1, rm / c1, shapes, f"{tag} m / (1 - b1)",
                         C5_M_TOL)
    v_err = rel_grad_err(v / c2, rv / c2, shapes, f"{tag} v / (1 - b2)",
                         C5_V_TOL)
    # the whole-vector reading the gate held before C5's VJP was C3's code
    whole = {name: float((a - b).abs().max()) / float(b.abs().max())
             for name, a, b in (("m", m, rm), ("v", v, rv))}
    big = rm.abs() > 1e-3 * rm.abs().max()
    perr = float((p - rp)[big].abs().max())
    check(perr <= 1e-6, f"{tag} p err {perr} where |m| > 1e-3 max|m|")
    held = run(fi.ldmk_iteration, LoopConfig(iters=500, loss_eps=1e9))
    torch.cuda.synchronize()
    check(bool(held[4].done) and torch.equal(held[0], flat)
          and not held[1].any() and not held[2].any()
          and int(held[4].it) == 1, f"{tag} did not hold with done set")
    res = dict(err=err, m_rel_err=m_err, v_rel_err=v_err,
               whole_vector_rel_err=whole, kinks=int((~keep).sum()),
               valid=int(mask.sum()), tol=C5_TOL)
    phase("kernels", f"{tag}: warped rows {err:.3e}, m / (1 - b1) "
          f"{m_err:.3e}, v / (1 - b2) {v_err:.3e} of each tensor's max "
          f"(whole vector, the old reading: m {whole['m']:.3e}, v "
          f"{whole['v']:.3e} of max), {res['kinks']} rows at a kink masked; "
          f"a second launch bit-equal")
    if not timed:
        return res
    # Timing: an early stop that never fires, so every call steps.
    never = LoopConfig(iters=10 ** 9, loss_eps=0.0, max_break_count=10 ** 9)
    states = {}
    for name in ("kernel", "plain"):
        stop = fi.EarlyStop(never, dev)
        states[name] = (flat.clone(), torch.zeros_like(flat),
                        torch.zeros_like(flat), stop, x.clone())
    scratch = fi.ldmk_scratch(rows, cfg, dev)
    kp, km, kv, kst, kaux = states["kernel"]
    pp, pm, pv, pst, paux = states["plain"]
    res.update(
        library_ms=None, rows=rows, blocks=scratch["partial"].shape[0],
        tile=fi.ldmk_tile(rows, cfg),
        **level_bounds(rows, cfg, flat.numel(), 0,
                       valid=int(mask.sum()))["ldmk_iteration"],
        ms=cuda_ms(lambda: fi.ldmk_iteration(
            kp, km, kv, x, tgt, mask, count, kst, kaux, MID_LEVEL, cfg, 0.01,
            scratch)),
        plain_ms=cuda_ms(lambda: fi.ldmk_iteration_plain(
            pp, pm, pv, x, tgt, mask, count, pst, paux, MID_LEVEL, cfg,
            0.01)))
    print_kernel(f"ldmk_iteration [{rows} rows, {res['valid']} valid, "
                 f"{res['blocks']} blocks of {res['tile']}]", res)
    return res


def ldmk_kernel_phase(dp, dev, pyr=None, timed=True):
    """C5 at LNDP's pyramid (or ``pyr``), a mid level: at 2048 landmark
    rows with 2000 valid and, timed, at the lndp path's 4096 rows with 30
    valid (``ldmk_case``). Returns the 2048-row case with the other under
    ``at_4096_30``."""
    from deformationpyramid_tpu_torch.models import pyramid

    cfg = pyramid.NDPConfig(**(pyr or LNDP_PYRAMID))
    res = ldmk_case(dev, cfg, LDMK_ROWS, N_LDMK, seed=5, timed=timed)
    if timed:
        res["at_4096_30"] = ldmk_case(dev, cfg, LNDP_ROWS, LNDP_VALID,
                                      seed=6, timed=True)
    return res


def repeat_phase(dp, dev):
    """One bench pair through the fused path twice: the same iterations per
    level and bit-equal output."""
    from deformationpyramid_tpu_torch.data.synthetic import make_batch

    cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**BENCH_PYRAMID),
                          **BENCH_SOLVER, use_fused_iteration=True)
    srcs, tgts, _ = make_batch(2, n=2000, seed=100, deform=0.12)
    s, t = (torch.from_numpy(a[1]).to(dev) for a in (srcs, tgts))
    (w1, st1), (w2, st2) = (dp.register_pair(1, s, t, cfg) for _ in range(2))
    it1, it2 = st1["iters"].tolist(), st2["iters"].tolist()
    check(it1 == it2, f"repeat: iterations {it1} then {it2}")
    check(torch.equal(w1, w2), "repeat: warped output differs, max abs "
          f"{float((w1 - w2).abs().max())}")
    phase("repeat", f"bench pair fused twice: iterations {it1} both times, "
          "warped output bit-equal")


def torus_mesh(n_major: int = 100, n_minor: int = 100):
    """A triangulated torus (radii 0.5 and 0.2): vertices [V, 3], faces."""
    u = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = 0.5 + 0.2 * np.cos(vv)
    verts = np.stack([r * np.cos(uu), r * np.sin(uu), 0.2 * np.sin(vv)], -1)
    idx = np.arange(n_major * n_minor).reshape(n_major, n_minor)
    a, b = idx, np.roll(idx, -1, 0)
    c, d = np.roll(idx, -1, 1), np.roll(np.roll(idx, -1, 0), -1, 1)
    faces = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                            np.stack([a, d, c], -1).reshape(-1, 3)])
    return verts.reshape(-1, 3).astype(np.float32), faces.astype(np.int32)


def sim3_bend(verts: np.ndarray) -> np.ndarray:
    """A Sim3 transform (0.15 rad about z, scale 1.05, offset) of a smoothly
    bent copy of ``verts``."""
    ang = 0.15
    rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                    [np.sin(ang), np.cos(ang), 0.0], [0.0, 0.0, 1.0]])
    bent = verts.copy()
    bent[:, 2] += 0.08 * np.sin(2.0 * verts[:, 0])
    return (1.05 * bent @ rot.T + [0.4, -0.2, 0.1]).astype(np.float32)


def mean_nn_dist(a: torch.Tensor, b: torch.Tensor) -> float:
    from deformationpyramid_tpu_torch.ops.knn import nn_argmin

    return float(torch.sqrt(nn_argmin(a, b)[0]).mean())


def shape_phase(dp, dev, kernels):
    from deformationpyramid_tpu_torch.cli import shape_transfer as st
    from deformationpyramid_tpu_torch.data.ply import (
        load_ply, save_ply, sample_points_uniformly)

    out_dir = REPO / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    verts, faces = torus_mesh()
    meshes = []
    for name, v in (("src", verts), ("tgt", sim3_bend(verts))):
        path = out_dir / f"{name}.ply"
        save_ply(str(path), v, faces)
        mesh = load_ply(str(path))
        check(mesh.vertices.shape == v.shape
              and np.array_equal(mesh.faces, faces)
              and float(np.abs(mesh.vertices - v).max()) <= 1e-6,
              f"shape: {name}.ply did not read back")
        meshes.append(mesh)
    cfg = st.DEMO_CFG
    src_pts = sample_points_uniformly(meshes[0], cfg.samples, seed=0)
    tgt_pts = sample_points_uniformly(meshes[1], cfg.samples, seed=1)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    warped, stats = st.register_meshes(src_pts, tgt_pts, meshes[0].vertices,
                                       cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    check(bool(torch.isfinite(warped).all()), "shape: non-finite output")
    it = stats["iters"].cpu()
    check(bool(((it >= 1) & (it <= cfg.iters)).all())
          and not bool((it <= 2).all()) and not bool((it == cfg.iters).all()),
          f"shape: level iterations {it.tolist()}")
    tgt_v = torch.from_numpy(meshes[1].vertices).to(dev)
    before = mean_nn_dist(torch.from_numpy(meshes[0].vertices).to(dev), tgt_v)
    after = mean_nn_dist(warped, tgt_v)
    check(after * 5.0 <= before,
          f"shape: NN distance {after} not 5x below {before}")
    for name in CHAMFER_KERNELS:
        check(launches[name] > 0, f"shape: kernel {name} never launched")
    iters = int(it.sum())
    phase("shape", f"{len(verts)} vertices, {cfg.samples} samples: mean NN "
          f"distance {before:.5f} -> {after:.5f}; iterations per level "
          f"{it.tolist()}; {dt:.3f} s, {dt * 1e3 / iters:.4f} ms/iter; "
          f"launches {launches}")
    return dict(seconds=dt, ms_per_iter=dt * 1e3 / iters, iters=iters,
                nn_before=before, nn_after=after, launches=launches)


def landmark_phase(dp, dev, kernels):
    """LNDP's solver: w_cd 0 through C5, then unfused, then w_cd 1 through
    C1-C4, on the same landmark pair (one warm-up pair through C5 first)."""
    base = dp.SolverConfig(pyramid=dp.NDPConfig(**LNDP_PYRAMID),
                           **LNDP_SOLVER)
    modes = {
        "C5": dict(use_fused_iteration=True, use_fused_ldmk=True),
        "unfused": dict(use_fused_iteration=False),
        "ldmk+cd": dict(use_fused_iteration=True, w_cd=1.0),
    }
    needs = {"C5": ["ldmk_iteration"], "unfused": ["adam_step"],
             "ldmk+cd": CHAMFER_KERNELS}

    def tensors(seed):
        return [torch.from_numpy(np.asarray(a)).to(dev)
                for a in landmark_rows(seed)]

    src, tgt, _, s_l, t_l, lv = tensors(300)
    dp.register_pair(0, src, tgt, dataclasses.replace(base, **modes["C5"]),
                     src_ldmk=s_l, tgt_ldmk=t_l, ldmk_valid=lv)
    src, tgt, flow, s_l, t_l, lv = tensors(301)
    out = {}
    for name, knobs in modes.items():
        cfg = dataclasses.replace(base, **knobs)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        warped, stats = dp.register_pair(1, src, tgt, cfg, src_ldmk=s_l,
                                         tgt_ldmk=t_l, ldmk_valid=lv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        epe, init, it = solve_checks(f"landmark {name}", warped, src, flow,
                                     stats, cfg.iters)
        for kn in needs[name]:
            check(launches[kn] > 0, f"landmark {name}: {kn} never launched")
        out[name] = dict(epe=epe, init=init, iters=it, seconds=dt,
                         ms_per_iter=dt * 1e3 / sum(it), launches=launches)
        phase("landmark", f"{name}: EPE {epe:.5f} (initial flow "
              f"{init:.5f}), iterations per level {it}, {dt:.3f} s, "
              f"{dt * 1e3 / sum(it):.4f} ms/iter, launches {launches}")
    out["fixed"] = fixed_landmark_paths(dp, dev, base, modes, kernels,
                                        (src, tgt, s_l, t_l, lv))
    return out


def fixed_landmark_paths(dp, dev, base, modes, kernels, pair) -> dict:
    """The C5 route against the unfused landmark loop on the landmark pair
    with the early stop off (no plateau rule, no loss floor) and
    FIXED_ITERS iterations a level, before a solve turns chaotic (as
    ``fixed_two_paths``): every level ran its iterations on both, the
    warped source (the landmarks are rows of it) within FIXED_FLOW_CM and
    each level's final loss within FIXED_LOSS_REL; C5 launched once an
    iteration."""
    src, tgt, s_l, t_l, lv = pair
    runs = {}
    for name in ("C5", "unfused"):
        cfg = dataclasses.replace(base, **modes[name], iters=FIXED_ITERS,
                                  max_break_count=NO_STOP, loss_eps=0.0)
        for k in kernels:
            k.launches = 0
        warped, stats = dp.register_pair(1, src, tgt, cfg, src_ldmk=s_l,
                                         tgt_ldmk=t_l, ldmk_valid=lv)
        torch.cuda.synchronize()
        runs[name] = (warped, stats,
                      {k.name: k.launches for k in kernels})
    (w5, st5, la5), (wu, stu, _) = runs["C5"], runs["unfused"]
    iters = [st5["iters"].tolist(), stu["iters"].tolist()]
    levels = len(iters[0])
    check(iters[0] == iters[1] == [FIXED_ITERS] * levels,
          f"landmark fixed: iterations {iters}, not {FIXED_ITERS} a level")
    check(la5["ldmk_iteration"] == FIXED_ITERS * levels,
          f"landmark fixed: C5 launched {la5['ldmk_iteration']} times")
    res = dict(flow_cm=100.0 * float((w5 - wu).abs().max()),
               loss_rel=float(((st5["loss"] - stu["loss"]).abs()
                               / stu["loss"].abs()).max()),
               losses=[st5["loss"].tolist(), stu["loss"].tolist()])
    check(res["flow_cm"] <= FIXED_FLOW_CM
          and res["loss_rel"] <= FIXED_LOSS_REL,
          f"landmark fixed: the C5 route and the unfused loop part with the "
          f"early stop off: warps by {res['flow_cm']} cm (limit "
          f"{FIXED_FLOW_CM}), losses by {res['loss_rel']} (limit "
          f"{FIXED_LOSS_REL}): {res}")
    phase("landmark", f"fixed, {FIXED_ITERS} iterations a level, early stop "
          f"off: C5 against the unfused loop, warps {res['flow_cm']:.3e} cm "
          f"(<= {FIXED_FLOW_CM}), level losses {res['loss_rel']:.3e} "
          f"relative (<= {FIXED_LOSS_REL})")
    return res


SUPERVISED_SPLIT = "4DMatch-F"
# the keys of an eval_supervised ledger row: the 12 flow metrics, then the
# matcher's
SUPERVISED_KEYS = 12 + 5


def supervised_phase(dp, dev, kernels):
    """The LNDP evaluation CLI (cli/eval_supervised.py, through its argument
    parser) on the first 3 pairs of write_4dmatch_suite's default 4DMatch-F
    stream at config/LNDP.yaml's widths with the landmark model of seed 0;
    then --resume, one --stage-timers --oracle-filter pass, and
    bench_lndp_torch.py on 2 pairs, 1 repetition."""
    import bench_lndp_torch
    from deformationpyramid_tpu_torch.cli import eval_supervised as ev
    from deformationpyramid_tpu_torch.data.synthetic import \
        write_4dmatch_suite
    from deformationpyramid_tpu_torch.ops.fused_iteration import SYNC_EVERY
    from deformationpyramid_tpu_torch.utils.config import load_config

    cap = load_config(str(REPO / "config" / "LNDP.yaml")).iters
    work = REPO / "build" / "chip_smoke" / "supervised"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "split"
    write_4dmatch_suite(str(root), SUPERVISED_SPLIT, n_pairs=3)

    def counted(fn):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {k.name: k.launches for k in kernels}, \
            time.perf_counter() - t0

    def run(tag, *extra, log=None):
        argv = ["--config", str(REPO / "config" / "LNDP.yaml"),
                "--data-root", str(root), "--splits", SUPERVISED_SPLIT,
                "--device", "cuda", "--log-dir", str(work / (log or tag)),
                *extra]
        report, launches, dt = counted(lambda: ev.main(argv))
        r = report[SUPERVISED_SPLIT]
        check(len(r["scores"]) == SUPERVISED_KEYS
              and all(np.isfinite(v) for v in r["scores"].values()),
              f"supervised {tag}: scores {r['scores']}")
        rows = [json.loads(l) for l in (
            work / (log or tag) / f"{SUPERVISED_SPLIT}.pairs.jsonl")
            .read_text().splitlines()]
        iters = sum(sum(v) for v in r["iters"].values())
        # C5 launches once an iteration; a level's loop reads the stop flag
        # every SYNC_EVERY launches, so the launches after the stop, which
        # hold the state, round each level's count up to that multiple
        held = sum(min(cap, -(-k // SYNC_EVERY) * SYNC_EVERY)
                   for v in r["iters"].values() for k in v)
        if r["pairs"]:
            check(launches["flash_attention_fwd"] == 8 * r["pairs"],
                  f"supervised {tag}: C7 launched "
                  f"{launches['flash_attention_fwd']} times over "
                  f"{r['pairs']} pairs, expected 8 a pair")
            check(launches["ldmk_iteration"] == held,
                  f"supervised {tag}: C5 launched "
                  f"{launches['ldmk_iteration']} times over {iters} "
                  f"iterations, expected {held}: one an iteration, each "
                  f"level's rounded up to a multiple of {SYNC_EVERY}")
            phase("supervised", f"{tag}: {r['pairs']} pairs in {dt:.3f} s, "
                  f"{iters} iterations ({dt * 1e3 / iters:.4f} ms/iter "
                  f"whole), {held} C5 launches, landmarks "
                  f"{[int(x['n_landmarks']) for x in rows]}; launches "
                  f"{ {k: v for k, v in launches.items() if v} }; score "
                  + " ".join(f"{k} {v:.3f}" for k, v in r["scores"].items()))
        return dict(report=r, rows=rows, launches=launches, seconds=dt,
                    iters=iters)

    out = {"main": run("main")}
    check(out["main"]["report"]["pairs"] == 3,
          f"supervised: {out['main']['report']['pairs']} pairs")
    again = run("resume", "--resume", log="main")
    check(again["report"]["pairs"] == 0
          and not any(again["launches"].values())
          and again["report"]["scores"] == out["main"]["report"]["scores"],
          f"supervised --resume: solved {again['report']['pairs']}, "
          f"launches {again['launches']}, scores {again['report']['scores']}")
    phase("supervised", "--resume: 0 pairs solved, no kernel launched, the "
          "scores reproduced")
    st = out["timed"] = run("timed", "--stage-timers", "--oracle-filter")
    for row in st["rows"]:
        check(all(k in row["stages_ms"] for k in
                  ("matcher", "oracle", "solve", "metrics", "rtt_pre",
                   "rtt_post"))
              and (row["n_landmarks"] == 0 or row["IR"] == 1.0),
              f"supervised --oracle-filter: row {row}")
    stages = {k: [round(r["stages_ms"][k], 2) for r in st["rows"]]
              for k in ("matcher", "oracle", "solve", "rtt_pre")}
    phase("supervised", f"--stage-timers --oracle-filter: ms a pair {stages}")
    line, launches, dt = counted(lambda: bench_lndp_torch.main(
        ["--limit", "2", "--reps", "1", "--data-root", str(root),
         "--weights", str(work / "no-such.npz"), "--device", "cuda"]))
    check(line["weights"] == "random" and line["pairs"] == 2
          and line["value"] > 0 and line["per_pair_best_s"] > 0
          and launches["flash_attention_fwd"] == 16,
          f"supervised bench_lndp_torch: {line}, launches {launches}")
    out["bench"] = dict(line=line, launches=launches, seconds=dt)
    phase("supervised", f"bench_lndp_torch.py --limit 2 --reps 1: "
          f"{line['value']} pairs/s, best pair {line['per_pair_best_s']} s; "
          f"{dt:.3f} s")
    return out


def threedmatch_phase(dp, dev, kernels):
    """The 3DMatch rigid evaluation (cli/eval_3dmatch.py through its
    argument parser) on 4 fragment pairs of write_3dmatch_suite at its
    defaults (9000-point scenes, 6300-point fragments) with the landmark
    model of seed 0 at config/LNDP.yaml's widths: with NeCo and with
    --no-reject-outliers."""
    from deformationpyramid_tpu_torch.cli import eval_3dmatch as ev
    from deformationpyramid_tpu_torch.data.synthetic import \
        write_3dmatch_suite

    work = REPO / "build" / "chip_smoke" / "threedmatch"
    shutil.rmtree(work, ignore_errors=True)
    info = write_3dmatch_suite(str(work / "split"), "3DMatch", n_pairs=4)
    out = {}
    for tag, extra in (("neco", []), ("ransac_only",
                                      ["--no-reject-outliers"])):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        summary = ev.main(["--config", str(REPO / "config" / "LNDP.yaml"),
                           "--info", info, "--base-dir", str(work / "split"),
                           "--device", "cuda", "--log-dir", str(work / tag),
                           *extra])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        rows = [json.loads(l) for l in (work / tag / "3DMatch.pairs.jsonl")
                .read_text().splitlines()]
        check(len(rows) == 4 and all(
            np.isfinite(v) for r in rows for k, v in r.items()
            if k != "name"), f"threedmatch {tag}: rows {rows}")
        check(0.0 <= summary["value"] <= 1.0 and summary["pairs"] == 4,
              f"threedmatch {tag}: {summary}")
        check(launches["flash_attention_fwd"] == 8 * 4,
              f"threedmatch {tag}: C7 launched "
              f"{launches['flash_attention_fwd']} times over 4 pairs")
        out[tag] = dict(summary=summary, launches=launches, seconds=dt,
                        matches=[r["n_matches"] for r in rows])
        phase("threedmatch", f"{tag}: recall {summary['value']}, IR "
              f"{summary['IR']}, RRE {summary['RRE_deg']} deg, RTE "
              f"{summary['RTE']} m; matches {out[tag]['matches']}; "
              f"{dt:.3f} s (matcher {summary['matcher_s']:.3f} s, host "
              f"RANSAC {summary['ransac_s']:.3f} s); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
    return out


def small_phase(dp, dev):
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.solve.registration import \
        optimize_pyramid

    small = dict(m=3, width=32)
    cases = {
        "SE3+axis_angle": (dict(small, k0=-6), {}),
        "Sim3+euler": (dict(small, k0=-6, motion="Sim3",
                            rotation_format="euler"), {}),
        "sflow": (dict(small, k0=-6, motion="sflow"), {}),
        "SE3+quaternion": (dict(small, k0=-6,
                                rotation_format="quaternion"), {}),
        "Sim3+6D": (dict(small, k0=-6, motion="Sim3",
                         rotation_format="6D"), {}),
        "landmark C5": (dict(small, k0=-8),
                        dict(w_cd=0.0, use_fused_ldmk=True)),
        "landmark+chamfer": (dict(small, k0=-8), dict(w_cd=1.0)),
    }
    src, tgt, flow = make_pair(n=260, seed=0, deform=0.12)
    rng = np.random.default_rng(0)
    s = torch.from_numpy(src[rng.permutation(260)[:200]] - src.mean(0))
    t = torch.from_numpy(tgt[rng.permutation(260)[:200]] - tgt.mean(0))
    li = rng.permutation(260)[:48]
    s_l = torch.from_numpy(src[li] - src.mean(0))
    t_l = torch.from_numpy(src[li] + flow[li] - tgt.mean(0))
    l_valid = torch.arange(48) < 40
    valid = torch.ones(200, dtype=torch.bool)
    for name, (pk, knobs) in cases.items():
        # The quaternion and 6D formats renormalise a head output of
        # ~mlp_scale: their float32 trajectories part after ~5 steps (the
        # horizon and the 1e-2 of the CPU parity tests).
        short = pk.get("rotation_format") in ("quaternion", "6D")
        iters, tol = (5, 1e-2) if short else (30, 1e-3)
        cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**pk), iters=iters,
                              samples=200, use_fused_iteration=True, **knobs)
        n_ldmk, pts, pv = 0, s, valid
        if "w_cd" in knobs:
            n_ldmk = 48
            pts, pv = ((torch.cat([s_l, s]), torch.cat([l_valid, valid]))
                       if knobs["w_cd"] > 0 else (s_l, l_valid))
        params = dp.init_pyramid_params(torch.Generator().manual_seed(7),
                                        cfg.pyramid)
        res = {}
        for d in (dev, torch.device("cpu")):
            p, st = optimize_pyramid(
                pyramid.tree_map(lambda a: a.to(d), params), pts.to(d),
                pv.to(d), t.to(d), valid.to(d), cfg, n_ldmk,
                t_l.to(d) if n_ldmk else None,
                l_valid.to(d) if n_ldmk else None)
            res[d.type] = (dp.warp(p, s.to(d), cfg.pyramid)[0].cpu(),
                           st["iters"].cpu().tolist())
        err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
        check(res["cuda"][1] == res["cpu"][1],
              f"small {name}: iterations {res['cuda'][1]} vs CPU "
              f"{res['cpu'][1]}")
        check(err <= tol, f"small {name}: warped err {err} vs CPU > {tol}")
        phase("small", f"{name}: card vs CPU plain: iterations "
              f"{res['cuda'][1]} equal, warped max abs err {err:.3e} "
              f"(<= {tol})")

FLASH_SHAPE = dict(L=2048, S=2048, src_len=1500, h=4, d=132)
# what a timed attention case reports of a further shape in the JSON line
SHAPE_KEYS = ("shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
              "bound_by")


def flash_bound(L: int, src_len: int, h: int, d: int) -> dict:
    """C7: two products of 2 L src_len h d flops each; q read and o written
    (L rows), k and v read up to the valid prefix. It computes them as
    3xTF32 on the tensor cores: three passes at the TF32 rate (the f32 FMA
    bound is kept beside it as ``f32_bound_ms``)."""
    nbytes = 4.0 * (2 * L + 2 * src_len) * h * d
    ops = 4.0 * L * src_len * h * d
    return dict(bound(nbytes, 3 * ops, TF32_FLOP_PER_S),
                f32_bound_ms=bound(nbytes, ops)["bound_ms"])


def flash_case(dev, L, S, src_len, h, d, seed, timed: bool):
    """C7 against its plain version on one shape, launched twice with
    bit-equal results; with ``timed`` also the device times of the kernel,
    the plain version and scaled_dot_product_attention with a boolean mask
    on the same tensors, and where C7 splits the source rows on this card,
    its time unsplit (``unsplit_ms``)."""
    from deformationpyramid_tpu_torch.match import attention as att

    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(n, h, d, generator=gen).to(dev)
               for n in (L, S, S))
    n_valid = torch.tensor(src_len, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    got = att.flash_attention(q, k, v, n_valid, scale)
    again = att.flash_attention(q, k, v, n_valid, scale)
    ref = att.flash_attention_plain(q, k, v, n_valid, scale)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    tag = f"L {L}, S {S}, src_len {src_len}, {h} heads of {d}"
    check(bool(torch.isfinite(got).all()), f"C7 [{tag}]: non-finite output")
    check(err <= 2e-5, f"C7 [{tag}]: max abs err {err} > 2e-5")
    check(torch.equal(got, again), f"C7 [{tag}]: differs on a second launch")
    if src_len == 0:
        check(not bool(got.any()), f"C7 [{tag}]: an empty prefix must give 0")
    res = dict(err=err, tol="max abs 2e-5; bit-equal on a second launch",
               shape=tag)
    if timed:
        mask = (torch.arange(S, device=dev) < src_len)[None, None, None, :]
        qs, ks, vs = (t.transpose(0, 1)[None] for t in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res.update(
            ms=cuda_ms(lambda: att.flash_attention(q, k, v, n_valid, scale)),
            plain_ms=cuda_ms(lambda: att.flash_attention_plain(
                q, k, v, n_valid, scale)),
            library_ms=cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                            scale=scale)),
            **flash_bound(L, src_len, h, d))
        print_kernel(f"flash_attention_fwd [{tag}]", res)
        extra = ""
        # a tree measured beside this one by scripts/ab_kernels.sh may
        # predate the source chunks
        if hasattr(att, "flash_fwd_splits"):
            splits = att.flash_fwd_splits(L, S, h, att._sm_count(dev))
            res["splits"] = splits
            extra = f"; {splits} source chunk(s)"
            if splits > 1:
                res["unsplit_ms"] = cuda_ms(
                    lambda: att._flash_attention_launch(
                        q, k, v, n_valid, scale, False, 1))
                extra += f", unsplit {res['unsplit_ms']:.4f} ms"
        phase("kernels", f"flash_attention_fwd [{tag}]: "
              f"{100.0 * res['bound_ms'] / res['ms']:.1f}% of its 3xTF32 "
              f"tensor-core bound ({res['bound_ms']:.5f} ms), "
              f"{100.0 * res['f32_bound_ms'] / res['ms']:.1f}% of the f32 "
              f"FMA bound ({res['f32_bound_ms']:.5f} ms){extra}")
    else:
        phase("kernels", f"flash_attention_fwd [{tag}]: max_abs_err "
              f"{err:.3e} ({res['tol']})")
    return res


def flash_split_cases(dev) -> None:
    """C7's source chunks forced where the card would not choose them: a
    prefix that ends inside the first chunk and an empty one (chunks at or
    beyond the prefix exit at once), each against the plain version, o and
    lse, bit-equal on a second launch; and the chunked o bit-equal with and
    without the lse output."""
    from deformationpyramid_tpu_torch.match import attention as att

    gen = torch.Generator().manual_seed(21)
    L, S, h, d = 200, 1000, 4, 132
    q, k0, v0 = (torch.randn(n, h, d, generator=gen).to(dev)
                 for n in (L, S, S))
    scale = d ** -0.5
    for src_len, splits in ((100, 4), (0, 4), (1000, 3), (640, 8)):
        n_valid = torch.tensor(src_len, dtype=torch.int32, device=dev)
        k, v = k0.clone(), v0.clone()
        k[src_len:], v[src_len:] = float("nan"), float("inf")
        runs = [att._flash_attention_launch(q, k, v, n_valid, scale, True,
                                            splits) for _ in range(2)]
        plain = att._flash_attention_launch(q, k, v, n_valid, scale, False,
                                            splits)
        o_ref, lse_ref = att.flash_attention_plain(q, k, v, n_valid, scale,
                                                   return_lse=True)
        torch.cuda.synchronize()
        (o, lse), (o2, lse2) = runs
        tag = f"C7 in {splits} chunks [src_len {src_len} of {S}]"
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"{tag}: differs on a second launch")
        check(torch.equal(o, plain), f"{tag}: o differs without lse")
        check(bool(torch.isfinite(o).all()), f"{tag}: non-finite output")
        err = float((o - o_ref).abs().max())
        finite = torch.isfinite(lse_ref)
        check(torch.equal(torch.isfinite(lse), finite), f"{tag}: lse's -inf")
        lse_err = float((lse - lse_ref)[finite].abs().max()) \
            if finite.any() else 0.0
        check(err <= 2e-5 and lse_err <= 2e-5,
              f"{tag}: max abs err o {err}, lse {lse_err} > 2e-5")
        if src_len == 0:
            check(not bool(o.any()), f"{tag}: an empty prefix must give 0")
        phase("kernels", f"{tag}: max_abs_err o {err:.3e}, lse {lse_err:.3e}"
              " (max abs 2e-5; bit-equal on a second launch)")


def flash_bwd_bounds(L: int, S: int, src_len: int, h: int, d: int) -> dict:
    """C8 and C9: the function's five products are 10 L src_len h d flops,
    counted 6 : 4 between the kernel with three and the one with two. C8
    reads q, do (L rows), k, v (the prefix), lse and delta and writes dk, dv
    (S rows); C9 reads the same and writes dq. Both compute their products
    as 3xTF32 on the tensor cores: three passes of their share at the TF32
    rate (the f32 FMA bound is kept beside it as ``f32_bound_ms``)."""
    rows = 4.0 * h * d
    read = (2 * L + 2 * src_len) * rows + 8.0 * L * h
    ops = L * src_len * h * d
    out = {}
    for name, nbytes, share in (
            ("flash_attention_bwd_dkv", read + 2 * S * rows, 6.0),
            ("flash_attention_bwd_dq", read + L * rows, 4.0)):
        out[name] = dict(bound(nbytes, 3 * share * ops, TF32_FLOP_PER_S),
                         f32_bound_ms=bound(nbytes, share * ops)["bound_ms"])
    return out


FLASH_BWD_TOL = 2e-5


def flash_bwd_case(dev, L, S, src_len, h, d, seed, timed: bool,
                   nan_pad: bool = False):
    """C8 and C9 against ``flash_attention_bwd_plain`` on one shape, each
    launched twice with bit-equal results; with ``timed`` also the device
    times of each kernel, of the plain version, and of autograd through
    scaled_dot_product_attention on the same tensors. ``nan_pad`` puts NaN
    into the source rows beyond the prefix, which must not leak."""
    from deformationpyramid_tpu_torch.match import attention as att

    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(n, h, d, generator=gen).to(dev)
                   for n in (L, S, S, L))
    if nan_pad:
        k[src_len:] = float("nan")
        v[src_len:] = float("nan")
    n_valid = torch.tensor(src_len, dtype=torch.int32, device=dev)
    scale = d ** -0.5
    o, lse = att.flash_attention_cuda(q, k, v, n_valid, scale,
                                      return_lse=True)
    o_ref, lse_ref = att.flash_attention_plain(q, k, v, n_valid, scale,
                                               return_lse=True)
    tag = (f"L {L}, S {S}, src_len {src_len}, {h} heads of {d}"
           + (", NaN in the padded rows" if nan_pad else ""))
    finite = torch.isfinite(lse_ref)
    check(torch.equal(torch.isfinite(lse), finite)
          and float((lse - lse_ref)[finite].abs().max() if finite.any()
                    else 0.0) <= 2e-5,
          f"C7 [{tag}]: the log-sum-exp output disagrees")
    args = (q, k, v, o, lse, do, n_valid, scale)
    got = att.flash_attention_bwd_cuda(*args)
    again = att.flash_attention_bwd_cuda(*args)
    ref = att.flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, n_valid,
                                        scale)
    torch.cuda.synchronize()
    errs = {}
    for name, a, b, r in zip(("dq", "dk", "dv"), got, again, ref):
        check(torch.equal(a, b), f"C8/C9 [{tag}]: {name} differs on a "
              "second launch")
        check(bool(torch.isfinite(a).all()), f"C8/C9 [{tag}]: {name} is not "
              "finite")
        errs[name] = float((a - r).abs().max()) if a.numel() else 0.0
        check(errs[name] <= FLASH_BWD_TOL, f"C8/C9 [{tag}]: {name} max abs "
              f"err {errs[name]} > {FLASH_BWD_TOL}")
    check(not bool(got[1][src_len:].any()) and not bool(got[2][src_len:].any()),
          f"C8 [{tag}]: dk, dv beyond the prefix must be 0")
    if src_len == 0:
        check(not bool(got[0].any()), f"C9 [{tag}]: an empty prefix must "
              "give zero dq")
    tol = f"max abs {FLASH_BWD_TOL}; bit-equal on a second launch"
    res = {"flash_attention_bwd_dkv": dict(err=max(errs["dk"], errs["dv"]),
                                           tol=tol, shape=tag),
           "flash_attention_bwd_dq": dict(err=errs["dq"], tol=tol, shape=tag)}
    if not timed:
        phase("kernels", f"flash_attention_bwd [{tag}]: max_abs_err dq "
              f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} "
              f"({tol})")
        return res
    delta = (do * o).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr(), n_valid.data_ptr(), L, S, h,
              d, scale)
    dkv_ms = cuda_ms(lambda: att.FLASH_ATTENTION_BWD_DKV.launch(
        *common, dk.data_ptr(), dv.data_ptr()))
    dq_ms = cuda_ms(lambda: att.FLASH_ATTENTION_BWD_DQ.launch(
        *common, dq.data_ptr()))
    both_ms = cuda_ms(lambda: att.flash_attention_bwd_cuda(*args))
    plain_ms = cuda_ms(lambda: att.flash_attention_bwd_plain(*args))
    # the library's yardstick: autograd through its fused attention (its
    # backward computes dq, dk and dv in one call, so both rows carry it)
    mask = (torch.arange(S, device=dev) < src_len)[None, None, None, :]
    qs, ks, vs = (t.transpose(0, 1)[None].detach().requires_grad_(True)
                  for t in (q, k, v))
    lib_o = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, scale=scale)
    lib_do = do.transpose(0, 1)[None]
    lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_o, (qs, ks, vs), lib_do,
                                                 retain_graph=True))
    bounds = flash_bwd_bounds(L, S, src_len, h, d)
    for name, ms in (("flash_attention_bwd_dkv", dkv_ms),
                     ("flash_attention_bwd_dq", dq_ms)):
        res[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         both_ms=both_ms, **bounds[name])
        print_kernel(f"{name} [{tag}]", res[name])
    for name, ms in (("flash_attention_bwd_dkv", dkv_ms),
                     ("flash_attention_bwd_dq", dq_ms)):
        r = res[name]
        phase("kernels", f"{name} [{tag}]: "
              f"{100.0 * r['bound_ms'] / ms:.1f}% of its 3xTF32 "
              f"tensor-core bound ({r['bound_ms']:.5f} ms), "
              f"{100.0 * r['f32_bound_ms'] / ms:.1f}% of the f32 FMA bound "
              f"({r['f32_bound_ms']:.5f} ms); the library's whole backward "
              f"{lib_ms:.4f} ms")
    phase("kernels", f"flash_attention_bwd [{tag}]: C8 + C9 + delta as the "
          f"backward runs them {both_ms:.4f} ms; the plain version and the "
          "library call compute dq, dk and dv together")
    return res


FLASH_EDGE_CASES = (dict(L=777, S=1333, src_len=1000, h=4, d=132),
                    dict(L=777, S=1333, src_len=0, h=4, d=132),
                    dict(L=300, S=200, src_len=130, h=4, d=24),
                    dict(L=130, S=70, src_len=70, h=8, d=144),
                    dict(L=77, S=45, src_len=1, h=2, d=1),
                    dict(L=333, S=97, src_len=97, h=3, d=18))


def flash_kernel_phase(dev):
    res = {"flash_attention_fwd": flash_case(dev, seed=11, timed=True,
                                             **FLASH_SHAPE)}
    res.update(flash_bwd_case(dev, seed=11, timed=True, **FLASH_SHAPE))
    # the caps and the coarse count of an 8000-point pair (the lndp path),
    # and of a pair with ~900 coarse points
    for key, shape, seed in (
            ("at_4096_2836", dict(L=4096, S=4096, src_len=2836, h=4, d=132),
             13),
            ("at_1024_900", dict(L=1024, S=1024, src_len=900, h=4, d=132),
             14)):
        at = {"flash_attention_fwd": flash_case(dev, seed=seed, timed=True,
                                                **shape)}
        at.update(flash_bwd_case(dev, seed=seed, timed=True, **shape))
        for name, r in at.items():
            res[name][key] = {k: r[k] for k in SHAPE_KEYS
                              + ("f32_bound_ms", "splits", "unsplit_ms")
                              if k in r}
    for i, shape in enumerate(FLASH_EDGE_CASES):
        flash_case(dev, seed=12 + i, timed=False, **shape)
        flash_bwd_case(dev, seed=12 + i, timed=False, **shape)
    flash_bwd_case(dev, seed=20, timed=False, nan_pad=True,
                   **FLASH_EDGE_CASES[0])
    flash_split_cases(dev)
    return res


def lndp_config(impl: str):
    """config/LNDP.yaml's landmark model at its published widths, with the
    attention route set."""
    from deformationpyramid_tpu_torch.match.config_loader import \
        landmark_config_from_yaml
    from deformationpyramid_tpu_torch.utils.config import load_config

    top = load_config(str(REPO / "config" / "LNDP.yaml"))
    lcfg = landmark_config_from_yaml(str(REPO / top.ldmk_config),
                                     inlier_thr=top.inlier_thr,
                                     reject_outliers=top.reject_outliers)
    m = lcfg.matcher
    check((m.kpfcn.coarse_feature_dim, m.transformer.feature_dim,
           m.transformer.n_head, m.kpfcn.num_kernel_points,
           m.kpfcn.first_feats_dim) == (528, 528, 4, 15, 256)
          and (lcfg.neco.feature_dim, lcfg.neco.n_head,
               lcfg.neco.num_layers) == (144, 8, 9),
          "lndp: the yaml files no longer give the published widths")
    tr = dataclasses.replace(m.transformer, attention_impl=impl)
    return dataclasses.replace(
        lcfg, matcher=dataclasses.replace(m, transformer=tr)), top


def lndp_phase(dp, dev, kernels):
    """collate -> matcher -> landmarks -> solve, at full width."""
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pow2_cap,
        pyramid_to_device)
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.models.pyramid import tree_map

    lcfg, top = lndp_config("flash")
    lcfg_xla, _ = lndp_config("xla")
    kp = lcfg.matcher.kpfcn
    cl = lcfg.matcher.coarse_level
    scfg = dp.SolverConfig(
        pyramid=dp.NDPConfig(m=top.m, k0=top.k0, depth=top.depth,
                             width=top.width,
                             rotation_format=top.rotation_format,
                             motion=top.motion_type),
        iters=top.iters, lr=top.lr, max_break_count=top.max_break_count,
        break_threshold_ratio=top.break_threshold_ratio, samples=top.samples,
        w_ldmk=float(top.w_ldmk), w_cd=top.w_cd, trunc_cd=top.trunc_cd,
        use_fused_iteration=True, use_fused_ldmk=True)
    check((scfg.pyramid.m, scfg.pyramid.motion, scfg.pyramid.rotation_format,
           scfg.w_cd) == (10, "SE3", "axis_angle", 0.0),
          "lndp: config/LNDP.yaml no longer gives the LNDP solver")
    t0 = time.perf_counter()
    params = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device=dev)
    n_params = []
    tree_map(lambda t: n_params.append(t.numel()), params)
    phase("lndp", f"landmark model: {sum(n_params) / 1e6:.2f} M values from "
          f"seed 0 in {time.perf_counter() - t0:.2f} s")

    def collate(seed):
        src, tgt, _ = make_pair(n=8000, seed=seed, deform=0.08)
        t0 = time.perf_counter()
        limits = calibrate_neighborhood_limits([(src, tgt)], kp,
                                               KPFCN_ARCHITECTURE)
        pyr = build_pair_pyramid(src, tgt, kp, KPFCN_ARCHITECTURE, limits,
                                 pad_to="pow2")
        secs = time.perf_counter() - t0
        return src, tgt, pyr, limits, secs

    def run_pair(seed):
        src, tgt, pyr, limits, collate_s = collate(seed)
        pyrd = pyramid_to_device(pyr, dev)
        caps = (pow2_cap(pyr.src_lengths[cl]), pow2_cap(pyr.tgt_lengths[cl]))
        lens = (torch.tensor(pyr.src_lengths[cl], device=dev),
                torch.tensor(pyr.tgt_lengths[cl], device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lm.landmark_inference(params, pyrd, *lens, lcfg,
                                    s_cap=caps[0], t_cap=caps[1])
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
        rows = max(LDMK_ROWS, caps[0])
        pad = rows - caps[0]
        s_l = torch.nn.functional.pad(out["ldmk_s"], (0, 0, 0, pad))
        t_l = torch.nn.functional.pad(out["ldmk_t"], (0, 0, 0, pad))
        l_v = torch.nn.functional.pad(out["ldmk_valid"], (0, pad))
        src_d, tgt_d = (torch.from_numpy(a).to(dev) for a in (src, tgt))
        t0 = time.perf_counter()
        warped, stats = dp.register_pair(seed, src_d, tgt_d, scfg,
                                         src_ldmk=s_l, tgt_ldmk=t_l,
                                         ldmk_valid=l_v)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        for name in ("conf_matrix_pred", "src_feats", "tgt_feats", "ldmk_s",
                     "ldmk_t", "neco_confidence", "match_conf", "vec_6d",
                     "R_s2t_pred", "t_s2t_pred", "condition"):
            check(bool(torch.isfinite(out[name]).all()),
                  f"lndp: {name} is not finite")
        check(bool(torch.isfinite(warped).all())
              and warped.shape == src_d.shape,
              "lndp: the solver's output is not finite")
        check(out["conf_matrix_pred"].shape == caps
              and out["ldmk_s"].shape == (caps[0], 3),
              f"lndp: output shapes at caps {caps}")
        iters = stats["iters"].cpu().tolist()
        check(all(1 <= i <= scfg.iters for i in iters),
              f"lndp: level iterations {iters}")
        return dict(src=src, tgt=tgt, pyr=pyr, pyrd=pyrd, caps=caps,
                    lens=lens, out=out, collate_s=collate_s,
                    infer_ms=infer_ms, solve_s=solve_s, iters=iters,
                    limits=limits, n_ldmk=int(out["ldmk_valid"].sum()),
                    n_match=int(out["match_valid"].sum()))

    run_pair(399)                                    # warm-up
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    pairs = [run_pair(seed) for seed in (400, 401)]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(launches["flash_attention_fwd"] == 8 * len(pairs),
          f"lndp: C7 launched {launches['flash_attention_fwd']} times over "
          f"{len(pairs)} pairs, expected 8 a pair")
    check(launches["ldmk_iteration"] > 0, "lndp: C5 never launched")
    for i, r in enumerate(pairs):
        pyr = r["pyr"]
        phase("lndp", f"pair {i + 1}: fine {len(pyr.points[0])} stacked "
              f"points (padded), coarse src {pyr.src_lengths[cl]} / tgt "
              f"{pyr.tgt_lengths[cl]}, caps {r['caps']}, neighbourhood "
              f"limits {r['limits']}; collate {r['collate_s']:.3f} s, "
              f"landmark_inference {r['infer_ms']:.3f} ms, solve "
              f"{r['solve_s']:.3f} s = "
              f"{r['solve_s'] * 1e3 / sum(r['iters']):.4f} ms/iter over "
              f"{r['iters']}; matches {r['n_match']}, landmarks "
              f"{r['n_ldmk']}; condition "
              f"{float(r['out']['condition']):.3f}")

    # The stages of one pair apart, after the counted run.
    last = pairs[-1]
    args = (params, last["pyrd"], *last["lens"])
    caps_kw = dict(s_cap=last["caps"][0], t_cap=last["caps"][1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = lm.matcher_inference(*args, lcfg, **caps_kw)
    torch.cuda.synchronize()
    matcher_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = lm.neco_filter(params, data, lcfg)
    torch.cuda.synchronize()
    neco_ms = (time.perf_counter() - t0) * 1e3

    # the same pair twice: bit-equal
    conf = last["out"]["conf_matrix_pred"]
    check(torch.equal(again["conf_matrix_pred"], conf),
          "lndp: the same pair twice gave another confidence matrix, max abs "
          f"{float((again['conf_matrix_pred'] - conf).abs().max())}")

    # the einsum route on the same pair
    ref = lm.landmark_inference(*args, lcfg_xla, **caps_kw)
    torch.cuda.synchronize()
    rconf = ref["conf_matrix_pred"]
    err = float((conf - rconf).abs().max())
    check(err <= 1e-4, f"lndp: flash against xla confidence matrix {err}")
    thr = lcfg.matcher.matching.confidence_threshold
    top2 = torch.topk(rconf, 2, dim=1).values
    col2 = torch.topk(rconf, 2, dim=0).values
    c = top2[:, 0]
    stable = ((top2[:, 0] - top2[:, 1] > 1e-4) & ((c - thr).abs() > 1e-4)
              & ((c < thr) | ((col2[0] - col2[1])[rconf.argmax(1)] > 1e-4)))
    check(torch.equal(last["out"]["match_valid"][stable],
                      ref["match_valid"][stable])
          and torch.equal(last["out"]["match_idx"][stable],
                          ref["match_idx"][stable]),
          "lndp: flash and xla disagree on a match that is no near-tie")
    phase("lndp", f"stages of pair 2: matcher {matcher_ms:.3f} ms, NeCo "
          f"{neco_ms:.3f} ms; repeat bit-equal; flash against xla: "
          f"confidence matrix max abs {err:.3e} (<= 1e-4), matches equal on "
          f"{int(stable.sum())} of {stable.numel()} rows that are no "
          f"near-ties; max confidence {float(conf.max()):.3e}; launches "
          f"{launches}")

    # C7 at the shape this path gave it (the source cloud's self-attention)
    shape = dict(L=last["caps"][0], S=last["caps"][0],
                 src_len=int(last["lens"][0]), h=4, d=132)
    at_path = flash_case(dev, seed=13, timed=True, **shape)
    return dict(
        launches=launches, collate_s=[r["collate_s"] for r in pairs],
        landmark_inference_ms=[r["infer_ms"] for r in pairs],
        solve_ms_per_iter=[r["solve_s"] * 1e3 / sum(r["iters"])
                           for r in pairs],
        iters=[r["iters"] for r in pairs], matcher_ms=matcher_ms,
        neco_ms=neco_ms, landmarks=[r["n_ldmk"] for r in pairs],
        matches=[r["n_match"] for r in pairs],
        caps=[list(r["caps"]) for r in pairs], flash_vs_xla_err=err,
        flash_at_path_shape={k: at_path[k] for k in SHAPE_KEYS})


TRAIN_LR = 1e-4          # cli/train_matcher.py's default
TRAIN_POINTS = 6000      # points a fabricated cloud, +-8%
# flash against einsum route, of each gradient leaf's max. The loss is
# steep (a dual softmax at temperature 0.1 under a focal log): moving every
# weight by one float32 ulp moves the einsum route's own gradient leaves by
# ~1e-2 of their max on the card, so the routes are also held to stay below
# that floor as this run measures it.
GRAD_TOL = 1e-2


def train_phase(dp, dev, kernels):
    """Fabricate a 4DMatch-format suite of ~TRAIN_POINTS a cloud, then train
    the matcher, compare the two attention routes on one step, train NeCo on
    the frozen matcher, and serve from the combined checkpoint: all at full
    width."""
    from deformationpyramid_tpu_torch.cli.train_matcher import \
        make_matcher_batch_stream
    from deformationpyramid_tpu_torch.cli.train_neco import make_batch_stream
    from deformationpyramid_tpu_torch.data.collate import \
        calibrate_neighborhood_limits
    from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
    from deformationpyramid_tpu_torch.data.synthetic import \
        write_4dmatch_suite
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.match.losses import match_motion_loss
    from deformationpyramid_tpu_torch.match.pipeline import apply_matcher
    from deformationpyramid_tpu_torch.models.pyramid import (tree_leaves,
                                                             tree_map)
    from deformationpyramid_tpu_torch.train import trainer
    from deformationpyramid_tpu_torch.utils.checkpoint import (load_pytree,
                                                               save_pytree)
    from deformationpyramid_tpu_torch.utils.config import load_config

    names = ("flash_attention_fwd", "flash_attention_bwd_dkv",
             "flash_attention_bwd_dq")

    def reset():
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0

    def counts():
        torch.cuda.synchronize()
        return [k.launches for k in kernels if k.name in names]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in
                   zip(tree_leaves(a), tree_leaves(b)))

    root = REPO / "build" / "chip_smoke" / "train"
    shutil.rmtree(root, ignore_errors=True)
    write_4dmatch_suite(str(root), "train", n_pairs=4,
                        size_clusters=(TRAIN_POINTS,), seed=7)
    write_4dmatch_suite(str(root), "val", n_pairs=2,
                        size_clusters=(TRAIN_POINTS,), seed=71)
    ds = FourDMatchDataset(str(root), "train", augment=False)
    check(len(ds) == 4, f"train: {len(ds)} fabricated pairs read back")
    lcfg, top = lndp_config("flash")
    lcfg_xla, _ = lndp_config("xla")
    radius = load_config(str(REPO / "config" / "configs" / "lepard.yaml")
                         ).coarse_matching.get("coarse_match_radius", 0.024)
    limits = calibrate_neighborhood_limits(
        [(ds[i].src, ds[i].tgt) for i in range(3)], lcfg.matcher.kpfcn,
        KPFCN_ARCHITECTURE)
    params = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device=dev)

    # 1. the matcher, through the CLI's batch stream (cached batches)
    stream = make_matcher_batch_stream(ds, lcfg, limits, radius, device=dev)
    t0 = time.perf_counter()
    batches = list(stream())
    collate_s = (time.perf_counter() - t0) / len(batches)
    caps = sorted({(b["s_cap"], b["t_cap"]) for b in batches})
    lens = [(int(b["src_len_c"]), int(b["tgt_len_c"]),
             int(b["match_gt_valid"].sum())) for b in batches]
    phase("train", f"4 + 2 fabricated pairs ({len(ds[0].src)} / "
          f"{len(ds[0].tgt)} points the first); neighbourhood limits "
          f"{limits}; coarse (src, tgt, GT matches within {radius}) {lens}, "
          f"caps {caps}; collate {collate_s:.3f} s a pair")
    snap = root / "snapshot_matcher"
    tcfg = trainer.TrainConfig(
        max_epoch=3, optimizer="Adam", lr=TRAIN_LR,
        weight_decay=top.get("weight_decay", 1e-6), scheduler="ExpLR",
        scheduler_gamma=top.get("scheduler_gamma", 0.99),
        snapshot_dir=str(snap))
    log = []
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    matcher = trainer.train_matcher(params["matcher"], lcfg, tcfg, stream,
                                    steps_per_epoch=len(ds),
                                    log_fn=log.append)
    torch.cuda.synchronize()
    matcher_s = time.perf_counter() - t0
    launches = dict(zip(names, counts()))
    steps = tcfg.max_epoch * len(ds)
    check(not any("not valid" in line for line in log),
          "train: a matcher step's gradient was not finite")
    rows = [json.loads(line) for line in
            (snap / "history.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    check(len(rows) == 3 and all(np.isfinite(losses)),
          f"train: matcher epoch losses {losses}")
    check(losses[-1] < losses[0], f"train: the matcher's epoch mean loss did "
          f"not fall over 3 epochs at lr {TRAIN_LR}: {losses}")
    check(all(launches[n] == 8 * steps for n in names),
          f"train: launches over {steps} matcher steps {launches}, expected "
          f"{8 * steps} of each")
    for name in ("matcher_best_loss.npz", "matcher_last.npz"):
        check((snap / name).exists(), f"train: {name} was not written")
    check(not same(matcher, params["matcher"]), "train: the matcher did not "
          "move")
    phase("train", f"train_matcher: 3 epochs x 4 steps (Adam, lr {TRAIN_LR}, "
          f"ExpLR) in {matcher_s:.3f} s, checkpoints included; epoch mean "
          f"loss {[round(x, 5) for x in losses]}, recall "
          f"{[round(r['recall_coarse'], 4) for r in rows]}, precision "
          f"{[round(r['precision_coarse'], 4) for r in rows]}; launches "
          f"{launches}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # 2. one step from the same start on each attention route
    b = batches[0]
    args = (b["pyramid"], b["src_len_c"], b["tgt_len_c"], b["match_gt"],
            b["match_gt_valid"], b["coarse_flow"], b["gt_rot"], b["gt_trn"])
    opt = trainer.make_optimizer(tcfg, len(ds))
    routes = {}
    for name, cfg in (("flash", lcfg), ("xla", lcfg_xla)):
        def loss_fn(mp, cfg=cfg):
            data = apply_matcher(mp, *args[:3], cfg.matcher,
                                 s_cap=b["s_cap"], t_cap=b["t_cap"])
            return match_motion_loss(data, *args[3:])

        (loss, _), grads = trainer.value_and_grad(loss_fn, params["matcher"])
        step = trainer.make_matcher_train_step(cfg, opt, s_cap=b["s_cap"],
                                               t_cap=b["t_cap"])
        state = opt.init(params["matcher"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        t0 = time.perf_counter()
        out = step(params["matcher"], state, *args)
        torch.cuda.synchronize()
        routes[name] = dict(
            loss=float(loss), grads=grads, ok=bool(out[4]),
            step_ms=(time.perf_counter() - t0) * 1e3, launches=counts(),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        del out, state
    fl, xl = routes["flash"], routes["xla"]
    check(fl["ok"] and xl["ok"], "train: a route's step was not valid")
    check(fl["launches"] == [8, 8, 8] and xl["launches"] == [0, 0, 0],
          f"train: one step launched {fl['launches']} (flash), "
          f"{xl['launches']} (einsum)")
    check(abs(fl["loss"] - xl["loss"]) <= 1e-4,
          f"train: loss {fl['loss']} (flash) against {xl['loss']} (einsum)")

    def worst_leaf(got, ref):
        """Largest difference of a gradient leaf over that leaf's max."""
        worst, n = 0.0, 0
        for g, r in zip(tree_leaves(got), tree_leaves(ref)):
            scale = float(r.abs().max())
            if scale == 0.0:
                check(not bool(g.any()), "train: a leaf with no einsum-route "
                      "gradient has one on the other side")
                continue
            worst = max(worst, float((g - r).abs().max()) / scale)
            n += 1
        return worst, n

    # the floor: the einsum route again, every weight moved by one ulp
    _, moved = trainer.value_and_grad(
        loss_fn, tree_map(lambda t: t * (1.0 + 2.0 ** -23),
                          params["matcher"]))
    floor, _ = worst_leaf(moved, xl["grads"])
    del moved
    worst, n_leaves = worst_leaf(fl["grads"], xl["grads"])
    check(worst <= GRAD_TOL and worst <= floor,
          f"train: a gradient leaf differs by {worst} of its max between the "
          f"routes (tolerance {GRAD_TOL}; a one-ulp move of the weights gives "
          f"{floor})")
    phase("train", f"one matcher step from the same start: flash "
          f"{fl['step_ms']:.3f} ms, peak {fl['peak_gib']:.2f} GiB; einsum "
          f"{xl['step_ms']:.3f} ms, peak {xl['peak_gib']:.2f} GiB; loss "
          f"{fl['loss']:.6f} / {xl['loss']:.6f}; worst gradient leaf of "
          f"{n_leaves} differs by {worst:.3e} of its max (<= {GRAD_TOL}, and "
          f"<= {floor:.3e}, what one ulp on every weight does to the einsum "
          "route's own gradient)")
    for r in routes.values():
        del r["grads"]

    # 3. NeCo on the frozen matcher, loaded back from its checkpoint
    loaded = load_pytree(str(snap / "matcher_last.npz"), params["matcher"])
    check(same(loaded, matcher) and tree_leaves(loaded)[0].device == dev,
          "train: matcher_last.npz does not hold the trained matcher")
    frozen = tree_map(torch.clone, loaded)
    # --no-augment, as cli/train_neco.py advises for a matcher that was
    # trained without augmentation: on rotated pairs it finds no inlier, the
    # labels have one class and the balanced loss and its gradient are zero
    nds = FourDMatchDataset(str(root), "train", augment=False)
    vds = FourDMatchDataset(str(root), "val", augment=False)
    nb = list(make_batch_stream(nds, lcfg, limits, device=dev)())
    vb = list(make_batch_stream(vds, lcfg, limits, device=dev)())
    nsnap = root / "snapshot_neco"
    ncfg = trainer.TrainConfig(
        max_epoch=1, optimizer=top.get("optimizer", "SGD"),
        lr=top.get("lr", 0.01), momentum=top.get("momentum", 0.9),
        weight_decay=top.get("weight_decay", 1e-6),
        scheduler=top.get("scheduler", "ExpLR"),
        scheduler_gamma=top.get("scheduler_gamma", 0.99), iter_size=2,
        snapshot_dir=str(nsnap))
    log = []
    reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    neco = trainer.train_neco(loaded, params["neco"], lcfg, ncfg,
                              lambda: iter(nb), steps_per_epoch=len(nb),
                              log_fn=log.append, val_batches=lambda: iter(vb))
    torch.cuda.synchronize()
    neco_s = time.perf_counter() - t0
    nl = counts()
    check(nl == [8 * (len(nb) + len(vb)), 0, 0], f"train: NeCo training "
          f"launched {nl}: the frozen matcher must run C7 alone")
    nrows = [json.loads(line) for line in
             (nsnap / "history.jsonl").read_text().splitlines()]
    check([r["phase"] for r in nrows] == ["train", "val"]
          and all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in nrows)
          and not any("not valid" in line for line in log),
          f"train: NeCo history {nrows}")
    check((nsnap / "model_best_loss.npz").exists(), "train: "
          "model_best_loss.npz was not written")
    check(not same(neco, params["neco"]), "train: NeCo did not move")
    check(same(loaded, frozen), "train: the frozen matcher changed")
    phase("train", f"train_neco: 1 epoch x {len(nb)} steps, iter_size 2, "
          f"{len(vb)} val pairs ({ncfg.optimizer}, lr {ncfg.lr}) in "
          f"{neco_s:.3f} s = {neco_s * 1e3 / (len(nb) + len(vb)):.3f} ms a "
          f"pair, checkpoints included; rows {nrows}; launches {nl}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          "matcher bit-equal")

    # 4. the combined checkpoint, and serving from it
    ckpt = root / "landmark.npz"
    trained = {"matcher": loaded, "neco": neco}
    save_pytree(str(ckpt), trained)
    served = load_pytree(str(ckpt), params)
    check(same(served, trained), "train: landmark.npz does not round-trip")
    v = vb[0]
    outs = []
    for p in (trained, served):
        reset()
        outs.append(lm.landmark_inference(
            p, v["pyramid"], v["src_len_c"], v["tgt_len_c"], lcfg,
            s_cap=v["s_cap"], t_cap=v["t_cap"]))
        check(counts() == [8, 0, 0], f"train: landmark_inference launched "
              f"{counts()}")
    for key in ("conf_matrix_pred", "neco_confidence", "ldmk_s", "ldmk_t",
                "ldmk_valid"):
        check(bool(torch.isfinite(outs[1][key].float()).all())
              and torch.equal(outs[0][key], outs[1][key]),
              f"train: {key} from the loaded checkpoint differs")
    phase("train", f"landmark.npz ({ckpt.stat().st_size / 2 ** 20:.0f} MiB) "
          "round-trips bit-equal; landmark_inference on a val pair from it "
          f"equals the in-memory model's: {int(outs[1]['match_valid'].sum())}"
          f" matches, {int(outs[1]['ldmk_valid'].sum())} landmarks")

    # C7-C9 at the shape this path gave them (the source cloud's
    # self-attention of the first training pair)
    shape = dict(L=b["s_cap"], S=b["s_cap"], src_len=lens[0][0], h=4, d=132)
    at_path = {"flash_attention_fwd": flash_case(dev, seed=14, timed=True,
                                                 **shape)}
    at_path.update(flash_bwd_case(dev, seed=14, timed=True, **shape))
    shutil.rmtree(root, ignore_errors=True)
    return dict(
        launches=launches, collate_s=collate_s, caps=[list(c) for c in caps],
        coarse=lens, matcher_s=matcher_s, matcher_epoch_loss=losses,
        matcher_epoch_recall=[r["recall_coarse"] for r in rows],
        routes=routes, grad_worst_rel=worst, grad_one_ulp_floor=floor, neco_s=neco_s, neco_rows=nrows,
        neco_launches=dict(zip(names, nl)),
        at_path_shape={n: {k: r[k] for k in SHAPE_KEYS}
                       for n, r in at_path.items()})


NERFIES_ITERS = 300      # of config/baselines/Nerfies.yaml's 5000: time
NSFP_KERNELS = ("nsfp_fwd", "nn_dual", "scatter_rows", "nsfp_bwd",
                "adam_step")


# The fast path and --no-fast held to each other on pair 1 of 4DMatch-F
# with the early stop's plateau rule off (max_break_count beyond any
# count) and FIXED_ITERS iterations a level: the largest gap of the flows
# (cm) and of each level's final loss (relative to --no-fast's). The solve
# is chaotic after a few iterations a level whatever the path (the same
# path on the same points in another order parts by ~1 cm after 8:
# scripts/solve_sensitivity.py), so the check stops before that; there
# the two paths agree to ~1e-5 cm and ~1e-7.
NO_STOP = 1_000_000
FIXED_ITERS = 2
FIXED_FLOW_CM = 1e-3
FIXED_LOSS_REL = 1e-5


def pair1_flow(ev, root, yaml: str, dev, no_fast: bool = False,
               edit=None) -> tuple:
    """Pair 1 of 4DMatch-F under ``root`` through the fast path (or
    --no-fast) as ``eval_nolearned`` composes it (``fast_inputs`` and
    ``make_fast_solver``; ``BucketBatcher`` and the runner of
    ``solver_from_config``), from the pair's seed, with the yaml at
    ``yaml``; ``edit`` may change the fast path's [2, samples, 4] sample
    block first. Its 1392 / 1183 points are fewer than ``samples``: both
    paths solve every point, in another order and padding. Returns (flow
    [1392, 3], ground-truth flow, solver stats)."""
    from deformationpyramid_tpu_torch.data.fourdmatch import (
        BucketBatcher, FourDMatchDataset)
    from deformationpyramid_tpu_torch.utils.config import load_config

    scfg, run_batch, _ = ev.solver_from_config(load_config(yaml), dev)
    ds = FourDMatchDataset(str(root), "4DMatch-F")
    ds.entries = ds.entries[1:2]
    pair = ds[0]
    pid = ev.pair_id(pair.name)
    seed = ev.pair_seed(pid, 0)
    st, packed, ns, delta = ev.fast_inputs(pair, pid, 0, scfg.samples)
    gt = torch.from_numpy(pair.flow_gt).to(dev)
    if no_fast:
        batch = next(iter(BucketBatcher(ds, 1)))
        src, tgt, sv, tv = (torch.from_numpy(a).to(dev) for a in (
            batch.src, batch.tgt, batch.src_valid, batch.tgt_valid))
        warped, stats = run_batch([seed], src, tgt, sv, tv)
        return ((warped - src)[0, :ns], gt,
                {k: v[0] for k, v in stats.items()})
    solve_fixed, _, warp_bucket = ev.make_fast_solver("NDP", scfg, dev)
    packed = torch.from_numpy(packed).to(dev)
    state = solve_fixed(seed, torch.from_numpy(
        st if edit is None else edit(st)).to(dev))
    return (warp_bucket(state, packed)[:ns] - packed[:ns, :3]
            + torch.from_numpy(delta).to(dev), gt, state[1])


def fixed_two_paths(ev, root, yaml: str, dev) -> dict:
    """``pair1_flow`` on both paths with ``yaml`` (the early stop off,
    FIXED_ITERS a level): every level ran its iterations on both, the
    flows within FIXED_FLOW_CM and each level's final loss within
    FIXED_LOSS_REL."""
    (flow_f, gt, st_f), (flow_n, _, st_n) = (
        pair1_flow(ev, root, yaml, dev, no_fast) for no_fast in (0, 1))
    iters = [st_f["iters"].tolist(), st_n["iters"].tolist()]
    check(iters[0] == iters[1] == [FIXED_ITERS] * len(iters[0]),
          f"nolearned fixed: iterations {iters}, not {FIXED_ITERS} a level")
    res = dict(
        flow_cm=100.0 * float((flow_f - flow_n).abs().max()),
        loss_rel=float(((st_f["loss"] - st_n["loss"]).abs()
                        / st_n["loss"].abs()).max()),
        epe_cm=[100.0 * float((f - gt).norm(dim=-1).mean())
                for f in (flow_f, flow_n)],
        losses=[st_f["loss"].tolist(), st_n["loss"].tolist()])
    check(res["flow_cm"] <= FIXED_FLOW_CM
          and res["loss_rel"] <= FIXED_LOSS_REL,
          f"nolearned fixed: the fast path and --no-fast part on pair 1 "
          f"with the early stop off: flows by {res['flow_cm']} cm (limit "
          f"{FIXED_FLOW_CM}), losses by {res['loss_rel']} (limit "
          f"{FIXED_LOSS_REL}): {res}")
    return res


def nolearned_phase(dp, dev, kernels):
    """The no-learned evaluation CLI on fabricated 4DMatch-F (the first 4
    pairs of write_4dmatch_suite's default stream) and 4DLoMatch-F (2
    pairs, partial 0.40, seed 1), through ``eval_nolearned.main`` and its
    argument parser, at the yaml files' widths."""
    from deformationpyramid_tpu_torch.cli import eval_nolearned as ev
    from deformationpyramid_tpu_torch.data.fourdmatch import \
        FourDMatchDataset
    from deformationpyramid_tpu_torch.data.synthetic import \
        write_4dmatch_suite

    work = REPO / "build" / "chip_smoke" / "nolearned"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "split"
    write_4dmatch_suite(str(root), "4DMatch-F", n_pairs=4)
    write_4dmatch_suite(str(root), "4DLoMatch-F", n_pairs=2, partial=0.40,
                        seed=1)
    init_epe, sizes = {}, {}
    for split in ("4DMatch-F", "4DLoMatch-F"):
        ds = FourDMatchDataset(str(root), split)
        pairs = [ds[i] for i in range(len(ds))]
        init_epe[split] = [100.0 * float(np.linalg.norm(p.flow_gt, axis=-1)
                                         .mean()) for p in pairs]
        sizes[split] = [(len(p.src), len(p.tgt)) for p in pairs]
    phase("nolearned", f"fabricated {sizes}; initial flow EPE (cm) "
          f"{ {k: [round(v, 2) for v in vs] for k, vs in init_epe.items()} }")

    def variant(name, src, *edits, append=""):
        text = (REPO / src).read_text()
        for old, new_text in edits:
            check(old in text, f"nolearned: {src} has no {old!r}")
            text = text.replace(old, new_text)
        path = work / f"{name}.yaml"
        path.write_text(text + append)
        return str(path)

    def run(tag, cfg, splits, limit=None, extra=(), snap=None):
        argv = ["--config", cfg, "--data-root", str(root), "--device", "cuda",
                "--splits", *splits, "--log-dir", str(work / (snap or tag)),
                *extra]
        if limit is not None:
            argv += ["--limit", str(limit)]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        report = ev.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        pairs = sum(r["pairs"] for r in report.values())
        iters = sum(sum(v) for r in report.values()
                    for v in r["iters"].values())
        for split, r in report.items():
            check(all(np.isfinite(v) for v in r["scores"].values())
                  and len(r["scores"]) == 12,
                  f"nolearned {tag}: {split} scores {r['scores']}")
        out = dict(report=report, launches=launches, pairs=pairs, iters=iters,
                   seconds=dt, pairs_per_s=pairs / dt if pairs else None,
                   ms_per_iter=dt * 1e3 / iters if iters else None)
        if pairs:
            score = {s: " ".join(f"{k} {v:.3f}" for k, v in r["scores"].items())
                     for s, r in report.items()}
            phase("nolearned", f"{tag}: {pairs} pairs in {dt:.3f} s = "
                  f"{pairs / dt:.4f} pairs/s, {iters} iterations, "
                  f"{dt * 1e3 / iters:.4f} ms/iter; iterations "
                  f"{ {s: list(r['iters'].values()) for s, r in report.items()} }"
                  f"; launches { {k: v for k, v in launches.items() if v} }"
                  f"; score {score}")
        return out

    def sane_iterations(tag, res, cap):
        """Each solve's iteration counts in [1, cap], not all at either
        end."""
        for split, r in res["report"].items():
            counts = [c for v in r["iters"].values() for c in v]
            check(all(1 <= c <= cap for c in counts)
                  and not all(c <= 2 for c in counts)
                  and not all(c == cap for c in counts),
                  f"nolearned {tag}: {split} iterations {r['iters']}")

    def converged(tag, res, cap, factor=5.0):
        """EPE `factor` x below the initial flow's on every split, and sane
        iteration counts."""
        sane_iterations(tag, res, cap)
        for split, r in res["report"].items():
            init = float(np.mean(init_epe[split][:len(r["iters"])]))
            epe = r["scores"]["full-epe"]
            check(epe * factor <= init, f"nolearned {tag}: {split} full-epe "
                  f"{epe} not {factor}x below the initial {init}")

    out = {}
    both = ("4DMatch-F", "4DLoMatch-F")
    one = ("4DMatch-F",)

    # NDP: config/NDP.yaml as it stands, both splits
    ndp = out["NDP"] = run("NDP", str(REPO / "config/NDP.yaml"), both)
    check(ndp["pairs"] == 6, f"nolearned NDP: {ndp['pairs']} pairs")
    converged("NDP", ndp, 500)
    for name in CHAMFER_KERNELS:
        check(ndp["launches"][name] > 0, f"nolearned NDP: {name} not launched")
    check(ndp["launches"]["level_warp_fwd"] == ndp["launches"]["level_warp_bwd"]
          >= ndp["iters"], f"nolearned NDP: launches {ndp['launches']}")
    # --resume on the finished splits solves nothing and scores the same
    again = run("NDP --resume", str(REPO / "config/NDP.yaml"), both,
                extra=["--resume"], snap="NDP")
    check(again["pairs"] == 0 and not any(again["launches"].values()),
          f"nolearned resume: solved {again['pairs']} pairs, launches "
          f"{again['launches']}")
    for split in both:
        a, b = again["report"][split]["scores"], ndp["report"][split]["scores"]
        check(all(abs(a[k] - b[k]) < 1e-9 for k in b),
              f"nolearned resume: {split} scores {a} against {b}")
    phase("nolearned", "NDP --resume: 0 pairs solved, no kernel launched, "
          "both splits' scores reproduced")
    # The fast path against --no-fast (padded buckets through
    # register_pair, the same initial weights). With the early stop on, a
    # single pair is no test of the paths: the stop flips on
    # summation-order noise, so even pair 1, whose 1392 / 1183 points both
    # paths solve in another order, moves by up to ~1 cm between them (as
    # between two builds of one path). Its EPEs and pair 0's are printed;
    # the paths are held to each other with the stop off
    # (``fixed_two_paths``).
    legacy = out["NDP --no-fast"] = run(
        "NDP --no-fast", str(REPO / "config/NDP.yaml"), one, limit=2,
        extra=["--no-fast"])
    check(legacy["pairs"] == 2 and legacy["launches"]["adam_step"]
          <= legacy["iters"] + 7 * 9 * 2,
          f"nolearned --no-fast: {legacy['pairs']} pairs, launches "
          f"{legacy['launches']} for {legacy['iters']} iterations")
    epes = []
    for snap in ("NDP", "NDP --no-fast"):
        with open(work / snap / "4DMatch-F.pairs.jsonl") as f:
            rows = {os.path.basename(r["name"]): r["full-epe"]
                    for r in map(json.loads, f)}
        epes.append([rows["pair0000.npz"], rows["pair0001.npz"]])
    fixed = fixed_two_paths(ev, root, variant(
        "NDP fixed", "config/NDP.yaml",
        ("max_break_count: 15", f"max_break_count: {NO_STOP}"),
        ("iters: &iters 500", f"iters: &iters {FIXED_ITERS}")), dev)
    phase("nolearned", f"fast against --no-fast, full-epe (cm), early stop "
          f"on: pair 1 (the same 1392 points) {epes[0][1]:.4f} and "
          f"{epes[1][1]:.4f}; pair 0 (two subsamples of 26968 points) "
          f"{epes[0][0]:.4f} and {epes[1][0]:.4f}. Early stop off, pair 1: "
          f"{FIXED_ITERS} iterations a level on both; full-epe "
          f"{fixed['epe_cm'][0]:.6f} and {fixed['epe_cm'][1]:.6f}; flows "
          f"within {fixed['flow_cm']:.3e} cm (<= {FIXED_FLOW_CM}), the "
          f"levels' final losses within {fixed['loss_rel']:.3e} "
          f"(<= {FIXED_LOSS_REL}) relative")
    legacy["fast_epe_cm"], legacy["no_fast_epe_cm"] = epes
    legacy["fixed_two_paths"] = fixed

    # The yaml's other motions and formats, 2 pairs each. sflow converges
    # like SE3. The quaternion and 6D formats normalise a head output of
    # ~mlp_scale, so every point starts from an arbitrary rotation (in the
    # reference and the JAX package too) and the solve does not reach the
    # target: their runs are held to finite metrics, sane iteration counts
    # and the launch counts, and one pair runs through the unfused loop
    # (the plain warp under autograd) beside them, where the same happens.
    fmt_line = 'rotation_format: &rotation_format "axis_angle"'
    for tag, edit, gate in (
            ("NDP quaternion", (fmt_line, fmt_line.replace(
                "axis_angle", "quaternion")), sane_iterations),
            ("NDP 6D", (fmt_line, fmt_line.replace("axis_angle", "6D")),
             sane_iterations),
            ("NDP sflow", ('motion_type: &motion_type "SE3"',
                           'motion_type: &motion_type "sflow"'), converged)):
        cfg = variant(tag.replace(" ", "_"), "config/NDP.yaml", edit)
        res = out[tag] = run(tag, cfg, one, limit=2)
        gate(tag, res, 500)
        la = res["launches"]
        check(la["level_warp_fwd"] == la["level_warp_bwd"] == la["adam_step"]
              >= res["iters"] > 0, f"nolearned {tag}: launches {la}")
    cfg = variant("NDP_quaternion_unfused", "config/NDP.yaml",
                  (fmt_line, fmt_line.replace("axis_angle", "quaternion")),
                  append="use_fused_iteration: false\n")
    res = out["NDP quaternion unfused"] = run("NDP quaternion unfused", cfg,
                                              one, limit=1)
    sane_iterations("NDP quaternion unfused", res, 500)
    check(res["launches"]["level_warp_fwd"] == 0,
          f"nolearned NDP quaternion unfused: launches {res['launches']}")

    # NSFP: fused at the full 5000-iteration cap (2 pairs), one of them
    # again (bit-equal), then unfused (1 pair). The flow MLP has no
    # coarse-to-fine schedule and fits these pairs' 0.2 rad rotation less
    # well than the pyramid does (14 cm of 26 on the 27k-point pair 0, 1.2
    # of 20 on pair 1): its EPE is held to 1.5x below the initial flow's,
    # not to 5x, and the two routes to each other on pair 0 within 15%.
    fused_cfg = variant("NSFP_fused", "config/baselines/NSFP.yaml",
                        append="use_fused_iteration: true\n")
    nsfp = out["NSFP fused"] = run("NSFP fused", fused_cfg, one, limit=2)
    converged("NSFP fused", nsfp, 5000, factor=1.5)
    la = nsfp["launches"]
    check(la["nsfp_bwd"] == la["adam_step"] == la["nn_dual"]
          == la["scatter_rows"] == la["nsfp_fwd"] - nsfp["pairs"],
          f"nolearned NSFP fused: launches {la}")
    # an iteration that starts halted still launches (the host reads the
    # stop flag every 8): at most 7 more than the iterations a solve
    check(nsfp["iters"] <= la["nsfp_bwd"] <= nsfp["iters"] + 7 * nsfp["pairs"],
          f"nolearned NSFP fused: {la['nsfp_bwd']} launches for "
          f"{nsfp['iters']} iterations")
    check(la["level_warp_fwd"] == la["level_warp_bwd"] == 0,
          f"nolearned NSFP fused: level kernels launched {la}")
    first = sorted(nsfp["report"]["4DMatch-F"]["iters"])[0]
    twice = run("NSFP fused again", fused_cfg, one, limit=1)
    rows = []
    for snap in ("NSFP fused", "NSFP fused again"):
        with open(work / snap / "4DMatch-F.pairs.jsonl") as f:
            rows.append(json.loads(f.readline()))
    check(rows[0] == rows[1] and twice["report"]["4DMatch-F"]["iters"][first]
          == nsfp["report"]["4DMatch-F"]["iters"][first],
          f"nolearned: fused NSFP twice: {rows[0]} then {rows[1]}")
    phase("nolearned", "fused NSFP, pair 0 twice: equal iterations and a "
          "bit-equal ledger row")
    unf = out["NSFP unfused"] = run(
        "NSFP unfused", str(REPO / "config/baselines/NSFP.yaml"), one,
        limit=1)
    converged("NSFP unfused", unf, 5000, factor=1.5)
    check(unf["launches"]["nsfp_fwd"] == unf["launches"]["nsfp_bwd"] == 0
          and unf["launches"]["nn_dual"] > 0,
          f"nolearned NSFP unfused: launches {unf['launches']}")
    a = rows[0]["full-epe"]
    b = unf["report"]["4DMatch-F"]["scores"]["full-epe"]
    check(abs(a - b) <= 0.15 * max(a, b), f"nolearned NSFP: pair 0 full-epe "
          f"{a} fused against {b} unfused")
    phase("nolearned", f"NSFP fused {nsfp['ms_per_iter']:.4f} ms/iter against "
          f"unfused {unf['ms_per_iter']:.4f} ms/iter; pair 0 full-epe "
          f"{a:.3f} against {b:.3f} cm")

    # Nerfies (its iteration cap cut for time) and Sinkhorn, 1 pair each
    nerf_cfg = variant("Nerfies", "config/baselines/Nerfies.yaml",
                       ("iters: 5000", f"iters: {NERFIES_ITERS}"))
    nerf = out["Nerfies"] = run(f"Nerfies (iters cut to {NERFIES_ITERS})",
                                nerf_cfg, one, limit=1)
    counts = list(nerf["report"]["4DMatch-F"]["iters"].values())[0]
    check(1 <= counts[0] <= NERFIES_ITERS, f"nolearned Nerfies: {counts}")
    check(nerf["launches"]["nn_dual"] > 0, "nolearned Nerfies: no C1 launch")
    sink = out["Sinkhorn"] = run(
        "Sinkhorn", str(REPO / "config/baselines/Sinkhorn.yaml"), one, limit=1)
    check(list(sink["report"]["4DMatch-F"]["iters"].values())[0] == [11],
          "nolearned Sinkhorn: not 11 steps")
    for res in out.values():
        report = res.pop("report")
        res["scores"] = {s: r["scores"] for s, r in report.items()}
        res["iterations"] = {s: list(r["iters"].values())
                             for s, r in report.items()}
    return dict(out, initial_epe_cm=init_epe, sizes=sizes)


OPTIN_TOL = 2e-5


def c12_bench_inputs(dev):
    """C12's inputs on the opt-in route's shapes: the bench pair's target
    and its source warped by C2 at a mid level (2000 points, width 128,
    depth 3, seed-0 weights), ~5% of each cloud masked out (numpy seed 5).
    Returns (x, warped, y, x_valid, y_valid, flat, cfg, rng), rng after the
    masks."""
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi

    n = 2000
    cfg = pyramid.NDPConfig(**BENCH_PYRAMID)
    src, tgt, _ = make_pair(n=n, seed=0, deform=0.12)
    x = torch.from_numpy(src - src.mean(0)).to(dev)
    y = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=0),
        device=dev)).contiguous()
    warped = fi.level_warp_fwd(flat, x, MID_LEVEL, cfg)
    rng = np.random.default_rng(5)
    xv = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    yv = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    return x, warped, y, xv, yv, flat, cfg, rng


def c12_case(warped, y, xv=None, yv=None, trunc=None,
             replaced: bool = True, label: str = "") -> dict:
    """C12 against its plain version on the CPU, where index_add_ adds in
    index order (on CUDA it adds by atomics, in another order on every
    run; the truncation, where ``trunc`` is None, at the median squared
    distance of the valid rows, so that half the rows and about half the
    columns are cut): rmin and rarg bit-equal; cgrad within OPTIN_TOL of
    its max and the two sums within OPTIN_TOL relative (torch's sqrt on the
    CPU is not correctly rounded for every input, the card's is, and the
    plain version sums in another order); the autograd gradient within
    1e-4 of its max against the CPU's, a repeat bit-equal; then its time,
    the plain version's on the card, the library call's, the bound and,
    where ``replaced``, the time of the work it replaces (C1 + glue + C6).
    Prints its line."""
    from deformationpyramid_tpu_torch.ops import chamfer_fused as cf
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.ops import knn

    n, m = warped.shape[0], y.shape[0]
    dev = warped.device
    xv = torch.ones(n, dtype=torch.bool, device=dev) if xv is None else xv
    yv = torch.ones(m, dtype=torch.bool, device=dev) if yv is None else yv
    if trunc is None:
        rmin0 = cf.chamfer_fused_plain(warped, y, xv, yv, 1e9)[2]
        trunc = float(rmin0[xv].median())
    got = cf.chamfer_fused(warped, y, xv, yv, trunc)
    again = cf.chamfer_fused(warped, y, xv, yv, trunc)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "C12 does not repeat bit for bit")
    sums, cgrad, rmin, rarg = (t.cpu() for t in got)
    rsums, rcgrad, rrmin, rrarg = cf.chamfer_fused_plain(
        warped.cpu(), y.cpu(), xv.cpu(), yv.cpu(), trunc)
    for name, a, b in (("rmin", rmin, rrmin), ("rarg", rarg, rrarg)):
        check(torch.equal(a, b), f"C12: {name} differs from the plain "
              "version on the CPU")
    e_sums = float(((sums - rsums).abs() / rsums.abs()).max())
    e_cgrad = float((cgrad - rcgrad).abs().max() / rcgrad.abs().max())
    check(e_sums <= OPTIN_TOL and e_cgrad <= OPTIN_TOL,
          f"C12: sums {e_sums}, cgrad {e_cgrad} (relative) > {OPTIN_TOL}")
    kept = float((rmin[xv.cpu()] < trunc).float().mean())
    wq = warped.clone().requires_grad_(True)
    cf.chamfer_l1_fused(wq, y, xv, yv, trunc=trunc).backward()
    wc = warped.cpu().requires_grad_(True)
    cf.chamfer_l1_fused(wc, y.cpu(), xv.cpu(), yv.cpu(),
                        trunc=trunc).backward()
    e_grad = float((wq.grad.cpu() - wc.grad).abs().max()
                   / wc.grad.abs().max())
    check(e_grad <= 1e-4, f"C12 gradient {e_grad} of max|g| > 1e-4")
    n_len = xv.sum().float()
    m_len = yv.sum().float()

    def glue():
        # the work C12 replaces: C1, the glue and its C6 scatter
        _, cidx, _, ra = knn.nn_argmin_dual(warped, y, xv, yv)
        return fi._chamfer_glue(warped, cidx, ra, y, xv, yv, n_len, m_len,
                                trunc)

    res = dict(
        err=max(float((sums - rsums).abs().max()),
                float((cgrad - rcgrad).abs().max())),
        shape=f"{n} x {m}", trunc=trunc, kept=kept,
        ms=cuda_ms(lambda: cf.chamfer_fused(warped, y, xv, yv, trunc)),
        plain_ms=cuda_ms(lambda: cf.chamfer_fused_plain(warped, y, xv, yv,
                                                        trunc)),
        # the library's exact-difference 1-NN both ways: the sweep alone,
        # without the masks, the truncation, the sums or the gradient
        library_ms=cuda_ms(lambda: cdist_nn(warped, y)),
        # 8 flops a pair of points; inputs, masks and outputs once
        **bound(n * (12 + 1 + 4 + 8 + 12) + m * (12 + 1) + 8,
                8.0 * n * m),
        tol=f"rmin and rarg bit-equal to the plain version on the CPU, "
        f"cgrad {OPTIN_TOL} of its max ({e_cgrad:.1e}) and the sums "
        f"{OPTIN_TOL} relative ({e_sums:.1e}), the gradient 1e-4 of its max "
        f"({e_grad:.2e}); a repeat bit-equal")
    if replaced:
        res["c1_glue_c6_ms"] = cuda_ms(glue)
    print_kernel(f"chamfer_fused [{n} x {m}{label}, trunc {trunc:.3e}: "
                 f"{100 * kept:.0f}% of rows kept]", res)
    if replaced:
        phase("kernels", f"chamfer_fused replaces C1 + glue + C6: "
              f"{res['c1_glue_c6_ms']:.4f} ms")
    return res


def optin_kernel_phase(dp, dev):
    """The kernels of the solver's opt-in routes at the bench shapes
    (2000 points, width 128, depth 3, a mid level) against their plain
    versions: C12 chamfer_fused with masks and truncation, C13
    sum_partials on C3's partial rows (with and without the nonrigidity
    head), and C2 / C3 with the nonrigidity head at levels 0 and 1. C12's
    outputs on pinned inputs bit-equal to C12_DIGESTS and its edge cases
    to the plain version on the CPU."""
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.ops import knn

    n = 2000
    x, warped, y, xv, yv, flat, cfg, rng = c12_bench_inputs(dev)
    res = {"chamfer_fused": c12_case(warped, y, xv, yv, label=", masks")}
    digests = c12_digests(dev)
    check(digests == C12_DIGESTS, f"C12 outputs differ from the pinned "
          f"bits: {digests}")
    n_edge = c12_edge_check(dev)
    res["chamfer_fused"].update(digests="equal to C12_DIGESTS",
                                edge_cases=n_edge)
    phase("kernels", f"chamfer_fused: outputs on {len(digests)} pinned "
          f"inputs bit-equal to C12_DIGESTS; {n_edge} edge cases (ties "
          "across slices, all rows or columns invalid, invalid queries, "
          "every column on one row) bit-equal to the plain version on the "
          "CPU (sums 1e-5 relative)")

    # C13 on C3's partial rows: the block-order sum, a repeat, float64
    n_len = torch.tensor(float(n), device=dev)
    _, cidx, _, ra = knn.nn_argmin_dual(warped, y)
    _, g = fi._chamfer_glue(warped, cidx, ra, y, torch.ones_like(xv),
                            torch.ones_like(yv), n_len, n_len, 1e9)
    cfg_nr = pyramid.NDPConfig(**BENCH_PYRAMID, nonrigidity_est=True)
    shapes_nr = pyramid.level_shapes(cfg_nr)
    flat_nr = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(shapes_nr, seed=21), device=dev)).contiguous()
    check(flat_nr.numel() == fi.level_param_count(cfg_nr),
          f"nonrigid flat level has {flat_nr.numel()} values")
    g_nr = (torch.from_numpy(rng.standard_normal(n)) * 1e-2).float().to(dev)
    sum_res = {}
    for tag, f_, c_, gn in (("", flat, cfg, None),
                            (" with the nonrigidity head", flat_nr, cfg_nr,
                             g_nr)):
        partials = fi.level_warp_bwd(f_, x, g, MID_LEVEL, c_, gn)
        got_s = fi.sum_partials(partials)
        again_s = fi.sum_partials(partials)
        order = partials[0].clone()
        for b in range(1, partials.shape[0]):
            order = order + partials[b]
        f64 = partials.double().sum(0)
        torch.cuda.synchronize()
        check(torch.equal(got_s, order), f"C13{tag}: not the block-order sum")
        check(torch.equal(got_s, again_s), f"C13{tag}: no bit-equal repeat")
        e64 = float((got_s.double() - f64).abs().max() / f64.abs().max())
        check(e64 <= 1e-6, f"C13{tag}: {e64} of max off the float64 sum")
        p4 = 4.0 * partials.numel()
        sum_res[tag] = dict(
            err=float((got_s.double() - f64).abs().max()),
            ms=cuda_ms(lambda: fi.sum_partials(partials)),
            plain_ms=cuda_ms(lambda: partials.sum(0)),
            # one call of the library computes it: partials.sum(0)
            library_ms=None, rows=partials.shape[0],
            params=partials.shape[1],
            **bound(p4 + 4.0 * partials.shape[1], float(partials.numel())),
            tol=f"bit-equal to the block-order sum and on a repeat; "
            f"{e64:.2e} of max off the float64 sum (<= 1e-6)")
        sum_res[tag]["library_ms"] = sum_res[tag]["plain_ms"]
        print_kernel(f"sum_partials [{partials.shape[0]} partial rows of "
                     f"{partials.shape[1]}{tag}]", sum_res[tag])
    res["sum_partials"] = dict(sum_res[""], nonrigid=sum_res[
        " with the nonrigidity head"])

    # C2 / C3 with the nonrigidity head, levels 0 (ungated, nr = 1, its
    # parameters get exactly zero gradient) and 1 (gated)
    nr_res = {}
    g_all, g_nr_all = g, g_nr
    for level in (0, 1):
        keep = off_kinks(flat_nr, x, level, cfg_nr)
        g, g_nr = g_all * keep[:, None], g_nr_all * keep
        w_, nr_ = fi.level_warp_fwd_nr(flat_nr, x, level, cfg_nr)
        rw, rnr = fi._plain_warp_nr(flat_nr, x, level, cfg_nr)
        part = fi.level_warp_bwd(flat_nr, x, g, level, cfg_nr, g_nr).sum(0)
        ref_g = fi.level_warp_bwd_plain(flat_nr, x, g, level, cfg_nr,
                                        g_nr)[0]
        torch.cuda.synchronize()
        err = max(float((w_ - rw).abs().max()), float((nr_ - rnr).abs().max()))
        check(err <= FWD_TOL, f"C2 nonrigid level {level}: err {err}")
        worst = rel_grad_err(part, ref_g, shapes_nr,
                             f"C3 nonrigid level {level}")
        nr_grad = pyramid.unravel(part, shapes_nr)["nr"]
        if level == 0:
            check(bool(nr_.eq(1.0).all()),
                  "C2 nonrigid level 0: nr is not all ones")
            check(not bool(nr_grad["w"].any() or nr_grad["b"].any()),
                  "C3 nonrigid level 0: the head got a gradient")
        r = {"level_warp_fwd": dict(err=err, tol=f"max abs {FWD_TOL}"),
             "level_warp_bwd": dict(
                 err=float((part - ref_g).abs().max()),
                 tol=f"1e-4 of each tensor's max|g| (worst {worst:.2e})")}
        if level == 1:
            r["level_warp_fwd"].update(
                ms=cuda_ms(lambda: fi.level_warp_fwd_nr(flat_nr, x, 1,
                                                        cfg_nr)),
                plain_ms=cuda_ms(lambda: fi._plain_warp_nr(flat_nr, x, 1,
                                                           cfg_nr)),
                library_ms=None)
            r["level_warp_bwd"].update(
                ms=cuda_ms(lambda: fi.level_warp_bwd(flat_nr, x, g, 1,
                                                     cfg_nr, g_nr)),
                plain_ms=cuda_ms(lambda: fi.level_warp_bwd_plain(
                    flat_nr, x, g, 1, cfg_nr, g_nr)), library_ms=None)
            rows = fi.level_warp_bwd(flat_nr, x, g, 1, cfg_nr,
                                     g_nr).shape[0]
            for name, b in level_bounds(n, cfg_nr, flat_nr.numel(),
                                        rows).items():
                if name in r:
                    r[name].update(b)
            for name in r:
                print_kernel(f"{name} [nonrigid, level 1]", r[name])
        else:
            phase("kernels", f"C2 / C3 [nonrigid, level 0]: forward err "
                  f"{err:.3e}, nr all ones, gradient worst {worst:.2e} of "
                  f"max|g|, the nonrigidity head's gradient exactly 0")
        nr_res[level] = r
    res["nonrigid"] = nr_res
    return res


OPTIN_ROUTES = (
    ("plain", {}),
    ("use_fused", dict(use_fused=True)),
    ("use_fused_chamfer", dict(use_fused_chamfer=True)),
    ("use_fused + use_fused_chamfer", dict(use_fused=True,
                                           use_fused_chamfer=True)),
    ("use_fused + transposed", dict(use_fused=True, transposed=True)),
)


def optin_phase(dp, dev, kernels):
    """The solver's opt-in routes on a bench pair (make_batch(2, n=2000,
    seed=100, deform=0.12), pair 1; the bench configuration), each with the
    launch counts set to 0 before and read after; then the evaluation CLI
    with the nonrigidity head (config/NDP.yaml at w_reg 0.2) on two
    fabricated 4DMatch-F pairs: the fused iteration (C2 / C3 with the
    head), the unfused loop and --no-fast."""
    from deformationpyramid_tpu_torch.cli import eval_nolearned as ev
    from deformationpyramid_tpu_torch.data.fourdmatch import \
        FourDMatchDataset
    from deformationpyramid_tpu_torch.data.synthetic import (
        make_batch, write_4dmatch_suite)

    srcs, tgts, flows = make_batch(2, n=2000, seed=100, deform=0.12)
    s, t, f = (torch.from_numpy(a[1]).to(dev) for a in (srcs, tgts, flows))
    out = {}
    cap = BENCH_SOLVER["iters"]
    levels = BENCH_PYRAMID["m"]
    for tag, opts in OPTIN_ROUTES:
        cfg = dp.SolverConfig(pyramid=dp.NDPConfig(**BENCH_PYRAMID),
                              **BENCH_SOLVER, **opts)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        warped, stats = dp.register_pair(1, s, t, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        la = {k.name: k.launches for k in kernels}
        epe, init, it = solve_checks(tag, warped, s, f, stats, cap)
        iters = sum(it)
        # an iteration that starts halted still launches (the host reads
        # the stop flag every 8): up to 7 a level beyond the iterations
        extra = 7 * levels

        def within(name, lo=iters):
            check(lo <= la[name] <= lo + extra,
                  f"optin {tag}: {la[name]} launches of {name} for {iters} "
                  f"iterations")

        check(la["ldmk_iteration"] == 0, f"optin {tag}: {la}")
        if opts.get("use_fused_chamfer"):
            within("chamfer_fused")
            check(la["nn_dual"] == 0, f"optin {tag}: C1 launched {la}")
        else:
            within("nn_dual")
            check(la["chamfer_fused"] == 0, f"optin {tag}: {la}")
        if opts.get("use_fused", False):
            within("level_warp_fwd")
            check(la["level_warp_bwd"] == la["sum_partials"]
                  == la["level_warp_fwd"], f"optin {tag}: C3 {la}")
        else:
            check(la["level_warp_fwd"] == la["level_warp_bwd"]
                  == la["sum_partials"] == 0, f"optin {tag}: {la}")
        out[tag] = dict(epe=epe, initial=init, iterations=it, seconds=dt,
                        ms_per_iter=dt * 1e3 / iters, pairs_per_s=1.0 / dt,
                        launches={k: v for k, v in la.items() if v})
        phase("optin", f"{tag}: EPE {epe:.5f} (initial {init:.5f}), "
              f"{iters} iterations {it}, {dt * 1e3 / iters:.4f} ms/iter, "
              f"{1.0 / dt:.4f} pairs/s, launches {out[tag]['launches']}")

    # the nonrigidity head through the evaluation CLI
    work = REPO / "build" / "chip_smoke" / "optin"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "split"
    write_4dmatch_suite(str(root), "4DMatch-F", n_pairs=2)
    base = (REPO / "config/NDP.yaml").read_text()
    check("w_reg: &w_reg 0.0" in base, "config/NDP.yaml has no w_reg line")
    text = base.replace("w_reg: &w_reg 0.0", "w_reg: &w_reg 0.2")
    runs = {}
    for tag, append, extra in (
            ("w_reg 0.2 fused", "", []),
            ("w_reg 0.2 unfused", "use_fused_iteration: false\n", []),
            ("w_reg 0.2 --no-fast", "", ["--no-fast"])):
        path = work / f"{tag.replace(' ', '_')}.yaml"
        path.write_text(text + append)
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        report = ev.main(["--config", str(path), "--data-root", str(root),
                          "--device", "cuda", "--splits", "4DMatch-F",
                          "--log-dir", str(work / tag.replace(" ", "_")),
                          *extra])["4DMatch-F"]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        la = {k.name: k.launches for k in kernels}
        iters = sum(sum(v) for v in report["iters"].values())
        epe = report["scores"]["full-epe"]
        check(all(np.isfinite(v) for v in report["scores"].values()),
              f"optin {tag}: scores {report['scores']}")
        if "unfused" in tag:
            check(la["level_warp_fwd"] == 0 and la["nn_dual"] > 0,
                  f"optin {tag}: launches {la}")
        else:
            check(la["level_warp_fwd"] == la["level_warp_bwd"]
                  == la["adam_step"] >= iters > 0,
                  f"optin {tag}: launches {la}")
        runs[tag] = dict(epe_cm=epe, iterations=iters, seconds=dt,
                         pairs_per_s=report["pairs"] / dt,
                         ms_per_iter=dt * 1e3 / iters,
                         iters=list(report["iters"].values()))
        phase("optin", f"eval_nolearned {tag}: full-epe {epe:.4f} cm, "
              f"{iters} iterations {runs[tag]['iters']}, "
              f"{runs[tag]['ms_per_iter']:.4f} ms/iter, "
              f"{runs[tag]['pairs_per_s']:.4f} pairs/s")
    ds = FourDMatchDataset(str(root), "4DMatch-F")
    init = float(np.mean([100.0 * np.linalg.norm(ds[i].flow_gt,
                                                 axis=-1).mean()
                          for i in range(len(ds))]))
    for tag, r in runs.items():
        check(r["epe_cm"] < init, f"optin {tag}: full-epe {r['epe_cm']} not "
              f"below the initial flow's {init}")
    fused, unfused = runs["w_reg 0.2 fused"], runs["w_reg 0.2 unfused"]
    check(fused["epe_cm"] <= 2.0 * unfused["epe_cm"],
          f"optin: w_reg 0.2 fused full-epe {fused['epe_cm']} against "
          f"unfused {unfused['epe_cm']}")
    phase("optin", f"w_reg 0.2: initial flow {init:.3f} cm; fused "
          f"{fused['epe_cm']:.4f} cm within 2x of unfused "
          f"{unfused['epe_cm']:.4f} cm")
    out["eval_w_reg"] = dict(runs, initial_cm=init)
    return out


def small_landmark_phase(dev):
    """A narrow landmark model on the card (C7 at head width 24) against the
    same model on the CPU (C7's plain version)."""
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pyramid_to_device)
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.match.kpconv import KPConvConfig
    from deformationpyramid_tpu_torch.match.matching import MatchingConfig
    from deformationpyramid_tpu_torch.match.outlier_rejection import \
        NeCoConfig
    from deformationpyramid_tpu_torch.match.pipeline import MatcherConfig
    from deformationpyramid_tpu_torch.match.position_encoding import \
        VolPEConfig
    from deformationpyramid_tpu_torch.match.transformer import \
        TransformerConfig
    from deformationpyramid_tpu_torch.models.pyramid import tree_map

    fd = 96
    kp = KPConvConfig(first_subsampling_dl=0.05, first_feats_dim=32,
                      coarse_feature_dim=fd, fine_feature_dim=24)
    mc = MatchingConfig(feature_dim=fd)
    lcfg = lm.LandmarkConfig(
        matcher=MatcherConfig(kpfcn=kp, matching=mc,
                              transformer=TransformerConfig(
                                  feature_dim=fd, n_head=4, matching=mc,
                                  vol=VolPEConfig(feature_dim=fd,
                                                  vol_origin=(-2., -2., -2.)),
                                  attention_impl="flash")),
        neco=NeCoConfig(feature_dim=48, n_head=4, num_layers=3))
    src, tgt, _ = make_pair(n=400, seed=0, deform=0.05)
    limits = calibrate_neighborhood_limits([(src, tgt)], kp,
                                           KPFCN_ARCHITECTURE)
    pyr = build_pair_pyramid(src, tgt, kp, KPFCN_ARCHITECTURE, limits,
                             pad_to="pow2")
    params = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device="cpu")
    outs = {}
    for d in (dev, torch.device("cpu")):
        outs[d.type] = lm.landmark_inference(
            tree_map(lambda t: t.to(d), params), pyramid_to_device(pyr, d),
            pyr.src_lengths[2], pyr.tgt_lengths[2], lcfg, s_cap=256,
            t_cap=256)
    err = float((outs["cuda"]["conf_matrix_pred"].cpu()
                 - outs["cpu"]["conf_matrix_pred"]).abs().max())
    check(err <= 1e-4, f"small landmark model: confidence matrix err {err} "
          "vs CPU > 1e-4")
    check(float(outs["cpu"]["conf_matrix_pred"].max()) > 1e-2,
          "small landmark model: the confidence matrix is flat")
    phase("small", f"landmark model (width {fd}, 4 heads of 24, NeCo 48): "
          f"card vs CPU confidence matrix max abs err {err:.3e} (<= 1e-4); "
          f"matches {int(outs['cuda']['match_valid'].sum())} on the card, "
          f"{int(outs['cpu']['match_valid'].sum())} on the CPU")


ED_SHAPE = (480, 640)     # RenderConfig's default image
C14_SHAPES = (2000, 6000)  # C1's shapes: the bench sample, the shape transfer


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit normals per vertex: the sum of the incident faces' normals
    (numpy cross products, area-weighted)."""
    v = vertices.astype(np.float64)
    fn = np.cross(v[faces[:, 1]] - v[faces[:, 0]], v[faces[:, 2]] - v[faces[:, 0]])
    n = np.zeros_like(v)
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                           1e-12)).astype(np.float32)


def c14_bound(n: int, m_valid: int, m: int) -> dict:
    """C14's least time: 8 flops a (query, valid row) pair; the points,
    the mask and both outputs once."""
    return bound(n * 12 + m * 13 + n * 12, 8.0 * n * m_valid)


def c14_case(dev, x, y, yv, tag, library_ms=None):
    """C14 against its plain version on the card (indices equal up to
    near-ties, distances 1e-6 relative), then its time, the plain
    version's, the library call's and the bound. The library call takes
    no mask: a masked case reuses the unmasked case's ``library_ms``. At
    40k x 40k the call takes ~2 s (cdist without the matmul form is a
    plain kernel that writes the whole [N, M] matrix): median of 3 there."""
    from deformationpyramid_tpu_torch.ops import knn

    sq, idx = knn.nn_argmin(x, y, yv)
    rsq, ridx = knn.nn_argmin_plain(x, y, yv)
    torch.cuda.synchronize()
    fin = torch.isfinite(rsq)
    check(bool(torch.equal(fin, torch.isfinite(sq))),
          f"C14 [{tag}]: rows without a candidate differ")
    rel = float(((sq - rsq).abs() / rsq.clamp_min(1e-30))[fin].max()) \
        if bool(fin.any()) else 0.0
    check(rel <= 1e-6, f"C14 [{tag}]: distance rel err {rel} > 1e-6")
    flips = near_ties(x, y, idx, ridx, f"C14 [{tag}]")
    if yv is not None:
        check(bool(yv[idx[fin]].all()), f"C14 [{tag}]: an invalid row won")
    m_valid = y.shape[0] if yv is None else int(yv.sum())
    res = dict(shape=f"{x.shape[0]} x {y.shape[0]}"
               + ("" if yv is None else f" ({m_valid} valid)"),
               err=float((sq - rsq)[fin].abs().max()), rel_err=rel,
               flips=flips, **c14_bound(x.shape[0], m_valid, y.shape[0]))
    if yv is None:      # cdist takes no mask
        lib = cdist_nn(x, y, both=False)
        near_ties(x, y, lib.indices, idx, f"C14 [{tag}] against cdist")
    if library_ms is None:
        big = x.shape[0] * y.shape[0] > 1e8
        library_ms = cuda_ms(lambda: cdist_nn(x, y, both=False),
                             reps=3 if big else REPS)
    res.update(ms=cuda_ms(lambda: knn.nn_argmin(x, y, yv)),
               plain_ms=cuda_ms(lambda: knn.nn_argmin_plain(x, y, yv)),
               library_ms=library_ms)
    res["tol"] = (f"indices equal up to near-ties < 3e-4 rel ({flips} "
                  f"flips); distances 1e-6 rel ({rel:.1e})")
    return res


def ed_phase(dp, dev, kernels):
    """ED / N-ICP from depth maps: two fabricated 480 x 640 depth pairs
    (tests/depth_pairs.py) through cli/eval_ed.py with config/baselines/
    NICP.yaml, one pair twice, Lepard+NICP on one pair, C14 at the pair's
    full clouds and at C1's shapes, point_2_plane_distance end to end, the
    renderer against the numpy z-buffer and silhouette_cost against the
    CPU."""
    import tempfile

    sys.path.insert(0, str(REPO / "tests"))
    from depth_pairs import write_ed_split
    from deformationpyramid_tpu_torch.cli import eval_ed
    from deformationpyramid_tpu_torch.data.fourdmatch import FourDMatchDataset
    from deformationpyramid_tpu_torch.data.graph import depth_to_mesh
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.geometry.camera import \
        depth_to_pointcloud
    from deformationpyramid_tpu_torch.ops import knn, render
    from deformationpyramid_tpu_torch.utils.config import load_config

    def reset():
        for k in kernels:
            k.launches = 0

    def counts():
        return {k.name: k.launches for k in kernels}

    out = {}
    nicp_yaml = str(REPO / "config" / "baselines" / "NICP.yaml")
    cfg = load_config(nicp_yaml)
    check((cfg.iters, cfg.lr, cfg.samples, cfg.node_coverage,
           cfg.num_neighbors) == (600, 0.02, 2000, 0.09, 8)
          and eval_ed.solver_config(cfg).lr_decay == 0.999,
          "ed: config/baselines/NICP.yaml no longer gives the N-ICP solver")
    h, w = ED_SHAPE
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        pairs = write_ed_split(root, "4DMatch-F", n_pairs=2, h=h, w=w)
        init = [float(np.linalg.norm(p["flow"], axis=1).mean()) * 100
                for p in pairs]
        phase("ed", f"fabricated 2 depth pairs of {h} x {w} in "
              f"{time.perf_counter() - t0:.2f} s: source "
              f"{[len(p['src']) for p in pairs]} vertices, target "
              f"{[int((p['tgt_depth_m'] > 0).sum()) for p in pairs]} pixels; "
              f"initial flow {[round(v, 3) for v in init]} cm")

        # the renderer at full size against the numpy z-buffer
        K32 = torch.tensor(pairs[0]["K"], dtype=torch.float32, device=dev)
        tgt_v = torch.from_numpy(pairs[0]["tgt"]).to(dev)
        src_v = torch.from_numpy(pairs[0]["src"]).to(dev)
        rc = render.RenderConfig(height=h, width=w)   # the default at 480 x 640
        depth, sil = render.render_depth_silhouette(tgt_v, K32, rc)
        ref = torch.from_numpy(pairs[0]["tgt_depth_m"]).to(dev)
        torch.cuda.synchronize()
        d_err = float((depth - ref).abs().max())
        check(d_err <= 1e-6 and torch.equal(sil > 0, ref > 0),
              f"ed: render_depth_silhouette against the numpy z-buffer: "
              f"depth err {d_err}, silhouettes differ by "
              f"{int(((sil > 0) != (ref > 0)).sum())} pixels")
        sc = render.silhouette_cost(src_v, tgt_v, K32, rc)
        sc_cpu = render.silhouette_cost(src_v.cpu(), tgt_v.cpu(), K32.cpu(),
                                        rc)
        sc_rel = abs(float(sc) - float(sc_cpu)) / abs(float(sc_cpu))
        check(sc_rel <= 1e-5, f"ed: silhouette_cost card {float(sc)} against "
              f"CPU {float(sc_cpu)} (rel {sc_rel} > 1e-5)")
        out["render"] = dict(
            depth_err=d_err, pixels=int((sil > 0).sum()),
            ms=cuda_ms(lambda: render.render_depth_silhouette(tgt_v, K32, rc)),
            silhouette_cost=float(sc), silhouette_cost_rel_err=sc_rel)
        phase("ed", f"render_depth_silhouette [{len(tgt_v)} points, {h} x "
              f"{w}]: equal to the numpy z-buffer (depth err {d_err:.1e}), "
              f"{out['render']['ms']:.4f} ms; silhouette_cost card "
              f"{float(sc):.6f} against CPU {float(sc_cpu):.6f} (rel "
              f"{sc_rel:.1e} <= 1e-5)")

        # N-ICP through the CLI, as a user runs it
        reset()
        t0 = time.perf_counter()
        rep = eval_ed.main(["--config", nicp_yaml, "--data-root", root,
                            "--splits", "4DMatch-F", "--device", "cuda"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = counts()
        r = rep["4DMatch-F"]
        scores = r["scores"]
        check(r["pairs"] == 2, f"ed: {r['pairs']} pairs scored, not 2")
        check(all(np.isfinite(v) for v in scores.values()),
              f"ed: non-finite metrics {scores}")
        its = [i["iters"] for i in r["info"]]
        check(all(1 <= i <= cfg.iters for i in its),
              f"ed: iterations {its} outside [1, {cfg.iters}]")
        check(scores["full-epe"] <= 0.5 * float(np.mean(init)),
              f"ed: full EPE {scores['full-epe']:.4f} cm > 0.5x the initial "
              f"{np.mean(init):.4f} cm")
        for name in ("nn_dual", "adam_step"):
            check(launches[name] > 0, f"ed: kernel {name} never launched")
        graph_s = {k: [round(i["graph_seconds"][k], 3) for i in r["info"]]
                   for k in ("mesh", "nodes", "dijkstra", "anchors")}
        ms_iter = [1e3 * i["solve_seconds"] / i["iters"] for i in r["info"]]
        out["nicp"] = dict(
            seconds=secs, scores=scores, initial_epe_cm=float(np.mean(init)),
            iters=its, graph_seconds=graph_s, solve_ms_per_iter=ms_iter,
            sizes=[(i["n_vertices"], i["n_nodes"], i["n_target"])
                   for i in r["info"]],
            launches={k: v for k, v in launches.items() if v})
        phase("ed", f"NICP.yaml through eval_ed (2 pairs, {secs:.2f} s): "
              f"graph build seconds by part {graph_s}; solve "
              f"{[round(v, 4) for v in ms_iter]} ms/iter over {its} "
              f"iterations; (vertices, nodes, target points) "
              f"{out['nicp']['sizes']}; C1 {launches['nn_dual']}, C4 "
              f"{launches['adam_step']} launches")
        phase("ed", "NICP.yaml scores (cm, %): " + ", ".join(
            f"{k} {v:.4f}" for k, v in scores.items())
              + f"; initial flow {np.mean(init):.4f} cm")

        # one pair twice: equal iterations, a bit-equal warp
        ds = FourDMatchDataset(root, "4DMatch-F")
        scfg = eval_ed.solver_config(cfg)
        infos = []
        for _ in range(2):
            info = {}
            eval_ed.evaluate_pair_ed(ds[0], cfg, scfg, 0, device=dev,
                                     info=info)
            infos.append(info)
        torch.cuda.synchronize()
        check(infos[0]["iters"] == infos[1]["iters"]
              and torch.equal(infos[0]["warped"], infos[1]["warped"]),
              f"ed: pair 0 twice: iterations {infos[0]['iters']} / "
              f"{infos[1]['iters']}, warp differs by "
              f"{float((infos[0]['warped'] - infos[1]['warped']).abs().max())}")
        phase("ed", f"pair 0 twice: {infos[0]['iters']} iterations both "
              f"times, bit-equal warp")

        # Lepard+NICP on one pair: the learned landmarks from seed 0
        lyaml = str(REPO / "config" / "baselines" / "Lepard+NICP.yaml")
        reset()
        t0 = time.perf_counter()
        lrep = eval_ed.main(["--config", lyaml, "--data-root", root,
                             "--splits", "4DMatch-F", "--device", "cuda",
                             "--limit", "1"])
        torch.cuda.synchronize()
        lsecs = time.perf_counter() - t0
        llaunch = counts()
        check("4DMatch-F" in lrep and lrep["4DMatch-F"]["pairs"] == 1,
              "ed: Lepard+NICP did not score its pair")
        lr_ = lrep["4DMatch-F"]
        li = lr_["info"][0]
        lm = li["landmarks"]
        check(lm["src_ldmk_idx"].dtype == np.int64
              and 0 <= lm["src_ldmk_idx"].min()
              and lm["src_ldmk_idx"].max() < li["n_vertices"]
              and 0 <= lm["tgt_ldmk_idx"].min()
              and lm["tgt_ldmk_idx"].max() < li["n_target"],
              "ed: Lepard+NICP landmarks are not raw-cloud indices")
        check(all(np.isfinite(v) for v in lr_["scores"].values()),
              f"ed: Lepard+NICP non-finite metrics {lr_['scores']}")
        check(llaunch["flash_attention_fwd"] > 0,
              "ed: Lepard+NICP never launched C7")
        l_graph = sum(li["graph_seconds"].values())
        out["lepard_nicp"] = dict(
            seconds=lsecs, scores=lr_["scores"], iters=li["iters"],
            graph_seconds=l_graph, solve_seconds=li["solve_seconds"],
            landmarks=int(lm["ldmk_valid"].sum()),
            landmark_rows=len(lm["ldmk_valid"]),
            launches={k: v for k, v in llaunch.items() if v})
        phase("ed", f"Lepard+NICP.yaml (1 pair, weights from seed 0, "
              f"{lsecs:.2f} s: graph {l_graph:.3f} s, solve "
              f"{li['solve_seconds']:.3f} s = "
              f"{1e3 * li['solve_seconds'] / li['iters']:.4f} ms/iter, the "
              f"landmark model with its collate and the I/O the rest): "
              f"{out['lepard_nicp']['landmarks']} valid "
              f"landmarks of {len(lm['ldmk_valid'])} rows, {li['iters']} "
              f"iterations, full-epe {lr_['scores']['full-epe']:.4f} cm "
              f"(not gated: untrained weights); launches "
              f"{out['lepard_nicp']['launches']}")

        # C14 at the pair's full clouds: the warped source vertices
        # against the target cloud, without and with a mask
        p0 = pairs[0]
        tgt_depth = p0["tgt_depth_mm"] / 1000.0
        tgt_pcd = depth_to_pointcloud(tgt_depth, p0["K"]).reshape(3, -1).T[
            (tgt_depth > 0).reshape(-1)].astype(np.float32)
        x = infos[0]["warped"].contiguous()
        y = torch.from_numpy(tgt_pcd).to(dev)
        yv = torch.from_numpy(
            np.random.default_rng(9).random(len(tgt_pcd)) > 0.3).to(dev)
        c14 = c14_case(dev, x, y, None, "full clouds")
        c14["masked"] = c14_case(dev, x, y, yv, "full clouds, masked",
                                 library_ms=c14["library_ms"])
        for n in C14_SHAPES:
            src, tgt, _ = make_pair(n=n, seed=0, deform=0.12)
            xs = torch.from_numpy(src - src.mean(0)).to(dev)
            ys = torch.from_numpy(tgt - tgt.mean(0)).to(dev)
            case = c14_case(dev, xs, ys, None, f"{n} x {n}")
            case["c1_ms"] = cuda_ms(lambda: knn.nn_argmin_dual(xs, ys))
            case["c1_library_ms"] = cuda_ms(lambda: cdist_nn(xs, ys))
            c14[f"at_{n}"] = case
        for tag, r_ in (("full clouds", c14), ("masked", c14["masked"]),
                        *((f"{n} x {n}", c14[f"at_{n}"])
                          for n in C14_SHAPES)):
            print_kernel(f"nn_argmin [{tag}: {r_['shape']}]", r_)
        for n in C14_SHAPES:
            phase("kernels", f"at {n} x {n}: C1 (both directions) "
                  f"{c14[f'at_{n}']['c1_ms']:.4f} ms, cdist both ways "
                  f"{c14[f'at_{n}']['c1_library_ms']:.4f} ms")
        digests = c14_digests(dev)
        check(digests == C14_DIGESTS, f"C14 outputs differ from the pinned "
              f"bits: {digests}")
        n_edge = c14_edge_check(dev)
        c14.update(digests="equal to C14_DIGESTS", edge_cases=n_edge)
        phase("kernels", f"nn_argmin: outputs on {len(digests)} pinned inputs "
              f"bit-equal to C14_DIGESTS; {n_edge} cases bit-equal to C1's "
              "x -> y half, the C1 edge cases also to the plain version on "
              "the CPU")

        # point_2_plane_distance end to end: the warped source mesh's
        # normals against the target mesh's, C14 twice a call
        verts, faces, _ = depth_to_mesh(p0["src_depth_mm"], p0["K"], 0.06,
                                        1000.0)
        nx = torch.from_numpy(vertex_normals(x.cpu().numpy(), faces)).to(dev)
        tv_, tf_, _ = depth_to_mesh(p0["tgt_depth_mm"], p0["K"], 0.06, 1000.0)
        yt = torch.from_numpy(tv_).to(dev)
        ny = torch.from_numpy(vertex_normals(tv_, tf_)).to(dev)
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total, x2p, y2p = render.point_2_plane_distance(x, yt, nx, ny)
        torch.cuda.synchronize()
        p2p_ms = (time.perf_counter() - t0) * 1e3
        p2p_launch = knn.NN_ARGMIN.launches
        check(p2p_launch == 2, f"ed: point_2_plane_distance launched C14 "
              f"{p2p_launch} times, not 2")
        _, ix = knn.nn_argmin_plain(x, yt)
        _, iy = knn.nn_argmin_plain(yt, x)
        rx = torch.sqrt(torch.clamp_min(
            (((x - yt[ix]) * ny[ix]) ** 2).sum(1), 1e-16)).mean()
        ry = torch.sqrt(torch.clamp_min(
            (((yt - x[iy]) * nx[iy]) ** 2).sum(1), 1e-16)).mean()
        p_rel = max(abs(float(x2p) - float(rx)) / float(rx),
                    abs(float(y2p) - float(ry)) / float(ry))
        check(np.isfinite(float(total)) and p_rel <= 1e-5,
              f"ed: point_2_plane_distance against the plain 1-NN: rel "
              f"{p_rel} > 1e-5")
        c14["point_2_plane"] = dict(total=float(total), x2p=float(x2p),
                                    y2p=float(y2p), rel_err=p_rel,
                                    host_ms=p2p_ms, launches=p2p_launch)
        phase("ed", f"point_2_plane_distance [{len(x)} x {len(yt)}]: "
              f"{float(total):.6f} (x2p {float(x2p):.6f}, y2p "
              f"{float(y2p):.6f}), the plain 1-NN's within {p_rel:.1e}; "
              f"C14 launched {p2p_launch} times; {p2p_ms:.3f} ms host")
    out["c14"] = c14
    return out


MOTION_NAMES = {0: "SE3", 1: "Sim3", 2: "sflow"}
FORMAT_NAMES = {0: "axis_angle", 1: "euler", 2: "quaternion", 3: "6D"}


def _ptxas(entry: str) -> list[dict]:
    """Registers and spill bytes of every instantiation of the kernel
    whose mangled name matches ``entry`` (its motion and format, and a
    nonrigid flag where the name has one, as groups; a kernel that is no
    template is named by the match itself), from the ptxas report of this
    build (``cuda_lib.ptxas_log``)."""
    import re

    from deformationpyramid_tpu_torch.ops import cuda_lib

    out, cur, spill = [], None, (0, 0)
    for line in cuda_lib.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = re.search(entry, m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            if cur.lastindex is None:
                layout = cur.group(0)
            else:
                motion = MOTION_NAMES[int(cur.group(1))]
                fmt = FORMAT_NAMES[int(cur.group(2))]
                layout = motion if motion == "sflow" else f"{motion}+{fmt}"
            out.append(dict(layout=layout,
                            nonrigid=(cur.lastindex == 3
                                      and cur.group(3) == "1"),
                            registers=int(m.group(1)),
                            spill_stores=spill[0], spill_loads=spill[1]))
            cur, spill = None, (0, 0)
    return out


def c3_ptxas() -> list[dict]:
    """Registers and spill bytes of every C3 instantiation (nine (motion,
    format) pairs, with and without the nonrigidity head)."""
    return _ptxas(r"level_warp_bwd_kernelILi(\d+)ELi(\d+)ELb([01])E")


def nsfp_ptxas() -> list[dict]:
    """Registers and spill bytes of C10 and C11."""
    return _ptxas(r"nsfp_(?:fwd|bwd)_kernel")


def nn_ptxas() -> list[dict]:
    """Registers and spill bytes of the kernels on nn_sweep.cuh and
    bucket_rows.cuh: C1, C14 (its three configurations, named
    nn_argmin_kernel<warps,groups,queries a lane>), C12's sweep and
    finish, C6."""
    import re

    regs = _ptxas(r"nn_dual_kernel|nn_argmin_kernel(?:ILi\d+ELi\d+ELi\d+E)?|"
                  r"chamfer_(?:sweep|finish)_kernel|scatter_rows_kernel")
    for r in regs:
        r["layout"] = re.sub(r"ILi(\d+)ELi(\d+)ELi(\d+)E", r"<\1,\2,\3>",
                             r["layout"])
    return regs


def c5_ptxas() -> list[dict]:
    """Registers and spill bytes of every C5 instantiation (nine (motion,
    format) pairs)."""
    return _ptxas(r"ldmk_iteration_kernelILi(\d+)ELi(\d+)EEv")


def ptxas_line(regs: list[dict]) -> str:
    return ", ".join(f"{r['layout']}{' nr' if r['nonrigid'] else ''} "
                     f"{r['registers']}/{r['spill_stores']}/"
                     f"{r['spill_loads']}" for r in regs)


def c2_c5_digests(dev) -> dict:
    """sha256 of C2's, C3's and C5's outputs on fixed inputs made with
    numpy (C2 and C3 at the bench shapes for SE3 + axis_angle, at 6000
    points for Sim3 + euler, with the nonrigidity head at level 1: C2's
    warp, C3's partial rows; C5 one step at 2048 landmark rows): kernels
    whose code did not change give the same bits from one tree to another
    (``scripts/check_torch_level_warp.py``,
    ``scripts/check_torch_ldmk_iteration.py``,
    ``tests/test_torch_cuda_kernels.py``)."""
    from deformationpyramid_tpu_torch.models import pyramid
    from deformationpyramid_tpu_torch.ops import fused_iteration as fi
    from deformationpyramid_tpu_torch.solve.loop import LoopConfig

    digest = sha256_of
    rng = np.random.default_rng(2024)
    out, c3_inputs = {}, []
    for tag, kw, n, level in (
            ("C2 SE3+axis_angle 2000", {}, 2000, MID_LEVEL),
            ("C2 Sim3+euler 6000", dict(motion="Sim3",
                                        rotation_format="euler"), 6000,
             MID_LEVEL),
            ("C2 nonrigid level 1", dict(nonrigidity_est=True), 2000, 1)):
        cfg = pyramid.NDPConfig(**dict(BENCH_PYRAMID, **kw))
        flat = pyramid.ravel(pyramid.params_from_numpy(
            numpy_level_params(pyramid.level_shapes(cfg), seed=7),
            device=dev)).contiguous()
        x = torch.from_numpy(rng.normal(0.0, 0.3, (n, 3)).astype(
            np.float32)).to(dev)
        if cfg.nonrigidity_est:
            out[tag] = digest(*fi.level_warp_fwd_nr(flat, x, level, cfg))
        else:
            out[tag] = digest(fi.level_warp_fwd(flat, x, level, cfg))
        c3_inputs.append((tag.replace("C2", "C3"), cfg, flat, x, level))
    # C3's cotangents from a stream of their own, so C2's and C5's inputs
    # stay what they were before C3 was pinned.
    g_rng = np.random.default_rng(2025)
    for tag, cfg, flat, x, level in c3_inputs:
        g = torch.from_numpy(g_rng.normal(0.0, 1e-3, x.shape).astype(
            np.float32)).to(dev)
        g_nr = torch.from_numpy(g_rng.normal(0.0, 1e-2, x.shape[0]).astype(
            np.float32)).to(dev) if cfg.nonrigidity_est else None
        out[tag] = digest(fi.level_warp_bwd(flat, x, g, level, cfg, g_nr))
    cfg = pyramid.NDPConfig(**LNDP_PYRAMID)
    x = torch.from_numpy(rng.normal(0.0, 0.3, (LDMK_ROWS, 3)).astype(
        np.float32)).to(dev)
    tgt = x + torch.from_numpy(rng.normal(0.0, 0.01, (LDMK_ROWS, 3)).astype(
        np.float32)).to(dev)
    mask = (torch.arange(LDMK_ROWS, device=dev) < N_LDMK).float()
    flat = pyramid.ravel(pyramid.params_from_numpy(
        numpy_level_params(pyramid.level_shapes(cfg), seed=8),
        device=dev)).contiguous()
    stop = fi.EarlyStop(LoopConfig(iters=500), dev)
    p, m, v, aux = (flat.clone(), torch.zeros_like(flat),
                    torch.zeros_like(flat), x.clone())
    fi.ldmk_iteration(p, m, v, x, tgt, mask, mask.sum(), stop, aux,
                      MID_LEVEL, cfg, 0.01)
    out["C5 one step"] = digest(p, m, v, aux, stop.loss)
    return out


MV_REL_TOL = 1e-4        # the card against the CPU (index_add's atomics)


def reference_state_dict(matcher: dict, neco: dict, layer_types,
                         seed: int) -> dict[str, np.ndarray]:
    """State dicts in the reference's layout (Lepard ``Pipeline`` and NeCo
    ``Outlier_Rejection``) with a name for every leaf of the port's trees
    and the matcher's dead ``tgt_proj`` weights, random values from a
    seed: nn.Linear weights [out, in], Conv1d [out, in, 1]."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.normal(scale=0.05, size=shape).astype(np.float32)

    def lin(t):
        return arr(t.shape[1], t.shape[0])

    def attention(prefix, layer):
        return {f"{prefix}.q_proj.weight": lin(layer["q"]),
                f"{prefix}.k_proj.weight": lin(layer["k"]),
                f"{prefix}.v_proj.weight": lin(layer["v"]),
                f"{prefix}.merge.weight": lin(layer["merge"]),
                f"{prefix}.mlp.0.weight": lin(layer["mlp1"]),
                f"{prefix}.mlp.2.weight": lin(layer["mlp2"]),
                f"{prefix}.norm1.weight": 1.0 + arr(*layer["ln1"]["g"].shape),
                f"{prefix}.norm1.bias": arr(*layer["ln1"]["b"].shape),
                f"{prefix}.norm2.weight": 1.0 + arr(*layer["ln2"]["g"].shape),
                f"{prefix}.norm2.bias": arr(*layer["ln2"]["b"].shape)}

    msd = {}
    for i, blk in enumerate(matcher["backbone"]["encoder"]):
        pfx = f"backbone.encoder_blocks.{i}"
        msd[f"{pfx}.KPConv.weights"] = arr(*blk["kpconv"]["weights"].shape)
        # the kernel points are the reference's fixed dispositions: keep
        msd[f"{pfx}.KPConv.kernel_points"] = \
            blk["kpconv"]["kernel_points"].cpu().numpy()
        if "offset_conv" in blk["kpconv"]:
            off = blk["kpconv"]["offset_conv"]
            msd[f"{pfx}.KPConv.offset_conv.weights"] = arr(
                *off["weights"].shape)
            msd[f"{pfx}.KPConv.offset_conv.kernel_points"] = \
                off["kernel_points"].cpu().numpy()
            msd[f"{pfx}.KPConv.offset_bias"] = arr(
                *blk["kpconv"]["offset_bias"].shape)
        for ours, theirs in (("unary1", "unary1"), ("unary2", "unary2"),
                             ("shortcut", "unary_shortcut")):
            if ours in blk:
                msd[f"{pfx}.{theirs}.mlp.weight"] = lin(blk[ours]["w"])
    for i, blk in enumerate(matcher["backbone"]["decoder"]):
        if blk:
            msd[f"backbone.decoder_blocks.{i}.mlp.weight"] = lin(blk["w"])
    for name in ("coarse_out", "fine_out"):
        w = matcher["backbone"][name]["w"]
        msd[f"backbone.{name}.weight"] = lin(w)[..., None]
        msd[f"backbone.{name}.bias"] = arr(w.shape[1])
    for i, lt in enumerate(layer_types):
        pfx = f"coarse_transformer.layers.{i}"
        layer = matcher["transformer"]["layers"][i]
        if lt in ("self", "cross"):
            msd.update(attention(pfx, layer))
        elif "src_proj" in layer:
            msd[f"{pfx}.0.src_proj.weight"] = lin(layer["src_proj"])
            msd[f"{pfx}.0.tgt_proj.weight"] = lin(layer["src_proj"])
            if "bin_score" in layer:
                msd[f"{pfx}.0.bin_score"] = arr()
    msd["coarse_matching.src_proj.weight"] = lin(matcher["matching"]
                                                 ["src_proj"])
    msd["coarse_matching.tgt_proj.weight"] = lin(matcher["matching"]
                                                 ["src_proj"])
    if "bin_score" in matcher["matching"]:
        msd["coarse_matching.bin_score"] = arr()
    nsd = {"in_proj.weight": lin(neco["in_proj"]["w"]),
           "in_proj.bias": arr(*neco["in_proj"]["b"].shape)}
    for i, layer in enumerate(neco["layers"]):
        nsd.update(attention(f"_6D_geometry_layers.{i}", layer))
    for ours, theirs in (("cls1", "classification.0"),
                         ("cls2", "classification.2"),
                         ("cls3", "classification.4")):
        nsd[f"{theirs}.weight"] = lin(neco[ours]["w"])
        nsd[f"{theirs}.bias"] = arr(*neco[ours]["b"].shape)
    return msd, nsd


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.cpu() - ref.cpu()).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


def multiview_phase(dp, dev, kernels):
    """The multiview GAT stack at cli/train_multiview.py's defaults, the
    card against the CPU, and the reference-checkpoint converters at full
    width."""
    from deformationpyramid_tpu_torch.cli import train_multiview as tm
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pow2_cap,
        pyramid_to_device)
    from deformationpyramid_tpu_torch.data.fourdmatch_multiview import \
        FourDMatchMultiview
    from deformationpyramid_tpu_torch.data.synthetic import (
        make_pair, write_multiview_suite)
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match import multiview as mv
    from deformationpyramid_tpu_torch.match import port_torch
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.match.outlier_rejection import \
        NeCoConfig
    from deformationpyramid_tpu_torch.models.pyramid import (tree_leaves,
                                                             tree_map)
    from deformationpyramid_tpu_torch.utils.checkpoint import (load_pytree,
                                                               save_pytree)

    work = REPO / "build" / "chip_smoke" / "multiview"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_multiview_suite(str(work / "split"), "multiview-train")
    ds = FourDMatchMultiview(str(work / "split"), "multiview-train")
    check(len(paths) == len(ds) == 4 and ds[0].pcds.shape == (4, 500, 3)
          and len(ds[0].pcd_pairs) == 12,
          f"multiview: suite {len(ds)} sequences, {ds[0].pcds.shape}")
    out = {"suite_s": time.perf_counter() - t0}

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    rows = tm.main(["--data-root", str(work / "split"), "--device", str(dev),
                    "--snapshot-dir", str(work / "snap")])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["launches"] = {k.name: k.launches for k in kernels if k.launches}
    hist = [json.loads(l) for l in
            (work / "snap" / "history.jsonl").read_text().splitlines()]
    check(len(rows) == len(hist) == 10 and all(
        np.isfinite(r[k]) for r in rows for k in r), f"multiview: {rows}")
    check(hist == [{k: r[k] for k in h} for r, h in zip(rows, hist)],
          "multiview: history.jsonl differs from the run")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"multiview: the loss did not fall: {rows[0]['loss']} -> "
          f"{rows[-1]['loss']}")
    check(rows[-1]["IR_after"] > rows[-1]["IR_before"],
          f"multiview: IR after {rows[-1]['IR_after']} <= before "
          f"{rows[-1]['IR_before']}")
    cfg = mv.MultiviewNeCoConfig(neco=NeCoConfig(feature_dim=144,
                                                 num_layers=3))
    like = tree_map(lambda t: t.to(dev), mv.init_multiview_neco(
        torch.Generator().manual_seed(1), cfg))
    for name in ("model_best_loss.npz", "model_last.npz"):
        back = load_pytree(str(work / "snap" / name), like)
        save_pytree(str(work / f"again_{name}"), back)
        with np.load(work / "snap" / name) as a, \
                np.load(work / f"again_{name}") as b:
            check(sorted(k for k in a.files if not k.startswith("__"))
                  == sorted(b.files) and all(
                      np.array_equal(a[k], b[k]) for k in b.files),
                  f"multiview: {name} does not read back bit-equal")
    out["epochs"] = rows
    out["step_ms"] = statistics.median(r["step_ms"] for r in rows[1:])
    out["epoch_s"] = statistics.median(r["seconds"] for r in rows[1:])
    phase("multiview", f"train_multiview at its defaults (144 wide, 8 heads, "
          f"3 layers, k 64, 12 pairs, 16384 edges), 10 epochs x 4 "
          f"sequences: loss {rows[0]['loss']:.4f} -> {rows[-1]['loss']:.4f}, "
          f"IR {rows[-1]['IR_before']:.3f} -> {rows[-1]['IR_after']:.3f}; "
          f"step {out['step_ms']:.3f} ms (median; epoch 0 "
          f"{rows[0]['step_ms']:.3f}), epoch {out['epoch_s']:.3f} s, "
          f"{out['train_s']:.3f} s in all; hand kernels launched "
          f"{out['launches'] or 'none'} (index_add_ and the einsum route)")

    # the card against the CPU on one batch, the same weights
    batch = tm.make_training_batch(ds[0], 64, 0.4, 12, 16384,
                                   np.random.default_rng(3),
                                   cfg.edge_search_radius)
    params = mv.init_multiview_neco(torch.Generator().manual_seed(2), cfg)
    on = {d: ([torch.from_numpy(b).to(d) for b in batch],
              tree_map(lambda t: t.to(d), params)) for d in ("cpu", dev)}
    conf = {}
    for d, (b, p) in on.items():
        conf[d] = mv.apply_multiview_neco(p, b[0], b[1], *b[3:], cfg)
    err = rel_err(conf[dev], conf["cpu"])
    check(err <= MV_REL_TOL and bool(torch.isfinite(conf[dev]).all()),
          f"multiview: apply_multiview_neco card against CPU {err:.3e}")
    step_ms = cuda_ms(lambda: mv.apply_multiview_neco(
        on[dev][1], on[dev][0][0], on[dev][0][1], *on[dev][0][3:], cfg),
        reps=10)
    out["neco_rel_err"], out["neco_ms"] = err, step_ms
    nl_cfg = mv.NonLocalNetConfig()
    rng = np.random.default_rng(4)
    v6 = torch.from_numpy((rng.normal(size=(1024, 6)) * 0.2).astype(
        np.float32))
    m6 = torch.from_numpy(rng.random(1024) < 0.9)
    nl = mv.init_nonlocalnet(torch.Generator().manual_seed(5), nl_cfg)
    nl_conf = {d: mv.apply_nonlocalnet(tree_map(lambda t: t.to(d), nl),
                                       v6.to(d), m6.to(d), nl_cfg)
               for d in ("cpu", dev)}
    nl_err = rel_err(nl_conf[dev], nl_conf["cpu"])
    check(nl_err <= MV_REL_TOL and bool(torch.isfinite(nl_conf[dev]).all()),
          f"multiview: apply_nonlocalnet card against CPU {nl_err:.3e}")
    out["nonlocal_rel_err"] = nl_err
    phase("multiview", f"card against CPU (relative to the max, tolerance "
          f"{MV_REL_TOL}): apply_multiview_neco [12 x 64, "
          f"{int(batch[5].sum())} edges] {err:.3e} ({step_ms:.3f} ms on the "
          f"card), apply_nonlocalnet [6 x 128, K 1024] {nl_err:.3e}")

    # reference checkpoints at full width through the converters, then
    # landmark_inference on the card with the ported weights
    lcfg, _ = lndp_config("flash")
    lparams = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                     device=dev)
    msd, nsd = reference_state_dict(lparams["matcher"], lparams["neco"],
                                    lcfg.matcher.transformer.layer_types, 6)
    t0 = time.perf_counter()
    matcher, mrep = port_torch.port_matcher(
        msd, lparams["matcher"], lcfg.matcher.transformer.layer_types)
    neco, nrep = port_torch.port_neco(nsd, lparams["neco"])
    port_s = time.perf_counter() - t0
    check(mrep["missing"] == [] and nrep["missing"] == []
          and nrep["unused"] == [] and mrep["unused"]
          and all("tgt_proj" in u for u in mrep["unused"]),
          f"multiview: port reports {mrep['missing']} {mrep['unused']} "
          f"{nrep['missing']} {nrep['unused']}")
    n_leaves = len(tree_leaves(matcher)) + len(tree_leaves(neco))
    check(len(mrep["used"]) + len(nrep["used"]) == n_leaves,
          f"multiview: {len(mrep['used']) + len(nrep['used'])} names for "
          f"{n_leaves} leaves")
    check(torch.equal(neco["in_proj"]["w"].cpu(),
                      torch.from_numpy(nsd["in_proj.weight"].T.copy()))
          and all(t.device == dev for t in tree_leaves(matcher)),
          "multiview: ported leaves not transposed or not on the card")
    kp, cl = lcfg.matcher.kpfcn, lcfg.matcher.coarse_level
    src, tgt, _ = make_pair(n=8000, seed=11, deform=0.08)
    limits = calibrate_neighborhood_limits([(src, tgt)], kp,
                                           KPFCN_ARCHITECTURE)
    pyr = build_pair_pyramid(src, tgt, kp, KPFCN_ARCHITECTURE, limits,
                             pad_to="pow2")
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    res = lm.landmark_inference(
        {"matcher": matcher, "neco": neco}, pyramid_to_device(pyr, dev),
        pyr.src_lengths[cl], pyr.tgt_lengths[cl], lcfg,
        s_cap=pow2_cap(pyr.src_lengths[cl]),
        t_cap=pow2_cap(pyr.tgt_lengths[cl]))
    torch.cuda.synchronize()
    c7 = kernels[[k.name for k in kernels].index("flash_attention_fwd")]
    check(c7.launches == 8, f"multiview: C7 launched {c7.launches} times")
    check(all(bool(torch.isfinite(res[n]).all()) for n in
              ("conf_matrix_pred", "neco_confidence", "ldmk_s")),
          "multiview: landmark_inference with ported weights not finite")
    out["port"] = dict(matcher_names=len(mrep["used"]),
                       neco_names=len(nrep["used"]),
                       unused=mrep["unused"], seconds=port_s,
                       c7_launches=c7.launches,
                       landmarks=int(res["ldmk_valid"].sum()))
    phase("multiview", f"port_matcher / port_neco: {len(mrep['used'])} + "
          f"{len(nrep['used'])} reference names onto every leaf (skipped: "
          f"{mrep['unused']}) in {port_s:.3f} s; landmark_inference with "
          f"them: C7 {c7.launches} launches, "
          f"{out['port']['landmarks']} landmarks")
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PARALLEL_ITERS = 100        # of BENCH_SOLVER's 500 a level: time
PARALLEL_KERNELS = ("nn_dual", "level_warp_fwd", "scatter_rows",
                    "level_warp_bwd", "adam_step")


def parallel_cfg(dp):
    return dp.SolverConfig(
        pyramid=dp.NDPConfig(**BENCH_PYRAMID),
        **dict(BENCH_SOLVER, iters=PARALLEL_ITERS), use_fused_iteration=True)


def _gloo_rank(rank: int, port: int, payload: dict, queue) -> None:
    """One of two ranks on one card under gloo: register_sharded over a
    data axis of 2, aggregate_metrics_sharded, and sharded_nn_min over a
    model axis of 2, with CUDA tensors, against the parent's one-process
    results."""
    import traceback

    import torch.distributed as dist

    try:
        sys.path.insert(0, str(REPO))
        import deformationpyramid_tpu_torch as dp
        from deformationpyramid_tpu_torch.metrics.flow import metric_sums
        from deformationpyramid_tpu_torch.ops import cuda_lib
        from deformationpyramid_tpu_torch.parallel import batched, mesh

        dev = torch.device(payload["device"])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        data_mesh = mesh.make_mesh()
        model_mesh = mesh.make_mesh(n_data=1, n_model=2)
        for k in cuda_lib.KERNELS:
            k.launches = 0
        src, tgt = (payload[k].to(dev) for k in ("src", "tgt"))
        warped, stats = batched.register_sharded(data_mesh, parallel_cfg(dp))(
            payload["keys"], src, tgt)
        flow = warped - src
        sums = batched.aggregate_metrics_sharded(data_mesh)(
            flow, payload["flow_gt"].to(dev),
            torch.ones(flow.shape[:2], dtype=torch.bool, device=dev))
        ref = metric_sums(flow.reshape(-1, 3),
                          payload["flow_gt"].to(dev).reshape(-1, 3))
        nn = batched.sharded_nn_min(model_mesh)(payload["x"].to(dev),
                                                payload["y"].to(dev))
        torch.cuda.synchronize()
        queue.put((rank, dict(
            warped_equal=torch.equal(warped.cpu(), payload["warped"]),
            iters_equal=torch.equal(stats["iters"].cpu(), payload["iters"]),
            sums_rel_err=max(rel_err(sums[k], ref[k]) for k in ref),
            nn_equal=torch.equal(nn.cpu(), payload["nn"]),
            launches={k.name: k.launches for k in cuda_lib.KERNELS
                      if k.launches})))
        dist.destroy_process_group()
    except Exception:   # the parent fails the phase on any error
        queue.put((rank, {"error": traceback.format_exc()[-3000:]}))


def parallel_phase(dp, dev, kernels):
    """parallel/ on one card: a world of 1 under NCCL (register_sharded,
    aggregate_metrics_sharded, sharded_nn_min, neco_train_step_sharded, the
    eval_nolearned sweep under torchrun's variables), then two ranks on the
    same card under gloo with CUDA tensors."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from deformationpyramid_tpu_torch.cli import eval_nolearned as ev
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pyramid_to_device)
    from deformationpyramid_tpu_torch.data.synthetic import (
        make_batch, make_pair, write_4dmatch_suite)
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE
    from deformationpyramid_tpu_torch.metrics.flow import metric_sums
    from deformationpyramid_tpu_torch.models.pyramid import (tree_leaves,
                                                             tree_map)
    from deformationpyramid_tpu_torch.ops import knn
    from deformationpyramid_tpu_torch.parallel import batched, mesh

    out = {}
    t_phase = time.perf_counter()
    env = dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    check(not mesh.initialize_distributed(), "parallel: a world of 1 "
          "initialised a process group")
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{env['MASTER_PORT']}", world_size=1, rank=0,
                            device_id=dev)
    try:
        m = mesh.make_mesh()
        check(dist.get_backend() == "nccl" and tuple(m.shape) == (1, 1),
              f"parallel: mesh {m}")
        cfg = parallel_cfg(dp)
        srcs, tgts, flows = make_batch(2, n=2000, seed=300, deform=0.12)
        src, tgt, flow_gt = (torch.from_numpy(a).to(dev)
                             for a in (srcs, tgts, flows))
        keys = [3, 4]
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        warped, stats = batched.register_sharded(m, cfg)(keys, src, tgt)
        torch.cuda.synchronize()
        reg_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels if k.launches}
        for name in PARALLEL_KERNELS:
            check(launches.get(name, 0) > 0,
                  f"parallel: register_sharded never launched {name}")
        ref_w, ref_s = dp.register_batch(keys, src, tgt, cfg)
        check(torch.equal(warped, ref_w) and all(
            torch.equal(stats[k], ref_s[k]) for k in ref_s),
              "parallel: register_sharded differs from register_batch")
        iters = stats["iters"].cpu()
        check(bool(((iters >= 1) & (iters <= PARALLEL_ITERS)).all()),
              f"parallel: iterations {iters.tolist()}")
        epe = float((warped - src - flow_gt).norm(dim=-1).mean())
        init = float(flow_gt.norm(dim=-1).mean())
        check(np.isfinite(epe) and epe < init,
              f"parallel: EPE {epe} against the initial {init}")
        sums = batched.aggregate_metrics_sharded(m)(
            warped - src, flow_gt,
            torch.ones(2, 2000, dtype=torch.bool, device=dev))
        ref = metric_sums((warped - src).reshape(-1, 3),
                          flow_gt.reshape(-1, 3))
        check(all(torch.equal(sums[k], ref[k]) for k in ref),
              "parallel: aggregate_metrics_sharded != metric_sums")
        rng = np.random.default_rng(8)
        x, y = (torch.from_numpy(rng.normal(size=(6000, 3)).astype(
            np.float32)).to(dev) for _ in range(2))
        c14 = kernels[[k.name for k in kernels].index("nn_argmin")]
        c14.launches = 0
        nn = batched.sharded_nn_min(m)(x, y)
        nn_launches = c14.launches
        check(nn_launches == 1 and torch.equal(nn, knn.nn_argmin(x, y)[0]),
              "parallel: sharded_nn_min is not bit-equal to one C14 call")
        out.update(register_s=reg_s, launches=launches,
                   iters=iters.tolist(), epe=epe, initial_epe=init,
                   nn_min_c14_launches=nn_launches)
        phase("parallel", f"NCCL world of 1, mesh (1, 1): register_sharded "
              f"on 2 bench pairs (cap {PARALLEL_ITERS} iterations a level) "
              f"bit-equal to register_batch in {reg_s:.3f} s, iterations "
              f"{iters.tolist()}, EPE {epe:.5f} (initial {init:.5f}), "
              f"launches {launches}; aggregate_metrics_sharded == "
              f"metric_sums; sharded_nn_min [6000 x 6000] bit-equal to C14 "
              f"({nn_launches} launch)")

        # one data-parallel NeCo step at full width on 2 pairs
        lcfg, _ = lndp_config("flash")
        kp = lcfg.matcher.kpfcn
        pairs = [make_pair(n=2000, seed=20 + i, deform=0.08)[:2]
                 for i in range(2)]
        limits = calibrate_neighborhood_limits(pairs, kp, KPFCN_ARCHITECTURE)
        pyrs = [build_pair_pyramid(s, t, kp, KPFCN_ARCHITECTURE, limits,
                                   pad_to="pow2") for s, t in pairs]
        pad = [max(len(p.points[l]) for p in pyrs)
               for l in range(len(pyrs[0].points))]
        pyrs = [build_pair_pyramid(s, t, kp, KPFCN_ARCHITECTURE, limits,
                                   pad_to=pad) for s, t in pairs]
        cl = lcfg.matcher.coarse_level
        batch = {
            "pyramid": tree_map(lambda *ts: torch.stack(ts),
                                *[pyramid_to_device(p, dev) for p in pyrs]),
            "src_len_c": torch.tensor([p.src_lengths[cl] for p in pyrs],
                                      dtype=torch.int32, device=dev),
            "tgt_len_c": torch.tensor([p.tgt_lengths[cl] for p in pyrs],
                                      dtype=torch.int32, device=dev),
            "coarse_flow": torch.zeros(2, pad[cl], 3, device=dev),
            "gt_rot": torch.eye(3, device=dev).repeat(2, 1, 1),
            "gt_trn": torch.zeros(2, 3, 1, device=dev)}
        lparams = lm.init_landmark_model(torch.Generator().manual_seed(0),
                                         lcfg, device=dev)
        c7 = kernels[[k.name for k in kernels].index("flash_attention_fwd")]
        c7.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, loss = batched.neco_train_step_sharded(
            m, lparams["matcher"], lcfg)(lparams["neco"], batch)
        torch.cuda.synchronize()
        neco_s = time.perf_counter() - t0
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(new), tree_leaves(lparams["neco"])))
        check(np.isfinite(float(loss)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(new))
              and moved > 0 and c7.launches == 16,
              f"parallel: NeCo step loss {float(loss)}, moved {moved}, C7 "
              f"{c7.launches}")
        out.update(neco_loss=float(loss), neco_s=neco_s,
                   neco_c7_launches=c7.launches)
        phase("parallel", f"neco_train_step_sharded at full width on 2 pairs "
              f"(coarse pad {pad[cl]}): loss {float(loss):.5f}, the largest "
              f"move {moved:.3e}, C7 {c7.launches} launches, "
              f"{neco_s:.3f} s")

        # the sweep under torchrun's variables for a world of 1 against a
        # plain run: the same ledger row, no .p suffix
        work = REPO / "build" / "chip_smoke" / "parallel"
        shutil.rmtree(work, ignore_errors=True)
        write_4dmatch_suite(str(work / "split"), "4DMatch-F", n_pairs=1)
        argv = ["--config", str(REPO / "config" / "NDP.yaml"), "--data-root",
                str(work / "split"), "--splits", "4DMatch-F", "--device",
                str(dev)]
        ev.main([*argv, "--log-dir", str(work / "torchrun")])
    finally:
        dist.destroy_process_group()
    for k in env:
        os.environ.pop(k)
    ev.main([*argv, "--log-dir", str(work / "plain")])
    rows = {tag: (work / tag / "4DMatch-F.pairs.jsonl").read_text()
            for tag in ("torchrun", "plain")}
    check(rows["torchrun"] == rows["plain"] and rows["plain"].count("\n") == 1
          and not list((work / "torchrun").glob("*.p0.*")),
          f"parallel: the world-of-1 sweep's row differs: {rows}")
    phase("parallel", "eval_nolearned under torchrun's variables (world 1): "
          "the same ledger row as a plain run, no .p suffix")

    # two ranks on the one card under gloo (NCCL takes one rank a card)
    payload = dict(device=str(dev), keys=keys, src=src.cpu(), tgt=tgt.cpu(),
                   flow_gt=flow_gt.cpu(), warped=warped.cpu(),
                   iters=iters, x=x.cpu(), y=y.cpu(), nn=nn.cpu())
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_gloo_rank, args=(r, port, payload, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
    gloo_s = time.perf_counter() - t0
    for r in range(2):
        check("error" not in res[r], f"parallel: gloo rank {r}: "
              f"{res[r].get('error')}")
        check(res[r]["warped_equal"] and res[r]["iters_equal"]
              and res[r]["nn_equal"] and res[r]["sums_rel_err"] <= 1e-6,
              f"parallel: gloo rank {r}: {res[r]}")
        for name in PARALLEL_KERNELS + ("nn_argmin",):
            check(res[r]["launches"].get(name, 0) > 0,
                  f"parallel: gloo rank {r} never launched {name}")
    out.update(gloo=res, gloo_s=gloo_s,
               seconds=time.perf_counter() - t_phase)
    phase("parallel", f"gloo, 2 ranks on one card, CUDA tensors: "
          f"register_sharded (one pair a rank) bit-equal to register_batch, "
          f"sharded_nn_min over a model axis of 2 bit-equal to C14, metric "
          f"sums within {max(r['sums_rel_err'] for r in res.values()):.1e}; "
          f"launches rank 0 {res[0]['launches']}, rank 1 "
          f"{res[1]['launches']}; {gloo_s:.3f} s with the start-up")
    return out


C1_SLOTS = 4             # bench_torch.py --streaming's slots
STREAM_EPE_RATIO = 0.6   # tests/test_streaming.py's bound on every pair


def c1_slots_case(dev) -> dict:
    """C1 with a slot axis, the streaming solver's launch, at its shapes:
    4 slots of 2000 x 2000 (slot 1 a third of each cloud masked out, slot
    2 on a grid of 1/32 with exact ties, slot 3 without a valid database
    row), made with numpy. One launch; every slot's four outputs bit-equal
    to the one-pair C1 on that slot; distances 1e-5 of the batched plain
    version and indices equal up to near-ties; the time against four
    one-pair launches, the plain version, the library call (batched cdist
    both ways) and the bound (8 flops a pair of points, B x N x M pairs;
    the points, masks and outputs once)."""
    from deformationpyramid_tpu_torch.ops import knn

    rng = np.random.default_rng(2027)
    b, n, m = C1_SLOTS, 2000, 2000
    x = rng.normal(0.0, 0.3, (b, n, 3)).astype(np.float32)
    y = rng.normal(0.0, 0.3, (b, m, 3)).astype(np.float32)
    x[2], y[2] = np.round(x[2] * 32) / 32, np.round(y[2] * 32) / 32
    xv, yv = np.ones((b, n), bool), np.ones((b, m), bool)
    xv[1], yv[1] = rng.random(n) > 1 / 3, rng.random(m) > 1 / 3
    yv[3] = False
    x, y, xv, yv = (torch.from_numpy(a).to(dev) for a in (x, y, xv, yv))
    before = knn.NN_DUAL.launches
    got = knn.nn_argmin_dual(x, y, xv, yv)
    torch.cuda.synchronize()
    check(knn.NN_DUAL.launches == before + 1,
          "C1 slots: not one launch for the 4 slots")
    for slot in range(b):
        one = knn.nn_argmin_dual(x[slot], y[slot], xv[slot], yv[slot])
        for name, a, c in zip(("d_xy", "i_xy", "d_yx", "i_yx"), got, one):
            check(torch.equal(a[slot], c), f"C1 slots: slot {slot} {name} "
                  "differs from the one-pair launch")
    ref = knn.nn_argmin_dual_plain(x, y, xv, yv)
    err = 0.0
    for slot in range(b):
        for q, db, (d, i), (rd, ri) in (
                (x[slot], y[slot], (got[0][slot], got[1][slot]),
                 (ref[0][slot], ref[1][slot])),
                (y[slot], x[slot], (got[2][slot], got[3][slot]),
                 (ref[2][slot], ref[3][slot]))):
            fin = torch.isfinite(rd)
            check(torch.equal(torch.isfinite(d), fin),
                  f"C1 slots: slot {slot} +inf rows differ from plain")
            if bool(fin.any()):
                err = max(err, float((d[fin] - rd[fin]).abs().max()))
                near_ties(q[fin], db, i[fin], ri[fin], "C1 slots")
    check(err <= 1e-5, f"C1 slots: distance err {err} > 1e-5")

    def library():
        d = torch.cdist(x, y, compute_mode="donot_use_mm_for_euclid_dist")
        return d.min(-1), d.min(-2)

    def one_pair_launches():
        for slot in range(b):
            knn.nn_argmin_dual(x[slot], y[slot], xv[slot], yv[slot])

    return dict(
        err=err, shape=f"{b} x {n} x {m}",
        ms=cuda_ms(lambda: knn.nn_argmin_dual(x, y, xv, yv)),
        one_pair_x4_ms=cuda_ms(one_pair_launches),
        plain_ms=cuda_ms(lambda: knn.nn_argmin_dual_plain(x, y, xv, yv)),
        library_ms=cuda_ms(library),
        **bound(b * (n + m) * (12 + 1 + 4 + 8), 8.0 * b * n * m),
        tol="each slot bit-equal to the one-pair C1; distances 1e-5 of "
            "plain, indices equal up to near-ties")


def stream_step_reads_nothing(dev, k_inner: int = 3) -> int:
    """``multi_step`` of solve/streaming.py at the bench configuration on 4
    slots of bench pairs, once to warm up, then again with the device's
    synchronising calls turned into errors: the iterations read nothing
    back to the host. Returns the iterations checked."""
    import bench_torch
    from deformationpyramid_tpu_torch.data.synthetic import make_batch
    from deformationpyramid_tpu_torch.solve import streaming

    srcs, tgts, _ = make_batch(C1_SLOTS, n=2000, seed=0, deform=0.12)
    multi_step, _, _, init_one = streaming.make_stream_fns(bench_torch.CFG,
                                                           k_inner)
    gen = torch.Generator().manual_seed(0)
    state = streaming.stack_states([
        init_one(gen, torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
        for s, t in zip(srcs, tgts)])
    state = multi_step(state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = multi_step(state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    check(int(state["total_iters"].min()) == 2 * k_inner,
          f"streaming: total_iters {state['total_iters'].tolist()}")
    return k_inner


def streaming_phase(dev, kernels) -> dict:
    """bench_torch.py --streaming at its defaults (16 timed pairs after a
    warm-up on 4, 4 slots, 2000 points, 100 iterations between polls):
    every pair's EPE below 0.6x its initial flow, C1 the one kernel
    launched, pairs/s; then the slot-batched C1 at the bench's shapes."""
    import bench_torch
    from deformationpyramid_tpu_torch.solve import streaming

    # every iteration of every multi_step, warm-up included, is one C1
    # launch for all slots: count the iterations the solver ran
    iterations = [0]
    make = streaming.make_stream_fns

    def counting(cfg, k_inner=50):
        multi_step, *rest = make(cfg, k_inner)

        def counted(state):
            iterations[0] += k_inner
            return multi_step(state)
        return (counted, *rest)

    for k in kernels:
        k.launches = 0
    streaming.make_stream_fns = counting
    try:
        t0 = time.perf_counter()
        out = bench_torch.main(["--streaming"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        streaming.make_stream_fns = make
    launches = {k.name: k.launches for k in kernels}
    check(launches["nn_dual"] > 0 and launches["nn_dual"] == iterations[0],
          f"streaming: {launches['nn_dual']} C1 launches, not one for each "
          f"of the {iterations[0]} slot-batched iterations")
    check(all(v == 0 for k, v in launches.items() if k != "nn_dual"),
          f"streaming: kernels other than C1 launched: {launches}")
    for i, (e, e0) in enumerate(zip(out["epe"], out["initial_epe"])):
        check(np.isfinite(e) and e < STREAM_EPE_RATIO * e0,
              f"streaming: pair {i} EPE {e} against initial {e0}")
    phase("streaming", f"bench_torch.py --streaming: {out['value']} pairs/s "
          f"({out['pairs']} pairs, {out['slots']} slots, k_inner "
          f"{out['k_inner']}, {out['seconds']:.3f} s timed, {secs:.3f} s "
          f"with the warm-up); EPE / initial max "
          f"{max(e / e0 for e, e0 in zip(out['epe'], out['initial_epe'])):.4f}"
          f"; C1 launches {launches['nn_dual']}, one an iteration of all "
          f"slots; {out['card']}")
    no_sync = stream_step_reads_nothing(dev)
    phase("streaming", f"multi_step (4 slots, {no_sync} iterations) under "
          "torch.cuda.set_sync_debug_mode('error'): no host read")
    slots = c1_slots_case(dev)
    phase("kernels", f"nn_dual [{slots['shape']}, one launch]: slots "
          f"bit-equal to one-pair launches, max_abs_err {slots['err']:.3e}; "
          f"{slots['ms']:.4f} ms against four one-pair launches "
          f"{slots['one_pair_x4_ms']:.4f} ms, plain {slots['plain_ms']:.4f}, "
          f"library {slots['library_ms']:.4f}, bound {slots['bound_ms']:.4f} "
          f"({slots['bound_by']})")
    return dict(out, launches=launches, phase_s=secs, c1_slots=slots)


def _tie_ok(pts_q, pts_s, a, b, radius) -> int:
    """Rows of two neighbour tables that differ as sets only by members
    at the cut-off: equidistant with the row's farthest kept neighbour, or
    at the radius (1e-5 relative, the two paths compute the distance in
    float32 and float64). Returns the number of such rows; anything else
    fails."""
    n_s = len(pts_s)
    rows = np.nonzero((np.sort(a, 1) != np.sort(b, 1)).any(1))[0]
    for r in rows:
        ka, kb = set(a[r][a[r] < n_s]), set(b[r][b[r] < n_s])
        kept = np.array(sorted(ka | kb), np.int64)
        d = np.sqrt(((pts_s[kept].astype(np.float64)
                      - pts_q[r].astype(np.float64)) ** 2).sum(-1))
        dist = dict(zip(kept.tolist(), d))
        cut = max(max((dist[j] for j in ka), default=0.0),
                  max((dist[j] for j in kb), default=0.0))
        for j in ka ^ kb:
            check(abs(dist[j] - cut) <= 1e-5 * cut
                  or abs(dist[j] - radius) <= 1e-5 * radius,
                  f"native: row {r} member {j} at {dist[j]} is no tie "
                  f"(cut-off {cut}, radius {radius})")
    return len(rows)


def native_phase(dev) -> dict:
    """The collate of the lndp pair (make_pair(n=8000, seed=400)) through
    the native library (the default) and through numpy + cKDTree: every
    level's points equal, neighbour, pool and upsample tables equal as
    sets up to ties at the cut-off; seconds a pair of each (calibration +
    pyramid, host clock, the better of 3)."""
    from deformationpyramid_tpu_torch import native
    from deformationpyramid_tpu_torch.data import collate
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE

    lib = native.load()
    lcfg, _ = lndp_config("flash")
    kp = lcfg.matcher.kpfcn
    src, tgt, _ = make_pair(n=8000, seed=400, deform=0.08)

    def run():
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            limits = collate.calibrate_neighborhood_limits(
                [(src, tgt)], kp, KPFCN_ARCHITECTURE)
            pyr = collate.build_pair_pyramid(src, tgt, kp, KPFCN_ARCHITECTURE,
                                             limits, pad_to="pow2")
            times.append(time.perf_counter() - t0)
        return pyr, limits, min(times)

    nat_pyr, nat_limits, nat_s = run()
    hook = collate._native
    collate._native = lambda: None
    try:
        np_pyr, np_limits, np_s = run()
    finally:
        collate._native = hook
    check(collate._native() is native, "native: the collate's default is "
          "not the native library")
    check(nat_limits == np_limits, f"native: neighbourhood limits "
          f"{nat_limits} against numpy {np_limits}")
    tie_rows, rows = 0, 0
    r_normal = kp.first_subsampling_dl * kp.conv_radius
    for lvl, (pa, pb) in enumerate(zip(nat_pyr.points, np_pyr.points)):
        check(np.array_equal(pa, pb), f"native: level {lvl} points differ")
        r = r_normal * 2 ** lvl      # KPFCN has no deformable block
        tables = [(nat_pyr.neighbors[lvl], np_pyr.neighbors[lvl], pa, pa, r)]
        if lvl < len(nat_pyr.pools):
            nxt = nat_pyr.points[lvl + 1]
            tables += [(nat_pyr.pools[lvl], np_pyr.pools[lvl], nxt, pa, r),
                       (nat_pyr.upsamples[lvl], np_pyr.upsamples[lvl], pa,
                        nxt, 2 * r)]
        for a, b, q, sup, radius in tables:
            check(a.shape == b.shape, f"native: level {lvl} table shapes "
                  f"{a.shape} / {b.shape}")
            # the padded rows and the shadow rows are the same on both
            n_sup = len(sup)
            a = np.where(a >= n_sup, n_sup, a)
            b = np.where(b >= n_sup, n_sup, b)
            rows += len(a)
            tie_rows += _tie_ok(q, sup[:n_sup], a, b, radius)
    phase("native", f"collate of the lndp pair ({len(src)} + {len(tgt)} "
          f"points): native {nat_s:.4f} s against numpy + cKDTree "
          f"{np_s:.4f} s (the better of 3; {Path(lib._name).name}); "
          f"points equal at every level, "
          f"neighbour tables equal as sets on {rows - tie_rows} of {rows} "
          f"rows, the other {tie_rows} differ only by ties at the cut-off")
    return dict(native_s=nat_s, numpy_s=np_s, rows=rows,
                tie_rows=tie_rows, limits=nat_limits)


BF16_CONF_REL = 2.0 ** -5   # tests/test_torch_bf16_inference.py's bound


def bf16_matmul_check(dev, rows: int = 2900, k: int = 528) -> dict:
    """``matmul_f32acc``'s bf16 product on the card, which must take the
    'out_dtype' form (``torch.mm(a_bf16, b_bf16, out_dtype=float32)``; a
    failed probe fails here), against its upcast form (the bf16-rounded
    operands in a float32 product, TF32 off) on the same inputs at the
    transformer's widths ([rows, 528] x [528, 528]). A product of two bf16
    values is exact in float32, so the forms differ only in how the K terms
    are summed: each sum lies within K u of sum |a||b|, u = 2^-24 where it
    rounds and up to 2^-23 where the tensor cores truncate, so every
    element is held within K 2^-22 of (|a| @ |b|)."""
    from deformationpyramid_tpu_torch.match.attention import (
        _round_bf16, bf16_matmul_form, matmul_f32acc)

    form = bf16_matmul_form(dev)
    check(form == "out_dtype", f"bf16: the product form on torch "
          f"{torch.__version__} is {form!r}, not 'out_dtype'")
    gen = torch.Generator().manual_seed(18)
    a = torch.randn(rows, k, generator=gen).to(dev)
    b = (torch.randn(k, k, generator=gen) * k ** -0.5).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = matmul_f32acc(a, b, True)
        ref = _round_bf16(a) @ _round_bf16(b)
        scale = _round_bf16(a).abs() @ _round_bf16(b).abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    check(got.dtype == torch.float32 and got.shape == ref.shape,
          f"bf16: out_dtype product {got.dtype} {tuple(got.shape)}")
    ratio = float(((got - ref).abs()
                   / (k * 2.0 ** -22 * scale.clamp_min(1e-30))).max())
    err = float((got - ref).abs().max())
    check(ratio <= 1.0, f"bf16: out_dtype product {err:.3e} from the "
          f"upcast form, {ratio:.3f} of its bound K 2^-22 |a||b|")
    return dict(form=form, err=err, rel_err=err / float(ref.abs().max()),
                ratio=ratio)


def bf16_phase(dev) -> dict:
    """landmark_inference at config/LNDP.yaml's widths (weights from seed
    0, the flash route) with inference_dtype bfloat16 (compute_dtype of
    the transformer and the matching) against float32, on the lndp pair
    (make_pair(n=8000, seed=400)): every output finite, the confidence
    matrices within 2^-5 of the float32 one's max (the bound of
    tests/test_torch_bf16_inference.py's narrow landmark model), matches
    and landmarks counted, the overlap of the two match sets; ms a call
    (host clock, the median of 5 after a warm-up); then
    :func:`bf16_matmul_check`."""
    from deformationpyramid_tpu_torch.data.collate import (
        build_pair_pyramid, calibrate_neighborhood_limits, pow2_cap,
        pyramid_to_device)
    from deformationpyramid_tpu_torch.data.synthetic import make_pair
    from deformationpyramid_tpu_torch.match import landmark as lm
    from deformationpyramid_tpu_torch.match.attention import bf16_matmul_form
    from deformationpyramid_tpu_torch.match.backbone import KPFCN_ARCHITECTURE

    lcfg, _ = lndp_config("flash")
    m = lcfg.matcher
    mc = dataclasses.replace(m.matching, compute_dtype="bfloat16")
    tr = dataclasses.replace(m.transformer, compute_dtype="bfloat16",
                             matching=mc)
    lcfg_bf = dataclasses.replace(lcfg, matcher=dataclasses.replace(
        m, transformer=tr, matching=mc))
    kp, cl = m.kpfcn, m.coarse_level
    params = lm.init_landmark_model(torch.Generator().manual_seed(0), lcfg,
                                    device=dev)
    src, tgt, _ = make_pair(n=8000, seed=400, deform=0.08)
    limits = calibrate_neighborhood_limits([(src, tgt)], kp,
                                           KPFCN_ARCHITECTURE)
    pyr = build_pair_pyramid(src, tgt, kp, KPFCN_ARCHITECTURE, limits,
                             pad_to="pow2")
    pyrd = pyramid_to_device(pyr, dev)
    caps = dict(s_cap=pow2_cap(pyr.src_lengths[cl]),
                t_cap=pow2_cap(pyr.tgt_lengths[cl]))
    lens = (torch.tensor(pyr.src_lengths[cl], device=dev),
            torch.tensor(pyr.tgt_lengths[cl], device=dev))
    res = {}
    for tag, cfg in (("float32", lcfg), ("bfloat16", lcfg_bf)):
        out = lm.landmark_inference(params, pyrd, *lens, cfg, **caps)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            out = lm.landmark_inference(params, pyrd, *lens, cfg, **caps)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        for name in ("conf_matrix_pred", "src_feats", "tgt_feats", "ldmk_s",
                     "ldmk_t", "match_conf", "R_s2t_pred", "condition"):
            check(bool(torch.isfinite(out[name]).all()),
                  f"bf16: {tag} {name} is not finite")
        idx = out["match_idx"][out["match_valid"]].cpu().numpy()
        res[tag] = dict(ms=statistics.median(times), ms_all=times,
                        matches={tuple(r) for r in idx.tolist()},
                        landmarks=int(out["ldmk_valid"].sum()),
                        conf=out["conf_matrix_pred"])
    a, b = res["float32"], res["bfloat16"]
    overlap = len(a["matches"] & b["matches"]) / max(len(a["matches"]), 1)
    conf_err = float((a["conf"] - b["conf"]).abs().max())
    conf_max = float(a["conf"].abs().max())
    check(conf_err <= BF16_CONF_REL * conf_max, f"bf16: confidence "
          f"matrices {conf_err:.3e} apart, above 2^-5 of the float32 "
          f"matrix's max {conf_max:.3e}")
    check(np.isfinite(overlap), f"bf16: match overlap {overlap}")
    mm = bf16_matmul_check(dev)
    out = dict(form=bf16_matmul_form(dev), conf_max_abs_diff=conf_err,
               conf_max=conf_max, matmul=mm,
               match_overlap=overlap, caps=[caps["s_cap"], caps["t_cap"]],
               **{f"{tag}_{k}": (len(r[k]) if k == "matches" else r[k])
                  for tag, r in res.items()
                  for k in ("ms", "ms_all", "matches", "landmarks")})
    phase("bf16", f"landmark_inference at config/LNDP.yaml's widths, caps "
          f"{out['caps']}: bfloat16 {b['ms']:.3f} ms against float32 "
          f"{a['ms']:.3f} ms (median of 5; bf16 products by "
          f"'{out['form']}'); matches {len(b['matches'])} / "
          f"{len(a['matches'])}, overlap {overlap:.4f} of the float32 set; "
          f"landmarks {b['landmarks']} / {a['landmarks']}; confidence "
          f"matrices max abs diff {conf_err:.3e} (max {conf_max:.3e}, "
          f"bound 2^-5 of it); the out_dtype product at [2900, 528] x "
          f"[528, 528] {mm['err']:.3e} from the upcast form, "
          f"{mm['ratio']:.4f} of its bound")
    return out


def machine_line() -> str:
    """The card, its driver, power limit and compute capability, the CUDA
    of PyTorch and of nvcc: what ties a failing run to its machine."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,driver_version,power.limit,"
         "compute_cap", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    try:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        ver = ver.splitlines()[-1] if ver else "no output"
    except OSError as exc:
        ver = f"not run ({exc})"
    return (f"machine: {smi}; torch.version.cuda {torch.version.cuda}; "
            f"nvcc {ver}")


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: no CUDA device; the port's main path "
                           "runs only on a GPU")
    print(machine_line(), flush=True)
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)      # the yaml files name their sub-configs from here
    import deformationpyramid_tpu_torch as dp
    from deformationpyramid_tpu_torch.match import attention
    from deformationpyramid_tpu_torch.ops import (chamfer_fused, cuda_lib,
                                                  fused_iteration, knn)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls enabled")
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}; fp32 highest, "
          "no TF32")

    path, secs = cuda_lib.build()
    cuda_lib.load()
    phase("build", f"nvcc {secs:.1f} s -> {path.relative_to(REPO)}")
    from deformationpyramid_tpu_torch import native
    path, secs = native.build()
    native.load()
    phase("build", f"the native collate: c++ {secs:.1f} s -> "
          f"{path.relative_to(REPO)}")
    c3_regs, c5_regs = c3_ptxas(), c5_ptxas()
    check(len(c3_regs) == 18, f"ptxas reported {len(c3_regs)} C3 "
          "instantiations, not 18")
    check(len(c5_regs) == 9, f"ptxas reported {len(c5_regs)} C5 "
          "instantiations, not 9")
    phase("build", "C3 ptxas (registers / spill stores / spill loads): "
          + ptxas_line(c3_regs))
    phase("build", "C5 ptxas (registers / spill stores / spill loads): "
          + ptxas_line(c5_regs))
    nsfp_regs = nsfp_ptxas()
    check(len(nsfp_regs) == 2 and not any(
        r["spill_stores"] or r["spill_loads"] for r in nsfp_regs),
          f"ptxas on C10 / C11: {nsfp_regs}")
    phase("build", "C10 / C11 ptxas (registers / spill stores / spill "
          "loads): " + ptxas_line(nsfp_regs))
    nn_regs = nn_ptxas()
    check(len(nn_regs) == 7 and not any(
        r["spill_stores"] or r["spill_loads"] for r in nn_regs),
          f"ptxas on C1 / C14 / C12 / C6: {nn_regs}")
    phase("build", "C1 / C14 / C12 / C6 ptxas (registers / spill stores / "
          "spill loads): " + ptxas_line(nn_regs))

    kernels = [knn.NN_DUAL, fused_iteration.LEVEL_WARP_FWD,
               fused_iteration.SCATTER_ROWS, fused_iteration.LEVEL_WARP_BWD,
               fused_iteration.ADAM_STEP, fused_iteration.LDMK_ITERATION,
               attention.FLASH_ATTENTION, attention.FLASH_ATTENTION_BWD_DKV,
               attention.FLASH_ATTENTION_BWD_DQ, fused_iteration.NSFP_FWD,
               fused_iteration.NSFP_BWD, chamfer_fused.CHAMFER_FUSED,
               fused_iteration.SUM_PARTIALS, knn.NN_ARGMIN]
    measured = kernel_phase(dp, dev)
    sim3 = sim3_kernel_phase(dp, dev)
    formats = format_kernel_phase(dp, dev)
    measured["ldmk_iteration"] = ldmk_kernel_phase(dp, dev)
    ldmk_quat = ldmk_kernel_phase(
        dp, dev, pyr=dict(LNDP_PYRAMID, rotation_format="quaternion"),
        timed=False)
    measured.update(flash_kernel_phase(dev))
    nsfp_k = nsfp_kernel_phase(dp, dev)
    measured.update({k: nsfp_k[k] for k in ("nsfp_fwd", "nsfp_bwd")})
    optin_k = optin_kernel_phase(dp, dev)
    measured.update({k: optin_k[k] for k in ("chamfer_fused",
                                             "sum_partials")})

    fused = slice_phase(dp, dev, kernels, fused=True, n_pairs=3)
    for name in CHAMFER_KERNELS:
        check(fused["launches"][name] > 0,
              f"fused: kernel {name} was never launched")
    phase("fused", f"{fused['pairs_per_s']:.4f} pairs/s, "
          f"{fused['ms_per_iter']:.4f} ms/iter ({fused['iters']} iterations "
          f"in {fused['seconds']:.3f} s), launches {fused['launches']}; {smi}")

    repeat_phase(dp, dev)

    unfused = slice_phase(dp, dev, kernels, fused=False, n_pairs=1)
    check(unfused["launches"]["nn_dual"] > 0,
          "unfused: kernel nn_dual was never launched")
    phase("unfused", f"{unfused['pairs_per_s']:.4f} pairs/s, "
          f"{unfused['ms_per_iter']:.4f} ms/iter, launches "
          f"{unfused['launches']}; {smi}")

    shape = shape_phase(dp, dev, kernels)
    landmark = landmark_phase(dp, dev, kernels)
    phase("landmark", f"C5 {landmark['C5']['ms_per_iter']:.4f} ms/iter "
          f"against the unfused loop's "
          f"{landmark['unfused']['ms_per_iter']:.4f} ms/iter; {smi}")

    lndp = lndp_phase(dp, dev, kernels)
    phase("lndp", f"collate {statistics.mean(lndp['collate_s']):.3f} s, "
          f"landmark_inference "
          f"{statistics.mean(lndp['landmark_inference_ms']):.3f} ms a pair "
          f"(matcher {lndp['matcher_ms']:.3f} ms, NeCo "
          f"{lndp['neco_ms']:.3f} ms), solve "
          f"{statistics.mean(lndp['solve_ms_per_iter']):.4f} ms/iter, "
          f"landmarks {lndp['landmarks']}; {smi}")

    train = train_phase(dp, dev, kernels)
    fl, xl = train["routes"]["flash"], train["routes"]["xla"]
    phase("train", f"matcher step {fl['step_ms']:.3f} ms (flash, peak "
          f"{fl['peak_gib']:.2f} GiB) against {xl['step_ms']:.3f} ms (einsum, "
          f"peak {xl['peak_gib']:.2f} GiB); 12 steps with checkpoints "
          f"{train['matcher_s']:.3f} s; NeCo {train['neco_s']:.3f} s; "
          f"collate {train['collate_s']:.3f} s a pair; {smi}")

    nolearned = nolearned_phase(dp, dev, kernels)
    phase("nolearned", f"NDP {nolearned['NDP']['pairs_per_s']:.4f} pairs/s, "
          f"{nolearned['NDP']['ms_per_iter']:.4f} ms/iter; NSFP fused "
          f"{nolearned['NSFP fused']['ms_per_iter']:.4f} ms/iter, unfused "
          f"{nolearned['NSFP unfused']['ms_per_iter']:.4f} ms/iter; Nerfies "
          f"{nolearned['Nerfies']['ms_per_iter']:.4f} ms/iter; Sinkhorn "
          f"{nolearned['Sinkhorn']['seconds']:.3f} s a pair; {smi}")

    optin = optin_phase(dp, dev, kernels)
    phase("optin", "ms/iter: " + ", ".join(
        f"{tag} {r['ms_per_iter']:.4f}" for tag, r in optin.items()
        if "ms_per_iter" in r) + f"; {smi}")

    ed = ed_phase(dp, dev, kernels)
    measured["nn_argmin"] = ed["c14"]
    phase("ed", f"NICP full-epe {ed['nicp']['scores']['full-epe']:.4f} cm "
          f"(initial {ed['nicp']['initial_epe_cm']:.4f}), solve "
          f"{statistics.mean(ed['nicp']['solve_ms_per_iter']):.4f} ms/iter; "
          f"C14 {ed['c14']['ms']:.4f} ms at {ed['c14']['shape']}; {smi}")

    supervised = supervised_phase(dp, dev, kernels)
    threedmatch = threedmatch_phase(dp, dev, kernels)

    small_phase(dp, dev)
    small_landmark_phase(dev)

    multiview = multiview_phase(dp, dev, kernels)
    parallel = parallel_phase(dp, dev, kernels)
    streaming = streaming_phase(dev, kernels)
    measured["nn_dual"]["slots"] = streaming["c1_slots"]
    native = native_phase(dev)
    bf16 = bf16_phase(dev)
    phase("multiview", f"step {multiview['step_ms']:.3f} ms, epoch "
          f"{multiview['epoch_s']:.3f} s, phase "
          f"{multiview['train_s'] + multiview['suite_s']:.3f} s of training; "
          f"parallel phase {parallel['seconds']:.3f} s; {smi}")

    sources = {"nn_dual": ("csrc/nn_dual.cu", "ops/knn.py:389"),
               "level_warp_fwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:139"),
               "level_warp_bwd": ("csrc/level_warp.cu",
                                  "ops/fused_iteration.py:439"),
               "adam_step": ("csrc/adam.cu", "ops/fused_iteration.py:439"),
               "scatter_rows": ("csrc/scatter_rows.cu",
                                "ops/fused_iteration.py:431"),
               "ldmk_iteration": ("csrc/ldmk_iteration.cu",
                                  "ops/fused_iteration.py:1002"),
               "flash_attention_fwd": ("csrc/flash_attention.cu",
                                       "match/attention.py:70"),
               # the stock op's two backward kernels, which that function's
               # VJP launches
               "flash_attention_bwd_dkv": ("csrc/flash_attention_bwd.cu",
                                           "match/attention.py:70"),
               "flash_attention_bwd_dq": ("csrc/flash_attention_bwd.cu",
                                          "match/attention.py:70"),
               # kernels 1 and 2 with model="nsfp"
               "nsfp_fwd": ("csrc/nsfp.cu", "ops/fused_iteration.py:139"),
               "nsfp_bwd": ("csrc/nsfp.cu", "ops/fused_iteration.py:439"),
               "chamfer_fused": ("csrc/chamfer_fused.cu",
                                 "ops/chamfer_fused.py:53"),
               # the cross-tile accumulation of the standalone VJP
               "sum_partials": ("csrc/adam.cu", "ops/fused_level.py:108"),
               "nn_argmin": ("csrc/nn_argmin.cu", "ops/knn.py:76")}
    # the TPU kernels a kernel replaces beyond its "replaces" entry
    also = {"nn_dual": ["ops/knn.py:166", "ops/knn.py:236", "ops/knn.py:306"],
            "level_warp_fwd": ["ops/fused_level.py:99",
                               "ops/fused_level.py:440",
                               "ops/fused_iteration.py:319"],
            "level_warp_bwd": ["ops/fused_level.py:108",
                               "ops/fused_level.py:447"],
            "sum_partials": ["ops/fused_level.py:447"]}
    # each kernel's count from the path that is its own: the fused bench,
    # the landmark solve (C5), the lndp path (C7), the matcher's training
    # (C8, C9; C7's count there stands in the train block), the fused NSFP
    # evaluation (C10, C11)
    path_launches = dict(
        fused["launches"],
        nsfp_fwd=nolearned["NSFP fused"]["launches"]["nsfp_fwd"],
        nsfp_bwd=nolearned["NSFP fused"]["launches"]["nsfp_bwd"],
        ldmk_iteration=landmark["C5"]["launches"]["ldmk_iteration"],
        flash_attention_fwd=lndp["launches"]["flash_attention_fwd"],
        flash_attention_bwd_dkv=train["launches"]["flash_attention_bwd_dkv"],
        flash_attention_bwd_dq=train["launches"]["flash_attention_bwd_dq"],
        chamfer_fused=optin["use_fused_chamfer"]["launches"]["chamfer_fused"],
        sum_partials=optin["use_fused"]["launches"]["sum_partials"],
        # the ed path's point_2_plane_distance, once each way
        nn_argmin=ed["c14"]["point_2_plane"]["launches"])
    rows = []
    for k in kernels:
        row = {"name": k.name, "route": "cuda",
               "source": f"deformationpyramid_tpu_torch/{sources[k.name][0]}",
               "replaces": f"deformationpyramid_tpu/{sources[k.name][1]}",
               "launches": path_launches[k.name],
               "max_abs_err": measured[k.name]["err"],
               "ms": measured[k.name]["ms"],
               "plain_ms": measured[k.name]["plain_ms"],
               "bound_ms": measured[k.name]["bound_ms"],
               "bound_by": measured[k.name]["bound_by"],
               "library_ms": measured[k.name]["library_ms"]}
        if "design_bound_ms" in measured[k.name]:
            row["design_bound_ms"] = measured[k.name]["design_bound_ms"]
        if k.name in also:
            row["also_replaces"] = [f"deformationpyramid_tpu/{r}"
                                    for r in also[k.name]]
        if k.name in ("level_warp_fwd", "level_warp_bwd"):
            row["nonrigid_level_1"] = optin_k["nonrigid"][1][k.name]
        if k.name == "level_warp_bwd":
            row["ptxas"] = c3_regs
            row["rows"] = measured[k.name]["rows"]
        if k.name == "chamfer_fused":
            row["c1_glue_c6_ms"] = measured[k.name]["c1_glue_c6_ms"]
            row["ptxas"] = [r for r in nn_regs if "chamfer" in r["layout"]]
        if k.name in ("nn_dual", "nn_argmin", "scatter_rows"):
            row["ptxas"] = [r for r in nn_regs if k.name in r["layout"]]
        if k.name == "sum_partials":
            row["nonrigid"] = measured[k.name]["nonrigid"]
        if k.name in sim3:
            row["sim3_euler"] = {key: sim3[k.name][key]
                                 for key in ("err", "ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "f32_bound_ms",
                                             "design_bound_ms")
                                 if key in sim3[k.name]}
        if k.name in ("level_warp_fwd", "level_warp_bwd"):
            row["formats"] = {tag: res[k.name]
                              for tag, res in formats.items()}
            row["nolearned_launches"] = {
                tag: nolearned[tag]["launches"][k.name]
                for tag in ("NDP", "NDP quaternion", "NDP 6D", "NDP sflow")}
        if k.name == "ldmk_iteration":
            row["se3_quaternion"] = ldmk_quat
            row["ptxas"] = c5_regs
            for key in ("at_4096_30", "m_rel_err", "v_rel_err",
                        "whole_vector_rel_err", "blocks", "tile"):
                row[key] = measured[k.name][key]
        if k.name == "adam_step":
            row["at_nsfp_shape"] = nsfp_k["adam_step_at_nsfp"]
        if k.name in ("nsfp_fwd", "nsfp_bwd"):
            row["ptxas"] = [r for r in nsfp_regs if k.name in r["layout"]]
        if k.name == "nsfp_bwd":
            row["with_adam"] = measured[k.name]["with_adam"]
        if k.name == "nn_argmin":
            c14 = measured[k.name]
            row["masked"] = c14["masked"]
            row.update({f"at_{n}": c14[f"at_{n}"] for n in C14_SHAPES})
            row["point_2_plane"] = c14["point_2_plane"]
        if "f32_bound_ms" in measured[k.name]:
            row["f32_bound_ms"] = measured[k.name]["f32_bound_ms"]
        if k.name == "scatter_rows":
            row.update({key: measured[k.name][key]
                        for key in ("at_6000", "one_row")})
        if k.name == "nn_dual":
            row.update({key: measured[k.name][key]
                        for key in ("at_6000", "digests", "slots")})
            row["streaming_launches"] = streaming["launches"]["nn_dual"]
        if k.name == "level_warp_fwd":
            row["err_mlp_scale_1"] = measured[k.name]["err_mlp_scale_1"]
        for key in ("at_4096_2836", "at_1024_900"):
            if key in measured[k.name]:
                row[key] = measured[k.name][key]
        if k.name in PARALLEL_KERNELS:
            row["parallel_launches"] = {
                "register_sharded": parallel["launches"][k.name],
                "gloo_ranks": [parallel["gloo"][r]["launches"][k.name]
                               for r in range(2)]}
        if k.name == "nn_argmin":
            row["parallel_launches"] = {
                "sharded_nn_min": parallel["nn_min_c14_launches"],
                "gloo_ranks": [parallel["gloo"][r]["launches"][k.name]
                               for r in range(2)]}
        if k.name in ("flash_attention_fwd", "ldmk_iteration"):
            row["eval_supervised_launches"] = \
                supervised["main"]["launches"][k.name]
        if k.name == "flash_attention_fwd":
            row["eval_3dmatch_launches"] = \
                threedmatch["neco"]["launches"][k.name]
            row["at_path_shape"] = lndp["flash_at_path_shape"]
            row["at_train_shape"] = train["at_path_shape"][k.name]
        elif k.name in train["at_path_shape"]:
            row["at_path_shape"] = train["at_path_shape"][k.name]
            row["both_ms"] = measured[k.name]["both_ms"]
        rows.append(row)
    print(json.dumps({
        "kernels": rows,
        "fused_pairs_per_s": fused["pairs_per_s"],
        "fused_ms_per_iter": fused["ms_per_iter"],
        "unfused_pairs_per_s": unfused["pairs_per_s"],
        "unfused_ms_per_iter": unfused["ms_per_iter"],
        "shape_transfer": shape,
        "landmark": landmark,
        "lndp": {k: v for k, v in lndp.items()
                 if k != "flash_at_path_shape"},
        "train": {k: v for k, v in train.items()
                  if k != "at_path_shape"},
        "nolearned": nolearned,
        "optin": optin,
        "ed": {k: v for k, v in ed.items() if k != "c14"},
        "supervised": {tag: {k: v for k, v in r.items() if k != "rows"}
                       for tag, r in supervised.items()},
        "threedmatch": threedmatch,
        "multiview": multiview,
        "parallel": parallel,
        "streaming": {k: v for k, v in streaming.items()
                      if k != "c1_slots"},
        "native": native,
        "bf16": bf16}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
