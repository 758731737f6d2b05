"""The least time of the chamfer-mode iteration's kernels C2, C3, C4 and
C6, and the share of it that a traced run reads.

Frozen copy of ``chip_smoke.py``'s ``level_bounds`` (its C2, C3 and C4
entries) and of the byte count in its ``scatter_case`` (C6) at commit
a4cba1c6258da00be03068b86d6ef9f5b81c3f56, with the time in seconds; C1's
bound is ``roofline.nn_dual_bound``. Each counts the function's work from
its shapes, each input read once and each output written once.
"""
from __future__ import annotations

import bisect

from benchmark import program_spans, roofline

# Kernel of each share, as its name appears in the trace.
KERNELS = {"nn_dual": "nn_dual_kernel",
           "level_warp_fwd": "level_warp_fwd_kernel",
           "level_warp_bwd": "level_warp_bwd_kernel",
           "adam": "adam_step_kernel",
           "scatter_rows": "scatter_rows_kernel"}


def level_bounds(n: int, width: int, depth: int, heads: int,
                 n_params: int) -> dict:
    """C2, C3 and C4 at n points. The forward is the MLP; it reads the
    parameters and the points and writes the warp. The backward is the
    recomputed forward, the weight gradients and the hidden-activation
    gradients (3x the forward); it reads the parameters, the points and
    the upstream gradient and writes one gradient. Adam on a summed
    gradient reads p, m, v, g and writes p, m, v. C2 and C3 compute their
    width x width products as 3xTF32 on the tensor cores
    (``roofline.tc_bound``)."""
    fwd = roofline.level_mlp_flops(n, width, depth, heads)
    wide = 2.0 * n * (depth - 1) * width ** 2
    p4 = 4.0 * n_params
    return {
        "level_warp_fwd": roofline.tc_bound(p4 + 24.0 * n, fwd, wide),
        "level_warp_bwd": roofline.tc_bound(2.0 * p4 + 36.0 * n, 3.0 * fwd,
                                            3.0 * wide),
        "adam": roofline.bound(7.0 * p4, 12.0 * n_params),
    }


def scatter_rows_bound(n: int, m: int) -> dict:
    """C6, ``dst[idx[j]] += src[j]`` for dst [n, 3] and src [m, 3]: dst
    read and written, idx (int64) and src read; one add a value."""
    return roofline.bound(n * 24 + m * (8 + 12), 3.0 * m)


def iteration_bounds(n: int, m: int, width: int, depth: int, heads: int,
                     n_params: int) -> dict:
    """The bound of one call of each kernel of a chamfer-mode iteration at
    n source and m target rows, in seconds, by share name."""
    out = {k: b["bound_s"] for k, b in
           level_bounds(n, width, depth, heads, n_params).items()}
    out["nn_dual"] = roofline.nn_dual_bound(1, n, m)["bound_s"]
    out["scatter_rows"] = scatter_rows_bound(n, m)["bound_s"]
    return out


def share_pct(run, key: str, span: str = "dp::solve") -> float | None:
    """A kernel's share of its roofline in the traced slice: the calls of
    it launched inside the port's ``span`` ranges, times the bound of one
    call (the driver's counter ``bound_s.<key>``; every call of a cell
    has the same shapes), over their device time. None where no such call
    ran."""
    trace = run.trace
    bound_s = run.counters.get(f"bound_s.{key}", 0.0)
    if trace is None or bound_s <= 0:
        return None
    spans = program_spans.ranges(trace, span)
    starts = [s for s, _ in spans]
    calls, device_ns = 0, 0
    for op in trace.device:
        if op.launch is None or KERNELS[key] not in op.name:
            continue
        i = bisect.bisect_right(starts, op.launch) - 1
        if i >= 0 and op.launch <= spans[i][1]:
            calls += 1
            device_ns += op.end - op.start
    return roofline.roofline_pct(calls * bound_s, device_ns * 1e-9)
