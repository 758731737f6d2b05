"""Share of the blocks of up to SYNC_EVERY iterations that the port's
chamfer-mode level loops issued inside ``dp::solve`` in the profiled slice
and that a replay of a captured CUDA graph served, in %: the port's
counters ``fused_level.graph_replays`` over ``fused_level.blocks``, over
the ``dp::solve`` ranges. None where the port has no such counters."""
from benchmark import program_spans

RANGE = "dp::solve"


def read(run):
    if run.trace is None:
        return None
    blocks = program_spans.counter_per_range(run.trace, "fused_level.blocks",
                                             RANGE)
    if not blocks:
        return None
    replays = program_spans.counter_per_range(
        run.trace, "fused_level.graph_replays", RANGE) or 0.0
    return 100.0 * replays / blocks
