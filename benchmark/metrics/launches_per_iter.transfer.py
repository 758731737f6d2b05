"""Device operations launched inside the port's ``dp::solve`` span over
the iterations the same transfers report, in the profiled slice: what a
chamfer-mode iteration costs the host in launches (the no-op calls after
a level's stop and the vertex warp's launches counted in)."""
from benchmark import program_spans


def read(run):
    iters = run.counters.get("traced_iters", 0.0)
    if run.trace is None or iters <= 0:
        return None
    per_range = program_spans.launches(run.trace, "dp::solve")
    if per_range is None:
        return None
    return per_range * len(program_spans.ranges(run.trace, "dp::solve")) \
        / iters
