"""Device idle time inside the port's ``dp::solve`` span
(``register_pair``: the level loops and the final warp), a pair, in the
profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.idle_ms(run.trace, "dp::solve")
