"""Device idle time inside the port's ``dp::landmark`` span
(``landmark_inference``: the matcher and NeCo), a pair, in the profiled
slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.idle_ms(run.trace, "dp::landmark")
