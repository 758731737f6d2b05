"""Device operations launched inside the port's ``dp::train.step`` span
(the whole training step: forward, the autograd backward on the engine's
thread, the update), a step, in the profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.launches(run.trace, "dp::train.step")
