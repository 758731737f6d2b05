"""Device idle time inside the port's ``dp::train.update`` span (the
training step's gradient guard, the optimizer's update, the parameters'
add and the keep), a step, in the profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.idle_ms(run.trace, "dp::train.update")
