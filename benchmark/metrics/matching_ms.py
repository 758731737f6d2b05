"""Device time a pair of what the port launches under its
``dp::landmark.matching`` span (the confidence matrix's dual softmax and
the mutual-max match extraction), in the profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.device_ms(run.trace, "dp::landmark.matching")
