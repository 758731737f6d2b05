"""Device time a pair of what the port launches under its
``dp::landmark.neco`` span (``neco_filter``: NeCo's scores and the inlier
threshold), in the profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.device_ms(run.trace, "dp::landmark.neco")
