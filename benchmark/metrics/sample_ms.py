"""Host time of the port's ``dp::shape_transfer.sample`` span (the two
meshes' area-weighted surface sampling), a transfer, in the profiled
slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    spans = program_spans.ranges(run.trace, "dp::shape_transfer.sample")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / program_spans.NS_PER_MS \
        / len(spans)
