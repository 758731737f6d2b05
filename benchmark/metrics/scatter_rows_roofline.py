"""Share of its roofline of C6, the glue's y -> x scatter: the calls launched
inside the port's ``dp::solve`` in the profiled slice, times the frozen
bound of one call (``roofline_ndp.iteration_bounds``), over their device
time."""
from benchmark import roofline_ndp


def read(run):
    return roofline_ndp.share_pct(run, "scatter_rows")
