"""Share of its roofline of C3, the level warp's backward: the calls launched
inside the port's ``dp::solve`` in the profiled slice, times the frozen
bound of one call (``roofline_ndp.iteration_bounds``), over their device
time."""
from benchmark import roofline_ndp


def read(run):
    return roofline_ndp.share_pct(run, "level_warp_bwd")
