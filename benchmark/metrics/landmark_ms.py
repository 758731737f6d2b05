"""Device time a pair of everything launched under the ``landmark``
range (``landmark_inference``: the matcher and NeCo), in the profiled
slice."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    n = trace.count("landmark")
    t = trace.device_s_under("landmark")
    if n == 0 or t <= 0:
        return None
    return 1e3 * t / n
