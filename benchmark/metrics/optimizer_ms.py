"""Device time a step of everything launched under the ``optimizer``
range (the optimizer's ``update``: weight decay and Adam over every leaf),
in the profiled slice."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    n = trace.count("optimizer")
    t = trace.device_s_under("optimizer")
    if n == 0 or t <= 0:
        return None
    return 1e3 * t / n
