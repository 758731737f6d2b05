"""Share of the profiled slice in which no device operation ran
(training cells)."""


def read(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0 or trace.n_device_ops == 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
