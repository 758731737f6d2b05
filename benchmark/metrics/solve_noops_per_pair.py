"""Calls of a level loop's step that applied nothing, a pair, in the
profiled slice: the port's counter ``early_stop.noops`` (the calls issued
after the stop, until the host read the flag every SYNC_EVERY calls) over
the ``dp::solve`` ranges. ``solve_launches_per_pair`` less this is what
the same pairs applied."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.counter_per_range(run.trace, "early_stop.noops",
                                           "dp::solve")
