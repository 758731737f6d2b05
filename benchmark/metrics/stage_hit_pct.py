"""Share of the profiled slice's ``dp::collate.to_device`` ranges (a
pyramid's upload, one a pair) that went through the port's reused
page-locked staging buffer without allocating one, in %: the port's
counters ``collate.staged`` less ``collate.stage_misses`` over the ranges.
None where the port has no such counters."""
from benchmark import program_spans

RANGE = "dp::collate.to_device"


def read(run):
    if run.trace is None:
        return None
    staged = program_spans.counter_per_range(run.trace, "collate.staged",
                                             RANGE)
    if staged is None:
        return None
    missed = program_spans.counter_per_range(
        run.trace, "collate.stage_misses", RANGE) or 0.0
    return 100.0 * (staged - missed)
