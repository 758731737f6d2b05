"""Device idle time inside the port's ``dp::collate.to_device`` span
(``pyramid_to_device``: the pyramid's host copies to the card), a pair, in
the profiled slice."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.idle_ms(run.trace, "dp::collate.to_device")
