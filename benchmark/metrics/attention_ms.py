"""Device time launched inside the port's ``dp::attention`` span (the
streamed attention, ``match.attention.flash_attention``: C7), a call, in
the profiled slice. The same calls as the benchmark's ``attention`` range,
which the attention rooflines read."""
from benchmark import program_spans


def read(run):
    if run.trace is None:
        return None
    return program_spans.device_ms(run.trace, "dp::attention")
