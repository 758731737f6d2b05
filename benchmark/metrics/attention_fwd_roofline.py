"""Share of its roofline of the matcher's streamed attention at
inference: the least time of the transformer's attention over the valid
query and source rows of every pair in the profiled slice (the frozen
``flash_bound``, summed by ``roofline.transformer_attention_bound_s``),
over the device time of whatever ran under the ``attention`` range."""
from benchmark import roofline


def read(run):
    if run.trace is None:
        return None
    return roofline.roofline_pct(run.counters.get("attention_bound_s", 0.0),
                                 run.trace.device_s_under("attention"))
