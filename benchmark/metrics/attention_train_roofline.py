"""Share of its roofline of the matcher's streamed attention in training:
the least time of the transformer's attention forward and backward over
the valid query and source rows of every step in the profiled slice (the
frozen ``flash_bound`` and ``flash_bwd_bounds``, summed by
``roofline.transformer_attention_bound_s``), over the device time of what
ran under the ``attention`` range (the forward) and under the autograd
node's own backward."""
from benchmark import roofline


def read(run):
    trace = run.trace
    if trace is None:
        return None
    fwd = trace.device_s_under("attention")
    bwd = sum(op.end - op.start
              for op in trace.under_op("FlashAttentionBackward")) * 1e-9
    if fwd <= 0 or bwd <= 0:
        return None
    return roofline.roofline_pct(run.counters.get("attention_bound_s", 0.0),
                                 fwd + bwd)
