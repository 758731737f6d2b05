"""Ranges the benchmark opens around calls into the port, in the traced
run: what the ``*_roofline`` readers take the device time from. The least
time of the work comes from the configuration and the pair's valid rows
(``roofline.transformer_attention_bound_s``), not from the call.
"""
from __future__ import annotations


def wrap_attention(run) -> None:
    """Put a ``bench::attention`` range around every call of the port's
    streamed attention (``match.attention.flash_attention``) while the
    profiled slice records."""
    from deformationpyramid_tpu_torch.match import attention

    inner = attention.flash_attention

    def flash(*args, **kw):
        if not run.tracing:
            return inner(*args, **kw)
        with run.span("attention"):
            return inner(*args, **kw)

    attention.flash_attention = flash
