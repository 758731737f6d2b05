"""FLOPs the window's registration work needs (counted by the driver from
its shapes and iterations, independently of the port), over the window,
over the TF32 tensor-core peak."""
from benchmark import roofline


def read(run):
    return roofline.mfu_pct(run.counters.get("register_flops", 0.0),
                            run.window_s)
