"""FLOPs the window's training steps need (the reference's forward and
backward counted by ``FlopCounterMode`` at the split's cap, independently
of the port), over the window, over the TF32 tensor-core peak."""
from benchmark import roofline


def read(run):
    return roofline.mfu_pct(run.counters.get("train_flops", 0.0),
                            run.window_s)
