"""The detect step's model operations (convolutions, counted from the
shapes in ``counts/yolov9.py``) of every frame the window detected, per
second of window, as a percentage of the H100's 989 TFLOP/s bf16 peak."""
from bench_h100.counts.bounds import PEAK


def read(ctx):
    w = ctx.window
    if not getattr(w, "ticks", 0):
        return None
    return 100.0 * w.flops_per_tick * w.ticks / w.window_s / PEAK["bfloat16"]
