"""Useful model operations of every serving call in the window
(``counts/qwen3.model_flops``: the blocks' matrices, attention over the
live positions, the LM head) per second of window, as a percentage of the
H100's 989 TFLOP/s bf16 peak."""
from bench_h100.counts.bounds import PEAK
from bench_h100.counts.qwen3 import model_flops


def read(ctx):
    w = ctx.window
    if not w.calls:
        return None
    return 100.0 * model_flops(w.hf, [(k, m) for _, k, m in w.calls]) / w.window_s / PEAK["bfloat16"]
