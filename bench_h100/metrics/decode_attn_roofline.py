"""The decode-attention kernel's share of its roofline: the least time of
the decode calls issued in the profiled stretch (each row's K and V read
once at its live positions, ``counts/qwen3.decode_attn_bound_s``) over the
time the profiler gives the kernel's launches."""
from bench_h100.counts.qwen3 import decode_attn_bound_s


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ks = tr.kernels("decode_attn")
    calls = [(k, m) for t, k, m in ctx.window.calls if tr.t0 <= t <= tr.t1]
    if not ks or not calls:
        return None
    return 100.0 * decode_attn_bound_s(ctx.window.hf, calls) / sum(b - a for _, a, b in ks)
