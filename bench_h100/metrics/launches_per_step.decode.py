"""Kernel launches in the profiled stretch over the decode steps the engine
issued in it (interleaved prefill chunks' launches included)."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    steps = [c for c in ctx.window.calls if c[1] == "decode" and tr.t0 <= c[0] <= tr.t1]
    return len(tr.kernels()) / len(steps) if steps else None
