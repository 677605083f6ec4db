"""The quant-matmul kernel's share of its roofline: the least time of every
launch of the serving calls issued in the profiled stretch
(``counts/qwen3.qm_bound_s``: the int8 matrix and its scales, f32 rows in
and out, against operations over the kernel's f32-x rate) over the time the
profiler gives its launches."""
from bench_h100.counts.qwen3 import qm_bound_s


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ks = tr.kernels("quant_mm")
    w = ctx.window
    calls = [(k, m) for t, k, m in w.calls if tr.t0 <= t <= tr.t1]
    if not ks or not calls:
        return None
    return 100.0 * qm_bound_s(w.hf, calls, w.n_slots, w.chunk) / sum(b - a for _, a, b in ks)
