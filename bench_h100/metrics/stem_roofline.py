"""The stem kernel's share of its roofline: the least time of its calls in
the profiled stretch (bytes over HBM's rate against operations over the
bf16 peak, ``counts/yolov9.stem_cost``) over the time the profiler gives
its launches."""
from bench_h100.counts.bounds import PEAK, bound_s

NAMES = ("stem_tc_kernel", "stem_cc_kernel")


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ks = [k for k in tr.kernels() if k[0].startswith(NAMES) or any(n in k[0] for n in NAMES)]
    per_tick = ctx.window.stem_per_tick
    if not ks or len(ks) % len(per_tick):
        return None
    ticks = len(ks) // len(per_tick)
    least = ticks * sum(bound_s(b, o, PEAK["bfloat16"]) for b, o in per_tick)
    return 100.0 * least / sum(b - a for _, a, b in ks)
