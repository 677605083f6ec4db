"""Device milliseconds of host-to-device copies a tick, from the profiled
stretch (which starts and stops between ticks)."""


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    ticks = ctx.spans.within("detect_many", tr.t0, tr.t1)
    if not ticks:
        return None
    return 1e3 * sum(b - a for _, a, b in tr.copies("HtoD")) / len(ticks)
