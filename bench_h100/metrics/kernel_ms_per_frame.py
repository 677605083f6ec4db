"""Milliseconds in which a kernel ran on the card, per frame detected: the
union of the kernel intervals of the profiled stretch over the frames of
the ticks that lie inside it. Copies are left out: a pageable upload's
pace on the card is the host's (``h2d_ms``, ``host_streams_30fps``)."""


def read(ctx):
    tr, w = ctx.trace, ctx.window
    if tr is None or not getattr(w, "n_cams", 0):
        return None
    ticks = ctx.spans.within("tick", tr.t0, tr.t1)
    busy = tr.kernel_busy_s()
    if not ticks or busy <= 0:
        return None
    return 1e3 * busy / (len(ticks) * w.n_cams)
