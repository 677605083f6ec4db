"""Median over the requests finished in the window of ``Request.tpot_s``
(mean time between a request's output tokens after its first), in ms."""
import statistics


def read(ctx):
    t = ctx.window.tpot_ms
    return statistics.median(t) if t else None
