"""The 95th percentile over the window's ticks of one tick's host time:
frames handed over to tracks out."""


def read(ctx):
    return ctx.window.metrics.get("tick_p95_ms")
