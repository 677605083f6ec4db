"""Frames through detect and track over the window, per second, over 30:
the 30 fps cameras the host and card together keep up with, on the host's
clock."""


def read(ctx):
    return ctx.window.metrics.get("streams_30fps")
