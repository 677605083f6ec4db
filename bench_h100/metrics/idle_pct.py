"""Share of the profiled stretch in which no kernel ran on the card
(copies are ``h2d_ms``'s), in percent."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.kernel_busy_s() / tr.window_s)
