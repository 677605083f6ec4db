"""Host milliseconds an engine step in the program's ``engine.fetch_wait``
spans (``ServingEngine``: the host blocked on a lagged token copy), over the
``engine.step`` spans of the window. None where the program records no such
span."""


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    w = ctx.window
    steps = spans("engine.step", w.t_start, w.t_end)
    parts = spans("engine.fetch_wait", w.t_start, w.t_end)
    if not steps or not parts:
        return None
    return 1e3 * sum(s.end_s - s.start_s for s in parts) / len(steps)
