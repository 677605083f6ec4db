"""Mean host milliseconds a tick in the program's ``detect.readback`` spans
(``BatchDetector.detect_many``: the host waits for each shape group's rows,
then copies them back), over the window; a tick is one ``detect.call``.
None where the program records no such span."""


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    w = ctx.window
    calls = spans("detect.call", w.t_start, w.t_end)
    parts = spans("detect.readback", w.t_start, w.t_end)
    if not calls or not parts:
        return None
    return 1e3 * sum(s.end_s - s.start_s for s in parts) / len(calls)
