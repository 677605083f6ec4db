"""Host-to-card rate of the detector's uploads in the window, GB/s: the
bytes the program's ``detect.upload`` spans copied (each span's attribute,
the count the counter ``detect.h2d_bytes`` adds up) over the spans' seconds.
None where the program records no such span."""


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    w = ctx.window
    parts = spans("detect.upload", w.t_start, w.t_end)
    seconds = sum(s.end_s - s.start_s for s in parts)
    if not parts or seconds <= 0:
        return None
    return sum(int(s.attr) for s in parts) / seconds / 1e9
