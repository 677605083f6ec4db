"""p95 over the requests sent in the window of the program's
``request.queue`` span (``ServingEngine``: submit to admission into a slot),
in ms. After the window the harness holds the host until the engine's next
step (a traced run stops its profiler there, for seconds): that stretch is
taken out of every span it overlaps. None where the program records no such
span."""
import numpy as np


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    w = ctx.window
    queued = spans("request.queue", w.t_start, w.t_end)
    if not queued:
        return None
    after = spans("engine.step", w.t_end)
    held = (w.t_end, after[0].start_s if after else w.t_end)
    return float(np.percentile([1e3 * (s.end_s - s.start_s - max(
        0.0, min(s.end_s, held[1]) - max(s.start_s, held[0]))) for s in queued], 95))
