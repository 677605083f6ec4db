"""Seconds of set-up in the program's ``ops.library`` span (``ops._build.load``:
the CUDA kernel library's build, or its load where a build was found), read
from before the window. None where the program records no such span (no
kernel on the path, or a program without spans)."""


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    loads = spans("ops.library", None, ctx.window.t_start)
    return sum(s.end_s - s.start_s for s in loads) if loads else None
