"""Share of the window's ``serving.decode_graph`` spans (the program's
``decode_all`` calls, ``models/llm._DecodeGraphs``) whose attribute is
``replay``, a CUDA-graph replay rather than a capture or an eager run, in
percent. None where the program records no such span."""


def read(ctx):
    from clearcam_tpu_torch.runtime import metrics
    spans = getattr(metrics, "spans", None)
    if spans is None:
        return None
    w = ctx.window
    calls = spans("serving.decode_graph", w.t_start, w.t_end)
    if not calls:
        return None
    return 100.0 * sum(1 for s in calls if s.attr == "replay") / len(calls)
