"""Prompt tokens the engine prefilled in the window
(``ServingEngine.stats["prefill_tokens"]``) per second of window."""


def read(ctx):
    w = ctx.window
    n = w.stats1["prefill_tokens"] - w.stats0["prefill_tokens"]
    return n / w.window_s if n else None
