"""Mean host milliseconds a tick spends in ``MultiCamOCSort.update_all``
(the harness's ``track`` span), over the window."""


def read(ctx):
    spans = ctx.spans.data.get("track")
    return None if not spans else 1e3 * sum(b - a for a, b in spans) / len(spans)
