"""Mean host milliseconds of ``BatchDetector.detect_many`` a tick (the
harness's ``detect_many`` span: host stacking, upload, the model, the
readback), over the window."""


def read(ctx):
    spans = ctx.spans.data.get("detect_many")
    return None if not spans else 1e3 * sum(b - a for a, b in spans) / len(spans)
