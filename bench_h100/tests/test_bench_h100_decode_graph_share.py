"""``decode_graph_share``: the reader of the program's ``serving.decode_graph``
spans, on made-up spans and on a traced tiny serving cell on the CPU, where
every decode step runs eagerly."""
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny


def _reader():
    return harness.load_module(harness.reader_path(tiny.PKG / "metrics", "decode_graph_share"))


def _window(t0, t1):
    return SimpleNamespace(window=SimpleNamespace(t_start=t0, t_end=t1), trace=None,
                           spans=harness.Spans())


def test_reads_the_replay_share_of_the_window(monkeypatch):
    from clearcam_tpu_torch.runtime import metrics
    from clearcam_tpu_torch.runtime.metrics import Span
    attrs = ["eager:warmup", "capture"] + ["replay"] * 6 + ["eager:cpu", "replay"]
    rows = [Span(float(i), i + 0.5, 0, -1, i, "serving.decode_graph", a)
            for i, a in enumerate(attrs)]

    def spans(name=None, t0=None, t1=None):
        return [s for s in rows if name == s.name and (t0 is None or s.start_s >= t0)
                and (t1 is None or s.start_s < t1)]
    monkeypatch.setattr(metrics, "spans", spans)
    # the set-up's warm-up and capture lie before the window
    assert _reader().read(_window(2.0, 20.0)) == pytest.approx(100.0 * 7 / 8)
    assert _reader().read(_window(0.0, 20.0)) == pytest.approx(100.0 * 7 / 10)
    assert _reader().read(_window(30.0, 40.0)) is None


def test_without_the_spans_gives_none(monkeypatch):
    """A program that records no such span (the engine before its decode
    graphs), or no spans at all, gives no value."""
    from clearcam_tpu_torch.runtime import metrics
    assert _reader().read(_window(-2.0, -1.0)) is None
    monkeypatch.delattr(metrics, "spans")
    assert _reader().read(_window(0.0, 1e12)) is None


def test_traced_tiny_serving_run_reports_it(tmp_path):
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    try:
        res = harness.run(tiny.SERVE, 2 ** 31 + 93, 1.5, True, device="cpu",
                          root=tiny.checkout(tmp_path), log=lambda m: None)
    finally:
        torch.set_num_threads(before)
    assert res["correct"], res["check"]
    # the CPU runs every step eagerly
    assert res["metrics"]["decode_graph_share"] == {"value": 0.0, "unit": "%"}
