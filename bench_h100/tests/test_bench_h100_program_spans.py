"""The readers of the program's own spans (``clearcam_tpu_torch.runtime.metrics``)
on the tiny cells on the CPU: a traced run reports each of them where its
cell lists it (``library_load_s`` only where a kernel library was loaded:
not on the CPU), and a program without spans gives nothing to read."""
import time
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny

SEED = 2 ** 31 + 91
DETECT = ["stack_ms", "upload_ms", "readback_ms", "upload_gbps"]
SERVE = ["queue_wait_p95_ms", "admit_to_first_p95_ms", "issue_ms", "fetch_wait_ms"]
READERS = DETECT + SERVE + ["library_load_s"]


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def _traced(root, cell):
    return harness.run(cell, SEED, 1.5, True, device="cpu", root=root, log=lambda m: None)


def _reader(name):
    return harness.load_module(harness.reader_path(tiny.PKG / "metrics", name))


@pytest.mark.parametrize("cell,names", [(tiny.DETECT, DETECT), (tiny.SERVE, SERVE)])
def test_traced_run_reports_the_program_spans(root, cell, names):
    res = _traced(root, cell)
    assert res["correct"], res["check"]
    got = res["metrics"]
    for name in names:
        assert got[name]["value"] > 0, name
    assert "library_load_s" not in got
    if cell == tiny.DETECT:
        # the four child spans of a tick lie inside the harness's detect_many
        parts = sum(got[n]["value"] for n in ("stack_ms", "upload_ms", "readback_ms"))
        assert parts <= got["detect_call_ms"]["value"]
    else:
        assert got["admit_to_first_p95_ms"]["value"] > 0


def test_library_load_is_read_from_set_up_only():
    """The load's span counts where it began before the window, not after."""
    from clearcam_tpu_torch.runtime import metrics
    now = time.perf_counter_ns()
    metrics.span_at("ops.library", now, now + 50_000_000, metrics.new_ident(), attr=True)
    reader = _reader("library_load_s")
    later = SimpleNamespace(t_start=now / 1e9 + 1.0, t_end=now / 1e9 + 2.0)
    earlier = SimpleNamespace(t_start=now / 1e9, t_end=now / 1e9 + 1.0)
    before = reader.read(SimpleNamespace(window=earlier)) or 0.0   # other loads only
    assert reader.read(SimpleNamespace(window=later)) - before == pytest.approx(0.05, abs=1e-6)


def test_request_spans_leave_out_the_hold_after_the_window(monkeypatch):
    """A request waiting across the window's end loses the stretch from the
    end to the engine's next step (where a traced run stops its profiler)."""
    from clearcam_tpu_torch.runtime import metrics
    from clearcam_tpu_torch.runtime.metrics import Span
    rows = {"request.queue": [Span(1.0, 1.5, 7, -1, 1, "request.queue", None),
                              Span(9.0, 12.0, 8, -1, 2, "request.queue", None)],
            "request.prefill": [Span(1.5, 3.0, 7, -1, 3, "request.prefill", None),
                                Span(12.0, 13.0, 8, -1, 4, "request.prefill", None)],
            "engine.step": [Span(10.0, 10.1, 0, -1, 5, "engine.step", None),
                            Span(11.0, 11.1, 0, -1, 6, "engine.step", None)]}

    def spans(name=None, t0=None, t1=None):
        return [s for s in rows.get(name, []) if (t0 is None or s.start_s >= t0)
                and (t1 is None or s.start_s < t1)]
    monkeypatch.setattr(metrics, "spans", spans)
    ctx = SimpleNamespace(window=SimpleNamespace(t_start=0.0, t_end=10.05))
    # the second request waits 9.0 -> 12.0 less 10.05 -> 11.0 (the hold)
    assert _reader("queue_wait_p95_ms").read(ctx) == pytest.approx(
        1e3 * (0.5 + 0.95 * (2.05 - 0.5)))
    assert _reader("admit_to_first_p95_ms").read(ctx) == pytest.approx(
        1e3 * (1.0 + 0.95 * (1.5 - 1.0)))


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_gives_none(monkeypatch, name):
    """A program whose registry has no spans API (the port before spans),
    or whose window holds none of the reader's spans, gives no value."""
    from clearcam_tpu_torch.runtime import metrics
    ctx = SimpleNamespace(window=SimpleNamespace(t_start=-2.0, t_end=-1.0), trace=None,
                          spans=harness.Spans())
    assert _reader(name).read(ctx) is None
    monkeypatch.delattr(metrics, "spans")
    ctx.window = SimpleNamespace(t_start=0.0, t_end=1e12)
    assert _reader(name).read(ctx) is None
