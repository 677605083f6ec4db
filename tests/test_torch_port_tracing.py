"""The port's spans and counters (``runtime/metrics.py``, the port's change
of the JAX package's registry): the registry's span ring, the spans and
counters ``BatchDetector.detect_many``, the serving engine and the kernel
library's load record, and the Prometheus names. On the CPU."""
import ctypes
import time

import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import llm
from clearcam_tpu_torch.ops import _build
from clearcam_tpu_torch.runtime import metrics
from clearcam_tpu_torch.runtime.metrics import Metrics, to_prometheus
from clearcam_tpu_torch.runtime.nvr import BatchDetector
from clearcam_tpu_torch.serving import ServingEngine
from clearcam_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _by_sid(spans):
    return {s.sid: s for s in spans}


def test_nested_spans_get_their_parent_and_share_an_ident():
    reg = Metrics()
    with reg.timer("outer"):
        with reg.timer("inner", attr="x"):
            with reg.timer("leaf"):
                pass
        with reg.timer("inner"):
            pass
    with reg.timer("outer"):
        pass
    spans = reg.spans()
    outer = [s for s in spans if s.name == "outer"]
    inner = [s for s in spans if s.name == "inner"]
    (leaf,) = [s for s in spans if s.name == "leaf"]
    assert [s.parent for s in outer] == [-1, -1]
    assert all(s.parent == outer[0].sid for s in inner)
    assert leaf.parent == inner[0].sid
    # a root span's ident is its own number; its children share it
    assert {s.ident for s in inner + [leaf, outer[0]]} == {outer[0].sid}
    assert outer[1].ident == outer[1].sid != outer[0].sid
    assert inner[0].attr == "x" and inner[1].attr is None
    for child in inner + [leaf]:
        parent = _by_sid(spans)[child.parent]
        assert parent.start_s <= child.start_s <= child.end_s <= parent.end_s


def test_spans_of_other_threads_have_their_own_parents():
    import threading
    reg = Metrics()
    started, release = threading.Event(), threading.Event()

    def other():
        with reg.timer("other"):
            started.set()
            release.wait(5)
    t = threading.Thread(target=other)
    with reg.timer("main"):
        t.start()
        assert started.wait(5)
        with reg.timer("main.child"):
            pass
        release.set()
        t.join(5)
    assert not t.is_alive()
    by_name = {s.name: s for s in reg.spans()}
    assert by_name["other"].parent == -1
    assert by_name["main.child"].parent == by_name["main"].sid


def test_spans_are_on_perf_counter_and_filtered_by_start():
    reg = Metrics()
    a = time.perf_counter()
    with reg.timer("x"):
        time.sleep(0.01)
    b = time.perf_counter()
    with reg.timer("x"):
        pass
    c = time.perf_counter()
    (first,) = reg.spans("x", a, b)
    assert a <= first.start_s and first.end_s <= b
    assert first.end_s - first.start_s >= 0.01
    assert len(reg.spans("x", a)) == 2 and len(reg.spans("x", None, c)) == 2
    assert reg.spans("x", c) == [] and reg.spans("nothing") == []


def test_timer_still_feeds_its_ewma_and_span_at_records_a_root_span():
    reg = Metrics()
    for _ in range(3):
        with reg.timer("step"):
            pass
    t0 = time.perf_counter_ns()
    reg.span_at("request.queue", t0, t0 + 2_000_000, ident=42)
    snap = reg.snapshot()
    assert snap["timers"]["step"]["count"] == 3
    assert snap["timers"]["step"]["ewma_ms"] is not None
    assert snap["timers"]["request.queue"]["max_ms"] == pytest.approx(2.0)
    (q,) = reg.spans("request.queue")
    assert (q.ident, q.parent) == (42, -1)
    assert q.end_s - q.start_s == pytest.approx(2e-3)
    assert reg.new_ident() != reg.new_ident()


def test_the_ring_wraps_and_counts_the_spans_it_drops():
    reg = Metrics(span_capacity=8)
    for i in range(20):
        reg.span_at("s", i, i + 1, ident=i)
    kept = reg.spans("s")
    assert [s.ident for s in kept] == list(range(12, 20))
    assert reg.snapshot()["counters"]["trace.spans_dropped"] == 12
    assert reg.snapshot()["timers"]["s"]["count"] == 20


def test_prometheus_labels_only_cameras():
    reg = Metrics()
    reg.gauge("fps.gate", 12.5)
    reg.gauge('fps.a"b', 1)
    reg.gauge("serving.slots_live", 3)
    reg.count("detect.h2d_bytes", 10)
    with reg.timer("detect.stack"):
        pass
    text = to_prometheus(reg.snapshot())
    assert 'clearcam_fps{camera="gate"} 12.5' in text
    assert 'clearcam_fps{camera="a\\"b"} 1' in text
    assert "clearcam_serving_slots_live 3" in text
    assert "clearcam_detect_h2d_bytes_total 10" in text
    assert "clearcam_detect_stack_ewma_ms " in text
    assert "camera=\"slots_live\"" not in text and "camera=\"stack\"" not in text


def _counters():
    return dict(metrics.snapshot()["counters"])


def test_detect_many_spans_and_counters():
    """Two shapes (3 frames, bucket 4; 1 frame, bucket 1), twice: every
    group's stack, upload, model and readback lie inside the call and are
    its descendants; the counters add up the frames' bytes and the
    bucket's padding; a (shape, bucket) key's first call is marked once."""
    det = BatchDetector("dryrun", res=64, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, s, np.uint8)
              for s in [(64, 96, 3), (48, 64, 3), (64, 96, 3), (64, 96, 3)]]
    before = _counters()
    t0 = time.perf_counter()
    for _ in range(2):
        rows = det.detect_many(frames)
    t1 = time.perf_counter()
    after = _counters()

    def delta(k):
        return after.get(k, 0) - before.get(k, 0)
    assert delta("detect.frames") == 8 and delta("detect.calls") == 4
    assert delta("detect.pad_rows") == 2 * ((4 - 3) + (1 - 1))
    assert delta("detect.h2d_bytes") == 2 * sum(f.nbytes for f in frames)
    assert delta("detect.d2h_bytes") == 2 * (4 + 1) * rows[0].nbytes     # buckets' rows

    spans = metrics.spans(None, t0, t1)
    by_sid = _by_sid(spans)
    calls = [s for s in spans if s.name == "detect.call"]
    assert len(calls) == 2
    assert len([s for s in spans if s.name == "detect.first_call"]) == 2   # one a key
    for call in calls:
        kids = [s for s in spans if s.ident == call.ident and s is not call]
        names = sorted(s.name for s in kids)
        groups = ["detect.model", "detect.readback", "detect.stack", "detect.upload"]
        assert sorted(n for n in names if n != "detect.first_call") == sorted(groups * 2)
        for s in kids:
            assert call.start_s <= s.start_s <= s.end_s <= call.end_s
            up = s
            while up.parent != call.sid:        # descends from the call
                up = by_sid[up.parent]
        uploads = sorted(s.attr for s in kids if s.name == "detect.upload")
        assert uploads == sorted([3 * 64 * 96 * 3, 48 * 64 * 3])
    first_calls = [s for s in spans if s.name == "detect.first_call"]
    assert all(s.ident == calls[0].ident for s in first_calls)


def _tiny_engine():
    cfg = llm.TransformerConfig(num_blocks=2, dim=32, hidden_dim=64, n_heads=4,
                                n_kv_heads=2, norm_eps=1e-5, vocab_size=64, head_dim=8,
                                rope_theta=10000.0, rope_dim=8, v_head_dim=8, max_context=96)
    return ServingEngine(llm.init_params(cfg, seed=4), cfg, n_slots=2)


def test_engine_request_and_step_spans():
    """Three requests on two slots (one waits for a slot, one spans two
    prefill chunks): each has one queue and one prefill span under its
    number, which together are its TTFT; every issue, fetch wait, emit and
    schedule span is a child of a step."""
    eng = _tiny_engine()
    t0 = time.perf_counter()
    rs = [eng.submit([1, 2, 3, 4, 5], max_new=6), eng.submit(list(range(1, 41)), max_new=4),
          eng.submit([9, 8, 7], max_new=5)]
    eng.run_until_idle()
    t1 = time.perf_counter()
    assert all(r.done and not r.failed for r in rs)
    assert len({r.number for r in rs}) == 3
    for r in rs:
        (q,) = [s for s in metrics.spans("request.queue", t0, t1) if s.ident == r.number]
        (p,) = [s for s in metrics.spans("request.prefill", t0, t1) if s.ident == r.number]
        (d,) = [s for s in metrics.spans("request.decode", t0, t1) if s.ident == r.number]
        assert q.end_s == p.start_s and p.end_s == d.start_s
        assert (q.end_s - q.start_s) + (p.end_s - p.start_s) == \
            pytest.approx(r.ttft_s, abs=1e-3)
    waited = [s for s in metrics.spans("request.queue", t0, t1) if s.ident == rs[2].number]
    assert waited[0].end_s - waited[0].start_s > 0

    steps = {s.sid: s for s in metrics.spans("engine.step", t0, t1)}
    assert steps
    kinds = set()
    for name in ("engine.schedule", "engine.issue", "engine.fetch_wait", "engine.emit"):
        kids = metrics.spans(name, t0, t1)
        assert kids, name
        for s in kids:
            step = steps[s.parent]
            assert step.start_s <= s.start_s <= s.end_s <= step.end_s
            if name == "engine.issue":
                kinds.add(s.attr)
    # both first prompts in one batched chunk, then the long one's second
    # chunk and the third request's alone, between decode steps
    assert kinds == {"prefill_many", "prefill_slot", "decode_all"}
    assert len(metrics.spans("engine.schedule", t0, t1)) == len(steps)


def test_engine_feeds_ttft_and_tpot_timers_not_gauges():
    eng = _tiny_engine()
    eng.submit([1, 2, 3], max_new=4)
    eng.run_until_idle()
    eng._publish_metrics()
    snap = metrics.snapshot()
    assert snap["timers"]["serving.ttft"]["count"] >= 1
    assert snap["timers"]["serving.tpot"]["count"] >= 1
    assert "serving.ttft_ms" not in snap["gauges"] and "serving.tpot_ms" not in snap["gauges"]
    assert not hasattr(eng, "_ttft_ewma") and not hasattr(eng, "_tpot_ewma")
    assert snap["gauges"]["serving.slots_free"] == 2


def test_kernel_library_load_is_a_span(monkeypatch, tmp_path):
    """``ops.library`` times the build or load, with whether a build was
    found (the library and ``ctypes`` stood in for: no nvcc here)."""
    lib = tmp_path / "libclearcam_kernels-test.so"
    lib.write_bytes(b"")

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "last_build", {})
    t0 = time.perf_counter()
    _build.load()
    (span,) = metrics.spans("ops.library", t0)
    assert span.attr is True and span.end_s >= span.start_s
    assert _build.last_build["cached"] is True
