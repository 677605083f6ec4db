"""Lightweight tracing/metrics for the NVR pipeline.

The reference's observability is print-based (FPS per frame,
clearcam.py:456-458; tok/s in qwen3vl.py:135-137). We keep those lines for
parity and add a structured layer: per-stage EWMA latency/throughput counters
the HTTP server exposes at /metrics (JSON) — detect step time, batch size,
tracker time, queue depths, per-camera fps.

Every timer is also a span: its name, start and end on
``time.perf_counter_ns`` (the clock ``time.perf_counter`` reads, onto which
a ``torch.profiler`` trace of the card can be mapped), the span open on the
same thread when it began (its parent), and an identifier that the spans of
one unit of work share (one detect call, one request). Spans go into a
preallocated ring of numpy columns; once it is full the oldest are
overwritten, each counted in the counter ``trace.spans_dropped``. Recording
is always on, so the ring is the process's flight recorder: ``spans()``
reads it (``/profile`` adds it to its trace).

Usage:
    with metrics.timer("detect_step"):
        ...
    metrics.count("frames", n)
    metrics.gauge("batch_size", n)
    metrics.span_at("request.queue", t0_ns, t1_ns, ident)  # timed elsewhere
    metrics.spans("detect.stack", t0, t1)                  # perf_counter s
"""
from __future__ import annotations

import itertools
import re
import threading
import time
from typing import NamedTuple

import numpy as np

# the busiest served loop records ~45 spans a second (Qwen3-1.7B's chunked
# prefill on an H100), so a 45 s window 4x over is ~8,100 spans; the rest is
# room for steps several times shorter, with the set-up's spans kept (~7 MB)
SPAN_CAPACITY = 1 << 17


class Span(NamedTuple):
    start_s: float          # time.perf_counter seconds
    end_s: float
    ident: int              # shared by the spans of one unit of work
    parent: int             # sid of the span open on its thread, or -1
    sid: int                # this span's own number
    name: str
    attr: object            # one attribute, or None


class _Timer:
    """The context manager ``Metrics.timer`` returns: set ``attr`` inside
    the block to give the span its attribute."""
    __slots__ = ("reg", "name", "ident", "attr", "sid", "parent", "stack", "t0")

    def __init__(self, reg: "Metrics", name: str, ident, attr):
        self.reg, self.name, self.ident, self.attr = reg, name, ident, attr

    def __enter__(self) -> "_Timer":
        self.stack = stack = self.reg._stack()
        self.sid = next(self.reg._sids)
        if stack:
            self.parent, parent_ident = stack[-1]
        else:
            self.parent, parent_ident = -1, self.sid
        if self.ident is None:
            self.ident = parent_ident
        stack.append((self.sid, self.ident))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.stack.pop()
        self.reg._record(self.name, self.t0, t1, self.ident, self.parent, self.sid,
                         self.attr)
        return False


class Metrics:
    def __init__(self, ewma_alpha: float = 0.1, span_capacity: int = SPAN_CAPACITY):
        self.alpha = ewma_alpha
        self._lock = threading.Lock()
        self._timers: dict[str, dict] = {}
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._start = time.time()
        self._local = threading.local()
        self._sids = itertools.count()
        self._names: list[str] = []
        self._name_ids: dict[str, int] = {}
        self._cap = int(span_capacity)
        self._n = 0                                      # spans ever recorded
        self._s_name = np.zeros(self._cap, np.int32)
        self._s_t0 = np.zeros(self._cap, np.int64)
        self._s_t1 = np.zeros(self._cap, np.int64)
        self._s_ident = np.zeros(self._cap, np.int64)
        self._s_parent = np.zeros(self._cap, np.int64)
        self._s_sid = np.zeros(self._cap, np.int64)
        self._s_attr = np.empty(self._cap, object)

    def timer(self, name: str, ident: int | None = None, attr=None) -> _Timer:
        """Time a block: an EWMA timer ``name`` and a span. ``ident``
        defaults to the enclosing span's, or this span's own number."""
        return _Timer(self, name, ident, attr)

    def new_ident(self) -> int:
        """A span identifier unique in the process (for a unit of work
        whose spans are recorded with ``span_at``)."""
        return next(self._sids)

    def span_at(self, name: str, t0_ns: int, t1_ns: int, ident: int = -1, attr=None):
        """Record an interval timed elsewhere on ``time.perf_counter_ns``:
        a span with no parent, and the timer ``name``."""
        self._record(name, int(t0_ns), int(t1_ns), ident, -1, next(self._sids), attr)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, name, t0, t1, ident, parent, sid, attr) -> None:
        with self._lock:
            self._observe(name, (t1 - t0) / 1e9)
            nid = self._name_ids.get(name)
            if nid is None:
                nid = self._name_ids[name] = len(self._names)
                self._names.append(name)
            i = self._n % self._cap
            if self._n >= self._cap:
                self._counters["trace.spans_dropped"] = \
                    self._counters.get("trace.spans_dropped", 0) + 1
            self._s_name[i], self._s_t0[i], self._s_t1[i] = nid, t0, t1
            self._s_ident[i], self._s_parent[i], self._s_sid[i] = ident, parent, sid
            self._s_attr[i] = attr
            self._n += 1

    def spans(self, name: str | None = None, t0: float | None = None,
              t1: float | None = None) -> list[Span]:
        """The spans in the ring named ``name`` (every name where None) that
        began in [t0, t1) (``time.perf_counter`` seconds; either end open
        where None), by start."""
        with self._lock:
            n = min(self._n, self._cap)
            cols = [c[:n].copy() for c in (self._s_name, self._s_t0, self._s_t1,
                                           self._s_ident, self._s_parent, self._s_sid,
                                           self._s_attr)]
            names = list(self._names)
            nid = self._name_ids.get(name, -1) if name is not None else None
        keep = np.ones(n, bool) if nid is None else cols[0] == nid
        if t0 is not None:
            keep &= cols[1] >= int(round(t0 * 1e9))
        if t1 is not None:
            keep &= cols[1] < int(round(t1 * 1e9))
        idx = np.flatnonzero(keep)
        idx = idx[np.argsort(cols[1][idx], kind="stable")]
        return [Span(cols[1][i] / 1e9, cols[2][i] / 1e9, int(cols[3][i]), int(cols[4][i]),
                     int(cols[5][i]), names[cols[0][i]], cols[6][i]) for i in idx]

    def observe(self, name: str, seconds: float):
        with self._lock:
            self._observe(name, seconds)

    def _observe(self, name: str, seconds: float):
        t = self._timers.setdefault(
            name, {"ewma_ms": None, "count": 0, "total_s": 0.0,
                   "max_ms": 0.0})
        ms = seconds * 1000.0
        t["count"] += 1
        t["total_s"] += seconds
        t["max_ms"] = max(t["max_ms"], ms)
        t["ewma_ms"] = ms if t["ewma_ms"] is None else \
            (1 - self.alpha) * t["ewma_ms"] + self.alpha * ms

    def count(self, name: str, n: float = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float):
        with self._lock:
            self._gauges[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "uptime_s": round(time.time() - self._start, 1),
                "timers": {k: {kk: (round(vv, 3) if isinstance(vv, float) else vv)
                               for kk, vv in v.items()}
                           for k, v in self._timers.items()},
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
            }
        for name, t in out["timers"].items():
            if t["total_s"]:
                t["rate_hz"] = round(t["count"] / max(t["total_s"], 1e-9), 2)
        return out


def to_prometheus(snap: dict) -> str:
    """Render a snapshot() dict in the Prometheus text exposition format:
    metric names prefixed `clearcam_`; a per-camera name (`fps.<camera>`)
    carries its camera as a label, every other name's dots (and any
    character a metric name cannot hold) become underscores."""
    def name_of(k: str) -> tuple[str, str]:
        # "fps.gate" -> ("fps", '{camera="gate"}');
        # "serving.slots_live" -> ("serving_slots_live", "")
        if k.startswith("fps."):
            cam = k[4:].replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
            return "fps", f'{{camera="{cam}"}}'
        return re.sub(r"[^a-zA-Z0-9_]", "_", k), ""

    lines = [f"clearcam_uptime_seconds {snap['uptime_s']}"]
    for k, t in snap.get("timers", {}).items():
        base, lbl = name_of(k)
        lines.append(f"clearcam_{base}_ewma_ms{lbl} {t['ewma_ms']}")
        lines.append(f"clearcam_{base}_total_seconds{lbl} {t['total_s']}")
        lines.append(f"clearcam_{base}_count{lbl} {t['count']}")
        if "rate_hz" in t:
            lines.append(f"clearcam_{base}_rate_hz{lbl} {t['rate_hz']}")
    for k, v in snap.get("counters", {}).items():
        base, lbl = name_of(k)
        lines.append(f"clearcam_{base}_total{lbl} {v}")
    for k, v in snap.get("gauges", {}).items():
        base, lbl = name_of(k)
        lines.append(f"clearcam_{base}{lbl} {v}")
    return "\n".join(lines) + "\n"


# process-wide default registry
default = Metrics()
timer = default.timer
count = default.count
gauge = default.gauge
observe = default.observe
span_at = default.span_at
spans = default.spans
new_ident = default.new_ident
snapshot = default.snapshot
