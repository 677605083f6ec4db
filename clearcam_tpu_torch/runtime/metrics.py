"""Lightweight tracing/metrics for the NVR pipeline.

The reference's observability is print-based (FPS per frame,
clearcam.py:456-458; tok/s in qwen3vl.py:135-137). We keep those lines for
parity and add a structured layer: per-stage EWMA latency/throughput counters
the HTTP server exposes at /metrics (JSON) — detect step time, batch size,
tracker time, queue depths, per-camera fps.

Usage:
    with metrics.timer("detect_step"):
        ...
    metrics.count("frames", n)
    metrics.gauge("batch_size", n)
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Metrics:
    def __init__(self, ewma_alpha: float = 0.1):
        self.alpha = ewma_alpha
        self._lock = threading.Lock()
        self._timers: dict[str, dict] = {}
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._start = time.time()

    @contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, seconds: float):
        with self._lock:
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
    """Render a snapshot() dict in the Prometheus text exposition format
    (metric names prefixed `clearcam_`, dots -> labels where sensible)."""
    def name_of(k: str) -> tuple[str, str]:
        # "fps.gate" -> ("fps", '{camera="gate"}')
        if "." in k:
            base, label = k.split(".", 1)
            return base, f'{{camera="{label}"}}'
        return k, ""

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
snapshot = default.snapshot
