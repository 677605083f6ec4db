"""Reduction of a ``torch.profiler`` trace of the card to what the per-layer
readers take: each device operation's name and interval on the host's
``time.perf_counter`` clock, busy time (the union of the intervals), and
the breakdown the result line carries.

The method is ``clearcam_tpu_torch/tools/llm_decode_profile.py``'s (commit
b24f536): device entries of a profile over a steady stretch, summed by
kernel name, busy share over the profiled wall time; here the intervals are
also merged, so time in which two operations overlap counts once.
"""
from __future__ import annotations

from dataclasses import dataclass, field


def union_s(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(intervals) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Trace:
    t0: float                    # perf_counter seconds at the profiler's start
    t1: float                    # ... and at its stop (after a synchronize)
    ops: list = field(default_factory=list)    # (name, start, end), device

    @classmethod
    def from_profile(cls, prof, t0: float, t1: float, wall0_ns: int) -> "Trace":
        """Device entries of ``prof`` (kineto's times are wall-clock ns)."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        ops = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            a = t0 + (e.start_ns() - wall0_ns) / 1e9
            ops.append((e.name(), a, a + e.duration_ns() / 1e9))
        return cls(t0, t1, ops)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels(self, match: str | None = None) -> list:
        """Kernel entries (not copies or sets), optionally those whose name
        holds ``match``."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))
                and (match is None or match in o[0])]

    def copies(self, kind: str = "HtoD") -> list:
        return [o for o in self.ops if o[0].startswith("Memcpy") and kind in o[0]]

    @property
    def busy_s(self) -> float:
        """Seconds in which any operation ran on the device."""
        return union_s((a, b) for _, a, b in self.ops)

    def kernel_busy_s(self) -> float:
        return union_s((a, b) for _, a, b in self.kernels())

    def breakdown(self, spans, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the host span that covered the gap's middle."""
        by_name: dict = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(a, b) for _, a, b in self.ops])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])

        def label(mid):
            inner = [(b - a, name) for name, ss in spans.data.items()
                     for a, b in ss if a <= mid <= b]
            return min(inner)[1] if inner else "host"
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[label((a + b) / 2), b - a] for a, b in gaps[:top]]}
