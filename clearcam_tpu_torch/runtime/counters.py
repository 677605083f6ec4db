"""Alert rules engine: rolling per-class event counts in a time window.

Behavioral mirror of the reference RollingClassCounter (clearcam.py:47-103):
per-class deques of event timestamps, window pruning, max-count trigger,
weekly schedule gate, zone opt-out flag, optional CLIP text description +
similarity threshold. Instances are pickled whole into the `alerts`/`counters`
KV tables, so attribute names are part of the persistence format.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque

DEFAULT_SCHED = [[0, 86399], True, True, True, True, True, True, True]


class RollingClassCounter:
    def __init__(self, window_seconds=None, max=None, classes=None,
                 sched=None, cam_name=None, desc=None, threshold=0.28):
        self.window = window_seconds
        self.data = defaultdict(deque)
        self.max = max
        self.classes = classes
        self.last_det = 0
        self.sched = sched if sched is not None else list(DEFAULT_SCHED)
        self.cam_name = cam_name
        self.is_on = True
        self.is_notif = True
        self.zone = True
        self.reset = False
        self.new = True
        self.desc = desc
        self.desc_emb = None
        self.threshold = threshold

    def _window(self) -> float:
        # None window -> 60s for notifying alerts, 1s otherwise (clearcam.py:73)
        return self.window if self.window else (60 if self.is_notif else 1)

    def add(self, class_id, now: float | None = None):
        if self.classes is not None and class_id not in self.classes:
            return
        now = time.time() if now is None else now
        self.data[class_id].append(now)
        self._cleanup(class_id, now)

    def _cleanup(self, class_id, now: float):
        q = self.data[class_id]
        w = self._window()
        while w and q and now - q[0] > w:
            q.popleft()

    def reset_counts(self):
        for class_id in list(self.data):
            self.data[class_id] = deque()
        self.reset = True

    def get_counts(self, now: float | None = None):
        """-> (counts {class: n}, max_reached)."""
        now = time.time() if now is None else now
        w = self._window()
        counts, max_reached = {}, False
        for class_id, q in self.data.items():
            while w and q and now - q[0] > w:
                q.popleft()
            if q:
                counts[class_id] = len(q)
                if self.max and len(q) >= self.max:
                    max_reached = True
        return counts, max_reached

    def is_active(self, offset: float = 0, alerts_enabled: bool = True,
                  localtime=None) -> bool:
        """Schedule gate (clearcam.py:95-103): sched[0]=[start,end] seconds of
        day; sched[1+weekday] weekday enable. The window start is widened by
        the rolling window so events straddling the boundary still fire."""
        if not alerts_enabled:
            return False
        if not getattr(self, "is_on", False):
            return False
        if not self.sched:
            return True
        lt = time.localtime() if localtime is None else localtime
        tod = lt.tm_hour * 3600 + lt.tm_min * 60 + lt.tm_sec
        if not self.sched[lt.tm_wday + 1]:
            return False
        return (self.sched[0][0] - self._window()) + offset < tod < self.sched[0][1]
