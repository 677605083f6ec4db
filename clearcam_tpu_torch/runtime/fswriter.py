"""Async crop/image writer: decouple jpeg encode + filesystem latency from
the NVR tick.

The reference writes every crop inline in its per-frame loop
(clearcam.py:396-399 save_object -> cv2.imwrite) — fine for a handful of
cameras, but at 128 streams the tick was spending ~35 ms PER CROP on this
container (mkdir/stat ~7 ms each on overlayfs, plus encode+write). One
writer thread absorbs that latency; the tick only enqueues (bounded queue,
newest dropped under backpressure — a missed crop is cosmetic, a stalled
tick drops frames for every camera).
"""
from __future__ import annotations

import queue
import threading
from pathlib import Path

from . import metrics


class AsyncFileWriter(threading.Thread):
    """Single writer thread with a made-dirs cache (storage cleanup can
    delete a cached day dir: a failed write invalidates and retries once)."""

    def __init__(self, maxsize: int = 512):
        super().__init__(daemon=True, name="fswriter")
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._made: set[str] = set()
        self._sentinel = object()
        self._closed = False
        self.start()

    def submit(self, path: Path, img, then=None) -> bool:
        """Enqueue `cv2.imwrite(path, img)`; `then(path)` runs in the writer
        thread after a successful write. Returns False when dropped."""
        if self._closed:      # stop() raced an in-flight tick: drop, never
            return False      # strand items behind the sentinel
        try:
            self.q.put_nowait((Path(path), img, then))
            metrics.default.gauge("fswriter_depth", self.q.qsize())
            return True
        except queue.Full:
            metrics.default.count("fswriter_dropped")
            return False

    def _write(self, path: Path, img) -> bool:
        import cv2

        parent = str(path.parent)
        if parent not in self._made:
            path.parent.mkdir(parents=True, exist_ok=True)
            self._made.add(parent)
        if cv2.imwrite(str(path), img):
            return True
        # cached dir may have been reaped by the storage manager
        self._made.discard(parent)
        path.parent.mkdir(parents=True, exist_ok=True)
        return bool(cv2.imwrite(str(path), img))

    def run(self):
        while True:
            item = self.q.get()
            try:
                if item is self._sentinel:
                    return
                path, img, then = item
                try:
                    if self._write(path, img) and then is not None:
                        then(path)
                except Exception:  # noqa: BLE001 — a bad crop never kills the writer
                    metrics.default.count("fswriter_errors")
            finally:
                self.q.task_done()

    def flush(self, timeout: float = 30.0):
        """Wait (bounded) until everything enqueued so far is on disk.
        Unlike q.join(), returns when the writer thread has exited — a
        concurrent stop() must not deadlock a run() winding down."""
        import time

        t0 = time.monotonic()
        while (self.q.unfinished_tasks and self.is_alive()
               and time.monotonic() - t0 < timeout):
            time.sleep(0.01)

    def stop(self):
        self._closed = True
        # A saturated queue must still receive the sentinel or run() never
        # exits and join() just times out (leaked thread on in-process NVR
        # restart, ADVICE r2) — the drain frees slots, so a bounded blocking
        # put succeeds unless the writer thread is already gone.
        try:
            self.q.put(self._sentinel, timeout=10 if self.is_alive() else 0.01)
        except queue.Full:
            pass
        self.join(timeout=10)
