"""Recording storage manager.

Reference policy (clearcam.py:1327-1381): every 600s, if total recordings
exceed the configured max GB (default 256) or free disk falls under 5 GB,
delete the oldest recording day of the largest camera, plus its sibling
event_images/objects/faces day folders.
"""
from __future__ import annotations

import shutil
import threading
from pathlib import Path

CHECK_INTERVAL_S = 600
MIN_FREE_GB = 5
DEFAULT_MAX_GB = 256
SIBLING_DIRS = ("event_images", "objects", "faces")


def dir_size_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.glob("**/*") if f.is_file())


def over_budget(cameras_dir: Path, max_gb: float) -> bool:
    if not cameras_dir.exists():
        return False
    size_gb = dir_size_bytes(cameras_dir) / 1000**3
    free_gb = shutil.disk_usage(cameras_dir).free / 1000**3
    return size_gb > max_gb or free_gb < MIN_FREE_GB


def cleanup_once(cameras_dir: Path) -> Path | None:
    """Delete the oldest recording dir of the largest camera (+ siblings).
    Returns the removed path, or None if nothing to do."""
    cams = [(d, dir_size_bytes(d)) for d in cameras_dir.iterdir() if d.is_dir()]
    if not cams:
        return None
    largest = max(cams, key=lambda t: t[1])[0]
    streams = largest / "streams"
    if not streams.exists():
        shutil.rmtree(largest)
        return largest
    recordings = sorted((d for d in streams.iterdir() if d.is_dir()),
                        key=lambda d: d.stat().st_ctime)
    if not recordings:
        shutil.rmtree(largest)
        return largest
    oldest = recordings[0]
    shutil.rmtree(oldest)
    for sib in SIBLING_DIRS:
        p = largest / sib / oldest.name
        if p.exists():
            shutil.rmtree(p)
    return oldest


class StorageManager:
    """Background enforcement thread (start()/stop())."""

    def __init__(self, cameras_dir: Path, max_gb: float = DEFAULT_MAX_GB,
                 interval_s: float = CHECK_INTERVAL_S):
        self.cameras_dir = Path(cameras_dir)
        self.max_gb = max_gb
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def check(self):
        if over_budget(self.cameras_dir, self.max_gb):
            cleanup_once(self.cameras_dir)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.check()
            except Exception as e:  # noqa: BLE001
                print(f"storage cleanup error: {e}")
            self._stop.wait(self.interval_s)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="StorageCleanup")
            self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
