"""Camera ingest: ffmpeg HLS recording + raw frame pumps + VOD playback.

Reference recipe (clearcam.py:300-421): two subprocesses per live camera —
(a) RTSP -> HLS copy (2s .ts segments) for recording/playback, and
(b) HLS -> rawvideo bgr24 pipe feeding inference; a daemon thread reads the
pipe into a newest-frame-wins slot. VOD files play through cv2.VideoCapture.

Re-design for the batched TPU pipeline: sources are pluggable (ffmpeg, cv2,
synthetic for tests), each pump writes into a lock-free latest-frame slot with
a monotonically increasing frame number, and the NVR loop snapshots all slots
per tick to build the cross-stream detect batch. Restart-on-failure semantics
match the reference (5 consecutive short reads -> respawn, clearcam.py:407-413).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

VOD_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def find_ffmpeg() -> str | None:
    """Locate ffmpeg (reference helpers.py:223-235)."""
    p = shutil.which("ffmpeg")
    if p:
        return p
    for cand in ("/opt/homebrew/bin/ffmpeg", "/usr/local/bin/ffmpeg", "/usr/bin/ffmpeg"):
        if Path(cand).exists():
            return cand
    return None


def probe_resolution(src: str, timeout: float = 10.0) -> tuple[int, int]:
    """(width, height) of a stream via ffmpeg banner parse; 1920x1080 fallback
    (reference clearcam.py:145-163)."""
    ff = find_ffmpeg()
    if ff:
        try:
            r = subprocess.run([ff, "-i", src], stderr=subprocess.PIPE,
                               stdout=subprocess.DEVNULL, text=True, timeout=timeout)
            m = re.search(r"Video:.*?(\d{2,5})x(\d{2,5})", r.stderr)
            if m:
                return int(m.group(1)), int(m.group(2))
        except Exception:
            pass
    try:
        import cv2
        cap = cv2.VideoCapture(src)
        if cap.isOpened():
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            cap.release()
            if w and h:
                return w, h
    except Exception:
        pass
    return 1920, 1080


def hls_record_cmd(ff: str, src: str, out_dir: Path) -> list[str]:
    """ffmpeg arguments for the copy->HLS recorder (clearcam.py:329-345).

    The reference's VOD fmp4 variant (clearcam.py:311-325) is intentionally
    absent: VOD analysis reads via OpenCVSource and serves the original
    file through the HTTP VOD path rewrite — no recorder runs for VOD cams
    (a vod branch here was dead code; removed)."""
    rtsp = ["-rtsp_transport", "tcp"] if src.startswith("rtsp") else []
    return [ff, *rtsp, "-fflags", "+genpts", "-avoid_negative_ts", "make_zero",
            "-i", src, "-c", "copy", "-an", "-f", "hls",
            "-hls_time", "2", "-hls_list_size", "0",
            "-hls_playlist_type", "event",
            "-hls_flags", "append_list+independent_segments+temp_file",
            "-hls_segment_filename", str(out_dir / "stream_%06d.ts"),
            str(out_dir / "stream.m3u8")]


def raw_decode_cmd(ff: str, playlist: Path, width: int, height: int) -> list[str]:
    """ffmpeg arguments for the HLS -> rawvideo bgr24 inference pipe
    (clearcam.py:349-371)."""
    return [ff, "-live_start_index", "-1", "-i", str(playlist),
            "-loglevel", "quiet", "-an", "-f", "rawvideo",
            "-pix_fmt", "bgr24", "-vf", f"scale={width}:{height}",
            "-fflags", "+discardcorrupt+fastseek+flush_packets+nobuffer",
            "-avioflags", "direct", "-flags", "low_delay",
            "-max_delay", "100000", "-threads", "1", "-"]


class FrameSlot:
    """Newest-frame-wins shared slot between a pump thread and the NVR loop."""

    def __init__(self):
        self._frame: np.ndarray | None = None
        self._num = -1
        self._lock = threading.Lock()

    def push(self, frame: np.ndarray):
        with self._lock:
            self._frame = frame
            self._num += 1

    def snapshot(self) -> tuple[np.ndarray | None, int]:
        with self._lock:
            return self._frame, self._num


class FrameSource:
    """Interface: read() -> frame | None (BGR uint8 HWC); close()."""

    fps: float = 30.0
    finite: bool = False   # True: a file that ENDS (VOD), not a live feed

    def read(self) -> np.ndarray | None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self):
        pass

    def progress(self) -> float | None:
        """VOD completion 0..100 or None for live."""
        return None


class SyntheticSource(FrameSource):
    """Deterministic moving-box frames for tests and benchmarks."""

    # Round-robin buffers: a handed-out frame is ALIASED until POOL more
    # reads reuse its buffer (reuse window = POOL/fps s). Consumers that
    # persist pixels copy at use (crop saves do); a slow tick may observe a
    # redrawn box — acceptable for a synthetic test/bench source, never used
    # in production ingest.
    POOL = 16

    def __init__(self, width=640, height=360, n_frames=None, seed=0, fps=100.0):
        self.w, self.h = width, height
        self.n = n_frames
        self.finite = n_frames is not None
        self.t = 0
        self.fps = fps
        rng = np.random.default_rng(seed)
        self.base = rng.integers(0, 60, (height, width, 3), np.uint8)
        # frame generation must be O(box), not O(frame): at 128 cams x 30 fps
        # a full-frame copy per read (~0.3 ms) is ~3.5 cores of memcpy and
        # starves the NVR tick. Buffers round-robin; only the previous box
        # region is restored before drawing the new one.
        self._pool = [self.base.copy() for _ in range(self.POOL)]
        self._prev_box: list = [None] * self.POOL

    def read(self):
        if self.n is not None and self.t >= self.n:
            return None
        i = self.t % self.POOL
        f = self._pool[i]
        if self._prev_box[i] is not None:
            y0, x0 = self._prev_box[i]
            f[y0:y0 + 120, x0:x0 + 80] = self.base[y0:y0 + 120, x0:x0 + 80]
        # ping-pong motion so one object persists as a single long-lived track
        span = max(1, self.w - 160)
        p = (self.t * 6) % (2 * span)
        x = 40 + (p if p < span else 2 * span - p)
        y = self.h // 3
        f[y:y + 120, x:x + 80] = (40, 180, 240)
        self._prev_box[i] = (y, x)
        self.t += 1
        return f

    def progress(self):
        if self.n is None:
            return None
        return min(100.0, self.t / self.n * 100.0)


class OpenCVSource(FrameSource):
    """VOD playback through cv2.VideoCapture (reference clearcam.py:425-438)."""

    finite = True

    def __init__(self, path: str, grab_skip: bool = True):
        import cv2
        self.cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.grab_skip = grab_skip

    def read(self):
        if self.grab_skip:
            self.cap.grab()  # skip alternate frames for max throughput
        ok, frame = self.cap.read()
        return frame if ok else None

    def position_seconds(self) -> float:
        return self.cap.get(self.cv2.CAP_PROP_POS_FRAMES) / max(self.fps, 1e-6)

    def progress(self):
        total = self.cap.get(self.cv2.CAP_PROP_FRAME_COUNT)
        if not total:
            return None
        return self.cap.get(self.cv2.CAP_PROP_POS_FRAMES) / total * 100.0

    def close(self):
        self.cap.release()


class FfmpegSource(FrameSource):
    """Live source: HLS recorder + rawvideo pipe, with respawn on read
    failures (reference clearcam.py:300-421)."""

    MAX_FAILS = 5

    def __init__(self, src: str, record_dir: Path, width: int | None = None,
                 height: int | None = None, warmup_s: float | None = None):
        if warmup_s is None:
            warmup_s = float(os.environ.get("CLEARCAM_INGEST_WARMUP", "15"))
        self.src = src
        self.record_dir = Path(record_dir)
        self.record_dir.mkdir(parents=True, exist_ok=True)
        if width is None or height is None:
            width, height = probe_resolution(src)
        self.w, self.h = width, height
        self.warmup_s = warmup_s
        self.hls_proc: subprocess.Popen | None = None
        self.pipe_proc: subprocess.Popen | None = None
        self.fails = 0
        self._spawn()

    def _spawn(self):
        ff = find_ffmpeg()
        if ff is None:
            raise RuntimeError("ffmpeg not found; live ingest requires ffmpeg")
        self._kill(self.hls_proc)
        self._kill(self.pipe_proc)
        self.hls_proc = subprocess.Popen(
            hls_record_cmd(ff, self.src, self.record_dir),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        # wait for the playlist + first segment (warmup_s is the CAP, not a
        # fixed sleep — a 15 s sleep per camera froze the NVR tick thread
        # for every hot-add; typical streams are ready in one 2 s segment)
        playlist = self.record_dir / "stream.m3u8"
        deadline = time.monotonic() + self.warmup_s
        while time.monotonic() < deadline:
            if playlist.exists() and any(self.record_dir.glob("*.ts")):
                break
            if self.hls_proc.poll() is not None:
                break                     # recorder died; let read() respawn
            time.sleep(0.25)
        self.pipe_proc = subprocess.Popen(
            raw_decode_cmd(ff, self.record_dir / "stream.m3u8", self.w, self.h),
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)

    @staticmethod
    def _kill(proc):
        if proc:
            try:
                proc.terminate()
                proc.wait(timeout=5)
            except Exception:
                try:
                    proc.kill()
                except Exception:
                    pass

    def read(self):
        size = self.w * self.h * 3
        raw = self.pipe_proc.stdout.read(size)
        if raw is None or len(raw) != size:
            self.fails += 1
            if self.fails > self.MAX_FAILS:
                self._spawn()
                self.fails = 0
            return None
        self.fails = 0
        return np.frombuffer(raw, np.uint8).reshape(self.h, self.w, 3)

    def close(self):
        self._kill(self.hls_proc)
        self._kill(self.pipe_proc)


class MJPEGSource(FrameSource):
    """motion-JPEG over HTTP (multipart/x-mixed-replace) — the most common
    IP-camera protocol after RTSP, ingested WITHOUT ffmpeg.

    The reference can only reach HTTP cameras through ffmpeg
    (clearcam.py:300-371); this pure-Python reader gives minimal/air-gapped
    deploys live detection + alerts + crops with zero external binaries
    (recording/day-playback still needs the ffmpeg HLS recorder — when
    ffmpeg exists it keeps handling http sources so recording works).

    Frames are delimited by scanning for the JPEG SOI/EOI markers, which is
    robust to cameras that omit Content-Length part headers; Content-Length
    is honored when present (skips the scan).
    """

    MAX_BUF = 32 * 1024 * 1024  # a frame larger than this is a broken stream

    def __init__(self, url: str, timeout: float = 10.0, resp=None):
        import urllib.request
        self.url = url
        self.timeout = timeout
        # resp: an already-open response (_sniff_http_source sniffed the
        # Content-Type from it; reuse instead of reconnecting)
        self.resp = resp if resp is not None else \
            urllib.request.urlopen(url, timeout=timeout)
        self.buf = b""
        self.fails = 0

    def _refill(self) -> bool:
        chunk = self.resp.read1(65536) if hasattr(self.resp, "read1") else \
            self.resp.read(65536)
        if not chunk:
            return False
        self.buf += chunk
        return True

    @staticmethod
    def _part_header(buf: bytes, soi: int):
        """Parse the multipart part-header block preceding the next SOI:
        (body_offset, content_length|None). Headers end at the first blank
        line and are matched case-insensitively in any order — cameras
        commonly send Content-Type AFTER Content-Length, which a
        position-sensitive regex misses (round-4 advisor)."""
        he, sep = buf.find(b"\r\n\r\n"), 4
        he2 = buf.find(b"\n\n")
        if he == -1 or (he2 != -1 and he2 < he):
            he, sep = he2, 2
        if he == -1 or (soi != -1 and he + sep > soi):
            return None, None     # no header block before the jpeg data
        clen = None
        for line in buf[:he].replace(b"\r\n", b"\n").split(b"\n"):
            k, _, v = line.partition(b":")
            if k.strip().lower() == b"content-length":
                try:
                    clen = int(v.strip())
                except ValueError:
                    clen = None
        return he + sep, clen

    def _next_jpeg(self) -> bytes | None:
        while True:
            soi = self.buf.find(b"\xff\xd8")
            # honor an explicit Content-Length part header when visible —
            # the authoritative frame length (an SOI/EOI scan truncates at
            # an embedded EXIF/JFIF thumbnail's EOI)
            body, clen = self._part_header(self.buf, soi)
            if clen is not None:
                need = body + clen
                if len(self.buf) >= need:
                    jpg = self.buf[body:need]
                    self.buf = self.buf[need:]
                    return jpg
            elif soi != -1:
                eoi = self.buf.find(b"\xff\xd9", soi + 2)
                if eoi != -1:
                    jpg = self.buf[soi:eoi + 2]
                    self.buf = self.buf[eoi + 2:]
                    return jpg
            if len(self.buf) > self.MAX_BUF:
                self.buf = b""
                return None
            if not self._refill():
                return None

    def read(self):
        import cv2
        try:
            jpg = self._next_jpeg()
        except Exception:
            jpg = None
        if jpg is None:
            self.fails += 1
            if self.fails > FfmpegSource.MAX_FAILS:
                try:  # respawn semantics mirror the ffmpeg pipe (clearcam.py:407-413)
                    import urllib.request
                    self.close()
                    self.resp = urllib.request.urlopen(self.url, timeout=self.timeout)
                    # stale partial-frame bytes from the dead connection
                    # would corrupt the first frames after respawn
                    self.buf = b""
                    self.fails = 0
                except Exception:
                    pass
            return None
        frame = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
        if frame is None:
            return None
        self.fails = 0
        return frame

    def close(self):
        try:
            self.resp.close()
        except Exception:
            pass


class SnapshotSource(FrameSource):
    """Still-JPEG polling (http://cam/snapshot.jpg) at a fixed rate — the
    lowest-common-denominator IP-camera surface, also ffmpeg-free. read()
    paces itself (FramePump loops as fast as read returns)."""

    def __init__(self, url: str, fps: float = 2.0, timeout: float = 10.0):
        self.url = url
        self.interval = 1.0 / max(fps, 0.01)
        self.timeout = timeout
        self._next_t = 0.0

    def read(self):
        import cv2
        import urllib.request
        # monotonic, like every other pacing loop here: a wall-clock step
        # backwards (NTP/DST) must not freeze the camera for the delta
        now = time.monotonic()
        if now < self._next_t:
            time.sleep(self._next_t - now)
        self._next_t = max(self._next_t + self.interval, time.monotonic())
        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as r:
                data = r.read()
        except Exception:
            return None
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


def _sniff_http_source(src: str) -> FrameSource | None:
    """Content-Type sniff for http(s) cameras when ffmpeg is unavailable:
    multipart/x-mixed-replace -> MJPEG stream; image/* -> snapshot poller."""
    import urllib.request
    try:
        resp = urllib.request.urlopen(src, timeout=10)
    except Exception:
        return None
    ctype = (resp.headers.get("Content-Type") or "").lower()
    if "multipart/x-mixed-replace" in ctype:
        return MJPEGSource(src, resp=resp)
    resp.close()
    if ctype.startswith("image/"):
        return SnapshotSource(src)
    return None


def open_source(src: str, record_dir: Path) -> FrameSource:
    if src.startswith("synthetic://"):
        # synthetic://WxH?n=120&fps=30  (params optional, any order)
        m = re.match(r"synthetic://(\d+)x(\d+)(?:\?(.*))?$", src)
        if m:
            params = dict(p.split("=", 1) for p in (m.group(3) or "").split("&")
                          if "=" in p)
            n = int(params["n"]) if "n" in params else None
            return SyntheticSource(int(m.group(1)), int(m.group(2)), n,
                                   fps=float(params.get("fps", 100.0)))
        return SyntheticSource()
    if src.startswith("mjpeg://"):  # force the pure-Python reader
        return MJPEGSource("http://" + src[len("mjpeg://"):])
    if src.startswith("mjpegs://"):
        return MJPEGSource("https://" + src[len("mjpegs://"):])
    if src.startswith("snapshot://"):
        # fps may ride anywhere in the query (cameras have their own
        # params: snapshot://cam/img.cgi?user=a&fps=5) and malformed
        # values fall back to the default instead of killing init_cam
        from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit
        parts = urlsplit("http://" + src[len("snapshot://"):])
        fps, keep = 2.0, []
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            if k == "fps":
                try:
                    fps = float(v)
                except ValueError:
                    pass
            else:
                keep.append((k, v))
        url = urlunsplit(parts._replace(query=urlencode(keep)))
        return SnapshotSource(url, fps=fps)
    if src.endswith(VOD_SUFFIXES):
        return OpenCVSource(src)
    if src.startswith(("http://", "https://")) and find_ffmpeg() is None:
        sniffed = _sniff_http_source(src)
        if sniffed is not None:
            return sniffed
    return FfmpegSource(src, record_dir)


class SharedFramePump(threading.Thread):
    """ONE thread pacing many non-blocking sources (SyntheticSource).

    Per-camera pump threads convoy the GIL at NVR scale: 128 threads waking
    30x/s starved the tick thread into multi-second ticks (each wakeup holds
    the GIL up to a switch interval). Sources whose read() never blocks
    don't need a thread each — a single scheduler reads each at its own fps
    into its slot. Blocking sources (ffmpeg pipes) keep per-camera pumps
    (their reads park in C without the GIL) or the C++ native ingest.
    """

    def __init__(self):
        super().__init__(daemon=True, name="shared-pump")
        self._lock = threading.Lock()
        self._srcs: dict = {}          # name -> [source, slot, next_t]
        self.running = True
        self.start()

    def add(self, name: str, source: FrameSource, slot: FrameSlot):
        with self._lock:
            self._srcs[name] = [source, slot, time.monotonic()]

    def remove(self, name: str):
        with self._lock:
            self._srcs.pop(name, None)

    def run(self):
        while self.running:
            now = time.monotonic()
            wake = now + 0.05
            with self._lock:
                entries = list(self._srcs.values())
            for ent in entries:
                source, slot, next_t = ent
                if next_t <= now:
                    try:
                        frame = source.read()
                    except Exception:  # noqa: BLE001
                        frame = None
                    if frame is not None:
                        slot.push(frame)
                    period = 1.0 / max(source.fps, 1.0)
                    ent[2] = next_t + period
                    if ent[2] < now:          # fell behind: don't burst
                        ent[2] = now + period
                wake = min(wake, ent[2])
            time.sleep(max(0.001, wake - time.monotonic()))

    def stop(self):
        self.running = False


class FramePump(threading.Thread):
    """Daemon thread: source.read() -> slot, pacing to the source fps."""

    def __init__(self, name: str, source: FrameSource, slot: FrameSlot):
        super().__init__(daemon=True, name=f"pump-{name}")
        self.source = source
        self.slot = slot
        self.running = True
        self.ended = False

    def run(self):
        period = 1.0 / max(self.source.fps, 1.0)
        next_t = time.monotonic()
        while self.running:
            try:
                frame = self.source.read()
            except Exception:
                time.sleep(1.0)
                continue
            if frame is None:
                if self.source.finite:
                    # a finite file ends on SUSTAINED failure, not one
                    # corrupt frame (a mid-file decode glitch used to
                    # silently abandon the rest of the VOD); works for
                    # containers with unknown frame counts too (where
                    # progress() is None and EOF was never detected)
                    self._eof_strikes = getattr(self, "_eof_strikes", 0) + 1
                    if self._eof_strikes >= 5 or (
                            self.source.progress() or 0) >= 100.0:
                        self.ended = True
                        return
                    time.sleep(0.05)
                    continue
                time.sleep(0.5)
                continue
            self._eof_strikes = 0
            self.slot.push(frame)
            # blocking sources (ffmpeg pipe — FramePump's remaining users;
            # synthetic sources ride SharedFramePump) pace themselves inside
            # read(); the sleep is only a GIL yield. Never cap at the
            # *declared* fps: a 60 fps stream read at 30 would accumulate
            # unbounded pipe backlog/latency.
            time.sleep(min(period, 0.01))

    def stop(self):
        self.running = False
        self.source.close()
