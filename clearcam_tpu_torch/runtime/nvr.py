"""NVR core runtime on a torch device: cross-stream batched detection,
tracking, alerts, and Qwen3-VL alert summaries.

The host runtime is the JAX package's (clearcam_tpu/runtime/nvr.py, copied
with its design notes): per-camera pumps fill newest-frame-wins slots; each
tick, every camera with a fresh frame is grouped by resolution and detected
in one batched device call per group; trackers, alert logic and crop saving
stay on the host; a DeviceExecutor drains queued CLIP/face/search work
between ticks. What the port changes: ``BatchDetector`` runs the port's
YOLOv9 (and its stem kernel on CUDA), and ``NVR.summary_engine`` builds the
port's ``serving.vlm.VLMServingEngine`` with a bf16 KV cache.

Behavioral parity (per camera): class whitelist {0,1,2,7}, tracklet_len>=1
gate, min speed 2.5, crop save throttling (<=20 crops, >=1s apart, min 100px
side), zone filtering with per-alert zone opt-out, alert windows + schedules,
hourly preview.png, 5s settings/counters sync through the KV store, daily
restart, VOD analysis progress (clearcam.py:165-628,1162-1176).
"""
from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models import yolov9
from ..ops import stem as stem_ops
from ..track.multicam import MultiCamOCSort
from ..utils.annotate import draw_predictions
from ..utils.labels import COCO_LABELS
from . import metrics
from .counters import RollingClassCounter
from .ingest import (FramePump, FrameSlot, OpenCVSource, SyntheticSource,
                     open_source, VOD_SUFFIXES)
from .settings import GlobalSettings
from .zones import box_outside_zone

DEFAULT_CLASSES = {"0", "1", "2", "7"}  # person, bicycle, car, truck
MIN_TRACK_SPEED = 2.5
MIN_CROP_SIDE = 100
MAX_CROPS_PER_TRACK = 20


class DeviceExecutor:
    """Single-consumer task queue: HTTP threads submit device work and block;
    the NVR loop drains one task per tick (reference add_to_queue /
    process_queue, clearcam.py:1214-1226)."""

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self.loop_running = False   # set by NVR.run; inline execution otherwise

    def submit(self, fn, *args):
        if not self.loop_running:
            return fn(*args)
        result: queue.Queue = queue.Queue(maxsize=1)
        self._q.put((fn, args, result))
        while True:
            try:
                out = result.get(timeout=0.5)
                break
            except queue.Empty:
                if not self.loop_running:
                    self.drain_one()  # loop exited mid-wait: self-service
        if isinstance(out, BaseException):
            raise out
        return out

    def drain_one(self) -> bool:
        try:
            fn, args, result = self._q.get_nowait()
        except queue.Empty:
            return False
        try:
            result.put(fn(*args))
        except BaseException as e:  # noqa: BLE001
            result.put(e)
        return True

    def shutdown(self):
        """Unblock submitters still queued when the loop exits: run their
        tasks inline-style so no HTTP thread hangs on result.get() forever."""
        self.loop_running = False
        while self.drain_one():
            pass


class BatchDetector:
    """Shape-bucketed batched detection with the JAX ``BatchDetector``'s
    ``detect_many`` contract: frames of one shape share one device call,
    mixed resolutions are grouped by shape, and batches are padded to powers
    of two. ``size`` and ``res`` are read by the settings hook.

    On a CUDA device with the stem kernel on the model's path, the kernel
    is built and set up here (``kernel_library`` is its path), so a failed
    build stops the detector's construction instead of every detect step.

    With ``mesh`` (``parallel.mesh.make_mesh``), every rank builds the
    detector (and prepares the stem kernel on its card), and rank 0's
    ``detect_many`` leads: for each shape group it sends the step to the
    other ranks (which run ``mesh.follow()``), scatters the uint8 frames, a
    contiguous slice of rows a ``data`` rank, and gathers every rank's
    detections (``parallel.mesh.sharded_detect_fn``), both on the
    detector's own group. Buckets are ``data`` times a power of two, so
    every rank gets equal rows. Weights are replicated (detect is
    activation-dominated). A raise on rank 0 inside a step releases the
    other ranks from it (``Channel.call``) and fails this call only, as a
    failed step does on one device."""

    def __init__(self, size: str = "t", res: int = 960, params=None,
                 dtype=torch.bfloat16, device="cuda", mesh=None):
        self.size, self.res, self.dtype = size, res, dtype
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.kernel_library = None
        if self.device.type == "cuda" and yolov9.uses_stem_kernel(size):
            self.kernel_library = stem_ops.prepare(self.device)
        self.params = yolov9.params_from_jax(
            params if params is not None else yolov9.init_params(size),
            self.device, dtype)
        self.mesh = mesh
        self._dp = 1
        self._seen: set[tuple] = set()      # (shape, bucket) groups run so far
        if mesh is not None:
            from ..parallel import mesh as pmesh
            self._dp = mesh.shape["data"]
            self.group = mesh.new_group()
            self._step, _ = pmesh.sharded_detect_fn(mesh, size, res=res, group=self.group,
                                                    compute_dtype=dtype)
            self.name = mesh.channel.register("detect", self)

    def _bucket(self, n: int) -> int:
        """Smallest dp * 2^k >= n: powers of two bound the set of batch
        shapes, the dp factor keeps every bucket divisible by the mesh's
        data axis."""
        b = self._dp
        while b < n:
            b *= 2
        return b

    @torch.inference_mode()
    def detect_many(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """uint8 BGR frames, mixed shapes allowed -> one float32 [300, 6]
        array of rows per frame (x1,y1,x2,y2,score,class; zero rows for
        suppressed slots).

        Spans (``runtime.metrics``): ``detect.call`` around the call and,
        in it for each shape group, ``detect.stack`` (the host's stack of
        its frames), ``detect.upload`` (their copy to the device and the
        zeroing of the bucket's padding; attribute: bytes copied),
        ``detect.model`` (the host's enqueue of the model, or the mesh's
        step), ``detect.readback`` (the wait for the rows and their copy
        back), all under ``detect.first_call`` where this process has not
        run the group's (shape, bucket) before. Counters: ``detect.frames``,
        ``detect.calls`` (one a group), ``detect.pad_rows`` (bucket rows
        without a frame), ``detect.h2d_bytes``, ``detect.d2h_bytes``."""
        out: list[np.ndarray | None] = [None] * len(frames)
        with metrics.timer("detect.call"):
            groups: dict[tuple, list[int]] = {}
            for i, f in enumerate(frames):
                groups.setdefault(f.shape, []).append(i)
            for shape, idxs in groups.items():
                n = len(idxs)
                key = (tuple(shape), self._bucket(n))
                first = key not in self._seen
                with metrics.timer("detect.first_call") if first else contextlib.nullcontext():
                    preds = self._detect_group(frames, idxs, *key)
                self._seen.add(key)
                for j, i in enumerate(idxs):
                    out[i] = preds[j]
                metrics.count("detect.frames", n)
                metrics.count("detect.calls")
                metrics.count("detect.pad_rows", key[1] - n)
                metrics.count("detect.d2h_bytes", preds.nbytes)
        return out  # type: ignore[return-value]

    def _detect_group(self, frames, idxs, shape, bucket) -> np.ndarray:
        """One shape group's device call: [bucket, 300, 6] rows on the host."""
        # only the real frames cross to the device; the bucket's padding
        # is zeroed there
        n = len(idxs)
        with metrics.timer("detect.stack"):
            host = torch.from_numpy(np.stack([frames[i] for i in idxs]))
        with metrics.timer("detect.upload", attr=host.nbytes):
            batch = torch.empty((bucket, *shape), dtype=torch.uint8, device=self.device)
            batch[:n].copy_(host)
            batch[n:].zero_()
        metrics.count("detect.h2d_bytes", host.nbytes)
        with metrics.timer("detect.model"):
            if self.mesh is None:
                preds = yolov9.detect(self.params, batch, size=self.size,
                                      res=self.res, compute_dtype=self.dtype)
            else:
                key = (shape, bucket)
                preds = self.mesh.channel.call(
                    self.name, "sharded_rows", key,
                    lambda: self.sharded_rows(*key, batch))
        with metrics.timer("detect.readback"):
            preds = preds.cpu().numpy()
        return preds

    @torch.inference_mode()
    def sharded_rows(self, shape: tuple, bucket: int, batch=None) -> torch.Tensor:
        """One sharded detect step on every rank: rank 0's ``batch`` [bucket,
        *shape] scattered (each rank gets its data rank's rows), detected,
        gathered: [bucket, 300, 6] on every rank."""
        from ..parallel import comm
        rows = bucket // self._dp
        local = torch.empty((rows, *shape), dtype=torch.uint8, device=self.device)
        chunks = None
        if batch is not None:
            m = self.mesh.shape["model"]
            chunks = [batch[(r // m) * rows:(r // m + 1) * rows].contiguous()
                      for r in range(self.mesh.size)]
        comm.scatter(local, chunks, self.group)
        return self._step(self.params, local)


class NativeIngest:
    """Groups live ffmpeg cameras by resolution onto native batchers
    (native/ingest): pipe fds are consumed by C++ reader threads and the NVR
    tick materializes each group's batch with one snapshot call — no
    per-frame Python copies (replaces FramePump for FfmpegSource cams).

    Each resolution group is PAGED: a new PAGE_CAP-slot batcher is allocated
    when the group fills, so camera count per resolution is unbounded while
    frame memory (2 buffers/slot) is only allocated in page-sized steps.

    downsample k (odd, CLEARCAM_INGEST_DOWNSAMPLE): the C++ readers decimate
    frames with the exact center-tap the on-device letterbox would apply at
    an exact odd ratio — k^2 less host memcpy + host->device traffic (a
    128-stream 1080p deployment is otherwise PCIe-bound). Applied per group
    when the resolution divides evenly; crops/previews are then k-times
    smaller (quality trade, so opt-in)."""

    PAGE_CAP = 32

    def __init__(self, downsample: int = 1):
        self.downsample = downsample
        self.groups: dict[tuple, list[dict]] = {}  # shape -> [page, ...]

    def _group_downsample(self, shape) -> int:
        k = self.downsample
        if k > 1 and k % 2 == 1 and shape[0] % k == 0 and shape[1] % k == 0:
            return k
        return 1

    def _pages(self, shape):
        return self.groups.setdefault(shape, [])

    def register(self, cam_name: str, fd: int, shape: tuple[int, int, int]):
        from .native_loader import NativeBatcher
        # a camera respawning at a different resolution moves groups: free its
        # old slot first so repeated re-points never leak slots
        for other_shape, pages in self.groups.items():
            if other_shape != shape:
                for pg in pages:
                    if cam_name in pg["names"]:
                        self._free_slot(pg, pg["names"].index(cam_name))
        page = idx = None
        for pg in self._pages(shape):
            names = pg["names"]
            if cam_name in names:       # same-shape respawn: reuse the slot
                page, idx = pg, names.index(cam_name)
                break
            if idx is None and None in names:
                page, idx = pg, names.index(None)
            elif idx is None and len(names) < self.PAGE_CAP:
                page, idx = pg, len(names)
        if page is None:
            page = {"batcher": NativeBatcher(self.PAGE_CAP, shape,
                                             self._group_downsample(shape)),
                    "names": []}
            self._pages(shape).append(page)
            idx = 0
        names = page["names"]
        if idx == len(names):
            names.append(cam_name)
        else:
            names[idx] = cam_name
        page["batcher"].add_fd(idx, fd)
        return shape, idx

    def _free_slot(self, page: dict, idx: int):
        page["names"][idx] = None
        page["batcher"].remove(idx)

    def remove(self, cam_name: str):
        """Free the camera's slot (stop reader, reset seq) so it can be
        reused — the reference tolerates unlimited re-points
        (clearcam.py:255-268); so must we."""
        for pages in self.groups.values():
            for pg in pages:
                if cam_name in pg["names"]:
                    self._free_slot(pg, pg["names"].index(cam_name))

    def snapshot_all(self) -> dict[str, tuple]:
        """-> {cam_name: (frame_view, seq)} for every registered camera."""
        out = {}
        for pages in self.groups.values():
            for pg in pages:
                batch, seqs = pg["batcher"].snapshot()
                for i, name in enumerate(pg["names"]):
                    if name is not None:
                        out[name] = (batch[i], int(seqs[i]))
        return out

    def close(self):
        for pages in self.groups.values():
            for pg in pages:
                pg["batcher"].close()
        self.groups.clear()


@dataclass
class CamState:
    name: str
    src: str
    slot: FrameSlot = field(default_factory=FrameSlot)
    pump: FramePump | None = None
    source: object = None
    vod: bool = False
    counter: RollingClassCounter = None
    alerts: dict = field(default_factory=dict)
    settings: dict | None = None
    last_frame_num: int = -1
    last_frame: np.ndarray | None = None
    prev_frame: np.ndarray | None = None
    last_preds: np.ndarray = field(default_factory=lambda: np.zeros((0, 7)))
    object_set: set = field(default_factory=set)
    object_set_zone: set = field(default_factory=set)
    pred_occs: dict = field(default_factory=dict)
    start_time: float | None = None
    warmup: int = 0
    last_preview: float | None = None
    last_sync: float = 0.0
    last_live_check: float = 0.0
    last_live_seg: float = 0.0
    live_link: str | None = None
    alerts_on: bool = True
    native_key: tuple | None = None
    on_shared_pump: bool = False
    _obj_day: str = ""
    _obj_dir: Path | None = None
    last_infer_t: float = 0.0
    last_seq_seen: float = 0.0
    fps: float = 0.0
    _prev_t: float = field(default_factory=time.time)


class NVR:
    """Owns the cameras, the detector, and the KV-store sync loop."""

    def __init__(self, db, base_dir: Path, settings: GlobalSettings | None = None,
                 detector: BatchDetector | None = None, object_finder=None,
                 qwen=None, notifier=None, uploader=None,
                 classes: set | None = None, labels=None,
                 use_native_ingest: bool = True,
                 summary_slots: int | None = None, llm_mesh=None):
        self.db = db
        self.base_dir = Path(base_dir)
        (self.base_dir / "cameras").mkdir(parents=True, exist_ok=True)
        self.settings = settings or GlobalSettings()
        self.detector = detector
        self.object_finder = object_finder
        self.qwen = qwen
        self.qwen_prompt = ("What has been detected on my CCTV camera? "
                            "Write in one short sentence")
        self.notifier = notifier          # callable(userID, title, body)
        self.uploader = uploader          # callable(**kw) -> export_and_upload
        # CLEARCAM_SUMMARY_SLOTS=N (>0): serve alert summaries through the
        # continuous-batching engine — N cameras' summaries decode
        # concurrently from one cache instead of the single cooperative
        # generator (which a second alert would preempt)
        import os as _os
        self.summary_slots = summary_slots if summary_slots is not None \
            else int(_os.environ.get("CLEARCAM_SUMMARY_SLOTS", "0") or 0)
        # llm_mesh: a ("data", "model") parallel.mesh.Mesh; the summary
        # engine's language model tensor/expert-parallels over its "model"
        # axis (--mesh), rank 0 leading
        self.llm_mesh = llm_mesh
        self._summary_engine = None
        self._summaries: list[tuple] = []   # (request, cam_name, notify)
        self.executor = DeviceExecutor()
        # one cross-camera batched tracker (track/multicam.py): the per-camera
        # OCSort loop was the e2e ceiling at 32+ streams
        self.tracker = MultiCamOCSort(max_age=100)
        self.cams: dict[str, CamState] = {}
        self.classes = classes if classes is not None else set(DEFAULT_CLASSES)
        self.labels = labels or COCO_LABELS
        self.object_queue: list[Path] = []
        from .fswriter import AsyncFileWriter
        self.fswriter = AsyncFileWriter()
        self.shared_pump = None  # lazily created for non-blocking sources
        self._last_cam_check = 0.0
        self._initing: set[str] = set()   # hot-adds mid-init off-thread
        from collections import deque
        self._ready_inits = deque()       # (name, src, opened source)
        self.running = True
        self.native_ingest: NativeIngest | None = None
        if use_native_ingest:
            try:
                from .native_loader import load_lib
                if load_lib("ccingest") is not None:
                    import os as _os
                    self.native_ingest = NativeIngest(downsample=int(
                        _os.environ.get("CLEARCAM_INGEST_DOWNSAMPLE", "1")))
            except Exception:
                self.native_ingest = None
        self._native_frames: dict[str, tuple] = {}

    # -- camera lifecycle ---------------------------------------------------

    def cam_dir(self, name: str) -> Path:
        return self.base_dir / "cameras" / name

    def stream_day_dir(self, cam: CamState) -> Path:
        day = "video" if cam.vod else datetime.now().strftime("%Y-%m-%d")
        d = self.cam_dir(cam.name) / "streams" / day
        d.mkdir(parents=True, exist_ok=True)
        return d

    def init_cam(self, name: str, src: str, source=None):
        """Tick-thread only (tracker.reset_cam mutates the shared SoA the
        tick's update_all indexes into). ``source``: a pre-opened
        FrameSource from _init_cam_async's worker — the slow part."""
        cam = CamState(name=name, src=src, vod=str(src).endswith(VOD_SUFFIXES))
        self.tracker.reset_cam(name)   # fresh track ids, like a new OCSort
        cam.counter = RollingClassCounter(cam_name=name, window_seconds=float("inf"))
        alerts = self.db.run_get("alerts", name)
        if not alerts:
            import uuid as _uuid
            default = RollingClassCounter(window_seconds=None, max=1,
                                          classes={0, 1, 2, 3, 5, 7}, cam_name=name)
            aid = str(_uuid.uuid4())
            self.db.run_put("alerts", name, default, id=aid)
            alerts = {aid: default}
        if not isinstance(alerts, dict) or isinstance(alerts, RollingClassCounter):
            alerts = {"1": alerts}
        cam.alerts = alerts
        cam.start_time = time.time()
        record_dir = self.stream_day_dir(cam)
        cam.source = source if source is not None \
            else open_source(src, record_dir)
        if not cam.vod:
            from .ingest import FfmpegSource
            if (self.native_ingest is not None
                    and isinstance(cam.source, FfmpegSource)
                    and cam.source.pipe_proc is not None):
                # hand the rawvideo pipe to a native reader thread
                cam.native_key = self.native_ingest.register(
                    name, cam.source.pipe_proc.stdout.fileno(),
                    (cam.source.h, cam.source.w, 3))
                # start the stall clock NOW: a stream that is dead from
                # birth (camera offline at add time) must trip the 15 s
                # housekeeping restart — with last_seq_seen left 0.0 the
                # truthiness gate never fired and the camera stayed dead
                # until a process restart (reference respawns after 5
                # failed reads, clearcam.py:407-413)
                cam.last_seq_seen = time.time()
            elif isinstance(cam.source, SyntheticSource):
                # non-blocking sources share ONE pump thread (per-camera
                # Python threads convoy the GIL at 100+ cameras)
                if self.shared_pump is None:
                    from .ingest import SharedFramePump
                    self.shared_pump = SharedFramePump()
                self.shared_pump.add(name, cam.source, cam.slot)
                cam.on_shared_pump = True
            else:
                cam.pump = FramePump(name, cam.source, cam.slot)
                cam.pump.start()
        self.cams[name] = cam

    def remove_cam(self, name: str):
        cam = self.cams.pop(name, None)
        if cam and cam.on_shared_pump and self.shared_pump is not None:
            self.shared_pump.remove(name)
            try:
                cam.source.close()
            except Exception:  # noqa: BLE001
                pass
        if cam and cam.pump:
            cam.pump.stop()
        elif cam and cam.source is not None:
            try:
                cam.source.close()   # native-ingest cams: EOF stops the reader
            except Exception:
                pass
            if self.native_ingest is not None and getattr(cam, "native_key", None):
                self.native_ingest.remove(name)  # reclaim the batcher slot

    # sources whose construction is instant (no network / no subprocess):
    # initialize inline so tests and local cams stay deterministic
    _FAST_SRC = ("synthetic://",)

    def _init_cam_async(self, name: str, src: str):
        """Hot-add slow sources OFF the tick thread: an FfmpegSource spawn
        (resolution probe + playlist warmup) or an HTTP connect can take
        seconds — done inline it froze detection for EVERY camera per
        hot-add. ONLY open_source runs on the worker; everything that
        touches shared state (tracker.reset_cam's SoA swap, pump/native
        registration, the cams dict) is deferred to the tick thread via
        _ready_inits, so nothing races update_all."""
        if src.startswith(self._FAST_SRC) or str(src).endswith(VOD_SUFFIXES):
            try:
                self.init_cam(name, src)
            except Exception as e:  # noqa: BLE001
                print(f"init_cam {name} failed: {e}")
            return

        record_dir = self.cam_dir(name) / "streams" \
            / datetime.now().strftime("%Y-%m-%d")
        record_dir.mkdir(parents=True, exist_ok=True)

        def work():
            try:
                source = open_source(src, record_dir)
            except Exception as e:  # noqa: BLE001
                print(f"init_cam {name} failed: {e}")
                self._initing.discard(name)
                return
            self._ready_inits.append((name, src, source))

        self._initing.add(name)
        threading.Thread(target=work, daemon=True,
                         name=f"init-{name}").start()

    def _publish_ready_inits(self):
        """Tick thread: finish hot-adds whose slow source-open completed.
        Re-checks the links table so a camera removed or re-pointed while
        its source was opening is torn down instead of living as a zombie."""
        while self._ready_inits:
            name, src, source = self._ready_inits.popleft()
            self._initing.discard(name)
            link = self.db.run_get("links", name)
            if isinstance(link, list):
                link = link[0]
            if link != src or name in self.cams:
                try:
                    source.close()
                except Exception:  # noqa: BLE001
                    pass
                continue
            try:
                self.init_cam(name, src, source=source)
            except Exception as e:  # noqa: BLE001
                print(f"init_cam {name} failed: {e}")

    def refresh_cams(self):
        """Hot add / re-point from the links table (clearcam.py:255-268)."""
        links = self.db.run_get("links", None)
        for name, src in links.items():
            if not isinstance(src, str) or name in self._initing:
                continue
            if name not in self.cams:
                self._init_cam_async(name, src)
            elif self.cams[name].src != src:
                self.remove_cam(name)
                self._init_cam_async(name, src)
        for name in [n for n in self.cams if n not in links]:
            self.remove_cam(name)

    # -- per-tick pipeline ----------------------------------------------------

    def tick(self):
        now = time.time()
        self._publish_ready_inits()
        if now - self._last_cam_check >= 5:
            self._last_cam_check = now
            self.refresh_cams()

        if self.native_ingest is not None and self.native_ingest.groups:
            self._native_frames = self.native_ingest.snapshot_all()

        # gather fresh frames — per-camera isolation like every other
        # stage (a corrupt VOD read or a locked analysis_prog put must not
        # escape tick() and kill the whole loop)
        todo: list[CamState] = []
        frames: list[np.ndarray] = []
        for cam in list(self.cams.values()):
            try:
                frame, num = self._next_frame(cam)
                if frame is None:
                    continue
                if not self._should_infer(cam):
                    cam.last_preds = np.zeros((0, 7))
                    continue
                if cam.native_key is not None:
                    # the native view aliases the seqlock group buffer
                    # (rewritten next snapshot); copy only frames we KEEP —
                    # schedule/fps-capped cameras skip the ~6 MB memcpy
                    frame = frame.copy()
            except Exception as e:  # noqa: BLE001
                print(f"frame gather error {cam.name}: {e}")
                metrics.count("gather_errors")
                continue
            cam.prev_frame = cam.last_frame
            cam.last_frame = frame
            cam.last_frame_num = num
            todo.append(cam)
            frames.append(frame)

        # one batched device call per resolution bucket; errors are isolated
        # so one bad frame/camera can't kill the loop (reference reopens the
        # stream on process_frame errors, clearcam.py:543-546)
        if todo and self.detector is not None:
            metrics.gauge("batch_size", len(todo))
            try:
                with metrics.timer("detect_step"):
                    all_preds = self.detector.detect_many(frames)
            except Exception as e:  # noqa: BLE001
                print(f"detect error: {e}")
                metrics.count("detect_errors")
                all_preds = [np.zeros((0, 6)) for _ in todo]
            with metrics.timer("track_step"):
                det_map = {c.name: p for c, p in zip(todo, all_preds)}
                thr_map = {
                    c.name: (c.settings.get("threshold")
                             if c.settings and c.settings.get("threshold")
                             else 0.5)
                    for c in todo}
                try:
                    tracks_map = self.tracker.update_all(det_map, thr_map)
                except Exception as e:  # noqa: BLE001
                    print(f"tracker error: {e}")
                    metrics.count("tracker_errors")
                    tracks_map = {c.name: [] for c in todo}
                for cam in todo:
                    try:
                        cam.last_preds = self._postprocess(
                            cam, tracks_map[cam.name])
                    except Exception as e:  # noqa: BLE001
                        print(f"postprocess error {cam.name}: {e}")
                        metrics.count("postprocess_errors")
                        continue
                    t = time.time()
                    cam.fps = 1.0 / max(t - cam._prev_t, 1e-6)
                    cam._prev_t = t
                    metrics.gauge(f"fps.{cam.name}", round(cam.fps, 2))
            metrics.count("frames", len(todo))

        for cam in list(self.cams.values()):
            try:
                self._housekeeping(cam)
            except Exception as e:  # noqa: BLE001
                print(f"housekeeping error {cam.name}: {e}")

        # shared-device queued work (search/embed requests from HTTP threads)
        self.executor.drain_one()
        self._drain_object_queue()
        if getattr(self, "_pending_summary", None) is not None:
            with metrics.timer("summary_step"):
                self._advance_summary()
        if self._summaries or (self._summary_engine is not None
                               and self._summary_engine.has_work()):
            # external /generate requests share the engine, so step it
            # whenever it has work — not only while summaries are pending
            with metrics.timer("summary_step"):
                self._advance_summary_engine()

    def _next_frame(self, cam: CamState):
        if cam.vod:
            frame = cam.source.read()
            if frame is None:
                prog = self.db.run_get("analysis_prog", cam.name)
                if not (isinstance(prog, dict) and "Processing" in prog):
                    self.db.run_put("analysis_prog", cam.name, {"Tracking": 100})
                return None, -1
            self.db.run_put("analysis_prog", cam.name,
                            {"Tracking": cam.source.progress() or 0.0})
            return frame, cam.last_frame_num + 1
        if cam.native_key is not None:
            got = self._native_frames.get(cam.name)
            if got is None:
                return None, -1
            frame, seq = got
            if seq < 0 or seq == cam.last_frame_num:
                return None, -1
            cam.last_seq_seen = time.time()
            # VIEW into the seqlock group buffer (rewritten by the next
            # snapshot): tick() copies it only after _should_infer passes
            return frame, seq
        frame, num = cam.slot.snapshot()
        if frame is None or num == cam.last_frame_num:
            return None, -1
        return frame, num

    def _should_infer(self, cam: CamState) -> bool:
        """Skip inference when no alert schedule is active (clearcam.py:447)
        or a per-camera detect_fps cap hasn't elapsed (scale knob: quiet
        cameras can run detection below their ingest rate)."""
        # wall-clock cap is meaningless for VOD (analysis runs much faster
        # than real time — a cap would silently drop most of the video)
        cap = (cam.settings.get("detect_fps")
               if cam.settings and not cam.vod else None)
        if cap:
            now = time.time()
            if now - cam.last_infer_t < 1.0 / float(cap):
                return False
        if not cam.alerts:
            # reference semantics: any() over an empty alert dict is False
            # (clearcam.py:447) — deleting every alert PAUSES detection
            # for the camera instead of burning device/disk on it forever
            return False
        active = any(a.is_active(alerts_enabled=cam.alerts_on)
                     for a in cam.alerts.values())
        if not active:
            return False
        if self.settings.userID and not cam.alerts_on:
            return False
        self._mark_infer(cam, cap)
        return True

    @staticmethod
    def _mark_infer(cam: CamState, cap):
        if cap:
            cam.last_infer_t = time.time()

    def _postprocess(self, cam: CamState, tracks: list) -> np.ndarray:
        """Track filters + counters (reference run_inference,
        clearcam.py:580-623); tracks come from the shared cross-camera
        tracker. Returns rows [x1,y1,x2,y2,score,cls,track_id]."""
        tracks = [t for t in tracks
                  if self.classes is None or str(int(t.class_id)) in self.classes]
        out = []
        h, w = cam.last_frame.shape[:2]
        # crop-save throttling runs on media time for VOD (analysis is much
        # faster than real time) and wall time for live streams
        now = cam.source.position_seconds() if (
            cam.vod and isinstance(cam.source, OpenCVSource)) else time.time()
        # window-full state per alert, refreshed only when a track adds to it
        # (get_counts per track per alert dominated _postprocess at 128 cams)
        alerts_full = {id(a): a.get_counts()[1] for a in cam.alerts.values()}
        for t in tracks:
            if t.tracklet_len < 1:
                continue
            # crop saving (throttled), regardless of speed
            occ = cam.pred_occs.setdefault(t.track_id, [now])
            if ((len(occ) < MAX_CROPS_PER_TRACK and now - occ[-1] > 1)
                    or now - occ[-1] > 10):
                occ.append(now)
                self._save_object(cam, t)
            if t.speed < MIN_TRACK_SPEED:
                continue
            outside = False
            if cam.settings and cam.settings.get("coords"):
                outside = box_outside_zone(
                    t.tlbr, np.asarray(cam.settings["coords"]), (h, w),
                    invert=bool(cam.settings.get("outside") or False))
            if outside and not any(not a.zone for a in cam.alerts.values()):
                continue
            out.append([*t.tlbr, t.score, t.class_id, t.track_id])
            new = int(t.track_id) not in cam.object_set
            new_in_zone = (int(t.track_id) not in cam.object_set_zone
                           and not outside)
            if new:
                cam.object_set.add(int(t.track_id))
                cam.counter.add(int(t.class_id))
            if new_in_zone:
                cam.object_set_zone.add(int(t.track_id))
            for alert in cam.alerts.values():
                if alerts_full[id(alert)]:
                    continue
                if (new and not alert.zone) or (new_in_zone and alert.zone):
                    alert.add(int(t.class_id))
                    alerts_full[id(alert)] = alert.get_counts()[1]
        return np.array(out).reshape(-1, 7)

    def _save_object(self, cam: CamState, t):
        """Crop save with even-size expansion + min-side gate
        (clearcam.py:373-399)."""
        if self.fswriter.q.full():
            return          # writer saturated: skip before building paths
        day = "video" if cam.vod else datetime.now().strftime("%Y-%m-%d")
        if cam._obj_day != day:     # per-(cam, day) dir cache — at 128 cams
            cam._obj_day = day      # Path construction was a real tick cost
            cam._obj_dir = self.cam_dir(cam.name) / "objects" / day
        obj_dir = cam._obj_dir
        x1, y1, x2, y2 = map(int, t.tlbr)
        cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
        hw, hh = ((x2 - x1) // 2) * 2, ((y2 - y1) // 2) * 2
        H, W = cam.last_frame.shape[:2]
        x1n, x2n = max(0, cx - hw), min(W, cx + hw)
        y1n, y2n = max(0, cy - hh), min(H, cy + hh)
        if (y2n - y1n) < MIN_CROP_SIDE or (x2n - x1n) < MIN_CROP_SIDE:
            return
        ts = self._event_ts(cam)
        path = obj_dir / f"{ts}_{int(t.track_id)}_{int(t.class_id)}.jpg"
        # copy the crop (last_frame may be a reused ingest buffer) and hand
        # it to the async writer: jpeg encode + fs metadata (~ms each) must
        # not stall a tick serving every camera
        crop = cam.last_frame[y1n:y2n, x1n:x2n].copy()
        then = (self.object_queue.append
                if self.settings.use_clip or self.settings.use_face else None)
        self.fswriter.submit(path, crop, then=then)

    def _event_ts(self, cam: CamState) -> float:
        if cam.vod and isinstance(cam.source, OpenCVSource):
            return round(cam.source.position_seconds() - 5, 1)
        return round(time.time() - (cam.start_time or time.time()) - 5, 1)

    # -- periodic housekeeping ------------------------------------------------

    def _housekeeping(self, cam: CamState):
        now = time.time()
        cam.warmup += 1
        if cam.warmup <= 10:
            return
        # prune crop-throttle state of tracks idle >1h (the reference's
        # pred_occs only resets at the daily restart, clearcam.py:237).
        # Live cams only: VOD occurrences are in media time, not wall time.
        if not cam.vod and now - getattr(cam, "_occ_pruned", 0.0) > 600:
            cam._occ_pruned = now
            for tid in [t for t, occ in cam.pred_occs.items()
                        if now - occ[-1] > 3600]:
                del cam.pred_occs[tid]
        # hourly preview snapshot (clearcam.py:466-469)
        if cam.last_frame is not None and (
                cam.last_preview is None or now - cam.last_preview >= 3600):
            cam.last_preview = now
            try:
                import cv2
                cv2.imwrite(str(self.cam_dir(cam.name) / "preview.png"),
                            cam.last_frame)
            except Exception:
                pass
        self._fire_alerts(cam)
        if now - cam.last_sync >= 5:
            cam.last_sync = now
            self._sync_kv(cam)
        if (cam.native_key is not None and cam.last_seq_seen
                and now - cam.last_seq_seen > 15):
            # native reader stalled (stream died): respawn the camera
            print(f"{cam.name}: ingest stalled, restarting stream")
            src = cam.src
            self.remove_cam(cam.name)
            self._init_cam_async(cam.name, src)   # spawn is seconds-long
            return
        if now - cam.last_live_check >= 5:
            cam.last_live_check = now
            link = self.db.run_get("links", cam.name)
            if isinstance(link, list):
                link = link[0]
            if isinstance(link, str) and link != cam.src:
                self.remove_cam(cam.name)
                self._init_cam_async(cam.name, link)
                return
            if self.settings.userID and not cam.vod:
                threading.Thread(target=self._check_live_link, args=(cam,),
                                 daemon=True).start()
        if (self.settings.userID and not cam.vod and cam.live_link
                and now - cam.last_live_seg >= 4):
            cam.last_live_seg = now
            from ..cloud import relay
            threading.Thread(
                target=relay.upload_live_segment,
                args=(self.stream_day_dir(cam), cam.live_link, self.settings.key),
                daemon=True).start()

    def _check_live_link(self, cam: CamState):
        from ..cloud import relay
        link, alerts_on = relay.check_upload_link(cam.name, self.settings.userID)
        cam.live_link = link
        if alerts_on is not None:
            cam.alerts_on = alerts_on

    def _fire_alerts(self, cam: CamState):
        """Window-max alert trigger: annotated snapshot, push notification,
        optional Qwen summary, encrypted clip upload (clearcam.py:470-499)."""
        now = time.time()
        for alert in cam.alerts.values():
            if alert.desc is not None:
                continue  # description alerts fire from the CLIP embed path
            if not alert.is_active(alerts_enabled=cam.alerts_on):
                alert.reset_counts()
                continue
            window = alert._window()
            if not alert.get_counts()[1]:
                continue
            if now - alert.last_det < window:
                continue
            day = "video" if cam.vod else datetime.now().strftime("%Y-%m-%d")
            img_dir = self.cam_dir(cam.name) / "event_images" / day
            img_dir.mkdir(parents=True, exist_ok=True)
            ts = int(self._event_ts(cam))
            annotated = draw_predictions(cam.last_frame.copy(), cam.last_preds,
                                         self.labels)
            fname = img_dir / (f"{ts}_notif.jpg" if alert.is_notif else f"{ts}.jpg")
            if not cam.vod:
                try:
                    import cv2
                    cv2.imwrite(str(fname), annotated,
                                [cv2.IMWRITE_JPEG_QUALITY, 85])
                except Exception:
                    pass
            plain = img_dir / f"{ts}.jpg"
            if plain.exists() and (img_dir / f"{ts}_notif.jpg").exists():
                plain.unlink()
                fname = img_dir / f"{ts}_notif.jpg"
            if self.settings.userID and not cam.vod and alert.is_notif:
                self._notify_and_upload(cam, fname, ts)
            alert.last_det = now

    def summary_engine(self):
        """The continuous-batching Qwen engine (lazily built; summary_slots
        must be > 0). Shared by alert summaries and POST /generate — both
        kinds of request interleave in the same decode batch, driven by
        the NVR tick (single-device-consumer discipline)."""
        assert self.summary_slots > 0 and self.qwen is not None
        if self._summary_engine is None:
            from ..serving.vlm import VLMServingEngine
            lock = contextlib.nullcontext()
            if self.llm_mesh is not None:
                # the followers' object registered as "nvr" builds the same
                # engine on their ranks (__main__'s follower), before this
                # rank builds its own under the channel's lock (the engine
                # makes its groups, collectives every rank makes in order)
                lock = self.llm_mesh.channel.lock
            with lock:
                if self.llm_mesh is not None:
                    self.llm_mesh.channel.send("nvr", "summary_engine",
                                               self.summary_slots)
                # bf16 KV: the slots' cache is additional to the solo
                # qwen state — half the bytes, serving-grade numerics
                # max_restarts: a transient engine crash (one poisoned
                # request, a device hiccup) resets slot state and requeues
                # unstarted summaries instead of killing summaries for the
                # rest of the NVR's life (serving.engine._recover), a fault
                # inside a step under llm_mesh too
                self._summary_engine = VLMServingEngine(
                    self.qwen, n_slots=self.summary_slots,
                    state_dtype=torch.bfloat16, mesh=self.llm_mesh,
                    max_restarts=int(os.environ.get(
                        "CLEARCAM_SERVING_RESTARTS", "3")))
        return self._summary_engine

    def _notify_and_upload(self, cam: CamState, thumbnail: Path, ts: float):
        notify = self.notifier
        if notify is None:
            from ..cloud.relay import send_notif as notify  # noqa: N813
        threading.Thread(target=notify,
                         args=(self.settings.userID,
                               f"Event Detected ({cam.name})", None),
                         daemon=True).start()
        if self.settings.use_qwen and self.qwen is not None:
            if self.summary_slots > 0:
                # continuous-batching mode: every alerting camera gets its
                # own slot; decode interleaves all summaries (serving/vlm)
                frames = []
                if cam.prev_frame is not None:
                    frames.append(cam.prev_frame[..., ::-1])
                frames.append(cam.last_frame[..., ::-1])
                eng = self.summary_engine()
                # JSON-constrained summaries (CLEARCAM_SUMMARY_JSON) carry
                # structure overhead — give them headroom to close the
                # object before max_new truncates
                req = eng.submit(frames, self.qwen_prompt,
                                 max_new=96 if eng.json_summaries else 60)
                self._summaries.append((req, cam.name, notify))
            else:
                # cooperative summary: a few decode steps per tick so the
                # detect loop keeps running (the reference blocks it,
                # clearcam.py:494-496)
                self._pending_summary = {
                    "cam": cam.name, "notify": notify,
                    "gen": self._summary_steps(cam), "tokens": []}
        upload = self.uploader
        if upload is None:
            from ..cloud.relay import export_and_upload as upload  # noqa: N813
        threading.Thread(target=upload, kwargs=dict(
            cam_name=cam.name, thumbnail=thumbnail, userID=self.settings.userID,
            key=self.settings.key, base_dir=self.base_dir, start=ts, wait=True),
            daemon=True).start()

    def _summary_steps(self, cam: CamState):
        """Generator yielding one Qwen token per step (images fed first)."""
        if cam.prev_frame is not None:
            self.qwen.feed_image(cam.prev_frame[..., ::-1], reset=True)
            yield None
        self.qwen.feed_image(cam.last_frame[..., ::-1],
                             reset=cam.prev_frame is None)
        yield None
        toks = self.qwen.tok.encode("<|im_start|>user\n" + self.qwen_prompt
                                    + "<|im_end|>\n<|im_start|>assistant\n")
        produced = 0
        for t in self.qwen.lang.generate(toks, temperature=0.7,
                                         cache_offset=self.qwen.start_pos,
                                         max_new=60):
            if self.qwen.tok.is_end(t):
                break
            produced += 1
            yield t
        self.qwen.start_pos += len(toks) + produced

    def _advance_summary(self, steps: int = 4):
        """Run up to `steps` summary tokens this tick; send the notification
        when generation completes."""
        pending = getattr(self, "_pending_summary", None)
        if pending is None:
            return
        try:
            for _ in range(steps):
                tok = next(pending["gen"])
                if tok is not None:
                    pending["tokens"].append(tok)
        except StopIteration:
            text = self.qwen.tok.decode(pending["tokens"]) if pending["tokens"] else ""
            threading.Thread(target=pending["notify"],
                             args=(self.settings.userID,
                                   f"AI Summary ({pending['cam']}):", text),
                             daemon=True).start()
            self._pending_summary = None
        except Exception as e:  # noqa: BLE001
            print(f"qwen summary failed: {e}")
            self._pending_summary = None

    def _advance_summary_engine(self, steps: int = 4):
        """Engine-mode summaries: run a few scheduler ticks on the main
        thread (same single-device-consumer discipline as the cooperative
        path — decode shares the chip with detection at tick granularity),
        then flush any finished requests as notifications."""
        eng = self._summary_engine
        try:
            for _ in range(steps):
                if not eng.step():
                    break
            done = [s for s in self._summaries if s[0].done]
            for entry in done:
                req, cam_name, notify = entry
                self._summaries.remove(entry)
                threading.Thread(
                    target=notify,
                    args=(self.settings.userID, f"AI Summary ({cam_name}):",
                          eng.text(req)),
                    daemon=True).start()
        except Exception as e:  # noqa: BLE001
            print(f"qwen summary failed: {e}")
            self._summaries.clear()

    def _sync_kv(self, cam: CamState):
        """5-second KV sync: counters out, alert edits in (clearcam.py:509-536)."""
        counters = self.db.run_get("counters", cam.name)
        if counters not in (None, {}) and getattr(counters, "reset", False):
            cam.counter.reset_counts()
            cam.counter.reset = False
        self.db.run_put("counters", cam.name, cam.counter)

        alerts = self.db.run_get("alerts", cam.name)
        if not isinstance(alerts, dict) or isinstance(alerts, RollingClassCounter):
            alerts = {"1": alerts} if alerts else {}
        for aid, a in alerts.items():
            if a is None or not getattr(a, "new", False):
                continue
            a.new = False
            self.db.run_put("alerts", cam.name, a, id=aid)
            cam.alerts[aid] = a
            if a.classes:
                for c in a.classes:
                    self.classes.add(str(c))
        cam.alerts = {i: a for i, a in cam.alerts.items() if i in alerts}

        new_settings = self.db.run_get("settings", cam.name)
        if new_settings == {}:
            new_settings = None
        if (cam.settings is not None and new_settings != cam.settings and cam.vod):
            self._reset_vod(cam)
            if isinstance(new_settings, dict) and "reset" in new_settings:
                new_settings = {k: v for k, v in new_settings.items() if k != "reset"}
        cam.settings = new_settings

    def _reset_vod(self, cam: CamState):
        """Settings changed on a VOD camera: re-analyze from scratch
        (clearcam.py:574-578)."""
        import shutil
        cam.source.close()
        cam.source = OpenCVSource(cam.src)
        self.tracker.reset_cam(cam.name)
        # fresh track ids restart at 1: every per-camera novelty/throttle
        # structure keyed by track id must reset with them, or the stale
        # entries swallow the whole re-analysis (ids already "seen" ->
        # counters/alerts never fire; old media-time occurrences -> crop
        # saves never trigger)
        cam.object_set = set()
        cam.object_set_zone = set()
        cam.pred_occs = {}
        cam.last_frame_num = -1
        for sub in ("objects", "faces", "event_images"):
            shutil.rmtree(self.cam_dir(cam.name) / sub, ignore_errors=True)

    # -- CLIP/face embedding of saved crops ------------------------------------

    CROP_BATCH = 16

    def _drain_object_queue(self):
        """Embed up to CROP_BATCH saved crops in ONE batched device call per
        tick (the reference embeds one crop per loop iteration,
        clearcam.py:272-279)."""
        if not self.object_queue or self.object_finder is None:
            return
        import cv2
        batch_paths, batch_imgs = [], []
        while self.object_queue and len(batch_paths) < self.CROP_BATCH:
            path = self.object_queue.pop(0)
            try:
                img = cv2.imread(str(path))
            except Exception:
                img = None
            if img is None:
                continue
            batch_paths.append(path)
            batch_imgs.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        if not batch_paths:
            return
        try:
            self.object_finder.ingest_crops(batch_paths, batch_imgs, nvr=self)
        except Exception as e:  # noqa: BLE001
            print(f"object queue error: {e}")

    # -- loop -------------------------------------------------------------------

    def run(self, max_ticks: int | None = None, tick_sleep: float = 0.0):
        links = self.db.run_get("links", None)
        for name, src in links.items():
            if isinstance(src, str):
                try:
                    self.init_cam(name, src)
                except Exception as e:  # noqa: BLE001
                    print(f"init_cam {name} failed: {e}")
        n = 0
        self.executor.loop_running = True
        try:
            while self.running and (max_ticks is None or n < max_ticks):
                self.tick()
                n += 1
                if tick_sleep:
                    time.sleep(tick_sleep)
        finally:
            self.executor.shutdown()
            self.fswriter.flush()  # bounded runs: crops on disk on return

    def stop(self):
        self.running = False
        for name in list(self.cams):
            self.remove_cam(name)
        if self.native_ingest is not None:
            self.native_ingest.close()
        if self.shared_pump is not None:
            self.shared_pump.stop()
        self.fswriter.stop()
