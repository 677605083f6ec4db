"""HTTP API + web UI server (:8080).

Endpoint-for-endpoint mirror of the reference public surface
(clearcam.py:680-1156) — the browsers and the iOS/Android apps are the
clients, so routes, params and response shapes must match:

GET  /set_max_storage /get_global_settings /get_max_storage /list_cameras
     /list_days /add_camera /edit_settings /edit_alert /get_settings
     /get_alerts /delete_camera /get_counts /reset_counts
     /delete_day /download_day   (per-day cleanup + one-mp4 day export)
     /                      -> mainview.html
     /?cam=<name>           -> cameraview.html (templated)
     /<cam>/streams/...     -> HLS playlists/segments/images (VOD rewrite)
POST /edit_settings (global, secret-preserving)  /analyse-footage (chunked
     upload)  /event_thumbs (gallery + CLIP text/image/similar/face search)

New (reference only has the iOS client side, Yolo.m:269-302,363-403):
POST /yolo  — raw RGB frame bytes -> float32 [x1,y1,x2,y2,conf,cls]*N
POST /diff  — sparse (int32 idx, u8 val) patches vs the per-session frame,
              session affinity via x-session-id.

Design: a plain routing table on a ThreadingHTTPServer; all device work is
forwarded to the NVR's DeviceExecutor so HTTP threads never touch the TPU.
"""
from __future__ import annotations

import base64
import json
import os
import queue
import re
import shutil
import threading
import time
import uuid
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np

from ..runtime.counters import RollingClassCounter
from ..runtime.settings import GlobalSettings
from ..utils.labels import COCO_LABELS

SCORE_CUTOFF = 0.21  # search result floor (clearcam.py:689)
WEB_DIR = Path(__file__).parent / "web"
DATE_RE = re.compile(r"^\d{4}-\d{2}-\d{2}$")

# the reference loads hls.js from a CDN (mainview.html:2841) — egress-gated.
# Air-gapped deployments drop a copy at one of these paths and the server
# rewrites the pages' script tag to the locally served /hls.js.
_HLS_CDN_TAG = "https://cdn.jsdelivr.net/npm/hls.js@1"


def vendored_hls_path() -> Path | None:
    """Locally vendored hls.js, if the deployment provides one."""
    env = os.environ.get("CLEARCAM_HLSJS")
    cands = ([Path(env)] if env else []) + [
        WEB_DIR / "vendor" / "hls.js", Path("weights") / "hls.js"]
    for p in cands:
        if p.is_file():
            return p
    return None


def safe_cam_name(name: str | None) -> str | None:
    """Reject camera names that could escape the cameras dir (path traversal
    via /add_camera + /delete_camera): no separators, no dot-dirs, non-empty."""
    if (not name or "/" in name or "\\" in name or "\x00" in name
            or name in (".", "..")):
        return None
    return name


class OffloadSessions:
    """Per-session last-frame store for the /diff sparse protocol.

    LRU-capped: each full frame is ~1.2 MB and sessions are minted per
    x-session-id (or per request when the header is absent), so an uncapped
    dict is a memory leak under repeated /yolo POSTs."""

    MAX_SESSIONS = 64

    def __init__(self, res: int = 640):
        self.res = res
        self.frames: dict[str, np.ndarray] = {}  # insertion order = LRU order
        self.lock = threading.Lock()

    def full(self, sid: str, body: bytes) -> np.ndarray:
        frame = np.frombuffer(body, np.uint8).copy()
        with self.lock:
            self.frames.pop(sid, None)
            self.frames[sid] = frame
            while len(self.frames) > self.MAX_SESSIONS:
                self.frames.pop(next(iter(self.frames)))
        return frame

    def patch(self, sid: str, body: bytes) -> np.ndarray | None:
        with self.lock:
            frame = self.frames.get(sid)
            if frame is None:
                return None
            self.frames.pop(sid)
            self.frames[sid] = frame  # refresh LRU position
            n = len(body) // 5
            rec = np.frombuffer(body[: n * 5], np.uint8).reshape(n, 5)
            idx = rec[:, :4].copy().view("<i4").reshape(-1)
            frame[idx] = rec[:, 4]
            return frame


class OffloadBatcher:
    """Coalesce concurrent offload inferences into ONE batched device call.

    The reference serves one phone per request (Yolo.m posts a frame, waits);
    here many edge clients share one chip, and the DeviceExecutor drains one
    task per NVR tick — without batching, k concurrent /yolo requests take k
    ticks. Snapshot-at-execution: the first arrival enqueues a batch task;
    every request that lands before the device actually picks it up rides
    the same detect_many call (natural batching under load, zero added
    latency when idle)."""

    def __init__(self, detect_many):
        self.detect_many = detect_many          # callable(list[img]) -> list[rows]
        self.pending: list = []                 # (img, result_queue)
        self.lock = threading.Lock()
        self.leader_active = False

    def _run_batch(self):
        with self.lock:
            batch = list(self.pending)
            self.pending.clear()
            self.leader_active = False
        if not batch:
            return 0
        try:
            rows = list(self.detect_many([b[0] for b in batch]))
            if len(rows) != len(batch):   # malformed result must not strand
                raise RuntimeError(       # waiters past len(rows) in q.get()
                    f"detect_many returned {len(rows)} results "
                    f"for {len(batch)} frames")
            err = None
        except Exception as e:  # noqa: BLE001 — broadcast to every waiter
            rows, err = None, e
        for i, (_, bq) in enumerate(batch):
            bq.put(err if err is not None else rows[i])
        return len(batch)

    def infer(self, img, submit):
        """Called from HTTP threads; `submit` routes the batch task onto the
        device executor (or runs inline when no NVR loop is running)."""
        q: queue.Queue = queue.Queue(maxsize=1)
        with self.lock:
            self.pending.append((img, q))
            lead = not self.leader_active
            if lead:
                self.leader_active = True
        if lead:
            try:
                submit(self._run_batch)
            except Exception:  # executor dead: run the batch on this thread
                self._run_batch()
        out = q.get()
        if isinstance(out, Exception):
            raise out
        return out


class AppContext:
    """Shared state between the HTTP handler, the NVR loop and models."""

    def __init__(self, db, base_dir: Path, nvr=None, object_finder=None,
                 settings: GlobalSettings | None = None, max_gb: float = 256.0,
                 labels=None, offload_detect=None, offload_detect_many=None,
                 on_settings_change=None, api_token: str | None = None,
                 gen=None, served_model: str = "clearcam-llm"):
        # model id reported by the OpenAI-compatible surface (/v1/models,
        # completion objects) — the GGUF basename in tools/serve_llm.py
        self.served_model = served_model
        # optional shared-secret auth (beyond the reference, which serves an
        # unauthenticated API): when set, every request must carry the token
        # in an x-api-token header or ?token= query parameter
        self.api_token = api_token
        self.db = db
        self.base_dir = Path(base_dir)
        self.nvr = nvr
        self.object_finder = object_finder
        self.settings = settings or GlobalSettings()
        self.labels = labels or COCO_LABELS
        self.offload = OffloadSessions()
        from ..cloud.federation import FederationRegistry
        self.federation = FederationRegistry()
        self.offload_detect = offload_detect  # callable(frame_hw3_rgb) -> rows
        # batched variant: concurrent offload clients share one device call
        self.offload_batcher = (OffloadBatcher(offload_detect_many)
                                if offload_detect_many is not None else None)
        # LLM text serving for POST /generate: a serving.TextServing, or a
        # zero-arg factory for one (lazy — the NVR builds its summary
        # engine on first use)
        self._gen = gen
        self.on_settings_change = on_settings_change
        stored = db.run_get("max_storage", None)
        if stored == {}:
            db.run_put("max_storage", "all", max_gb)
            stored = {"all": max_gb}
        self.max_gb = stored["all"]

    @property
    def text_gen(self):
        """Resolve the /generate backend (factory called once, cached)."""
        if callable(self._gen) and not hasattr(self._gen, "submit"):
            made = self._gen()
            if made is None:      # not configured yet — keep the factory
                return None       # (qwen may arrive via /edit_settings)
            self._gen = made
        return self._gen

    # device work goes through the NVR executor when it exists
    def submit(self, fn, *args):
        if self.nvr is not None:
            return self.nvr.executor.submit(fn, *args)
        return fn(*args)


def _samp_at(samp: dict, i: int) -> dict:
    """Per-choice sampling kwargs: fold the choice index into a seeded
    request's seed so n>1 + seed yields n DISTINCT (but individually
    reproducible) samples instead of n bit-identical ones."""
    if i and "seed" in samp:
        return {**samp, "seed": samp["seed"] + i}
    return samp


_TOOL_TAG = "<tool_call>"


def _tool_visible_len(s: str) -> int:
    """Streaming with tools: chars of ``s`` safe to emit as content — up
    to the first <tool_call> tag, also holding back any TAIL that could
    be the start of one (so a tag split across poll boundaries never
    leaks its prefix into the content stream)."""
    i = s.find(_TOOL_TAG)
    if i >= 0:
        return i
    for k in range(min(len(_TOOL_TAG) - 1, len(s)), 0, -1):
        if s.endswith(_TOOL_TAG[:k]):
            return len(s) - k
    return len(s)


def _resolve_constraint(gen, rft, schema=None, choice_opts=None):
    """Map an OpenAI response-format request to an engine constraint name
    (grammar-constrained decoding, serving/constrain.py); registers
    runtime grammars (json_schema / guided_choice) into the engine's
    reserved table rows on first use, cached by content hash. Returns
    None for text/absent formats; raises ValueError for anything
    unsupported or unavailable (callers map to HTTP 400)."""
    import hashlib

    from ..serving import constrain as _con
    if choice_opts:
        # full digest: names are internal, and truncation would let two
        # different option lists silently share a grammar on collision
        key = "choice:" + hashlib.sha256(
            json.dumps(choice_opts).encode()).hexdigest()
        if key not in gen.engine._cstarts:
            gen.engine.register_constraint(
                key, _con.choice_token_constraint(
                    gen.tok, gen.engine.cfg.vocab_size,
                    [str(o) for o in choice_opts]))
        return key
    if rft in (None, "text"):
        return None
    if rft in ("json_object", "json"):
        if "json" not in gen.engine._cstarts:
            raise ValueError(
                "response_format json_object unavailable: engine built "
                "without a json constraint")
        return "json"
    if rft == "json_schema":
        if not isinstance(schema, dict):
            raise ValueError("json_schema needs a schema object")
        key = "schema:" + hashlib.sha256(json.dumps(
            schema, sort_keys=True).encode()).hexdigest()
        if key not in gen.engine._cstarts:
            gen.engine.register_constraint(
                key, _con.schema_token_constraint(
                    gen.tok, gen.engine.cfg.vocab_size, schema))
        return key
    raise ValueError(f"unsupported response_format type {rft!r}")


def _submit_retrying(do_submit, re_resolve, tries=4):
    """Submit, absorbing the register→submit LRU-eviction race: a grammar
    registered by _resolve_constraint can be evicted by a concurrent
    register_constraint before this request's submit lands (it is not yet
    pinned by _cinflight). The engine fails that cleanly with a 'was
    evicted' ValueError — an internal re-register protocol an OpenAI
    client should never see — so re-resolve (content-hash cache miss
    re-registers the grammar) and resubmit."""
    for _ in range(tries - 1):
        try:
            return do_submit()
        except ValueError as e:
            if "was evicted" not in str(e):
                raise
            re_resolve()
    return do_submit()


def _samp_of(data: dict) -> dict:
    """Sampling kwargs for ServingEngine.submit from a /generate or
    OpenAI-style JSON body (absent fields = feature off). logit_bias
    arrives with string token-id keys per the OpenAI schema."""
    out = {"top_p": float(data.get("top_p", 1.0)),
           "top_k": int(data.get("top_k", 0)),
           "min_p": float(data.get("min_p", 0.0)),
           "presence_penalty": float(data.get("presence_penalty", 0.0)),
           "frequency_penalty": float(data.get("frequency_penalty", 0.0)),
           "repetition_penalty": float(data.get("repetition_penalty", 1.0))}
    lb = data.get("logit_bias")
    if lb:
        out["logit_bias"] = {int(k): float(v) for k, v in lb.items()}
    return out


def event_img_info(stem: str) -> dict:
    """Parse `<ts>_<object>_<class>` crop names (clearcam.py:1193)."""
    parts = stem.split("_")
    return {"ts": int(float(parts[0])),
            "object_id": int(parts[1]) if len(parts) > 1 else None,
            "class_id": int(parts[2]) if len(parts) > 2 else None}


# the trace track of the program's spans: a thread id no OS thread has
SPAN_TRACK = 2 ** 31 - 1


def add_program_spans(trace_path: Path, t0: float, t1: float, wall_minus_perf_ns: int):
    """Add the program's spans that began in [t0, t1) (``time.perf_counter``
    seconds) to the Chrome trace at ``trace_path``, on its time base: the
    profiler's wall-clock microseconds from ``baseTimeNanoseconds``, the
    spans' perf_counter shifted by ``wall_minus_perf_ns``. One track,
    "program spans", in this process."""
    from ..runtime import metrics
    trace = json.loads(trace_path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_TRACK,
               "args": {"name": "program spans"}}]
    for sp in metrics.spans(None, t0, t1):
        start_ns = round(sp.start_s * 1e9) + wall_minus_perf_ns
        events.append({
            "ph": "X", "cat": "program_span", "name": sp.name, "pid": pid,
            "tid": SPAN_TRACK, "ts": (start_ns - base) / 1e3,
            "dur": (sp.end_s - sp.start_s) * 1e6,
            "args": {"ident": sp.ident, "parent": sp.parent, "sid": sp.sid,
                     "attr": None if sp.attr is None else str(sp.attr)}})
    trace.setdefault("traceEvents", []).extend(events)
    trace_path.write_text(json.dumps(trace))


def make_handler(ctx: AppContext):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # silenced like the reference (clearcam.py:684)
            pass

        # -- helpers -----------------------------------------------------
        def _json(self, body, status=200):
            data = json.dumps(body).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _html(self, text: str):
            data = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _q(self, query, name, default=None):
            return query.get(name, [default])[0]

        def _cameras_dir(self) -> Path:
            return ctx.base_dir / "cameras"

        # -- GET -----------------------------------------------------------
        def _authorized(self) -> bool:
            if not ctx.api_token:
                return True
            import hmac
            q = parse_qs(urlparse(self.path).query)
            auth = self.headers.get("Authorization", "")
            supplied = self.headers.get("x-api-token") \
                or (auth[7:] if auth.startswith("Bearer ") else "") \
                or (q.get("token") or [""])[0]
            if hmac.compare_digest(supplied or "", ctx.api_token):
                return True
            self.send_error(401, "missing or invalid api token")
            return False

        def do_GET(self):  # noqa: N802
            # /healthz is exempt from token auth: orchestration liveness
            # probes (k8s/LB health checks) can't carry deployment secrets,
            # and the body exposes only liveness counters
            if self.path.split("?", 1)[0] != "/healthz" \
                    and not self._authorized():
                return
            parsed = urlparse(unquote(self.path))
            # keep_blank_values: "window=" means "clear the window", and an
            # edit_alert request whose only param is blank must not fall
            # through to the delete branch
            q = parse_qs(parsed.query, keep_blank_values=True)
            cam = self._q(q, "cam")
            route = getattr(self, "_get_" + parsed.path.strip("/")
                            .replace("-", "_").replace("/", "_")
                            .replace(".", "_"), None)
            try:
                if parsed.path == "/":
                    return self._page(q, cam)
                if route is not None:
                    return route(q, cam)
                if parsed.path == f"/{cam}":
                    return self._page(q, cam)
                return self._static(parsed.path)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                try:
                    # ascii-sanitize: send_error writes the message into a
                    # latin-1 header line; a non-ASCII exception message
                    # (e.g. an em-dash) would otherwise kill the connection
                    # with no response at all
                    self.send_error(500, str(e).encode(
                        "ascii", "replace").decode())
                except Exception:
                    pass

        def _get_set_max_storage(self, q, cam):
            ctx.max_gb = float(self._q(q, "max"))
            ctx.db.run_put("max_storage", "all", ctx.max_gb)
            if ctx.nvr is not None and getattr(ctx.nvr, "storage", None):
                ctx.nvr.storage.max_gb = ctx.max_gb
            self._json(None)

        def _get_get_global_settings(self, q, cam):
            self._json(ctx.settings.masked().to_dict())

        def _get_get_max_storage(self, q, cam):
            self._json({"max_gb": ctx.max_gb})

        def _get_metrics(self, q, cam):
            from ..runtime import metrics
            snap = metrics.snapshot()
            if self._q(q, "format") == "prometheus" \
                    or "text/plain" in (self.headers.get("Accept") or ""):
                body = metrics.to_prometheus(snap).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._json(snap)

        def _get_healthz(self, q, cam):
            """GET /healthz — cheap liveness/readiness probe (no reference
            analogue: the reference's only health signal is whether :8080
            accepts at all, clearcam.py:1459). Side-effect-free: no device
            work, no filesystem, just the metrics snapshot; ``ready`` flips
            false once the NVR loop exits (NVR.run clears ``running``)."""
            from ..runtime import metrics
            snap = metrics.snapshot()
            nvr = ctx.nvr
            # inspect the LLM generator only if already materialized —
            # ctx.text_gen would trigger the lazy model load
            g = ctx._gen
            if callable(g) and not hasattr(g, "submit"):
                g = None
            serving_dead = bool(getattr(getattr(g, "engine", None),
                                        "_dead", False))
            self._json({
                "ok": True,
                "ready": (nvr is None or bool(nvr.running))
                         and not serving_dead,
                "serving_dead": serving_dead,
                "uptime_s": snap["uptime_s"],
                "cameras": 0 if nvr is None else len(nvr.cams),
                "frames": snap["counters"].get("frames", 0),
                "errors": {k: v for k, v in snap["counters"].items()
                           if k.endswith("_errors")},
            })

        def _get_profile(self, q, cam):
            """Capture a torch.profiler trace (CPU, and CUDA where a card
            is present) for N seconds -> a Chrome trace (trace.json) in the
            trace dir (chrome://tracing or Perfetto), with the program's
            spans of those seconds (``runtime.metrics``) on the trace's own
            time base, so host spans and kernels share one timeline.
            Deeper counterpart to /metrics; the reference's profiling story
            is tinygrad DEBUG env flags."""
            import time as _time
            seconds = float(self._q(q, "seconds", "3"))
            profiles = ctx.base_dir / "profiles"
            out_dir = profiles / str(int(_time.time()))
            out_dir.mkdir(parents=True, exist_ok=True)
            # keep only the 5 newest trace dirs (traces are tens of MB)
            old = sorted((d for d in profiles.iterdir() if d.is_dir()),
                         key=lambda d: d.name)[:-5]
            for d in old:
                shutil.rmtree(d, ignore_errors=True)
            try:
                import torch
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=acts) as prof:
                    # the profiler's clock is the wall clock, the spans'
                    # perf_counter: one pair of readings maps one onto the other
                    wall0, perf0 = _time.time_ns(), _time.perf_counter_ns()
                    _time.sleep(min(seconds, 30.0))
                    t1 = _time.perf_counter()
                prof.export_chrome_trace(str(out_dir / "trace.json"))
                add_program_spans(out_dir / "trace.json", perf0 / 1e9, t1, wall0 - perf0)
                self._json({"trace_dir": str(out_dir)})
            except Exception as e:  # noqa: BLE001
                self._json({"error": str(e)}, status=500)

        def _get_get_preds(self, q, cam):
            """Latest tracked boxes for live overlays (the iOS app's
            get-frames scrubbing metadata, FileServer.m:396)."""
            if not cam or ctx.nvr is None or cam not in ctx.nvr.cams:
                return self._json({"preds": [], "width": 0, "height": 0})
            c = ctx.nvr.cams[cam]
            h, w = (c.last_frame.shape[:2] if c.last_frame is not None
                    else (0, 0))
            self._json({"preds": np.asarray(c.last_preds).round(2).tolist(),
                        "width": w, "height": h, "fps": round(c.fps, 2)})

        def _get_snapshot(self, q, cam):
            """Latest live frame as JPEG — the air-gapped fallback for the
            web UI's video grid (hls.js comes from a CDN; without it the
            grid polls stills) and a one-call integration hook."""
            c = (ctx.nvr.cams.get(cam) if cam and ctx.nvr is not None
                 else None)
            if c is None or c.last_frame is None:
                self.send_error(404, "no frame")
                return
            import cv2
            ok, buf = cv2.imencode(".jpg", c.last_frame,
                                   [cv2.IMWRITE_JPEG_QUALITY, 80])
            if not ok:
                self.send_error(500, "encode failed")
                return
            data = buf.tobytes()
            self.send_response(200)
            self.send_header("Content-Type", "image/jpeg")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(data)

        def _get_live_mp4(self, q, cam):
            """Air-gapped LIVE video: tail the camera's rolling HLS `.ts`
            segments into fMP4 fragments streamed progressively (pure-Python
            box rewriting, io/fmp4.py) — a plain ``<video>`` plays live at
            ~2-4 s latency with neither hls.js (CDN, reference
            mainview.html:2678) nor ffmpeg on the serving host. A segment
            is consumed once a NEWER one exists (the HLS muxer writes in
            place; a successor means it is complete), which sets the
            latency floor at one segment (2 s). The stream ends when the
            recorder goes idle (`idle_timeout`, default 30 s) or the
            client disconnects; the UI's <video> error handler reconnects."""
            name = safe_cam_name(self._q(q, "cam_name") or cam)
            if not name:
                return self.send_error(400, "need cam or cam_name")
            base = self._cameras_dir() / name / "streams"

            def complete_segs():
                if not base.is_dir():
                    return []
                days = sorted(d for d in base.iterdir()
                              if d.is_dir() and DATE_RE.match(d.name))
                if not days:
                    return []
                segs = sorted(days[-1].glob("*.ts"))
                if len(days) >= 2:
                    # midnight rollover: the previous day's tail is
                    # complete once the new day has a segment (successor
                    # rule across the directory boundary) — without this
                    # the old day's last segments were silently dropped
                    # and the stream stalled until the new day had two
                    prev = sorted(days[-2].glob("*.ts"))
                    return prev + segs[:-1] if segs else prev[:-1]
                return segs[:-1]          # newest may still be mid-write

            deadline = time.time() + min(float(self._q(q, "wait") or 10.0),
                                         60.0)
            segs = complete_segs()
            while not segs and time.time() < deadline:
                time.sleep(0.25)
                segs = complete_segs()
            if not segs:
                return self.send_error(404, "no live recording for that camera")
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            from ..io import fmp4
            remux = fmp4.Remuxer(self.wfile.write)
            # join near live: seed with only the most recent complete
            # segment; everything older is history, not live
            sent = {str(s) for s in segs[:-1]}
            idle_limit = min(float(self._q(q, "idle_timeout") or 30.0), 3600.0)
            last_new = time.time()
            try:
                while True:
                    new = [s for s in complete_segs()
                           if str(s) not in sent]
                    for s in new:
                        sent.add(str(s))
                        remux.add_segment(s)
                    if new:
                        last_new = time.time()
                        self.wfile.flush()
                    elif time.time() - last_new > idle_limit:
                        break             # recorder stalled or stopped
                    else:
                        time.sleep(0.25)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass                      # client went away

        def _get_list_cameras(self, q, cam):
            cams = ctx.db.run_get("links", None)
            progs = ctx.db.run_get("analysis_prog", None)
            self._json({name: progs.get(name) for name in cams})

        def _get_list_days(self, q, cam):
            days = set()
            base = self._cameras_dir()
            if base.exists():
                for cam_dir in base.iterdir():
                    streams = cam_dir / "streams"
                    if streams.is_dir():
                        days.update(d.name for d in streams.iterdir()
                                    if d.is_dir() and DATE_RE.match(d.name))
            self._json(sorted(days, reverse=True))

        def _get_add_camera(self, q, cam):
            name, src = safe_cam_name(self._q(q, "cam_name")), self._q(q, "src")
            if not name or not src:
                return self.send_error(400, "Missing or invalid cam_name/src")
            ctx.db.run_put("links", name, src)
            self.send_response(302)
            self.send_header("Location", "/")
            self.end_headers()

        def _get_edit_settings(self, q, cam):
            if not cam:
                return self.send_error(400, "Missing cam or id")
            zone = ctx.db.run_get("settings", cam) or {}
            if not isinstance(zone, dict):
                zone = {}
            coords_json = self._q(q, "coords")
            if coords_json is not None:
                coords = json.loads(coords_json)
                if isinstance(coords, list):
                    if len(coords) >= 3:
                        zone["coords"] = [[float(x), float(y)] for x, y in coords]
                    else:
                        zone.pop("coords", None)
            for flag in ("is_notif", "outside"):
                v = self._q(q, flag)
                if v is not None:
                    zone[flag] = str(v).lower() == "true"
                else:
                    zone[flag] = zone.get(flag)
            thr = self._q(q, "threshold")
            if thr is not None:
                zone["threshold"] = float(thr)
            dfps = self._q(q, "detect_fps")
            if dfps is not None:
                # per-camera detect-rate cap (0/blank clears): lets operators
                # trade detection latency on quiet cameras for stream count
                try:
                    zone["detect_fps"] = float(dfps) or None
                except ValueError:
                    zone["detect_fps"] = None
            ctx.db.run_put("settings", cam, zone)
            url = q.get("url")
            if url is not None:
                ctx.db.run_put("links", cam, url[0])
            self._json({"status": "ok"})

        def _get_edit_alert(self, q, cam):
            if not cam:
                return self.send_error(400, "Missing cam or id")
            alerts = ctx.db.run_get("alerts", cam)
            if not isinstance(alerts, dict) or isinstance(alerts, RollingClassCounter):
                alerts = {"1": alerts} if alerts else {}
            alert_id = self._q(q, "id")
            is_on, zone = self._q(q, "is_on"), self._q(q, "zone")
            is_notif, desc = self._q(q, "is_notif"), self._q(q, "desc")
            thr = self._q(q, "threshold")
            if thr is not None:
                thr = float(thr) / 100
            alert = None
            if alert_id is None:  # create
                window = self._q(q, "window")
                sched = json.loads(self._q(
                    q, "sched", "[[0,86400],[0,86400],[0,86400],[0,86400],"
                                "[0,86400],[0,86400],[0,86400]]"))
                alert = RollingClassCounter(
                    window_seconds=int(window) if window else None,
                    max=int(self._q(q, "max")),
                    classes=[int(c) for c in self._q(q, "class_ids").split(",")],
                    sched=sched, cam_name=cam, desc=desc,
                    threshold=thr if thr is not None else 0.28)
                alert_id = str(uuid.uuid4())
                alerts[alert_id] = alert
            elif any(v is not None for v in
                     (is_on, is_notif, zone, self._q(q, "class_ids"),
                      self._q(q, "window"), self._q(q, "max"),
                      self._q(q, "sched"), desc, thr)):
                # edit in place: booleans like the reference
                # (clearcam.py:838-845) plus full-field edits of classes /
                # window / max / schedule (the reference SPA can only
                # delete+recreate; round-1 VERDICT item 7)
                alert = alerts[alert_id]
                if is_on is not None:
                    alert.is_on = str(is_on).lower() == "true"
                if is_notif is not None:
                    alert.is_notif = str(is_notif).lower() == "true"
                if zone is not None:
                    alert.zone = str(zone).lower() == "true"
                if desc is not None:
                    alert.desc = desc
                if thr is not None:
                    alert.threshold = thr
                if (cid := self._q(q, "class_ids")) is not None:
                    alert.classes = [int(c) for c in cid.split(",") if c != ""]
                if (window := self._q(q, "window")) is not None:
                    alert.window = int(window) if window else None
                if (mx := self._q(q, "max")) is not None:
                    alert.max = int(mx)
                if (sched := self._q(q, "sched")) is not None:
                    alert.sched = json.loads(sched)
                alert.new = True
            else:
                del alerts[alert_id]
            if alert is not None:
                ctx.db.run_put("alerts", cam, alert, alert_id)
            else:
                ctx.db.run_delete("alerts", cam, alert_id)
            # flag VOD re-analysis (clearcam.py:853-857)
            settings = ctx.db.run_get("settings", cam) or {}
            if not isinstance(settings, dict):
                settings = {}
            settings["reset"] = True
            ctx.db.run_put("settings", cam, settings)
            self._json({"status": "ok"})

        def _get_get_settings(self, q, cam):
            zone = ctx.db.run_get("settings", cam)
            self._json(zone if zone else {})

        def _get_get_alerts(self, q, cam):
            if not cam:
                return self.send_error(400, "Missing cam parameter")
            alerts = ctx.db.run_get("alerts", cam)
            if not isinstance(alerts, dict) or isinstance(alerts, RollingClassCounter):
                alerts = {"1": alerts} if alerts else {}
            out = []
            for key, a in alerts.items():
                out.append({
                    "window": a.window, "max": a.max,
                    "classes": list(a.classes) if a.classes else [],
                    "id": str(key),
                    "sched": a.sched or [[0, 86399], *[True] * 7],
                    "is_on": a.is_on, "is_notif": a.is_notif, "zone": a.zone,
                    "desc": a.desc, "threshold": a.threshold})
            self._json(out)

        def _get_delete_camera(self, q, cam):
            name = safe_cam_name(self._q(q, "cam_name"))
            if not name:
                return self.send_error(400, "Missing or invalid cam_name")
            shutil.rmtree(self._cameras_dir() / name, ignore_errors=True)
            alerts = ctx.db.run_get("alerts", name)
            if isinstance(alerts, dict):
                for aid in alerts:
                    ctx.db.run_delete("alerts", name, id=aid)
            for table in ("links", "analysis_prog", "settings", "counters"):
                ctx.db.run_delete(table, name)
            self._json({"status": "deleted"})

        def _get_delete_day(self, q, cam):
            """Remove one recording day (streams + derived objects/faces/
            event media) for a camera — the UI's per-day cleanup counterpart
            to the storage manager's oldest-day policy."""
            name = safe_cam_name(self._q(q, "cam_name") or cam)
            day = self._q(q, "day")
            if not name or not day or not DATE_RE.match(day):
                return self.send_error(400, "need cam + day (YYYY-MM-DD)")
            removed = []
            for sub in ("streams", "objects", "faces", "event_images",
                        "event_clips"):
                d = self._cameras_dir() / name / sub / day
                if d.exists():
                    shutil.rmtree(d, ignore_errors=True)
                    removed.append(sub)
            self._json({"status": "deleted", "removed": removed})

        def _get_day_mp4(self, q, cam):
            """Air-gapped day playback: remux the day's own HLS `.ts`
            segments into ONE fragmented MP4 (pure-Python box rewriting, no
            transcode — io/fmp4.py) and serve it with Range support, so a
            plain ``<video>`` tag plays and seeks a whole day with neither
            hls.js (CDN, reference mainview.html:2841) nor ffmpeg present.
            Cached next to the segments; rebuilt when new segments land."""
            name = safe_cam_name(self._q(q, "cam_name") or cam)
            day = self._q(q, "day")
            if not name or not day or not DATE_RE.match(day):
                return self.send_error(400, "need cam + day (YYYY-MM-DD)")
            stream_dir = self._cameras_dir() / name / "streams" / day
            segs = sorted(stream_dir.glob("*.ts"))
            if not segs:
                return self.send_error(404, "no recordings for that day")
            out = stream_dir / "day_remux.mp4"
            newest = max(s.stat().st_mtime for s in segs)
            if not out.exists() or out.stat().st_mtime < newest:
                from ..io import fmp4
                try:
                    skipped = fmp4.remux_segments(segs, out)
                except Exception as e:  # noqa: BLE001
                    out.unlink(missing_ok=True)
                    return self.send_error(500, f"remux failed: {e}")
                if skipped:
                    print(f"day.mp4 {name}/{day}: {skipped} segment(s) "
                          "skipped (unparseable or resolution changed)")
            self._send_file_ranged(out, "video/mp4")

        def _get_download_day(self, q, cam):
            """Concat a day's HLS segments into one mp4 download (stream
            copy, no re-encode) — the iOS on-phone server's `download`
            endpoint equivalent (FileServer.m:342)."""
            import subprocess
            from ..cloud.relay import find_ffmpeg
            name = safe_cam_name(self._q(q, "cam_name") or cam)
            day = self._q(q, "day")
            if not name or not day or not DATE_RE.match(day):
                return self.send_error(400, "need cam + day (YYYY-MM-DD)")
            stream_dir = self._cameras_dir() / name / "streams" / day
            segs = sorted(stream_dir.glob("*.ts"))
            if not segs:
                return self.send_error(404, "no recordings for that day")
            out = stream_dir / "day.mp4"
            newest = max(s.stat().st_mtime for s in segs)
            if not out.exists() or out.stat().st_mtime < newest:
                ff = find_ffmpeg()
                if ff is None:
                    # air-gapped host: pure-Python TS->fMP4 remux instead
                    # (same box rewriting /day.mp4 serves)
                    from ..io import fmp4
                    try:
                        fmp4.remux_segments(segs, out)
                    except Exception as e:  # noqa: BLE001
                        out.unlink(missing_ok=True)
                        return self.send_error(500, f"remux failed: {e}")
                else:
                    concat = stream_dir / "day_concat.txt"
                    concat.write_text("".join(f"file '{s.resolve()}'\n"
                                              for s in segs))
                    try:
                        rc = subprocess.run(
                            [ff, "-y", "-loglevel", "quiet", "-f", "concat",
                             "-safe", "0", "-i", str(concat), "-c", "copy",
                             str(out)], timeout=300).returncode
                    except subprocess.TimeoutExpired:
                        rc = -1
                    if rc != 0 or not out.exists():
                        return self.send_error(500, "concat failed")
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Disposition",
                             f'attachment; filename="{name}_{day}.mp4"')
            self.send_header("Content-Length", str(out.stat().st_size))
            self.end_headers()
            with open(out, "rb") as f:   # stream: a day can be gigabytes
                shutil.copyfileobj(f, self.wfile, 1 << 20)

        def _get_federation_cameras(self, q, cam):
            """Merged inventory: this host's cameras + every live peer's,
            with absolute URLs (media is fetched from the owning host)."""
            out = []
            links = ctx.db.run_get("links", None) or {}
            for name in links:
                out.append({"host": "", "cam": name, "url": f"/?cam={name}"})
            out += ctx.federation.cameras()
            self._json(out)

        def _get_get_counts(self, q, cam):
            if not cam:
                return self.send_error(400, "Missing cam parameter")
            counter = ctx.db.run_get("counters", cam)
            if counter:
                self._json({ctx.labels[int(k)]: len(v)
                            for k, v in counter.data.items()
                            if int(k) < len(ctx.labels)})
            else:
                ctx.db.run_put("counters", cam, RollingClassCounter(cam_name=cam))
                self._json([])

        def _get_reset_counts(self, q, cam):
            if not cam:
                return self.send_error(400, "Missing cam parameter")
            counter = ctx.db.run_get("counters", cam)
            if counter:
                counter.reset_counts()
            ctx.db.run_put("counters", cam, counter)
            self._json({})

        def _hls_src(self, html: str) -> str:
            """Point the pages' hls.js script tag at the vendored copy when
            one exists (served at /hls.js) instead of the CDN."""
            if vendored_hls_path() is not None:
                return html.replace(_HLS_CDN_TAG, "/hls.js")
            return html

        def _get_hls_js(self, q, cam):
            fp = vendored_hls_path()
            if fp is None:
                return self.send_error(404, "no vendored hls.js")
            self._send_file_ranged(fp, "application/javascript")

        def _page(self, q, cam):
            if not cam:
                return self._html(
                    self._hls_src((WEB_DIR / "mainview.html").read_text()))
            # per-camera page (served at /?cam=<name>, clearcam.py:968-988)
            selected_dir = self._q(q, "folder", datetime.now().strftime("%Y-%m-%d"))
            start = self._q(q, "start")
            try:
                start = max(float(start), 0) if start is not None else None
            except ValueError:
                start = None
            html = (WEB_DIR / "cameraview.html").read_text()
            # values land inside JS string literals: JSON-escape them so a
            # hostile camera/folder name cannot break out of the script
            for k, v in {
                "{selected_dir}": json.dumps(selected_dir)[1:-1],
                "{class_labels}": json.dumps(ctx.labels),
                "{start_time}": str(start) if start is not None else "null",
                "{cam_name}": json.dumps(cam)[1:-1],
            }.items():
                html = html.replace(k, v)
            self._html(self._hls_src(html))

        def _static(self, path: str):
            rel = path.lstrip("/")
            if rel.startswith("cameras/"):
                rel = rel[len("cameras/"):]
            # VOD path rewrite: any day folder maps to "video" (clearcam.py:994-999)
            try:
                cam_name = rel.split("/")[0]
                is_vod = (self._cameras_dir() / cam_name / "streams" / "video").is_dir()
                if is_vod and "preview.png" not in rel:
                    head, fname = rel.rsplit("/", 2)[0], rel.rsplit("/", 1)[1]
                    rel = f"{head}/video/{fname}"
            except Exception:
                pass
            fp = (self._cameras_dir() / rel).resolve()
            root = self._cameras_dir().resolve()
            if not fp.is_relative_to(root):       # block ../ traversal
                return self.send_error(403)
            if not fp.exists() or not fp.is_file():
                return self.send_error(404)
            ctype = {".m3u8": "application/vnd.apple.mpegurl",
                     ".ts": "video/MP2T", ".m4s": "video/iso.segment",
                     ".mp4": "video/mp4", ".png": "image/png",
                     ".jpg": "image/jpeg"}.get(fp.suffix, "application/octet-stream")
            self._send_file_ranged(fp, ctype)

        def _send_file_ranged(self, fp, ctype: str):
            """Serve a file with byte-Range support (video seeking needs
            206 responses)."""
            size = fp.stat().st_size
            rng = self.headers.get("Range")
            start, end = 0, size - 1
            if rng and rng.startswith("bytes="):
                try:
                    s, _, e = rng[6:].partition("-")
                    start = int(s) if s else max(0, size - int(e))
                    end = min(int(e), size - 1) if (e and s) else end
                except ValueError:
                    start, end = 0, size - 1
                self.send_response(206)
                self.send_header("Content-Range", f"bytes {start}-{end}/{size}")
            else:
                self.send_response(200)
            self.send_header("Accept-Ranges", "bytes")
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(end - start + 1))
            if fp.suffix == ".m3u8":
                self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            with open(fp, "rb") as f:
                f.seek(start)
                remaining = end - start + 1
                while remaining > 0:
                    chunk = f.read(min(1 << 20, remaining))
                    if not chunk:
                        break
                    self.wfile.write(chunk)
                    remaining -= len(chunk)

        # -- POST ------------------------------------------------------------
        def do_POST(self):  # noqa: N802
            if not self._authorized():
                return
            parsed = urlparse(self.path)
            try:
                if parsed.path == "/edit_settings":
                    return self._post_edit_settings()
                if parsed.path == "/analyse-footage":
                    return self._post_analyse_footage(parse_qs(parsed.query))
                if parsed.path == "/event_thumbs":
                    return self._post_event_thumbs()
                if parsed.path in ("/yolo", "/diff"):
                    return self._post_offload(parsed.path == "/diff")
                if parsed.path == "/federation/register":
                    return self._post_federation_register()
                if parsed.path == "/generate":
                    return self._post_generate()
                if parsed.path == "/v1/completions":
                    return self._post_openai(chat=False)
                if parsed.path == "/v1/chat/completions":
                    return self._post_openai(chat=True)
                if parsed.path == "/v1/responses":
                    return self._post_v1_responses()
                if parsed.path == "/v1/embeddings":
                    return self._post_v1_embeddings()
                self.send_error(404)
            except BrokenPipeError:
                pass
            except Exception as e:  # noqa: BLE001
                try:
                    # ascii-sanitize: send_error writes the message into a
                    # latin-1 header line; a non-ASCII exception message
                    # (e.g. an em-dash) would otherwise kill the connection
                    # with no response at all
                    self.send_error(500, str(e).encode(
                        "ascii", "replace").decode())
                except Exception:
                    pass

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(length)

        def _post_federation_register(self):
            """Peer NVR host announces itself + its camera list
            (cloud/federation.py; the DCN service-level federation)."""
            data = json.loads(self._body().decode())
            host, cameras = data.get("host"), data.get("cameras", [])
            if not isinstance(host, str) or not host.startswith(("http://",
                                                                 "https://")):
                return self.send_error(400, "host must be an http(s) URL")
            ctx.federation.register(host, [c for c in cameras
                                           if isinstance(c, str)
                                           and safe_cam_name(c)])
            self._json({"status": "ok"})

        def _post_generate(self):
            """LLM text generation over the continuous-batching engine
            (serving/engine.py) — the serving daemon's public surface.
            Body: {"prompt": str, "max_new": int, "temperature": float,
            "raw": bool (skip chat framing), "stream": bool}. stream=true
            returns chunked text deltas as tokens materialize; otherwise
            one JSON object. Requests from many clients decode
            concurrently (each gets a slot; the engine interleaves).
            Beyond the reference, which has no text-serving endpoint —
            its LLM only runs inside alert summaries (clearcam.py:494)."""
            gen = ctx.text_gen
            if gen is None:
                return self.send_error(
                    503, "no LLM serving engine configured")
            data = json.loads(self._body().decode() or "{}")
            prompt = data.get("prompt")
            if not isinstance(prompt, str) or not prompt:
                return self.send_error(400, "prompt (string) required")
            max_new = min(int(data.get("max_new", 128)), 4096)
            timeout = float(data.get("timeout", 600))
            from ..serving.engine import QueueFull
            try:
                # the engine enforces the deadline too: the slot is
                # reclaimed even if this HTTP thread dies, and a request
                # cut mid-generation returns its partial text
                req = gen.submit(prompt, max_new=max_new,
                                 temperature=float(
                                     data.get("temperature", 0.0)),
                                 raw=bool(data.get("raw", False)),
                                 timeout_s=timeout, **_samp_of(data))
            except QueueFull:
                self.send_response(503)   # admission backpressure
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            deadline = time.time() + timeout
            if not data.get("stream"):
                try:
                    req.wait(timeout + 5)  # engine deadline fires first
                except TimeoutError:
                    gen.cancel(req)       # free the slot for other clients
                    return self.send_error(504, "generation timed out")
                return self._json({"text": gen.text(req),
                                   "tokens": len(req.tokens),
                                   "timed_out": req.timed_out})
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(s: str):
                b = s.encode()
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                self.wfile.flush()

            seen = ""
            try:
                while True:
                    done = req.done   # BEFORE the delta read: tokens are
                    # complete once done is set, so this order can't drop
                    # a final delta that lands between the two
                    delta = gen.text_delta(req, seen)
                    if delta:
                        seen += delta
                        emit(delta)
                    if done or time.time() > deadline:
                        break
                    time.sleep(0.02)
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                if not req.done:      # disconnect/timeout: free the slot
                    gen.cancel(req)

        def _get_v1_models(self, q, cam):
            """OpenAI-compatible model listing (one served model)."""
            if ctx.text_gen is None:
                return self.send_error(503, "no LLM serving engine")
            self._json({"object": "list", "data": [
                {"id": ctx.served_model, "object": "model",
                 "created": 0, "owned_by": "clearcam_tpu"}]})

        def _post_openai(self, chat: bool):
            """OpenAI-compatible serving surface over the continuous-
            batching engine: /v1/completions (prompt string) and
            /v1/chat/completions (messages list), non-streamed JSON or
            SSE streaming (``data: {chunk}`` lines, terminated by
            ``data: [DONE]``) — so off-the-shelf OpenAI SDK clients /
            LangChain / curl recipes can point at the serving daemon
            (tools/serve_llm.py) unchanged. Supports max_tokens,
            temperature, stop (string or list, host-side truncation),
            stream, and n>1 (non-streamed: each choice is its own engine
            request, so they decode concurrently in the batch; streamed
            n>1 is rejected). Auth accepts ``Authorization:
            Bearer <token>`` when --api-token is set."""
            gen = ctx.text_gen
            if gen is None:
                return self.send_error(
                    503, "no LLM serving engine configured")
            try:
                data = json.loads(self._body().decode() or "{}")
            except json.JSONDecodeError:
                return self.send_error(400, "invalid JSON body")
            n_choices = max(1, min(int(data.get("n", 1)), 16))
            if data.get("stream") and n_choices != 1:
                return self.send_error(400, "streaming requires n=1")
            # echo (completions only): prepend the prompt — with logprobs,
            # teacher-forcing scores for every prompt token ride in front
            # of the generation's (llm.make_score_fn); max_tokens=0 + echo
            # + logprobs is the pure scoring call (lm-eval loglikelihood)
            echo = bool(data.get("echo")) and not chat
            if echo and data.get("stream"):
                return self.send_error(400, "echo not supported with stream")
            mt_raw = data.get("max_tokens")
            max_new = 128 if mt_raw is None \
                else max(0, min(int(mt_raw), 4096))
            if max_new == 0 and (chat or not echo):
                return self.send_error(400, "max_tokens must be >= 1")
            temp = float(data.get("temperature", 1.0))
            timeout = float(data.get("timeout", 600))
            # top_p / presence_penalty / frequency_penalty are OpenAI-
            # standard; top_k / min_p / repetition_penalty are the common
            # serving extensions (all run on device, llm.sample_filtered)
            samp = _samp_of(data)
            # logprobs — completions: int top-alt count (0 = chosen-token
            # logprob only); chat: logprobs: true + top_logprobs: int.
            # Engine-recorded per token (llm.LP_K cap); streamed chunks
            # carry entries for the rows materialized since the last poll
            # (TextServing.logprobs_delta — absolute text_offsets, so
            # concatenated chunks reconstruct the non-streamed object).
            from ..models.llm import LP_K
            n_top, lp_req = 0, 0
            if chat:
                if data.get("logprobs"):
                    n_top = max(0, min(int(data.get("top_logprobs") or 0),
                                       LP_K))
                    lp_req = max(1, n_top)
            elif data.get("logprobs") is not None:
                n_top = max(0, min(int(data.get("logprobs") or 0), LP_K))
                lp_req = max(1, n_top)
            if lp_req:
                samp["logprobs"] = lp_req
            # OpenAI seed: reproducible sampling (llm.serving_row_keys —
            # same seed => same draws regardless of slot/step/batch mates)
            if data.get("seed") is not None:
                samp["seed"] = int(data["seed"])
            # OpenAI response_format: grammar-constrained decoding — the
            # grammar compiles to a token-transition table masked ON
            # DEVICE each step (serving/constrain.py) instead of
            # prompt-and-pray. json_object needs the engine's startup
            # "json" grammar (tools/serve_llm.py registers one by
            # default); json_schema (structured outputs) and the vLLM-
            # style guided_choice extension compile PER GRAMMAR on first
            # use and register into the engine's reserved table rows
            # (ServingEngine.register_constraint — no graph recompile).
            rf = data.get("response_format") or {}
            rft = rf.get("type") if isinstance(rf, dict) else rf
            sch = (rf.get("json_schema") or {}).get("schema") \
                if isinstance(rf, dict) and isinstance(
                    rf.get("json_schema"), dict) else None
            try:
                cname = _resolve_constraint(gen, rft, sch,
                                            data.get("guided_choice"))
            except ValueError as e:          # unsupported format / schema
                return self.send_error(400, str(e))
            if cname:
                samp["constraint"] = cname
            stops = data.get("stop") or []
            if isinstance(stops, str):
                stops = [stops]
            model = str(data.get("model") or ctx.served_model)
            # serving-config fingerprint (TextServing.fingerprint): changes
            # with anything batch-width/numerics-affecting so clients can
            # tell when seeded outputs are not comparable across deployments
            fp = (gen.fingerprint() if hasattr(gen, "fingerprint")
                  else "fp_clearcam_tpu")
            # OpenAI tool calling (chat only): function specs ride into
            # the system turn (<tools> block, Qwen chat-template
            # convention); well-formed <tool_call> output blocks come
            # back as message.tool_calls + finish_reason "tool_calls"
            tools = data.get("tools") if chat else None
            if str(data.get("tool_choice") or "auto") == "none":
                tools = None
            if chat:
                msgs = data.get("messages")
                if not isinstance(msgs, list) or not msgs:
                    return self.send_error(400,
                                           "messages (list) required")
                make = lambda i=0: gen.submit_messages(  # noqa: E731
                    msgs, max_new=max_new, temperature=temp,
                    timeout_s=timeout, tools=tools, **_samp_at(samp, i))
            else:
                prompt = data.get("prompt")
                if isinstance(prompt, list):
                    prompt = prompt[0] if prompt else None
                if not isinstance(prompt, str) or not prompt:
                    return self.send_error(400, "prompt (string) required")
                if max_new == 0:          # pure scoring: no generation
                    ids = gen.encode_prompt(prompt, True)
                    try:
                        lp_obj = (gen.echo_logprobs(ids, n_top)
                                  if lp_req else None)
                    except AssertionError:  # scorer: prompt over ctx
                        return self.send_error(
                            400, "prompt too long for scoring")
                    return self._json({
                        "id": f"cmpl-{id(data):x}",
                        "created": int(time.time()), "model": model,
                        "object": "text_completion",
                        "system_fingerprint": fp,
                        "choices": [{
                            "index": 0, "text": prompt,
                            "finish_reason": "length",
                            "logprobs": lp_obj}],
                        "usage": {"prompt_tokens": len(ids),
                                  "completion_tokens": 0,
                                  "total_tokens": len(ids)}})
                make = lambda i=0: gen.submit(prompt, max_new=max_new,  # noqa: E731
                                              temperature=temp, raw=True,
                                              timeout_s=timeout,
                                              **_samp_at(samp, i))
            from ..serving.engine import QueueFull
            reqs = []
            rereg = lambda: _resolve_constraint(  # noqa: E731
                gen, rft, sch, data.get("guided_choice"))
            try:
                for i in range(n_choices):
                    if cname:
                        reqs.append(_submit_retrying(
                            lambda i=i: make(i), rereg))
                    else:
                        reqs.append(make(i))
            except ValueError as e:     # e.g. logprobs under spec serving
                for r in reqs:
                    gen.cancel(r)
                return self.send_error(400, str(e))
            except QueueFull:
                for r in reqs:            # partial fan-out: roll back
                    gen.cancel(r)
                self.send_response(429)   # OpenAI's rate-limit status
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            req = reqs[0]
            rid = f"{'chatcmpl' if chat else 'cmpl'}-{id(req):x}"
            created = int(time.time())

            def cut(text: str):
                """Host-side stop-sequence truncation (returns text,
                hit?). The engine decodes past a stop string by at most
                the polling interval; tokens past it are dropped here —
                same contract as OpenAI's server-side stop."""
                first = len(text)
                for s in stops:
                    i = text.find(s)
                    if i >= 0:
                        first = min(first, i)
                return text[:first], first < len(text)

            def finish_reason(r, stopped: bool):
                if stopped:
                    return "stop"
                if r.timed_out or len(r.tokens) >= max_new:
                    return "length"
                return "stop"             # retired on eos

            if not data.get("stream"):
                try:
                    for r in reqs:
                        r.wait(timeout + 5)
                except TimeoutError:
                    for r in reqs:
                        gen.cancel(r)
                    return self.send_error(504, "generation timed out")
                if any(getattr(r, "failed", False) for r in reqs):
                    return self.send_error(500, "serving engine failed")
                prompt_toks = (len(gen.encode_messages(msgs, tools)) if chat
                               else len(gen.encode_prompt(prompt, True)))
                ep = None
                if echo and lp_req:       # scored once, shared by choices
                    ep = gen.echo_logprobs(gen.encode_prompt(prompt, True),
                                           n_top)
                choices, done_toks = [], 0
                for i, r in enumerate(reqs):
                    text, hit = cut(gen.text(r))
                    done_toks += len(r.tokens)
                    lp_obj = (gen.logprobs_payload(
                        r, chat=chat, n_top=n_top,
                        max_chars=len(text) if hit else None)
                        if lp_req else None)
                    if ep is not None:    # prompt scores ahead of the
                        lp_obj = {        # generation's, offsets shifted
                            "tokens": ep["tokens"] + lp_obj["tokens"],
                            "token_logprobs": (ep["token_logprobs"]
                                               + lp_obj["token_logprobs"]),
                            "top_logprobs": ((ep["top_logprobs"]
                                              + lp_obj["top_logprobs"])
                                             if n_top else None),
                            "text_offset": (ep["text_offset"]
                                            + [o + len(prompt) for o in
                                               lp_obj["text_offset"]])}
                    choice = {"index": i,
                              "finish_reason": finish_reason(r, hit),
                              "logprobs": lp_obj}
                    if chat:
                        msg = {"role": "assistant", "content": text}
                        if tools:
                            content, calls = gen.parse_tool_calls(text)
                            if calls:
                                msg = {"role": "assistant",
                                       "content": content or None,
                                       "tool_calls": calls}
                                choice["finish_reason"] = "tool_calls"
                        choice["message"] = msg
                    else:
                        choice["text"] = (prompt + text) if echo else text
                    choices.append(choice)
                return self._json({
                    "id": rid, "created": created, "model": model,
                    "object": ("chat.completion" if chat
                               else "text_completion"),
                    "system_fingerprint": fp,
                    "choices": choices,
                    "usage": {"prompt_tokens": prompt_toks,
                              "completion_tokens": done_toks,
                              "total_tokens": prompt_toks + done_toks}})

            # --- SSE streaming ------------------------------------------
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(obj):
                b = b"data: " + json.dumps(obj).encode() + b"\n\n"
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                self.wfile.flush()

            def chunk_obj(delta_choice):
                o = {"id": rid, "created": created, "model": model,
                     "object": ("chat.completion.chunk" if chat
                                else "text_completion"),
                     "system_fingerprint": fp,
                     "choices": [delta_choice]}
                return o

            deadline = time.time() + timeout
            seen, hit, lp_sent = "", False, 0
            try:
                if chat:                  # role preamble chunk
                    emit(chunk_obj({"index": 0, "finish_reason": None,
                                    "delta": {"role": "assistant"}}))
                while True:
                    done = req.done       # read BEFORE the delta (see
                    # _post_generate: this order can't drop a final delta)
                    full, hit = cut(seen + gen.text_delta(req, seen))
                    if tools:             # hold back tool-call blocks (and
                        # any tail that could open one): they stream as
                        # delta.tool_calls entries after generation ends,
                        # not as content text
                        full = full[:_tool_visible_len(full)]
                    delta = full[len(seen):]
                    lp_payload = None
                    if lp_req:            # rows materialized since last
                        # poll (visible text implies its rows exist —
                        # _emit appends tokens and lp together)
                        lp_payload, lp_sent = gen.logprobs_delta(
                            req, lp_sent, chat=chat, n_top=n_top,
                            max_chars=len(full) if hit else None)
                    if delta or lp_payload:
                        seen = full
                        if chat:
                            c = {"index": 0, "finish_reason": None,
                                 "delta": ({"content": delta} if delta
                                           else {})}
                            if lp_req:
                                c["logprobs"] = lp_payload
                        else:
                            c = {"index": 0, "finish_reason": None,
                                 "text": delta,
                                 "logprobs": lp_payload if lp_req else None}
                        emit(chunk_obj(c))
                    if hit or done or time.time() > deadline:
                        break
                    time.sleep(0.02)
                fr = finish_reason(req, hit)
                if tools:                 # parse the held-back blocks into
                    # OpenAI streamed tool_calls deltas (whole argument
                    # strings in one chunk each — clients concatenate)
                    raw = cut(gen.text(req))[0]
                    content, calls = gen.parse_tool_calls(raw)
                    # held-back text that did NOT parse into calls (a
                    # malformed/truncated block, text between or after
                    # blocks) must still reach the client as content —
                    # the non-streamed path returns it in message.content
                    rem = ""
                    if calls:
                        if content.startswith(seen.strip()) \
                                and len(content) > len(seen.strip()):
                            rem = content[len(seen.strip()):]
                    else:
                        rem = raw[len(seen):] if raw.startswith(seen) \
                            else raw
                    if rem:
                        emit(chunk_obj({"index": 0, "finish_reason": None,
                                        "delta": {"content": rem}}))
                    if calls:
                        fr = "tool_calls"
                        for i, c in enumerate(calls):
                            emit(chunk_obj({
                                "index": 0, "finish_reason": None,
                                "delta": {"tool_calls": [
                                    {"index": i, **c}]}}))
                emit(chunk_obj({"index": 0, "finish_reason": fr,
                                **({"delta": {}} if chat
                                   else {"text": "", "logprobs": None})}))
                # stream_options.include_usage: one final chunk with
                # empty choices carrying the usage object (OpenAI shape)
                if (data.get("stream_options") or {}).get("include_usage"):
                    p_toks = (len(gen.encode_messages(msgs, tools)) if chat
                              else len(gen.encode_prompt(prompt, True)))
                    u = chunk_obj(None)
                    u["choices"] = []
                    u["usage"] = {
                        "prompt_tokens": p_toks,
                        "completion_tokens": len(req.tokens),
                        "total_tokens": p_toks + len(req.tokens)}
                    emit(u)
                b = b"data: [DONE]\n\n"
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                if not req.done:          # disconnect / stop-hit / timeout
                    gen.cancel(req)

        def _post_v1_responses(self):
            """OpenAI Responses API (the current-generation endpoint new
            SDKs default to — ``client.responses.create``) over the same
            continuous-batching engine as chat/completions. Supported:
            ``input`` (string or message list with input_text/output_text
            content parts), ``instructions`` (system turn),
            ``max_output_tokens``, ``temperature``/``top_p``, ``stream``
            (typed SSE events: response.created ->
            response.output_item.added -> response.content_part.added ->
            response.output_text.delta* -> ...done -> response.completed),
            ``text.format`` (text / json_object / json_schema — grammar-
            constrained decoding, serving/constrain.py), and flat
            ``tools`` function specs (function_call output items;
            non-streamed only). Stateful features (store/
            previous_response_id) are not persisted — each call is
            stateless, like chat/completions."""
            gen = ctx.text_gen
            if gen is None:
                return self.send_error(
                    503, "no LLM serving engine configured")
            try:
                data = json.loads(self._body().decode() or "{}")
            except json.JSONDecodeError:
                return self.send_error(400, "invalid JSON body")
            if data.get("previous_response_id"):
                return self.send_error(
                    400, "previous_response_id unsupported (stateless "
                    "serving); send the full input history instead")

            def parts_text(content):
                if isinstance(content, str):
                    return content
                out = []
                for p in content or []:
                    if not isinstance(p, dict) or p.get("type") not in (
                            "input_text", "output_text", "text"):
                        raise ValueError(
                            f"unsupported content part {p!r}")
                    out.append(str(p.get("text") or ""))
                return "".join(out)

            msgs = []
            if data.get("instructions"):
                msgs.append({"role": "system",
                             "content": str(data["instructions"])})
            inp = data.get("input")
            try:
                if isinstance(inp, str):
                    msgs.append({"role": "user", "content": inp})
                elif isinstance(inp, list):
                    for item in inp:
                        if not isinstance(item, dict) or "role" not in item:
                            raise ValueError(
                                f"unsupported input item {item!r} (only "
                                "role messages are supported)")
                        msgs.append({"role": str(item["role"]),
                                     "content":
                                         parts_text(item.get("content"))})
                else:
                    raise ValueError("input (string or message list) "
                                     "required")
            except ValueError as e:
                return self.send_error(400, str(e))
            if not msgs:
                return self.send_error(400, "empty input")

            mt = data.get("max_output_tokens")
            max_new = 128 if mt is None else max(1, min(int(mt), 4096))
            samp = _samp_of(data)
            fmt = (data.get("text") or {}).get("format") or {}
            try:
                cname = _resolve_constraint(
                    gen, fmt.get("type"), fmt.get("schema"))
            except ValueError as e:
                return self.send_error(400, str(e))
            if cname:
                samp["constraint"] = cname
            tools = data.get("tools") or None
            if str(data.get("tool_choice") or "auto") == "none":
                tools = None
            if tools and data.get("stream"):
                return self.send_error(
                    400, "streaming with tools unsupported on "
                    "/v1/responses; use stream: false")
            timeout = float(data.get("timeout", 600))
            fp = (gen.fingerprint() if hasattr(gen, "fingerprint")
                  else "fp_clearcam_tpu")
            model = str(data.get("model") or ctx.served_model)
            from ..serving.engine import QueueFull
            try:
                sub = lambda: gen.submit_messages(  # noqa: E731
                    msgs, max_new=max_new,
                    temperature=float(data.get("temperature", 1.0)),
                    timeout_s=timeout, tools=tools, **samp)
                if cname:
                    req = _submit_retrying(sub, lambda: _resolve_constraint(
                        gen, fmt.get("type"), fmt.get("schema")))
                else:
                    req = sub()
            except ValueError as e:
                return self.send_error(400, str(e))
            except QueueFull:
                self.send_response(429)
                self.send_header("Retry-After", "1")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            rid = f"resp_{id(req):x}"
            mid = f"msg_{id(req):x}"
            created = int(time.time())

            def response_obj(status, output, out_toks):
                p_toks = len(gen.encode_messages(msgs, tools))
                o = {"id": rid, "object": "response",
                     "created_at": created, "model": model,
                     "status": status, "system_fingerprint": fp,
                     "output": output, "error": None,
                     "incomplete_details": (
                         {"reason": "max_output_tokens"}
                         if status == "incomplete" else None),
                     "usage": {"input_tokens": p_toks,
                               "output_tokens": out_toks,
                               "total_tokens": p_toks + out_toks}}
                return o

            def message_item(text, status="completed"):
                return {"id": mid, "type": "message", "status": status,
                        "role": "assistant",
                        "content": [{"type": "output_text", "text": text,
                                     "annotations": []}]}

            if not data.get("stream"):
                try:
                    req.wait(timeout + 5)
                except TimeoutError:
                    gen.cancel(req)
                    return self.send_error(504, "generation timed out")
                if getattr(req, "failed", False):
                    return self.send_error(500, "serving engine failed")
                text = gen.text(req)
                status = ("incomplete"
                          if req.timed_out or len(req.tokens) >= max_new
                          else "completed")
                output = []
                if tools:
                    content, calls = gen.parse_tool_calls(text)
                    for c in calls:
                        output.append({
                            "id": f"fc_{c['id'][5:]}",
                            "type": "function_call",
                            "call_id": c["id"], "status": "completed",
                            "name": c["function"]["name"],
                            "arguments": c["function"]["arguments"]})
                    text = content
                if text or not output:
                    output.insert(0, message_item(text))
                return self._json(response_obj(status, output,
                                               len(req.tokens)))

            # --- typed-event SSE streaming ------------------------------
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(ev: str, obj: dict):
                b = (f"event: {ev}\n".encode()
                     + b"data: " + json.dumps({"type": ev, **obj}).encode()
                     + b"\n\n")
                self.wfile.write(f"{len(b):x}\r\n".encode() + b + b"\r\n")
                self.wfile.flush()

            deadline = time.time() + timeout
            seen = ""
            try:
                emit("response.created",
                     {"response": response_obj("in_progress", [], 0)})
                emit("response.output_item.added",
                     {"output_index": 0,
                      "item": {"id": mid, "type": "message",
                               "status": "in_progress",
                               "role": "assistant", "content": []}})
                emit("response.content_part.added",
                     {"item_id": mid, "output_index": 0,
                      "content_index": 0,
                      "part": {"type": "output_text", "text": "",
                               "annotations": []}})
                while True:
                    done = req.done
                    full = seen + gen.text_delta(req, seen)
                    delta = full[len(seen):]
                    if delta:
                        seen = full
                        emit("response.output_text.delta",
                             {"item_id": mid, "output_index": 0,
                              "content_index": 0, "delta": delta})
                    if done or time.time() > deadline:
                        break
                    time.sleep(0.02)
                emit("response.output_text.done",
                     {"item_id": mid, "output_index": 0,
                      "content_index": 0, "text": seen})
                emit("response.content_part.done",
                     {"item_id": mid, "output_index": 0, "content_index": 0,
                      "part": {"type": "output_text", "text": seen,
                               "annotations": []}})
                emit("response.output_item.done",
                     {"output_index": 0, "item": message_item(seen)})
                status = ("incomplete"
                          if req.timed_out or len(req.tokens) >= max_new
                          else "completed")
                emit("response.completed",
                     {"response": response_obj(status,
                                               [message_item(seen)],
                                               len(req.tokens))})
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
            finally:
                if not req.done:
                    gen.cancel(req)

        def _post_v1_embeddings(self):
            """OpenAI embeddings API over the CLIP text tower (the SAME
            768-dim unit-norm space the NVR's search index scores in —
            models/objects.ObjectFinder.embed_text), so external tooling
            can embed queries and compare against exported event
            embeddings with any OpenAI SDK. input: string or list of
            strings; encoding_format "float" only. 503 when the server
            runs without CLIP (use_clip off / no object finder)."""
            finder = ctx.object_finder
            if finder is None or not getattr(ctx.settings, "use_clip",
                                             False):
                return self.send_error(503, "no CLIP tower configured")
            try:
                data = json.loads(self._body().decode() or "{}")
            except json.JSONDecodeError:
                return self.send_error(400, "invalid JSON body")
            if str(data.get("encoding_format") or "float") != "float":
                return self.send_error(400,
                                       "only encoding_format float")
            inp = data.get("input")
            if isinstance(inp, str):
                inp = [inp]
            if not isinstance(inp, list) or not inp \
                    or not all(isinstance(s, str) and s for s in inp):
                return self.send_error(
                    400, "input must be a non-empty string or list")
            if len(inp) > 256:
                return self.send_error(400, "at most 256 inputs")
            embs = ctx.submit(finder.embed_texts, inp)  # ONE device call
            return self._json({
                "object": "list", "model": "clip-vit-l14-text",
                "data": [{"object": "embedding", "index": i,
                          "embedding": np.asarray(e).reshape(-1)
                          .astype(float).tolist()}
                         for i, e in enumerate(embs)],
                "usage": {"prompt_tokens": 0, "total_tokens": 0}})

        def _post_edit_settings(self):
            data = json.loads(self._body().decode())
            new = GlobalSettings.from_dict(data, current=ctx.settings)
            ctx.submit(ctx.db.run_put, "global_settings", "all", new)
            if ctx.on_settings_change is not None:
                ctx.submit(ctx.on_settings_change, new)
            ctx.settings = new
            if ctx.nvr is not None:
                ctx.nvr.settings = new
            self._json([])

        def _post_analyse_footage(self, q):
            filename = self._q(q, "filename")
            chunk = int(self._q(q, "chunk", 0))
            total = int(self._q(q, "total", 1))
            if not filename:
                return self.send_error(400, "Missing filename")
            filename = Path(filename).name
            upload_dir = self._cameras_dir()
            upload_dir.mkdir(parents=True, exist_ok=True)
            body = self._body()
            if not body:
                return self.send_error(411, "Content-Length required")
            temp = upload_dir / f"{filename}.part"
            with open(temp, "ab") as f:
                f.write(body)
            if chunk == total - 1:
                temp.rename(upload_dir / filename)
            self._json([])

        def _post_event_thumbs(self):
            try:
                data = json.loads(self._body())
            except json.JSONDecodeError:
                return self.send_error(400, "Invalid JSON")
            cam = data.get("cam")
            folder = data.get("folder")
            name_contains = data.get("name_contains")
            image_text = data.get("image_text")
            similar_img = data.get("similar_img")
            is_face = data.get("is_face") or False
            start = data.get("start")
            count = data.get("count")
            if is_face and not ctx.settings.use_face:
                return self._json({"images": [], "count": 0})
            if start is None:
                start, count = 0, 100
            uploaded = data.get("uploaded_image")
            if uploaded:
                if "," in uploaded:
                    uploaded = uploaded.split(",")[1]
                uploaded = base64.b64decode(uploaded)

            finder = ctx.object_finder
            use_clip = ctx.settings.use_clip and finder is not None
            if (image_text or uploaded or similar_img) and (use_clip or (is_face and finder)):
                ctx.submit(finder.load_all_embeddings, is_face)
                if uploaded or similar_img:
                    results = ctx.submit(finder.search_image,
                                         uploaded or similar_img,
                                         start + count, cam, folder, is_face)
                else:
                    results = ctx.submit(finder.search_text, image_text,
                                         start + count, cam, folder)
                return self._send_results(results, start, count)

            # plain listing of event images, newest first
            base = self._cameras_dir()
            cam_dirs = [base / cam] if cam else \
                [d for d in base.iterdir() if d.is_dir()] if base.exists() else []
            folders = [folder] if folder else sorted({
                sub.name for c in cam_dirs if (c / "streams").is_dir()
                for sub in (c / "streams").iterdir() if sub.is_dir()})
            folders = list(folders) + ["video"]
            images = []
            for c in cam_dirs:
                for day in folders:
                    p = c / "event_images" / day
                    if not p.exists():
                        continue
                    for img in sorted(p.glob("*.jpg"),
                                      key=lambda x: int(x.stem.split("_")[0]),
                                      reverse=True):
                        if name_contains and name_contains not in img.name:
                            continue
                        images.append({
                            "url": f"/{img.relative_to(ctx.base_dir)}",
                            "timestamp": int(img.stem.split("_")[0]),
                            "filename": img.name, "cam_name": c.name,
                            "folder": day})
            images.sort(key=_image_sort_key, reverse=True)
            images = images[start:start + count]
            self._json({"images": images, "count": len(images)})

        def _send_results(self, results, start, count):
            """Search results -> gallery rows with the 0.21 score floor
            (clearcam.py:686-710)."""
            images = []
            for path_str, score in results:
                if score < SCORE_CUTOFF:
                    break
                p = Path(path_str).resolve()
                parts = p.parts
                try:
                    cam = parts[parts.index("cameras") + 1]
                    rel = p.relative_to((self._cameras_dir()).resolve())
                except ValueError:
                    continue
                images.append({
                    "url": f"/{rel}",
                    "timestamp": event_img_info(p.stem)["ts"],
                    "filename": p.name, "cam_name": cam,
                    "folder": p.parts[-2], "score": score})
            images = images[start:start + count]
            self._json({"images": images, "count": len(images)})

        def _post_offload(self, is_diff: bool):
            """Remote-inference offload serving the iOS protocol."""
            sid = self.headers.get("x-session-id") or str(uuid.uuid4())
            body = self._body()
            if is_diff:
                frame = ctx.offload.patch(sid, body)
                if frame is None:
                    # unknown session: client must resend a full frame
                    self.send_response(409)
                    self.send_header("x-session-id", sid)
                    self.end_headers()
                    return
            else:
                frame = ctx.offload.full(sid, body)
            res = ctx.offload.res
            img = frame.reshape(res, res, 3)
            if ctx.offload_batcher is not None:
                rows = ctx.offload_batcher.infer(img, ctx.submit)
            elif ctx.offload_detect is not None:
                rows = ctx.submit(ctx.offload_detect, img)
            else:
                rows = np.zeros((0, 6), np.float32)
            data = np.asarray(rows, np.float32).tobytes()
            self.send_response(200)
            self.send_header("x-session-id", sid)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    return Handler


def _image_sort_key(item):
    try:
        return (datetime.strptime(item["folder"], "%Y-%m-%d").timestamp()
                + item["timestamp"])
    except ValueError:
        return -1


def serve(ctx: AppContext, port: int = 8080, host: str = "0.0.0.0",
          background: bool = True) -> ThreadingHTTPServer | None:
    try:
        server = ThreadingHTTPServer((host, port), make_handler(ctx))
    except OSError as e:
        print(f"Port in use, server not started ({e}).")
        return None
    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    else:
        server.serve_forever()
    return server
