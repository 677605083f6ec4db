"""Served-path latency decomposition: device vs transfer vs server overhead,
the counterpart of ``clearcam_tpu.tools.latency_probe`` with its flags and
JSON keys. A ``/yolo`` offload request's time splits into measured parts:

  device_step_ms      the YOLOv9-t 640 detect step on one 1080p frame that is
                      already on the card, amortized: 50 calls queued, then
                      one ``torch.cuda.synchronize`` (the card's time, plus
                      whatever host issue the queue cannot hide)
  dispatch_sync_ms    ONE detect call with the frame on the card, and its
                      rows read back (``.cpu()``): the step plus the launch
                      and readback round trip of a single request
  upload_ms           host -> card copy of one 1080p uint8 frame from
                      pageable numpy memory (``torch.from_numpy(frame)
                      .to(dev)``, then a sync)
  e2e_single_ms       numpy frame in -> boxes out, one shot (upload, step,
                      readback)
  http_overhead_ms    POST /yolo round trip on localhost with the device
                      REPLACED by a stub: HTTP parse, session store,
                      scheduling and response cost of server/http.py, the
                      part of the serving stack on top of the model (needs
                      no device)

A served request's p50 is about http_overhead + upload + dispatch_sync. A
closing ``#`` line gives the stem kernel's launches over the device stages.
``--device cpu`` runs the device stages on the CPU (host numbers, not the
card's). Mirrors the reference's offload protocol (Yolo.m:269-403 client).
"""
from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import stem as stem_ops


def _p(vals):
    v = sorted(vals)
    return {"p50_ms": round(1e3 * v[len(v) // 2], 2),
            "p90_ms": round(1e3 * v[int(len(v) * 0.9)], 2),
            "n": len(v)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_http(reps: int = 50, body_px: int = 640) -> dict:
    """HTTP /yolo overhead with a stub detector (no device): localhost
    round trip of a full uint8 frame body through the real server."""
    import urllib.request

    from ..server.http import AppContext, serve
    from ..utils.db import KVStore

    rows = np.zeros((30, 6), np.float32)
    data_dir = tempfile.mkdtemp(prefix="cc_latprobe")
    ctx = AppContext(KVStore(":memory:"), data_dir,
                     offload_detect=lambda img: rows)
    ctx.offload.res = body_px
    server = serve(ctx, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}/yolo"
    body = np.random.default_rng(0).integers(
        0, 255, (body_px, body_px, 3), np.uint8).tobytes()
    try:
        times = []
        sid = None
        for i in range(reps + 5):
            req = urllib.request.Request(url, data=body, method="POST")
            if sid:
                req.add_header("x-session-id", sid)
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=30) as r:
                sid = r.headers.get("x-session-id")
                out = r.read()
            if i >= 5:                         # warmup excluded
                times.append(time.perf_counter() - t0)
        assert len(out) == rows.nbytes
        return {"stage": "http_overhead", "body_mb": round(len(body) / 1e6, 2),
                **_p(times)}
    finally:
        server.shutdown()
        shutil.rmtree(data_dir, ignore_errors=True)


@torch.inference_mode()
def probe_device(reps: int = 30, device="cuda") -> list[dict]:
    """The four device stages with the port's YOLOv9("t", res=640)."""
    from ..models.yolov9 import YOLOv9

    dev = resolve_device(device)
    out = []
    m = YOLOv9("t", res=640, device=dev)
    frame = np.random.default_rng(1).integers(0, 255, (1080, 1920, 3), np.uint8)
    x = torch.from_numpy(frame[None]).to(dev)
    m(x).cpu()                                 # kernel build + warm

    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(50):
        m(x)
    _sync(dev)
    out.append({"stage": "device_step",
                "p50_ms": round(1e3 * (time.perf_counter() - t0) / 50, 2),
                "n": 50, "note": "queue of 50 calls, one sync"})

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m(x).cpu()
        times.append(time.perf_counter() - t0)
    out.append({"stage": "dispatch_sync", **_p(times)})

    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        torch.from_numpy(frame).to(dev)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    out.append({"stage": "upload_1080p", "mb": round(frame.nbytes / 1e6, 2),
                **_p(times)})

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m(frame).cpu()
        times.append(time.perf_counter() - t0)
    out.append({"stage": "e2e_single", **_p(times)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--http-only", action="store_true",
                    help="only the no-device HTTP overhead probe")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="device of the detect stages: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = None if args.http_only else resolve_device(args.device)
    results = [probe_http(args.reps)]
    n0 = stem_ops.stem.launches
    if dev is not None:
        results.extend(probe_device(args.reps, dev))
    for r in results:
        print(json.dumps(r))
    if dev is not None:
        print(f"# launches {json.dumps({'stem': stem_ops.stem.launches - n0})}", flush=True)
    return results


if __name__ == "__main__":
    main()
