"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives clearcam_tpu_torch's paths, the NVR detect tick (YOLOv9-t, res
640, random weights from seed 0) and the NVR's object search (CLIP
ViT-L/14 image and text towers, BlazeFace and AdaFace IR-50, random
weights from seed 0), and the hand-written kernels (stem, ViT attention)
on the card. Every phase raises on failure, so the script exits non-zero:

  0  the card: nvidia-smi name and power limit, torch, nvcc; TF32 off
  1  build csrc/*.cu with nvcc for sm_90a, timed
  2  stem kernel vs its plain version (stem_reference, cuDNN) at the main
     path's shapes: bf16 max|d| < 0.05, f32 max|d| < 1e-4; timed with CUDA
     events
  3  YOLOv9-t 640 on 8 random 1080p frames: GPU f32 vs CPU f32 (forward_raw
     rtol/atol 2e-3, NMS on one head output, detect rows under
     clearcam_tpu_torch.testing's rule), the bf16 default path through
     BatchDetector, and frames/s at batch 1, 8, 32
  4  `python -m clearcam_tpu_torch` on an empty data directory, set up
     through its API as a user does (/edit_settings to YOLOv9-t 640, then
     use_clip and use_face on; /add_camera for two synthetic 1080p
     cameras): /healthz, one /yolo offload request, /metrics (detect_step
     >= 3, no detect or tracker errors), /v1/embeddings (768-d unit rows,
     with a small synthetic BPE merge table), an uploaded-image search,
     and, where the NVR saved object crops, their embeddings.pkl and a
     similar_img search that finds the crop itself first; stem and
     vit_attention launches reported at shutdown
  5  ViT attention kernel vs its plain version (mha_reference) at the CLIP
     tower's shapes and the Qwen3-VL vision lengths: f32 max|d| < 1e-4
     (TF32 off), bf16 max|d| < 2e-2; timed with CUDA events
  6  the towers on the card against the CPU, f32: ViT-L/14 (24 blocks,
     through the kernel) and the text tower (12 blocks), cosine > 1 - 1e-5
     per row; BlazeFace detect and IR-50 AdaFace embed; image-tower img/s
     at batch 1, 16, 64 with the kernel and with the plain attention

The line before the last is the card's name and power limit; before it, a
JSON line with each kernel's launches on a served path (phase 4), its
error against the plain version and both times. The last line is
{"ok": true, "device": {...}}. Without CUDA, or outside the repository, it
exits non-zero and prints no result.

`--phases 0,1,2` runs a subset (the last line is then not printed).
"""
from __future__ import annotations

import argparse
import base64
import gzip
import json
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BF16_TOL, F32_TOL = 0.05, 1e-4      # stem kernel vs plain, max |d|
RAW_TOL = 2e-3                      # forward_raw GPU vs CPU, rtol and atol
STEM_SOURCE = "clearcam_tpu_torch/csrc/stem.cu"
STEM_REPLACES = "clearcam_tpu/ops/stem.py:149"
ATTN_SOURCE = "clearcam_tpu_torch/csrc/vit_attention.cu"
ATTN_REPLACES = "clearcam_tpu/ops/vit_attention.py:54"
# attention kernel vs plain, max |d|: f32 differs by summation order and
# exp2 vs exp only; in bf16 the plain version rounds the probabilities to
# bf16 before the PV product
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# one CROP_BATCH of crops, one crop, and ragged lengths up to the Qwen3-VL
# vision tower's 784 and 1600
ATTN_SHAPES = [(16, 16, 257, 64), (1, 16, 257, 64)] + [
    (2, 16, t, 64) for t in (1, 7, 128, 129, 784, 1600)]
TOWER_COS = 1 - 1e-5                # towers, GPU vs CPU, cosine per row
# BPE merges for the server's tokenizer: the real vocab is not in the repo
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>")]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------

def phase0(torch):
    log("== phase 0: the card")
    log(f"nvidia-smi: {smi_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from clearcam_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN and matmul: f32 comparisons are full f32")


def phase1():
    log("== phase 1: build csrc/*.cu for sm_90a")
    from clearcam_tpu_torch.ops import _build
    _build.load()
    b = _build.last_build
    log(f"build: {b['seconds']:.2f} s ({'cached' if b['cached'] else 'nvcc'}) "
        f"-> {Path(b['path']).relative_to(ROOT)}")
    for line in b["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    return b["seconds"]


def _stem_inputs(torch, shape, dtype, seed):
    """Letterbox-like input in [0,1] and the stem's operands as the model
    passes them (models.yolov9.params_from_jax): values rounded to `dtype`,
    held as float32 HWIO."""
    from clearcam_tpu_torch.models import yolov9
    p = yolov9.init_params("t", seed=0)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(shape, np.float32)).to("cuda", dtype)
    # random biases so the bias path is exercised (init_params gives zeros)
    ws = [p["model.0.conv.weight"], rng.normal(0, 0.1, 16).astype(np.float32),
          p["model.1.conv.weight"], rng.normal(0, 0.1, 32).astype(np.float32)]
    return (x, *(torch.from_numpy(w).cuda().to(dtype).float().contiguous() for w in ws))


def _plain_pair(torch, x, w1, b1, w2, b2):
    """The plain version as the model runs a stem without the kernel: two
    cuDNN convs + SiLU on weights packed once (OIHW, channels_last, x's
    dtype), so neither side's time holds per-call weight packing."""
    from clearcam_tpu_torch.nn import functional as F
    cl = torch.channels_last
    pw1, pw2 = (F.hwio_to_oihw(w).to(x.dtype).contiguous(memory_format=cl)
                for w in (w1, w2))
    pb1, pb2 = b1.to(x.dtype), b2.to(x.dtype)

    def plain():
        y = F.silu(F.conv2d_oihw(x, pw1, pb1, stride=2, padding=1))
        return F.silu(F.conv2d_oihw(y, pw2, pb2, stride=2, padding=1))
    return plain


def phase2(torch):
    log("== phase 2: stem kernel vs plain (cuDNN pair) on the card")
    from clearcam_tpu_torch.ops.stem import out_hw, stem, stem_reference
    max_err = 0.0
    cases = [((1, 384, 640, 3), torch.bfloat16, BF16_TOL),
             ((8, 384, 640, 3), torch.bfloat16, BF16_TOL),
             ((2, 100, 68, 3), torch.float32, F32_TOL),
             ((2, 640, 640, 3), torch.float32, F32_TOL)]
    for i, (shape, dtype, tol) in enumerate(cases):
        args = _stem_inputs(torch, shape, dtype, seed=i)
        got = stem(*args)
        ref = stem_reference(*args)
        torch.cuda.synchronize()
        h2, w2 = out_hw(shape[1], shape[2])
        if tuple(got.shape) != (shape[0], h2, w2, 32) or got.dtype != dtype:
            raise AssertionError(f"stem {shape}: got {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        log(f"stem {list(shape)} {str(dtype)[6:]}: max|kernel - plain| = {err:.3e} "
            f"(bound {tol})")
        if not err < tol:
            raise AssertionError(f"stem {shape} {dtype}: max|d| {err} >= {tol}")
    times = {}
    for b in (8, 128):
        args = _stem_inputs(torch, (b, 384, 640, 3), torch.bfloat16, seed=9)
        plain = _plain_pair(torch, *args)
        err = (stem(*args).float() - plain().float()).abs().max().item()
        if not err < BF16_TOL:
            raise AssertionError(f"stem [{b},384,640,3]: timed plain pair off by {err}")
        # plain, kernel, kernel, plain: drift on the card hits both alike
        p1 = cuda_ms(plain)
        k1 = cuda_ms(lambda: stem(*args))
        k2 = cuda_ms(lambda: stem(*args))
        p2 = cuda_ms(plain)
        times[b] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"stem [{b},384,640,3] bf16: kernel {times[b][0]:.4f} ms "
            f"(runs {k1:.4f}, {k2:.4f}), plain {times[b][1]:.4f} ms "
            f"(runs {p1:.4f}, {p2:.4f}), {b / times[b][0] * 1e3:.0f} vs "
            f"{b / times[b][1] * 1e3:.0f} frames/s")
        del args, plain
    return max_err, times


def phase3(torch):
    log("== phase 3: YOLOv9-t res 640 on 1080p frames")
    from clearcam_tpu_torch.models import yolov9
    from clearcam_tpu_torch.ops import image
    from clearcam_tpu_torch.ops.nms import yolo_postprocess
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    from clearcam_tpu_torch.testing import compared_rows, detection_mismatches

    params = yolov9.init_params("t", seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (8, 1080, 1920, 3), np.uint8)
    out = {}
    with torch.inference_mode():
        p_gpu = yolov9.params_from_jax(params, "cuda", torch.float32)
        p_cpu = yolov9.params_from_jax(params, "cpu", torch.float32)
        f_gpu, f_cpu = torch.from_numpy(frames).cuda(), torch.from_numpy(frames)
        x_gpu = image.letterbox(f_gpu, 640)
        x_cpu = image.letterbox(f_cpu, 640)
        log(f"letterbox 1080p -> {list(x_gpu.shape)}")
        raw_gpu = yolov9.forward_raw(p_gpu, x_gpu, "t").cpu().numpy()
        raw_cpu = yolov9.forward_raw(p_cpu, x_cpu, "t").numpy()
        np.testing.assert_allclose(raw_gpu, raw_cpu, rtol=RAW_TOL, atol=RAW_TOL)
        log(f"forward_raw f32 GPU vs CPU: max|d| {np.abs(raw_gpu - raw_cpu).max():.3e} "
            f"(rtol = atol = {RAW_TOL})")
        # NMS alone, fed the same head output on both devices: random weights
        # put every score near 0.5, so the tie rule below compares few rows
        n_gpu = yolo_postprocess(torch.from_numpy(raw_gpu).cuda()).cpu().numpy()
        n_cpu = yolo_postprocess(torch.from_numpy(raw_gpu)).numpy()
        np.testing.assert_allclose(n_gpu, n_cpu, rtol=0, atol=1e-4)
        log(f"yolo_postprocess on one head output, GPU vs CPU: rows equal "
            f"({int((n_cpu[..., 4] > 0).sum())} live)")
        d_gpu = yolov9.detect(p_gpu, f_gpu, size="t", res=640).cpu().numpy()
        d_cpu = yolov9.detect(p_cpu, f_cpu, size="t", res=640).numpy()
        bad = detection_mismatches(d_cpu, d_gpu)
        if bad:
            raise AssertionError("detect f32 GPU vs CPU:\n" + "\n".join(bad[:20]))
        log(f"detect f32 GPU vs CPU: rows agree ({int((d_cpu[..., 4] > 0).sum())} "
            f"live, {compared_rows(d_cpu)} clear of ties compared)")

        det = BatchDetector("t", 640, params=params, dtype=torch.bfloat16, device="cuda")
        det.detect_many(list(frames[:1]))          # warm up the shapes
        stem.launches = 0
        rows = det.detect_many(list(frames))
        launches = stem.launches
        if launches < 1:
            raise AssertionError("bf16 BatchDetector never launched the stem kernel")
        if not all(r.shape == (300, 6) and np.isfinite(r).all() for r in rows):
            raise AssertionError("bf16 BatchDetector rows not finite [300, 6]")
        log(f"BatchDetector bf16: 8 frames -> finite [300,6] rows, "
            f"{int(sum((r[:, 4] > 0).sum() for r in rows))} live; "
            f"stem launches {launches}")

        p_bf16 = det.params
        for b in (1, 8, 32):
            fb = torch.from_numpy(
                np.random.default_rng(b).integers(0, 256, (b, 1080, 1920, 3), np.uint8)).cuda()
            ms = cuda_ms(lambda: yolov9.detect(p_bf16, fb, size="t", res=640,
                                               compute_dtype=torch.bfloat16),
                         iters=10, warmup=3)
            host = [f.cpu().numpy() for f in fb]
            det.detect_many(host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                det.detect_many(host)
            e2e = (time.perf_counter() - t0) / 3
            out[b] = (b / ms * 1e3, b / e2e)
            log(f"detect bf16 batch {b}: {ms:.3f} ms/step on device = "
                f"{out[b][0]:.1f} frames/s (frames resident); detect_many "
                f"(numpy in, rows out) {e2e * 1e3:.3f} ms = {out[b][1]:.1f} frames/s")
            del fb, host
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url: str, timeout: float = 5.0) -> bytes:
    return urllib.request.urlopen(url, timeout=timeout).read()


def _post(url: str, body: bytes, timeout: float = 5.0) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def _wait(what: str, until, proc, log_path: Path, seconds: float):
    """Poll `until()` until it gives a truthy value; fail if the server
    exits or `seconds` pass."""
    deadline = time.time() + seconds
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"server exited rc={proc.returncode} waiting for "
                                 f"{what}:\n" + log_path.read_text()[-4000:])
        try:
            got = until()
        except OSError:
            got = None
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError(f"no {what} within {seconds} s:\n"
                                 + log_path.read_text()[-4000:])
        time.sleep(0.5)


def phase4():
    log("== phase 4: python -m clearcam_tpu_torch, two synthetic 1080p cameras")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    vocab = tmp / "merges.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        # no trailing newline: the reader takes every line after the header
        f.write("#version: smoke\n" + "\n".join(" ".join(m) for m in MERGES))
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
               CLEARCAM_BPE_PATH=str(vocab))
    out_path = tmp / "server.log"
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clearcam_tpu_torch", "--port", str(port),
             "--data", str(tmp / "data"), "--weights", str(tmp / "weights")],
            env=env, cwd=str(tmp), stdout=out, stderr=subprocess.STDOUT)
    try:
        health = _wait("/healthz", lambda: json.loads(_get(f"{base}/healthz", 2)),
                       proc, out_path, 300)
        log(f"/healthz: {health}")

        # configure as a user does, through the API: model size and
        # resolution (the detector is rebuilt), then the two cameras
        _post(f"{base}/edit_settings",
              json.dumps({"model_size": "t", "model_res": 640}).encode())
        line = _wait("detector rebuilt at res 640", lambda: re.search(
            r"^detector: YOLOv9-t res 640 .*$", out_path.read_text(), re.M),
            proc, out_path, 120).group(0)
        log(f"/edit_settings -> {line}")
        if "stem kernel on (CUDA" not in line:
            raise AssertionError(f"the detector does not run the stem kernel: {line}")
        for cam in ("cam1", "cam2"):
            q = urllib.parse.urlencode({"cam_name": cam, "src": "synthetic://1920x1080"})
            _get(f"{base}/add_camera?{q}")
        log("/add_camera: cam1, cam2 = synthetic://1920x1080")

        img = np.random.default_rng(5).integers(0, 256, (640, 640, 3), np.uint8)
        body = _post(f"{base}/yolo", img.tobytes(), timeout=120)
        if len(body) % 24:
            raise AssertionError(f"/yolo reply of {len(body)} bytes is not float32[N,6]")
        rows = np.frombuffer(body, np.float32).reshape(-1, 6)
        if not np.isfinite(rows).all():
            raise AssertionError("/yolo rows not finite")
        log(f"/yolo: float32{list(rows.shape)}, {int((rows[:, 4] > 0).sum())} live")

        def three_steps():
            snap = json.loads(_get(f"{base}/metrics"))
            steps = snap["timers"].get("detect_step", {}).get("count", 0)
            return snap if steps >= 3 else None
        snap = _wait("detect_step count >= 3", three_steps, proc, out_path, 180)
        counters = snap["counters"]
        for bad in ("detect_errors", "tracker_errors"):
            if counters.get(bad):
                raise AssertionError(f"{bad}={counters[bad]}:\n"
                                     + out_path.read_text()[-4000:])
        log(f"/metrics: detect_step {snap['timers']['detect_step']}, "
            f"counters {counters}")
        search = _object_search(base, tmp / "data" / "cameras", proc, out_path)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    text = out_path.read_text()
    shutil.rmtree(tmp, ignore_errors=True)
    for line in text.splitlines():
        log(f"  server| {line}")
    if "object queue error" in text:
        raise AssertionError("the NVR's crop ingest raised (see the server log)")
    launches = {}
    for name, what in (("stem", "the NVR detect path"),
                       ("vit_attention", "the object-search path")):
        m = re.search(rf"^{name}\.launches=(\d+)$", text, re.M)
        if m is None:
            raise AssertionError(f"server printed no {name}.launches line")
        launches[name] = int(m.group(1))
        if launches[name] < 1:
            raise AssertionError(f"{what} never launched the {name} kernel")
    log(f"launches on the served paths: {launches}; object search: {search}")
    return launches


def _object_search(base: str, cameras: Path, proc, out_path: Path) -> dict:
    """CLIP and faces turned on over HTTP; then the text tower, an
    uploaded-image search, and the crops the NVR saved and embedded."""
    import cv2
    t0 = time.time()
    # the web UI posts every setting: the detector's stay as they are
    _post(f"{base}/edit_settings", json.dumps(
        {"model_size": "t", "model_res": 640, "use_clip": True,
         "use_face": True}).encode(), timeout=600)
    line = _wait("the CLIP line", lambda: re.search(
        r"^clip: ViT-L/14 .*$", out_path.read_text(), re.M),
        proc, out_path, 600).group(0)
    log(f"/edit_settings use_clip, use_face ({time.time() - t0:.1f} s) -> {line}")
    if "attention kernel CUDA" not in line:
        raise AssertionError(f"the CLIP tower does not run the attention kernel: {line}")

    data = json.loads(_post(f"{base}/v1/embeddings", json.dumps(
        {"input": ["hello world", "hello"]}).encode(), timeout=120))["data"]
    embs = np.asarray([d["embedding"] for d in data], np.float32)
    norms = np.linalg.norm(embs, axis=-1)
    if embs.shape != (2, 768) or not np.isfinite(embs).all() \
            or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"/v1/embeddings: {embs.shape}, norms {norms}")
    log(f"/v1/embeddings: 2 rows of {embs.shape[1]}, norms {norms.tolist()}")

    crop = np.random.default_rng(7).integers(0, 256, (120, 80, 3), np.uint8)
    jpeg = base64.b64encode(cv2.imencode(".jpg", crop)[1].tobytes()).decode()
    found = json.loads(_post(f"{base}/event_thumbs", json.dumps(
        {"uploaded_image": jpeg}).encode(), timeout=120))
    if not isinstance(found.get("images"), list):
        raise AssertionError(f"/event_thumbs uploaded_image: {found}")
    log(f"/event_thumbs uploaded_image: {found['count']} results")
    out = {"uploaded_image_results": found["count"]}

    def embedded():
        """(day cache, its crop paths) once one reads whole."""
        for pkl in sorted(cameras.glob("*/objects/*/embeddings.pkl")):
            try:
                with open(pkl, "rb") as f:
                    return pkl, list(pickle.load(f)["embeddings"])
            except (EOFError, pickle.UnpicklingError, KeyError):
                pass        # being rewritten by the NVR
        return None
    try:
        pkl, keys = _wait("an embeddings.pkl of saved crops", embedded, proc,
                          out_path, 120)
    except AssertionError:
        crops = sorted(cameras.glob("*/objects/*/*.jpg"))
        if crops:
            raise AssertionError(f"{len(crops)} crops saved, none embedded:\n"
                                 + out_path.read_text()[-4000:])
        log("no object crops saved within 120 s: similar_img not checked")
        return dict(out, crops_saved=0)
    rel = Path(keys[0]).resolve().relative_to(cameras.resolve())
    found = json.loads(_post(f"{base}/event_thumbs", json.dumps(
        {"similar_img": str(rel)}).encode(), timeout=120))
    top = (found.get("images") or [{}])[0]
    if abs(top.get("score", 0) - 1.0) > 1e-4:
        raise AssertionError(f"similar_img {rel}: {found}")
    if top["url"] != f"/{rel}":
        # a static scene saves the same pixels twice; either copy may lead
        same = np.array_equal(cv2.imread(str(cameras / rel)),
                              cv2.imread(str(cameras / top["url"].lstrip("/"))))
        if not same:
            raise AssertionError(f"similar_img {rel}: first is {top}")
        log(f"similar_img {rel}: first is {top['url']}, the same pixels")
    n_crops = len(list(cameras.glob("*/objects/*/*.jpg")))
    n_faces = len(list(cameras.glob("*/faces/*/*.jpg")))
    log(f"crops saved {n_crops}, embedded in {pkl.parent.name}: {len(keys)}; "
        f"faces saved {n_faces}; similar_img {rel} -> itself first, score "
        f"{found['images'][0]['score']}")
    return dict(out, crops_saved=n_crops, embedded=len(keys), faces_saved=n_faces,
                similar_score=found["images"][0]["score"])


def _qkv(torch, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)
            for _ in range(3)]


def phase5(torch):
    log("== phase 5: ViT attention kernel vs plain (mha_reference) on the card")
    from clearcam_tpu_torch.ops.vit_attention import mha_flash, mha_reference
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for i, shape in enumerate(ATTN_SHAPES):
            q, k, v = _qkv(torch, shape, dtype, seed=i)
            got = mha_flash(q, k, v)
            ref = mha_reference(q, k, v)
            torch.cuda.synchronize()
            if tuple(got.shape) != shape or got.dtype != dtype:
                raise AssertionError(f"attention {shape}: got {tuple(got.shape)} {got.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            max_err[name] = max(max_err.get(name, 0.0), err)
            log(f"attention {list(shape)} {name}: max|kernel - plain| = {err:.3e} "
                f"(bound {ATTN_TOL[name]})")
            if not err < ATTN_TOL[name]:
                raise AssertionError(f"attention {shape} {name}: max|d| {err} >= "
                                     f"{ATTN_TOL[name]}")
    times = {}
    for b, dtype in ((16, torch.float32), (64, torch.float32), (16, torch.bfloat16)):
        q, k, v = _qkv(torch, (b, 16, 257, 64), dtype, seed=b)
        # plain, kernel, kernel, plain: drift on the card hits both alike
        p1 = cuda_ms(lambda: mha_reference(q, k, v))
        k1 = cuda_ms(lambda: mha_flash(q, k, v))
        k2 = cuda_ms(lambda: mha_flash(q, k, v))
        p2 = cuda_ms(lambda: mha_reference(q, k, v))
        key = (b, str(dtype)[6:])
        times[key] = ((k1 + k2) / 2, (p1 + p2) / 2)
        flop = 4 * b * 16 * 257 * 257 * 64
        log(f"attention [{b},16,257,64] {key[1]}: kernel {times[key][0]:.4f} ms "
            f"(runs {k1:.4f}, {k2:.4f}) = {flop / times[key][0] / 1e9:.1f} TFLOP/s, "
            f"plain {times[key][1]:.4f} ms (runs {p1:.4f}, {p2:.4f})")
    return max_err, times


def _cos_rows(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _tower_check(what, got, ref):
    cos = _cos_rows(got, ref)
    log(f"{what} GPU vs CPU: cosine min {cos.min():.9f}, max|d| "
        f"{np.abs(got - ref).max():.3e} (bound cosine > {TOWER_COS})")
    if not (np.isfinite(got).all() and cos.min() > TOWER_COS):
        raise AssertionError(f"{what}: cosine {cos}")


def phase6(torch):
    log("== phase 6: CLIP ViT-L/14, text tower, BlazeFace, IR-50 on the card vs CPU (f32)")
    from clearcam_tpu_torch.models import adaface, blazeface, clip
    from clearcam_tpu_torch.ops.vit_attention import mha_flash

    t0 = time.time()
    params = clip.init_params(seed=0)
    log(f"clip.init_params(seed=0): {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (2, 224, 224, 3), np.uint8)
    toks = np.zeros((2, 77), np.int64)
    toks[0, :4] = [49406, 320, 1929, 49407]
    toks[1, :6] = [49406, 1237, 530, 518, 2368, 49407]
    fps = {}
    with torch.inference_mode():
        p_gpu = clip.params_from_jax(params, "cuda")
        p_cpu = clip.params_from_jax(params, "cpu")
        before = mha_flash.launches
        got = clip.encode_image(p_gpu, torch.from_numpy(px).cuda()).cpu().numpy()
        if mha_flash.launches - before != clip.IMG_BLOCKS:
            raise AssertionError(f"image tower: {mha_flash.launches - before} "
                                 f"kernel launches, not {clip.IMG_BLOCKS}")
        _tower_check("ViT-L/14 image tower (24 blocks, kernel)", got,
                     clip.encode_image(p_cpu, torch.from_numpy(px)).numpy())
        _tower_check("text tower (12 blocks)",
                     clip.encode_text(p_gpu, torch.from_numpy(toks).cuda()).cpu().numpy(),
                     clip.encode_text(p_cpu, torch.from_numpy(toks)).numpy())
        del p_cpu

        # BlazeFace filters scaled by 0.5: He-initialised random weights blow
        # activations up to ~1e8 through 31 residual blocks; at 0.5 they stay
        # O(1) and some scores clear the 0.85 floor
        bp = {k: (v * 0.5 if v.ndim == 4 else v)
              for k, v in blazeface.init_params(seed=0).items()}
        img = rng.integers(0, 256, (256, 256, 3), np.uint8)
        d_gpu = blazeface.detect(blazeface.params_from_jax(bp, "cuda"),
                                 torch.from_numpy(img).cuda()).cpu().numpy()
        d_cpu = blazeface.detect(blazeface.params_from_jax(bp, "cpu"),
                                 torch.from_numpy(img)).numpy()
        live = d_cpu[:, 16] > 0
        if not np.array_equal(d_gpu[:, 16] > 0, live) or \
                np.abs(d_gpu - d_cpu).max() > 1e-2:
            raise AssertionError(f"BlazeFace detect GPU vs CPU: live "
                                 f"{(d_gpu[:, 16] > 0).sum()} vs {live.sum()}, max|d| "
                                 f"{np.abs(d_gpu - d_cpu).max()}")
        log(f"BlazeFace detect GPU vs CPU: the same {int(live.sum())} live rows, "
            f"max|d| {np.abs(d_gpu - d_cpu).max():.3e} px (bound 1e-2)")
        ap = adaface.init_params(seed=0)
        faces = torch.from_numpy(rng.integers(0, 256, (4, 112, 112, 3), np.uint8))
        _tower_check("AdaFace IR-50 (24 blocks)",
                     adaface.embed(adaface.params_from_jax(ap, "cuda"), faces.cuda()).cpu().numpy(),
                     adaface.embed(adaface.params_from_jax(ap, "cpu"), faces).numpy())

        for b in (1, 16, 64):
            x = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3), np.uint8)).cuda()
            runs = {}
            for flash in (False, None, None, False):
                ms = cuda_ms(lambda: clip.encode_image(p_gpu, x, flash=flash),
                             iters=5, warmup=2)
                runs.setdefault(flash, []).append(ms)
            kern, plain = (float(np.mean(runs[f])) for f in (None, False))
            fps[b] = (b / kern * 1e3, b / plain * 1e3)
            log(f"image tower f32 batch {b}: kernel {kern:.3f} ms = {fps[b][0]:.1f} "
                f"img/s (runs {runs[None]}), plain attention {plain:.3f} ms = "
                f"{fps[b][1]:.1f} img/s (runs {runs[False]})")
            del x
    return fps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6",
                    help="comma-separated subset of phases to run")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    try:
        import clearcam_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the repository root ({e})")

    t0 = time.time()
    build_s = max_err = times = fps = launches = attn_err = attn_times = clip_fps = None
    if 0 in phases:
        phase0(torch)
    if 1 in phases:
        build_s = phase1()
    if 2 in phases:
        max_err, times = phase2(torch)
    if 3 in phases:
        fps = phase3(torch)
    if 4 in phases:
        launches = phase4()
    if 5 in phases:
        attn_err, attn_times = phase5(torch)
    if 6 in phases:
        clip_fps = phase6(torch)
    log(f"== done in {time.time() - t0:.1f} s; build {build_s} s; detect fps {fps}; "
        f"image tower img/s (kernel, plain) {clip_fps}")
    if phases != {0, 1, 2, 3, 4, 5, 6}:
        return 0
    # the attention row: f32, the CLIP tower's dtype; times at one CROP_BATCH
    print(json.dumps({"kernels": [
        {"name": "stem", "route": "cuda", "source": STEM_SOURCE,
         "replaces": STEM_REPLACES, "launches": launches["stem"],
         "max_abs_err": max_err, "ms": times[8][0], "plain_ms": times[8][1]},
        {"name": "vit_attention", "route": "cuda", "source": ATTN_SOURCE,
         "replaces": ATTN_REPLACES, "launches": launches["vit_attention"],
         "max_abs_err": attn_err["float32"], "ms": attn_times[(16, "float32")][0],
         "plain_ms": attn_times[(16, "float32")][1]}]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
