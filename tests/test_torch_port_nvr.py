"""The port's BatchDetector inside the port's NVR, and the port's entry point
`python -m clearcam_tpu_torch`, on the CPU (device="cpu" given explicitly)."""
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import yolov9 as T
from clearcam_tpu_torch.ops import _build
from clearcam_tpu_torch.runtime import metrics
from clearcam_tpu_torch.runtime import nvr as tnvr
from clearcam_tpu_torch.runtime.nvr import NVR, BatchDetector
from clearcam_tpu_torch.runtime.settings import GlobalSettings
from clearcam_tpu_torch.utils.db import KVStore
from clearcam_tpu_torch.testing import torch_threads

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _errors():
    c = metrics.snapshot()["counters"]
    return c.get("detect_errors", 0), c.get("tracker_errors", 0)


def test_batch_detector_in_nvr(tmp_path):
    """YOLOv9-t at 64 px, random weights, two synthetic cameras: the whole
    tick (detect -> track -> postprocess) runs and leaves well-formed rows."""
    db = KVStore(tmp_path / "kv.db")
    db.run_put("links", "cam1", "synthetic://96x64")
    db.run_put("links", "cam2", "synthetic://96x64")
    det = BatchDetector("t", res=64, dtype=torch.float32, device="cpu")
    before = _errors()
    n = NVR(db, tmp_path / "data", GlobalSettings(), detector=det)
    try:
        n.run(max_ticks=6, tick_sleep=0.05)
        assert len(n.cams) == 2
        for cam in n.cams.values():
            assert cam.last_preds.shape[1] == 7      # [x1,y1,x2,y2,s,cls,tid]
            assert np.isfinite(cam.last_preds).all()
    finally:
        n.stop()
    assert _errors() == before


def test_bucketing_and_mixed_shapes(monkeypatch):
    """Same-shape frames share one call padded to a power of two; each frame
    gets the rows it would get alone."""
    det = BatchDetector("dryrun", res=64, dtype=torch.float32, device="cpu")
    assert [det._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, s, np.uint8)
              for s in [(64, 96, 3), (48, 64, 3), (64, 96, 3), (64, 96, 3)]]
    frames[2] = frames[2][..., ::-1]        # a BGR view, as /yolo hands over
    calls = []
    real = T.detect

    def spy(params, batch, **kw):
        calls.append(batch.clone())
        return real(params, batch, **kw)

    monkeypatch.setattr(T, "detect", spy)
    rows = det.detect_many(frames)
    assert [tuple(b.shape) for b in calls] == [(4, 64, 96, 3), (1, 48, 64, 3)]
    # the real frames in order, then the bucket's zero padding
    np.testing.assert_array_equal(calls[0][:3].numpy(),
                                  np.stack([frames[i] for i in (0, 2, 3)]))
    assert not calls[0][3:].any()
    assert all(r.ndim == 2 and r.shape[1] == 6 and r.dtype == np.float32
               for r in rows)
    for f, r in zip(frames, rows):
        alone = det.detect_many([f])[0]
        np.testing.assert_allclose(r, alone, atol=1e-3)


def test_batch_detector_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        BatchDetector("dryrun", res=64)         # default device is cuda
    assert BatchDetector("dryrun", res=64, device="cpu").device.type == "cpu"


def test_batch_detector_fails_at_construction_without_nvcc(monkeypatch, tmp_path):
    """On a CUDA device the stem kernel is built when the detector is made:
    a host without nvcc fails there, not inside NVR.tick (which would count
    detect_errors and carry on detecting nothing)."""
    monkeypatch.setattr(tnvr, "resolve_device", lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        BatchDetector("t", res=64)


def test_library_is_keyed_by_the_toolkit(monkeypatch, tmp_path):
    """The kernel library's name hashes ``nvcc --version`` beside the sources
    and flags (the role the JAX package's utils/jaxcache plays for XLA's
    cache), so a build directory carried to a host with another toolkit
    never loads the other toolkit's library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho \"Cuda compilation tools, release $CC_RELEASE\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CC_RELEASE", "12.9, V12.9.41")
    assert _build.nvcc_version() == "Cuda compilation tools, release 12.9, V12.9.41\n"
    a = _build.library_path()
    assert _build.library_path() == a and a.parent == _build.BUILD_DIR
    monkeypatch.setenv("CC_RELEASE", "12.8, V12.8.93")
    b = _build.library_path()
    assert b != a and b.parent == a.parent
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, "
                        "release 12.9, V12.9.41\n")
    assert _build.library_path() == a


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get_json(url):
    return json.loads(urllib.request.urlopen(url, timeout=5).read())


@contextlib.contextmanager
def _server(tmp_path, **env_extra):
    """`python -m clearcam_tpu_torch --device cpu` on tmp_path's data,
    up and answering /healthz; yields (base URL, a dict whose "out" is the
    server's output once it has shut down)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="2", **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "clearcam_tpu_torch", "--port", str(port),
         "--data", str(tmp_path), "--weights", str(tmp_path / "weights"),
         "--device", "cpu"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    result = {}
    try:
        deadline = time.time() + 60
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                health = _get_json(f"{base}/healthz")
                break
            except OSError:
                assert time.time() < deadline, "server never came up"
                time.sleep(0.3)
        assert health["ok"] is True
        yield base, result
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            result["out"], _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            result["out"], _ = proc.communicate(timeout=10)


def test_main_boots_on_cpu_and_detects(tmp_path):
    """`python -m clearcam_tpu_torch --device cpu`: NVR ticks through the
    port's detector, /yolo offload answers float32[N,6], no detect errors,
    and the stem launch count is reported at shutdown (0 on the CPU)."""
    db = KVStore(tmp_path / "cc_cache.db")
    db.run_put("links", "cam1", "synthetic://96x64")
    db.run_put("global_settings", "all", GlobalSettings(model_size="t", model_res=64))
    with _server(tmp_path) as (base, result):
        frame = np.random.default_rng(0).integers(0, 256, (640, 640, 3), np.uint8)
        req = urllib.request.Request(f"{base}/yolo", data=frame.tobytes(),
                                     method="POST")
        body = urllib.request.urlopen(req, timeout=30).read()
        assert len(body) % 24 == 0 and len(body) > 0
        rows = np.frombuffer(body, np.float32).reshape(-1, 6)
        assert np.isfinite(rows).all()
        deadline = time.time() + 30
        while True:
            snap = _get_json(f"{base}/metrics")
            if snap["timers"].get("detect_step", {}).get("count", 0) >= 3:
                break
            assert time.time() < deadline, snap
            time.sleep(0.3)
        assert not snap["counters"].get("detect_errors")
        assert not snap["counters"].get("tracker_errors")
    out = result["out"]
    assert "stem kernel on (plain)" in out, out
    assert "stem.launches=0" in out.splitlines(), out


MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>")]


def _small_clip_checkpoint(path):
    """Published-format CLIP weights (patch filter OIHW) at full width, cut
    to one block per tower and 1,024 token rows (the tiny merge table's ids
    stay below 522), so a CPU server loads them in a second. Returns the
    numpy params the port converts them to."""
    from clearcam_tpu_torch.io import safetensors as st
    from clearcam_tpu_torch.models import clip as tclip
    from clearcam_tpu_torch.nn import functional as F
    p = tclip.init_params(seed=3, img_blocks=1, txt_blocks=1)
    p["token_embedding.weight"] = p["token_embedding.weight"][:1024]
    sd = dict(p, **{tclip.PATCH_KEY: F.hwio_to_oihw(p[tclip.PATCH_KEY])})
    path.parent.mkdir(parents=True, exist_ok=True)
    st.save(sd, path)
    return tclip.convert_state_dict(st.load(path))


def test_main_serves_clip_search_on_cpu(tmp_path):
    """use_clip on: the entry point builds the port's ObjectFinder, loads the
    CLIP checkpoint, and /v1/embeddings and an uploaded-image search answer
    through it; its startup line names the dtype, device and the plain
    attention route, and the attention launch count is 0 on the CPU."""
    import base64
    import gzip

    import cv2

    from clearcam_tpu_torch.utils.tokenizer import CLIPTokenizer
    from clearcam_tpu_torch.models.objects import CLIP_WEIGHTS, ObjectFinder

    params = _small_clip_checkpoint(tmp_path / "weights" / CLIP_WEIGHTS)
    vocab = tmp_path / "merges.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        # no trailing newline: the reader takes every line after the header
        f.write("#version: test\n" + "\n".join(" ".join(m) for m in MERGES))
    KVStore(tmp_path / "cc_cache.db").run_put(
        "global_settings", "all", GlobalSettings(model_res=64, use_clip=True))
    texts = ["hello", "world"]
    with _server(tmp_path, CLEARCAM_BPE_PATH=str(vocab)) as (base, result):
        req = urllib.request.Request(
            f"{base}/v1/embeddings", data=json.dumps({"input": texts}).encode(),
            method="POST")
        data = json.loads(urllib.request.urlopen(req, timeout=60).read())["data"]
        crop = np.random.default_rng(1).integers(0, 256, (90, 60, 3), np.uint8)
        jpeg = base64.b64encode(cv2.imencode(".jpg", crop)[1].tobytes()).decode()
        req = urllib.request.Request(
            f"{base}/event_thumbs", method="POST",
            data=json.dumps({"uploaded_image": jpeg}).encode())
        found = json.loads(urllib.request.urlopen(req, timeout=60).read())
    out = result["out"]
    embs = np.asarray([d["embedding"] for d in data], np.float32)
    assert embs.shape == (2, 768)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=-1), 1.0, atol=1e-5)
    ref = ObjectFinder(device="cpu")
    ref.init_clip(params=params)
    ref._tok = CLIPTokenizer(merges=MERGES)
    np.testing.assert_allclose(embs, ref.embed_texts(texts), rtol=0, atol=1e-5)
    assert found == {"images": [], "count": 0}, found     # nothing indexed yet
    assert "clip: ViT-L/14 torch.float32 on cpu; attention kernel plain" in out, out
    assert "vit_attention.launches=0" in out.splitlines(), out
