"""The port's copies of the JAX package's jax-free host code: each copy is
byte-equal to its source, except the files the port deliberately changed
(``runtime/nvr.py``, ``server/http.py``, ``models/objects.py``,
``models/faces.py``), each of which has a test of what changed here; and the
metrics registry is one, the port's.
"""
import json
import socket
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "clearcam_tpu", ROOT / "clearcam_tpu_torch"

# copied verbatim (one case each); a number is a docstring line the copy
# words differently (the reference's source named without a local path)
COPIED = {f: None for f in (
    "cloud/__init__.py", "cloud/crypto.py", "cloud/federation.py", "cloud/relay.py",
    "io/__init__.py", "io/fmp4.py", "io/gguf.py", "io/ggml_grids.py", "io/h264.py",
    "io/mpegts.py", "io/safetensors.py",
    "runtime/counters.py", "runtime/fswriter.py", "runtime/ingest.py",
    "runtime/metrics.py", "runtime/native_loader.py", "runtime/settings.py",
    "runtime/storage.py", "runtime/zones.py",
    "server/__init__.py", "server/web/cameraview.html", "server/web/mainview.html",
    "track/__init__.py", "track/kalman.py", "track/multicam.py",
    "utils/__init__.py", "utils/annotate.py", "utils/db.py", "utils/labels.py",
    "utils/llm_tokenizer.py", "utils/tokenizer.py",
    "serving/text.py", "serving/constrain.py")}
COPIED["track/ocsort.py"] = 4
CHANGED = ("runtime/nvr.py", "server/http.py", "models/objects.py", "models/faces.py")


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copy_has_not_drifted(rel):
    src, copy = (JAX_PKG / rel).read_bytes(), (PORT_PKG / rel).read_bytes()
    if COPIED[rel] is not None:
        line = COPIED[rel] - 1
        src, copy = src.split(b"\n"), copy.split(b"\n")
        assert b"ocsort_tracker/ocsort.py" in copy[line] and src[line] != copy[line]
        del src[line], copy[line]
    assert copy == src, \
        f"clearcam_tpu_torch/{rel} differs from clearcam_tpu/{rel}: copy it again"


def test_every_host_module_is_covered():
    """Every file under the copied packages is either a checked copy or a
    deliberate change, so a new file cannot slip in unchecked."""
    for sub in ("cloud", "io", "track", "utils", "server"):
        for p in (PORT_PKG / sub).rglob("*"):
            if p.is_file() and "__pycache__" not in p.parts:
                rel = str(p.relative_to(PORT_PKG))
                assert rel in COPIED or rel in CHANGED, rel


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_profile_writes_a_torch_trace(tmp_path):
    """/profile (server/http.py's change) traces with torch.profiler and
    writes a Chrome trace into the trace directory."""
    from clearcam_tpu_torch.server.http import AppContext, serve
    from clearcam_tpu_torch.utils.db import KVStore
    port = _free_port()
    server = serve(AppContext(KVStore(tmp_path / "kv.db"), tmp_path), port=port,
                   host="127.0.0.1")
    try:
        reply = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/profile?seconds=0.2", timeout=60).read())
    finally:
        server.shutdown()
    trace = Path(reply["trace_dir"]) / "trace.json"
    assert trace.parent.parent == tmp_path / "profiles"
    assert "traceEvents" in json.loads(trace.read_text())


def test_summary_engine_is_the_ports(tmp_path):
    """NVR.summary_engine (runtime/nvr.py's change) builds the port's
    VLMServingEngine over a bf16 cache; a multi-device mesh raises."""
    from test_torch_port_qwen3vl import _vlms

    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.serving.engine import ServingEngine
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    from clearcam_tpu_torch.utils.db import KVStore
    _, qwen = _vlms()
    nvr = NVR(KVStore(tmp_path / "kv.db"), tmp_path / "data", qwen=qwen, summary_slots=2,
              use_native_ingest=False)
    try:
        eng = nvr.summary_engine()
        assert isinstance(eng, VLMServingEngine) and isinstance(eng.engine, ServingEngine)
        assert eng.engine.state[0]["k"].dtype == torch.bfloat16
        assert nvr.summary_engine() is eng
        nvr.llm_mesh, nvr._summary_engine = object(), None
        with pytest.raises(NotImplementedError, match="multi-device"):
            nvr.summary_engine()
    finally:
        nvr.stop()


def test_object_finder_searches_like_jax(tmp_path):
    """The port's ObjectFinder (models/objects.py's change: no JAX base
    class) gives the JAX one's search results on the same index of day
    caches: cosine order, per-track dedup, camera and day filters."""
    from clearcam_tpu.models.objects import ObjectFinder as JaxFinder
    from clearcam_tpu_torch.models.objects import ObjectFinder, append_day_cache
    rng = np.random.default_rng(0)
    base = tmp_path / "cameras"
    for cam in ("gate", "yard"):
        for day in ("2026-01-01", "2026-01-02"):
            for i in range(12):
                emb = rng.standard_normal(768).astype(np.float32)
                crop = base / cam / "objects" / day / f"{1000 + i}_{i % 5}_0.jpg"
                append_day_cache(crop.parent / "embeddings.pkl", str(crop),
                                 emb / np.linalg.norm(emb))
    ours, theirs = ObjectFinder(base, device="cpu"), JaxFinder(base)
    assert ours.load_all_embeddings() == theirs.load_all_embeddings() == 48
    for _ in range(4):
        q = rng.standard_normal(768).astype(np.float32)
        for cam, day in ((None, None), ("gate", None), ("yard", "2026-01-02")):
            got = ours.index.search(q, 6, cam, day)
            assert got == theirs.index.search(q, 6, cam, day) and got
    assert not ours.face_enabled and ours.load_all_embeddings(face=True) == 0


def test_face_alignment_is_the_jax_packages():
    """models/faces.py's change: the port's FacePipeline owns the JAX
    package's host alignment (same constants, same code)."""
    import inspect

    from clearcam_tpu.models import faces as jfaces
    from clearcam_tpu_torch.models import faces as tfaces
    for name in ("TARGET_LEFT_EYE", "TARGET_RIGHT_EYE", "MIN_FACE_W", "DETECT_RES"):
        np.testing.assert_array_equal(getattr(tfaces, name), getattr(jfaces, name))
    assert inspect.getsource(tfaces.FacePipeline.extract_face) == \
        inspect.getsource(jfaces.FacePipeline.extract_face)


def test_one_metrics_registry():
    """The port's NVR, engine and server publish to the port's registry;
    none of them reaches the JAX package's."""
    import clearcam_tpu_torch.runtime.nvr as nvr_mod
    import clearcam_tpu_torch.serving.engine as eng_mod
    import clearcam_tpu_torch.server.http as http_mod
    for mod in (nvr_mod, eng_mod, http_mod):
        text = Path(mod.__file__).read_text()
        assert "clearcam_tpu.runtime" not in text
        assert "from ..runtime import metrics" in text or "from . import metrics" in text
