"""The port's copies of the JAX package's jax-free host code: each copy is
byte-equal to its source, except the files the port deliberately changed
(``runtime/nvr.py``, ``server/http.py``, ``models/objects.py``,
``models/faces.py``, ``utils/db.py``), each of which has a test of what
changed here; and the metrics registry is one, the port's.
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

# copied verbatim (one case each); a dict maps each comment or docstring line
# the copy words differently (naming no local path or host) to a phrase that
# line keeps
COPIED = {f: None for f in (
    "cloud/__init__.py", "cloud/crypto.py", "cloud/federation.py", "cloud/relay.py",
    "cloud/viewer.py", "tools/clip_cli.py", "tools/uicheck.py",
    "jsengine/__init__.py", "jsengine/check.py", "jsengine/dom.py", "jsengine/es.py",
    "jsengine/interp.py",
    "io/__init__.py", "io/fmp4.py", "io/gguf.py", "io/ggml_grids.py", "io/h264.py",
    "io/mpegts.py", "io/safetensors.py",
    "runtime/counters.py", "runtime/fswriter.py", "runtime/ingest.py",
    "runtime/metrics.py", "runtime/native_loader.py", "runtime/settings.py",
    "runtime/storage.py", "runtime/zones.py",
    "server/__init__.py", "server/web/cameraview.html", "server/web/mainview.html",
    "track/__init__.py", "track/kalman.py", "track/multicam.py",
    "utils/__init__.py", "utils/annotate.py", "utils/labels.py",
    "utils/llm_tokenizer.py", "utils/tokenizer.py",
    "serving/text.py", "serving/constrain.py")}
COPIED["track/ocsort.py"] = {4: b"ocsort_tracker/ocsort.py"}
COPIED["jsengine/__init__.py"] = {3: b"have no browser, node, or any JS",
                                  23: b"clearcam.py:960-988) and never tests it"}
COPIED["jsengine/dom.py"] = {1283: b"API ----"}
CHANGED = ("runtime/nvr.py", "server/http.py", "models/objects.py", "models/faces.py",
           "utils/db.py")


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copy_has_not_drifted(rel):
    src, copy = (JAX_PKG / rel).read_bytes(), (PORT_PKG / rel).read_bytes()
    if COPIED[rel] is not None:
        src, copy = src.split(b"\n"), copy.split(b"\n")
        for line, phrase in sorted(COPIED[rel].items(), reverse=True):
            assert phrase in copy[line - 1] and src[line - 1] != copy[line - 1]
            assert phrase in src[line - 1]
            del src[line - 1], copy[line - 1]
    assert copy == src, \
        f"clearcam_tpu_torch/{rel} differs from clearcam_tpu/{rel}: copy it again"


def test_every_host_module_is_covered():
    """Every file under the copied packages is either a checked copy or a
    deliberate change, so a new file cannot slip in unchecked."""
    for sub in ("cloud", "io", "track", "utils", "server", "jsengine"):
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
    VLMServingEngine over a bf16 cache; with llm_mesh (here a one-rank gloo
    group) it builds the tensor-parallel one on that mesh, which serves a
    summary with the same text as the one-device engine (two ranks:
    tests/test_torch_port_parallel_tp.py)."""
    import torch.distributed as dist
    from test_torch_port_qwen3vl import _vlms

    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.serving.engine import ServingEngine
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    from clearcam_tpu_torch.utils.db import KVStore
    _, qwen = _vlms()
    nvr = NVR(KVStore(tmp_path / "kv.db"), tmp_path / "data", qwen=qwen, summary_slots=2,
              use_native_ingest=False)
    frame = np.zeros((48, 80, 3), np.uint8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        eng = nvr.summary_engine()
        assert isinstance(eng, VLMServingEngine) and isinstance(eng.engine, ServingEngine)
        assert eng.engine.state[0]["k"].dtype == torch.bfloat16
        assert nvr.summary_engine() is eng
        r = eng.submit([frame], "what is this", max_new=3, temperature=0.0)
        eng.run_until_idle()
        mesh = pmesh.make_mesh(1, data=1)
        nvr.llm_mesh, nvr._summary_engine = mesh, None
        tp = nvr.summary_engine()
        assert tp is not eng and tp.engine.mesh is mesh and tp.engine.ranks is not None
        assert tp.engine.state[0]["k"].dtype == torch.bfloat16
        r2 = tp.submit([frame], "what is this", max_new=3, temperature=0.0)
        tp.run_until_idle()
        assert tp.text(r2) == eng.text(r)
    finally:
        nvr.stop()
        dist.destroy_process_group()


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


@pytest.mark.parametrize("replace", [True, False])
def test_kvstore_puts_on_one_key_from_threads(tmp_path, replace):
    """utils/db.py's change: 4 threads x 500 puts on one key (the NVR thread
    and the HTTP handlers write ``counters``, ``alerts`` and ``settings``
    so) raise nothing; a replaced key keeps one row, an appended one gets
    contiguous unique ids. The copy as it was lost rows to ``UNIQUE
    constraint failed`` between one thread's DELETE (or next-id read) and
    another's INSERT."""
    import threading
    from clearcam_tpu_torch.utils.db import KVStore
    db = KVStore(tmp_path / "kv.db")
    n_threads, n_puts = 4, 500
    errors, ids = [], []
    start = threading.Barrier(n_threads)

    def put(t):
        start.wait()
        try:
            for i in range(n_puts):
                ids.append(db.run_put("counters", "gate", (t, i), replace=replace)[1])
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))
    threads = [threading.Thread(target=put, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    rows = db._conn().execute("SELECT id FROM 'counters_1' WHERE key='gate'").fetchall()
    if replace:
        assert [r[0] for r in rows] == ["1"]
        assert db.run_get("counters", "gate")[1] == n_puts - 1
    else:
        want = [str(i) for i in range(1, n_threads * n_puts + 1)]
        assert sorted(r[0] for r in rows) == sorted(want)
        assert sorted(ids) == sorted(want)
