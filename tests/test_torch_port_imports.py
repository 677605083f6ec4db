"""The PyTorch/CUDA port (clearcam_tpu_torch) and chip_smoke.py import
neither jax nor anything of the JAX package (clearcam_tpu), not even its
jax-free modules: the port keeps its own copies of those. The test process
has both loaded (conftest), so the import check runs in a subprocess with
``sys.modules["jax"] = sys.modules["clearcam_tpu"] = None``, which makes
any import of either raise."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "clearcam_tpu_torch"

_BLOCK = 'import sys\nsys.modules["jax"] = None\nsys.modules["clearcam_tpu"] = None\n'

_IMPORT_ALL = _BLOCK + r"""
import importlib, pkgutil
import clearcam_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    clearcam_tpu_torch.__path__, "clearcam_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and (m.split(".")[0] in ("jax", "clearcam_tpu"))]
assert not loaded, loaded
print(" ".join(sorted(m for m in sys.modules if m.startswith("clearcam_tpu_torch."))))
"""

# an import of jax or of the JAX package, at any depth of a file
JAX_IMPORT = re.compile(r"^\s*(import jax\b|from jax\b|(from|import)\s+clearcam_tpu(\.|\s|$))")
# a file of the JAX package loaded by path
LOAD_BY_PATH = re.compile(r"spec_from_file_location|find_spec\(\s*[\"']clearcam_tpu[\"']")


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    names = set(proc.stdout.split())
    expected = {f"clearcam_tpu_torch.{m}" for m in (
        "__main__", "device", "testing", "nn", "nn.functional", "ops",
        "ops._build", "ops.boxes", "ops.image", "ops.nms", "ops.stem",
        "ops.vit_attention", "ops.quant_matmul", "ops.decode_attention",
        "models", "models.yolov9", "models.clip", "models.objects",
        "models.blazeface", "models.adaface", "models.faces", "models.llm",
        "models.qwen3vl", "runtime", "runtime.nvr", "runtime.metrics",
        "runtime.ingest", "runtime.settings", "runtime.storage", "server",
        "server.http", "serving", "serving.engine", "serving.text",
        "serving.constrain", "serving.vlm", "cloud.relay", "io.gguf",
        "io.safetensors", "track.ocsort", "utils.db", "utils.llm_tokenizer",
        "tools", "tools.serve_llm", "tools.parity", "tools.llm_bench", "tools.vpu_probe")}
    assert expected <= names, expected - names


def test_no_source_line_imports_jax():
    """Neither jax nor any module of the JAX package, even inside a
    function (which the import check above cannot reach), and no file of
    it loaded by path."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if JAX_IMPORT.match(line) or LOAD_BY_PATH.search(line)]
    assert not hits, hits


def test_source_line_pattern_catches_the_jax_modules():
    """The pattern rejects jax and every import of the JAX package, the
    jax-free modules included, and lets the port's own imports through."""
    for line in ("import jax", "    import jax.numpy as jnp", "from jax import numpy",
                 "import clearcam_tpu", "from clearcam_tpu import models",
                 "    from clearcam_tpu.models.llm import x",
                 "from clearcam_tpu.models import objects as _objects",
                 "from clearcam_tpu.runtime.nvr import NVR",
                 "from clearcam_tpu.tools.parity import resolve_fixture",
                 "import clearcam_tpu.serving.constrain"):
        assert JAX_IMPORT.match(line), line
    for line in ("import clearcam_tpu_torch", "from clearcam_tpu_torch.models import llm",
                 "from ..runtime import metrics", "import jaxtyping",
                 "    # clearcam_tpu/models/llm.py:285 is the JAX counterpart"):
        assert not JAX_IMPORT.match(line), line
    assert LOAD_BY_PATH.search('root = importlib.util.find_spec("clearcam_tpu")')
    assert LOAD_BY_PATH.search("spec = importlib.util.spec_from_file_location(n, p)")


_SERVE = _BLOCK + r"""
import json, socket, urllib.error, urllib.request
from clearcam_tpu_torch.models import llm
from clearcam_tpu_torch.serving import ServingEngine, TextServing, constrain
from clearcam_tpu_torch.server.http import AppContext, serve
from clearcam_tpu_torch.tools.serve_llm import _AsciiTok
from clearcam_tpu_torch.utils.db import KVStore

cfg = llm.TransformerConfig(num_blocks=1, dim=32, hidden_dim=64, n_heads=4,
                            n_kv_heads=2, norm_eps=1e-5, vocab_size=128, head_dim=8,
                            rope_theta=1e4, rope_dim=8, v_head_dim=8, max_context=128)
tok = _AsciiTok(cfg.vocab_size)
tc = constrain.token_table(constrain.json_char_dfa(2), tok.vocab_bytes(), [0],
                           n_vocab=cfg.vocab_size)
eng = ServingEngine(llm.init_params(cfg, seed=1), cfg, n_slots=2, max_waiting=1,
                    constraints={"json": tc})
gen = TextServing(eng, tok)
s = socket.socket(); s.bind(("127.0.0.1", 0)); port = s.getsockname()[1]; s.close()
server = serve(AppContext(KVStore(sys.argv[1] + "/kv.db"), sys.argv[1], gen=gen),
               port=port, host="127.0.0.1")
base = f"http://127.0.0.1:{port}"

def post(path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()

eng.submit([1, 2, 3], max_new=2)          # the queue is full: no scheduler yet
status, _ = post("/generate", {"prompt": "hi", "max_new": 3})
assert status == 503, status
eng.start()
status, body = post("/generate", {"prompt": "hello", "max_new": 4, "raw": True})
assert status == 200 and json.loads(body)["tokens"] == 4, (status, body)
status, body = post("/v1/chat/completions", {
    "messages": [{"role": "user", "content": "give json"}], "max_tokens": 12,
    "response_format": {"type": "json_object"}})
assert status == 200, (status, body)
text = json.loads(body)["choices"][0]["message"]["content"]
assert text.startswith("{"), text
server.shutdown()
eng.close()
loaded = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in ("jax", "clearcam_tpu")]
assert not loaded, loaded
print("ok", text)
"""


def test_port_serves_the_shared_http_server_with_jax_blocked(tmp_path):
    """The port's own copy of the HTTP server, with jax and the JAX package
    blocked: its /generate and OpenAI handlers reach the port's engine
    (backpressure is a 503, not a 500)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(tmp_path)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.startswith("ok {")


def test_constrain_copy_gives_the_jax_modules_tables():
    """The port's ``serving.constrain`` is a copy of the JAX package's file:
    a module of its own, with the same tables."""
    from clearcam_tpu.serving import constrain as jcon
    from clearcam_tpu.tools.serve_llm import _AsciiTok
    from clearcam_tpu_torch.serving import constrain as tcon
    assert tcon is not jcon and tcon.__name__ == "clearcam_tpu_torch.serving.constrain"
    tok = _AsciiTok(300)
    for build in (lambda m: m.token_table(m.json_char_dfa(3), tok.vocab_bytes(), [0],
                                          n_vocab=300),
                  lambda m: m.choice_token_constraint(tok, 300, ["yes", "no", "maybe"])):
        a, b = build(tcon), build(jcon)
        assert a.start == b.start
        np.testing.assert_array_equal(a.trans, b.trans)
