"""The PyTorch/CUDA port (clearcam_tpu_torch) and chip_smoke.py never import
jax. The test process has jax loaded (conftest), so the import check runs in
a subprocess with ``sys.modules["jax"] = None``, which makes any
``import jax`` raise."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "clearcam_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import clearcam_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    clearcam_tpu_torch.__path__, "clearcam_tpu_torch."))
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None), "jax got imported"
# the loaded modules: serving.text and serving.constrain are the JAX
# package's files run under the port's names, not files of the port
print(" ".join(sorted(m for m in sys.modules if m.startswith("clearcam_tpu_torch."))))
"""


# jax itself, and the JAX package's modules that import it at the top
_JAX_MODELS = r"(yolov9|clip|blazeface|adaface|qwen3vl|llm|rfdetr|yolo_loss)"
JAX_IMPORT = re.compile(
    r"^\s*(import jax|from jax\b"
    r"|(from|import)\s+clearcam_tpu\.(nn|ops|models\." + _JAX_MODELS + r")\b"
    r"|from\s+clearcam_tpu\.models\s+import\s.*\b" + _JAX_MODELS + r"\b)")


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
        "runtime", "runtime.nvr", "serving", "serving.engine", "serving.text",
        "serving.constrain", "tools", "tools.serve_llm")}
    assert expected <= names, expected - names


def test_no_source_line_imports_jax():
    """Neither jax nor the JAX package's jax-importing modules, even inside
    a function (which the import check above cannot reach)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    pat = JAX_IMPORT
    hits = [f"{f.relative_to(ROOT)}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_source_line_pattern_catches_the_jax_modules():
    """The pattern above rejects each jax-importing module, and lets the
    jax-free host modules the port subclasses through."""
    pat = JAX_IMPORT
    for mod in ("clip", "blazeface", "adaface", "qwen3vl", "llm", "rfdetr",
                "yolo_loss", "yolov9"):
        assert pat.match(f"    from clearcam_tpu.models.{mod} import x")
        assert pat.match(f"import clearcam_tpu.models.{mod}")
        assert pat.match(f"from clearcam_tpu.models import objects, {mod}")
    for line in ("from clearcam_tpu.models import objects as _objects",
                 "from clearcam_tpu.models.objects import ObjectFinder",
                 "from clearcam_tpu.models.faces import FacePipeline",
                 "from clearcam_tpu.tools.parity import resolve_fixture"):
        assert not pat.match(line), line


_SERVE = r"""
import json, socket, sys, urllib.error, urllib.request
sys.modules["jax"] = None
from clearcam_tpu.tools.serve_llm import _AsciiTok
from clearcam_tpu_torch.models import llm
from clearcam_tpu_torch.serving import ServingEngine, TextServing, bind_shared_server, constrain

cfg = llm.TransformerConfig(num_blocks=1, dim=32, hidden_dim=64, n_heads=4,
                            n_kv_heads=2, norm_eps=1e-5, vocab_size=128, head_dim=8,
                            rope_theta=1e4, rope_dim=8, v_head_dim=8, max_context=128)
tok = _AsciiTok(cfg.vocab_size)
tc = constrain.token_table(constrain.json_char_dfa(2), tok.vocab_bytes(), [0],
                           n_vocab=cfg.vocab_size)
eng = ServingEngine(llm.init_params(cfg, seed=1), cfg, n_slots=2, max_waiting=1,
                    constraints={"json": tc})
gen = TextServing(eng, tok)
bind_shared_server()
from clearcam_tpu.server.http import AppContext, serve
from clearcam_tpu.utils.db import KVStore
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
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None), "jax got imported"
print("ok", text)
"""


def test_port_serves_the_shared_http_server_with_jax_blocked(tmp_path):
    """serve_llm's seam: the shared server's /generate and OpenAI handlers
    reach the port's engine (backpressure is a 503, not a 500), and jax
    never loads."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _SERVE, str(tmp_path)], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert proc.stdout.startswith("ok {")


def test_bind_shared_server_refuses_loaded_jax_modules():
    code = ("import clearcam_tpu.serving.constrain\n"
            "from clearcam_tpu_torch.serving import bind_shared_server\n"
            "try:\n    bind_shared_server()\nexcept RuntimeError as e:\n"
            "    print('refused', e)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.stdout.startswith("refused clearcam_tpu.serving"), \
        proc.stdout + proc.stderr[-2000:]


def test_constrain_copy_gives_the_jax_modules_tables():
    """The port's ``serving.constrain`` is the JAX package's file run under
    the port's name: a module of its own, with the same tables."""
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
