"""The PyTorch/CUDA port (clearcam_tpu_torch) and chip_smoke.py never import
jax. The test process has jax loaded (conftest), so the import check runs in
a subprocess with ``sys.modules["jax"] = None``, which makes any
``import jax`` raise."""
import os
import re
import subprocess
import sys
from pathlib import Path

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
print(" ".join(names))
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
        "ops.vit_attention", "models", "models.yolov9", "models.clip",
        "models.objects", "models.blazeface", "models.adaface", "models.faces",
        "runtime", "runtime.nvr")}
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
