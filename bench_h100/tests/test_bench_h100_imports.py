"""Nothing under bench_h100 imports JAX, the JAX package or the root bench
script, compared by whole top-level names; the references import nothing
of the program; the run-time check compares whole names too."""
import ast
import sys
from pathlib import Path

import pytest

from bench_h100 import harness

PKG = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "clearcam_tpu", "bench", "tools"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_banned_import(path):
    assert not _imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")) +
                         [PKG / "compare.py", PKG / "weights.py"] +
                         sorted((PKG / "counts").glob("*.py")),
                         ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    assert "clearcam_tpu_torch" not in _imports(path)


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_path_to_the_root_bench_or_tools(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not node.value.endswith("bench.py") and not node.value.startswith("tools/")


def test_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "clearcam_tpu_torch_fake_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "clearcam_tpu.sub", object())
    assert harness.forbidden_modules() == ["clearcam_tpu"]
