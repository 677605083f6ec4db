"""Runs of tiny cells through the harness on the CPU: found by name from
new files alone, correct when sound, and not correct under the control or
with the timed path broken underneath."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def _run(root, cell, trace=False, patch=None, seconds=1.5):
    return harness.run(cell, SEED, seconds, trace, device="cpu", root=root, patch=patch,
                       log=lambda m: None)


def test_new_files_alone_add_a_config_mix_cell_and_metric(tmp_path):
    root = tiny.checkout(tmp_path)
    (root / "bench_h100" / "metrics" / "ticks_seen.py").write_text(
        "def read(ctx):\n    return ctx.window.ticks\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "ticks_seen", "unit": "ticks", "better": "higher",
                           "source": "program_counter", "layer": "detector",
                           "moves": "kernel_ms_per_frame", "workloads": [tiny.DETECT]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    res = _run(root, tiny.DETECT, trace=True)
    assert res["metrics"]["ticks_seen"]["value"] >= 1
    assert "detect_call_ms" in res["metrics"] and "setup_s" not in res["metrics"]
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("cell", [tiny.DETECT, tiny.SERVE])
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", [tiny.DETECT, tiny.SERVE])
def test_control_fails(root, cell):
    held = []
    res = _run(root, cell, patch=held.append)
    assert res["correct"]
    limits = {k: v["limit"] for k, v in res["check"].items()}
    controls = held[0].controls()
    assert set(controls) == ({"float8", "no_suppression"} if cell == tiny.DETECT
                             else {"int4"})
    for name, readings in controls.items():
        assert not harness.judge([(k, readings[k], lim) for k, lim in limits.items()]), \
            (name, readings, limits)


def _detect_half(cell):
    fn = cell.detector.detect_many

    def half(frames):
        rows = fn(frames)
        return [r if i < len(rows) // 2 else np.zeros_like(r) for i, r in enumerate(rows)]
    cell.detector.detect_many = half


def _detect_altered(cell):
    fn = cell.detector.detect_many

    def moved(frames):
        rows = [r.copy() for r in fn(frames)]
        for r in rows:
            r[r[:, 4] > 0, :4] += 3.0
        return rows
    cell.detector.detect_many = moved


def _detect_no_suppression(cell):
    """NMS left out of the program: no overlap suppresses a row."""
    from clearcam_tpu_torch.models import yolov9

    post = yolov9.yolo_postprocess
    cell.restore = lambda: setattr(yolov9, "yolo_postprocess", post)
    yolov9.yolo_postprocess = lambda raw, max_det, conf, iou: post(raw, max_det, conf, 2.0)


def _serve_altered(cell):
    fn, vocab = cell.engine.decode_all, cell.cfg.vocab_size

    def altered(*a):
        out = fn(*a)
        return ((out[0] + 1) % vocab, *out[1:])
    cell.engine.decode_all = altered


def _serve_half(cell):
    fn = cell.engine.decode_all

    def half(*a):
        out = fn(*a)
        tok = out[0].clone()
        n = tok.shape[0]
        tok[n // 2:] = a[2][n // 2:]          # those rows' step left out
        return (tok, *out[1:])
    cell.engine.decode_all = half


@pytest.mark.parametrize("cell,fault", [
    (tiny.DETECT, _detect_half), (tiny.DETECT, _detect_altered),
    (tiny.DETECT, _detect_no_suppression),
    (tiny.SERVE, _serve_altered), (tiny.SERVE, _serve_half)],
    ids=["detect-half-batch", "detect-answer-altered", "detect-no-suppression",
         "serve-token-altered", "serve-half-batch"])
def test_broken_timed_path_is_not_correct(root, cell, fault):
    held = []

    def plant(obj):
        held.append(obj)
        fault(obj)
    try:
        res = _run(root, cell, patch=plant)
    finally:
        getattr(held[0], "restore", lambda: None)()
    assert not res["correct"], res["check"]


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result."""
    root = tiny.checkout(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "bench_h100", "--workload", "detect-t-32cam",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": f"{root}:{tiny.REPO}", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and bench_h100/, the command
    exits non-zero and prints no result."""
    root = tiny.checkout(tmp_path)
    p = subprocess.run([sys.executable, "-m", "bench_h100", "--workload", tiny.DETECT,
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=root, capture_output=True, text=True, timeout=120,
                       env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run([sys.executable, "-m", "bench_h100", "--workload", "detect-t-32cam",
                        "--seed", "5", "--seconds", "2", "--trace", "0"],
                       cwd=tiny.REPO, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_kernel_ms_per_frame_reads_the_kernels_of_the_ticks_traced():
    """Kernel time (overlaps once, copies out) over the frames of the ticks
    inside the profiled stretch; nothing to read without a trace."""
    from types import SimpleNamespace

    from bench_h100.trace import Trace
    spans = harness.Spans()
    spans.add("tick", 0.0, 0.5)                 # before the trace: not counted
    for t in range(4):
        spans.add("tick", 1.0 + t, 1.5 + t)
    tr = Trace(0.9, 5.0, [("conv", 1.0, 1.002), ("nms", 1.001, 1.003),
                          ("Memcpy HtoD (Pageable -> Device)", 2.0, 2.5)])
    reader = harness.load_module(
        harness.reader_path(tiny.PKG / "metrics", "kernel_ms_per_frame"))
    window = SimpleNamespace(n_cams=2)
    assert reader.read(SimpleNamespace(trace=tr, window=window, spans=spans)) == \
        pytest.approx(1e3 * 0.003 / 8)
    assert reader.read(SimpleNamespace(trace=None, window=window, spans=spans)) is None
