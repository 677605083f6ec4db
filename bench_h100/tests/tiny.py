"""Tiny cells for the CPU tests: a checkout in a temporary directory with
the repository's ``BENCHMARK.json`` and data files, plus small
configurations, mixes and cells of its own, added as new files only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "bench_h100"

DETECT = "tiny-detect"
SERVE = "tiny-serve"


def checkout(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and bench_h100/ under ``tmp`` with a tiny
    detect cell (YOLOv9-t at 64 px on 3 + 2 small frames) and a tiny
    serving cell (2 blocks at 256 wide, 3 slots)."""
    root = Path(tmp)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(PKG, root / "bench_h100",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = root / "bench_h100"
    b = json.loads((root / "BENCHMARK.json").read_text())

    det = json.loads((here / "configs" / "yolov9-t.json").read_text())
    det["input_size"] = 64
    det["init"]["class_bias"] = -1.0     # live rows among the 84 anchors at 64 px
    _write(here / "configs" / "tiny-det.json", det)
    cams = json.loads((here / "traffic" / "cams-32x1080p-16x720p.json").read_text())
    cams.update(groups=[{"cameras": 3, "height": 96, "width": 160},
                        {"cameras": 2, "height": 72, "width": 128}], pool_frames=2)
    _write(here / "traffic" / "tiny-cams.json", cams)
    _write(here / "workloads" / f"{DETECT}.json",
           {"check": {"ticks": 3},
            "limits": {"box_gap_px": 2.0, "score_gap": 0.02, "count_gap": 0.1}})

    llm = json.loads((here / "configs" / "qwen3-1.7b-int8.json").read_text())
    llm.update(hidden_size=256, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=128, intermediate_size=512, vocab_size=1024)
    llm["serving"]["cache_positions"] = 256
    _write(here / "configs" / "tiny-llm.json", llm)
    chat = json.loads((here / "traffic" / "chat-decode.json").read_text())
    chat.update(clients=3, slots=3, round=3,
                prompt={"dist": "uniform", "min": 20, "max": 90},
                output={"dist": "uniform", "min": 24, "max": 48})
    _write(here / "traffic" / "tiny-chat.json", chat)
    _write(here / "workloads" / f"{SERVE}.json",
           {"check": {"requests": 12}, "limits": {"logit_gap": 0.01}})

    b["configs"] += [
        {"name": "tiny-det", "source": "test", "file": "bench_h100/configs/tiny-det.json",
         "reduced": ["input_size"], "why": "test"},
        {"name": "tiny-llm", "source": "test", "file": "bench_h100/configs/tiny-llm.json",
         "reduced": ["hidden_size"], "why": "test"}]
    b["workloads"] += [
        {"name": DETECT, "config": "tiny-det", "traffic": "tiny-cams", "chips": 1, "why": "test"},
        {"name": SERVE, "config": "tiny-llm", "traffic": "tiny-chat", "chips": 1, "why": "test"}]
    for m in b["end_to_end"] + b["per_layer"]:
        if "detect-t-32cam" in m.get("workloads", ()):
            m["workloads"].append(DETECT)
        if "serve-qwen3-decode" in m.get("workloads", ()):
            m["workloads"].append(SERVE)
    _write(root / "BENCHMARK.json", b)
    return root


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")
