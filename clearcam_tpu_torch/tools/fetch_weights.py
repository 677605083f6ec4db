"""Download the published model weights into weights/ (the port's
counterpart of ``clearcam_tpu.tools.fetch_weights``: the same URLs, flags,
messages and exit codes; the ggml grids are extracted here, on the port's
own ``io.ggml_grids.GRID_SPECS``, so the tool imports nothing of the JAX
package, and a failed extraction says to run it again, not to run the
repo's ``tools/extract_ggml_grids.py``).

Mirrors the reference's lazy fetches (detection/yolov9.py:372,
models/objects.py:91, models/adaface.py:76, llm/qwen3vl.py:96,202) as one
explicit command — the NVR itself never touches the network for weights.

One command on a networked host activates every weight-gated parity test
(tests/test_weight_parity.py): `--models all` fetches the detector/CLIP/face
checkpoints into weights/ AND the parity fixtures (MOT16-03.mp4, the RF-DETR
nano checkpoint) into fixtures/ / weights/. `--dry-run` prints exactly what
would be fetched (url -> dest, present/absent) without touching the network.

Usage:
    python -m clearcam_tpu_torch.tools.fetch_weights [--dest weights]
        [--fixtures fixtures] [--models yolo clip face qwen mot16 rfdetr|all]
        [--yolo-sizes t s] [--qwen-size 2] [--dry-run]
"""
from __future__ import annotations

import argparse
import re
import sys
import urllib.request
from pathlib import Path

import numpy as np

from ..io.ggml_grids import GRID_SPECS

HF = "https://huggingface.co"
GH_REF = "https://github.com/roryclear/clearcam/raw/main"
# (url-candidates, dest-name, dest-kind) — candidates tried in order
URLS = {
    "yolo": lambda size, **_: [
        ([f"{HF}/roryclear/yolov9/resolve/main/yolov9-{size}.safetensors"],
         f"yolov9-{size}.safetensors", "weights")],
    "clip": lambda **_: [
        ([f"{HF}/roryclear/CLIP-ViT-L-14-laion2B-s32B-b82K/resolve/main/"
          "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors"],
         "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors", "weights"),
        (["https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz"],
         "bpe_simple_vocab_16e6.txt.gz", "weights")],
    "face": lambda **_: [
        ([f"{HF}/roryclear/AdaFace/resolve/main/adaface_ir50_ms1mv2.safetensors"],
         "adaface_ir50_ms1mv2.safetensors", "weights")],
    "qwen": lambda qwen_size, **_: [
        ([f"{HF}/Qwen/Qwen3-VL-{qwen_size}B-Instruct-GGUF/resolve/main/"
          f"Qwen3VL-{qwen_size}B-Instruct-F16.gguf"],
         f"Qwen3VL-{qwen_size}B-Instruct-F16.gguf", "weights"),
        ([f"{HF}/Qwen/Qwen3-VL-{qwen_size}B-Instruct-GGUF/resolve/main/"
          f"mmproj-Qwen3VL-{qwen_size}B-Instruct-F16.gguf"],
         f"mmproj-Qwen3VL-{qwen_size}B-Instruct-F16.gguf", "weights")],
    # parity-fixture media: the MOT16-03 clip the reference repo ships
    # (stripped from the read-only snapshot, .MISSING_LARGE_BLOBS) — try the
    # reference repo first, the MOT Challenge sequence video second
    "mot16": lambda **_: [
        ([f"{GH_REF}/test/videos/MOT16-03.mp4",
          "https://motchallenge.net/sequenceVideos/MOT16-03-raw.webm"],
         "MOT16-03.mp4", "fixtures")],
    # RF-DETR nano checkpoint (Roboflow's published release bucket, the
    # path the rfdetr pip package downloads from)
    "rfdetr": lambda **_: [
        (["https://storage.googleapis.com/rfdetr/rf-detr-nano.pth"],
         "rf-detr-nano.pth", "weights")],
    # ggml IQ lattice codebooks (iq3xxs/iq3s/iq2s grids): public constants
    # shipped in every llama.cpp checkout (ggml-common.h). Downloaded then
    # extracted into weights/ggml_grids.npz (see main()) so IQ3_XXS/IQ3_S/
    # IQ2_S GGUFs load with no llama.cpp checkout (io/ggml_grids.py).
    "ggml-grids": lambda **_: [
        (["https://raw.githubusercontent.com/ggml-org/llama.cpp/master/"
          "ggml/src/ggml-common.h",
          "https://raw.githubusercontent.com/ggerganov/llama.cpp/master/"
          "ggml/src/ggml-common.h"],
         "ggml-common.h", "weights")],
    # hls.js for fully air-gapped live/day HLS playback: the server serves
    # weights/hls.js at /hls.js and rewrites the pages' CDN script tag
    # (server/http.vendored_hls_path; reference loads it from the CDN,
    # mainview.html:2841)
    "hls.js": lambda **_: [
        (["https://cdn.jsdelivr.net/npm/hls.js@1/dist/hls.min.js",
          "https://unpkg.com/hls.js@1/dist/hls.min.js"],
         "hls.js", "weights")],
}


def fetch(urls: list[str], dest: Path) -> bool:
    if dest.exists():
        print(f"  {dest.name}: already present")
        return True
    tmp = dest.with_suffix(dest.suffix + ".part")
    for url in urls:
        try:
            print(f"  {dest.name}: downloading {url}")
            with urllib.request.urlopen(url, timeout=60) as r, \
                    open(tmp, "wb") as f:
                while chunk := r.read(1 << 20):
                    f.write(chunk)
            tmp.rename(dest)
            return True
        except Exception as e:  # noqa: BLE001
            print(f"  {dest.name}: FAILED ({e})")
            tmp.unlink(missing_ok=True)
    return False


def extract_table(text: str, name: str, count: int) -> np.ndarray:
    """Pull `count` integer literals from the table named `name` in either a
    C header (GGML_TABLE_BEGIN/static const) or a Python autogen module
    (the rules of the repo's tools/extract_ggml_grids.py)."""
    pats = [
        # C: GGML_TABLE_BEGIN(uint32_t, iq3xxs_grid, 256) ... GGML_TABLE_END()
        rf"GGML_TABLE_BEGIN\(\s*\w+\s*,\s*{name}\s*,\s*\d+\s*\)(.*?)GGML_TABLE_END",
        # C: static const uint32_t iq3xxs_grid[256] = { ... };
        rf"{name}\s*\[\s*\d*\s*\]\s*=\s*\{{(.*?)\}}",
        # Python: iq3xxs_grid = [ ... ]   (tinygrad autogen)
        rf"{name}\s*(?::[^=]+)?=\s*[\[\(](.*?)[\]\)]",
    ]
    for pat in pats:
        m = re.search(pat, text, re.DOTALL)
        if not m:
            continue
        vals = [int(v, 0) for v in re.findall(r"0[xX][0-9a-fA-F]+|\d+",
                                              m.group(1))]
        if len(vals) == count:
            return np.asarray(vals, np.uint64)
        print(f"warning: {name}: found {len(vals)} values, want {count}; "
              f"trying next pattern", file=sys.stderr)
    raise ValueError(f"could not extract {name} ({count} entries) from input")


def extract_to_npz(text: str, out_path) -> None:
    """Extract all three lattice tables from source text into an npz that
    ``io.ggml_grids.load_grids`` reads."""
    out = {}
    for name, (dtype, count, _) in GRID_SPECS.items():
        out[name] = extract_table(text, name, count).astype(dtype)
        print(f"{name}: {count} entries ok")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **out)
    print(f"wrote {out_path}")


def plan(models, dest: Path, fixtures: Path, yolo_sizes, qwen_size):
    """-> [(url_candidates, dest_path)] for the requested model groups."""
    out = []
    for model in models:
        sizes = yolo_sizes if model == "yolo" else [None]
        for size in sizes:
            for urls, name, kind in URLS[model](size=size, qwen_size=qwen_size):
                out.append((urls, (fixtures if kind == "fixtures" else dest)
                            / name))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dest", type=Path, default=Path("weights"))
    ap.add_argument("--fixtures", type=Path, default=Path("fixtures"))
    ap.add_argument("--models", nargs="+", default=["yolo", "clip"],
                    choices=list(URLS) + ["all"])
    ap.add_argument("--yolo-sizes", nargs="+", default=["t"])
    ap.add_argument("--qwen-size", type=int, default=2)
    ap.add_argument("--dry-run", action="store_true",
                    help="list exactly what would be fetched, touch nothing")
    args = ap.parse_args(argv)
    models = list(URLS) if "all" in args.models else args.models
    todo = plan(models, args.dest, args.fixtures, args.yolo_sizes,
                args.qwen_size)
    if args.dry_run:
        for urls, dest in todo:
            state = "present" if dest.exists() else "would fetch"
            print(f"  {dest}: {state}  <-  {' | '.join(urls)}")
        sys.exit(0)
    args.dest.mkdir(parents=True, exist_ok=True)
    args.fixtures.mkdir(parents=True, exist_ok=True)
    ok = True
    for urls, dest in todo:
        ok &= fetch(urls, dest)
    # post-step: extract the IQ lattice npz from the downloaded header
    hdr = args.dest / "ggml-common.h"
    npz = args.dest / "ggml_grids.npz"
    if "ggml-grids" in models and hdr.exists() and not npz.exists():
        try:
            extract_to_npz(hdr.read_text(errors="replace"), npz)
        except (OSError, ValueError) as e:
            print(f"  ggml_grids.npz: extraction FAILED ({e}); put a good "
                  f"ggml-common.h at {hdr} and run --models ggml-grids again")
            ok = False
    # blazeface ships with the reference repo, not HF — note it
    if "face" in models:
        print("  note: blazeface.safetensors is distributed with the reference "
              "repo; copy it into weights/ manually (the parity harness also "
              "resolves it from a reference snapshot when present)")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
