"""CLIP image-tower latency vs batch size, the counterpart of
``clearcam_tpu.tools.clip_bench`` with its flags and JSON keys: the
reference's test/test_clip_speed.py:8-15 as a CLI (it measured s/image for
bs 1..128 after warm-up calls).

The ViT-L/14 image tower runs in bf16 on uint8 crops already on the device,
its attention through the hand-written kernel on the card
(``ops.vit_attention.mha_flash``). Per batch: one warm call and a sync,
then ``--steps`` calls queued and one sync; the time is their mean. A
closing ``#`` line gives the attention kernel's launches.

Usage:
    python -m clearcam_tpu_torch.tools.clip_bench [--batches 1,8,32,128]

Random weights from seed 0 (throughput depends on the shapes, not the
values); pass --weights with the published OpenCLIP safetensors to measure
with real parameters. ``--device cpu`` runs on the CPU (host numbers).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import clip
from ..ops import vit_attention


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def bench(params: dict, batches, steps: int, dev) -> list[dict]:
    """One JSON line per batch size: seconds per image and images/s."""
    out = []
    for bs in batches:
        x = torch.from_numpy(np.random.default_rng(0).integers(
            0, 255, (bs, clip.IMG_RES, clip.IMG_RES, 3), np.uint8)).to(dev)
        clip.encode_image(params, x, normalize=True)      # kernel build + warm
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            clip.encode_image(params, x, normalize=True)
        _sync(dev)
        dt = (time.perf_counter() - t0) / steps
        row = {"batch": bs, "s_per_image": round(dt / bs, 5),
               "images_per_s": round(bs / dt, 1)}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="1,4,16,64,128")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--weights", default=None,
                    help="OpenCLIP safetensors (random init when absent)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.weights:
        from ..io import safetensors as st
        params = clip.convert_state_dict(st.load(args.weights))
    else:
        params = clip.init_params(seed=0)
    params = clip.params_from_jax(params, dev, torch.bfloat16)

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device {name}, ViT-L/14 image tower, bf16", flush=True)
    n0 = vit_attention.mha_flash.launches
    rows = bench(params, [int(b) for b in args.batches.split(",")], args.steps, dev)
    print(f"# launches {json.dumps({'vit_attention': vit_attention.mha_flash.launches - n0})}",
          flush=True)
    return rows


if __name__ == "__main__":
    main()
