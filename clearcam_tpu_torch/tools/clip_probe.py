"""CLIP image-tower per-stage probe, the counterpart of
``clearcam_tpu.tools.clip_probe`` with its flags, stages and JSON keys.

Breaks ViT-L/14 (bf16, random weights from seed 0) into stages and times
each on inputs already on the device: one warm call and a sync, then
``--steps`` calls queued and one sync. Each stage's output is reduced to ONE
f32 scalar on the device, so no activation crosses to the host:

  * stem: uint8 preprocess + patch embed + cls/pos + ln_pre (the prologue)
  * attn: 24x (LN + fused-qkv MHA + residual), plain attention with f32
    [B,16,257,257] scores
  * attn_bf16s: the same with the scores rounded to bf16 (a numerics probe,
    not the served path)
  * mlp: 24x (LN + 1024->4096 GELU MLP + residual)
  * full: ``encode_image`` on the pixels with the plain attention
  * full_flash: ``encode_image`` on the pixels with the hand-written
    attention kernel (``ops.vit_attention.mha_flash``), the served route

attn, attn_bf16s and mlp take [B,257,1024] bf16 token activations; stem,
full and full_flash take uint8 pixels. After each stage a ``#`` line gives
the attention kernel's launches during it (0 everywhere but full_flash).

FLOP accounting: ViT-L/14 @224 is ~81 GMACs = 162 GFLOPs an image (2 x
304M params x 257 tokens). mfu_pct = images/s x GFLOPs / PEAK_TF.

Usage:
    python -m clearcam_tpu_torch.tools.clip_probe --batches 16,128
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import clip
from ..nn import functional as F
from ..ops import vit_attention

GF_PER_IMG = 162.0          # 2 * 304M * 257 (see module docstring)
PEAK_TF = 989.0             # NVIDIA H100 SXM, dense bf16 tensor cores (data sheet)


def stem(p, pixels):
    x = (pixels.to(torch.bfloat16) / 255.0 - 0.5) / 0.5
    x = F.linear(clip.patchify(x), p[clip.PATCH_KEY])
    b = x.shape[0]
    cls = p["class_embedding"].expand(b, 1, clip.IMG_WIDTH)
    x = torch.cat([cls, x], 1) + p["positional_embedding"]
    return F.layer_norm_p(p, "ln_pre", x)


def _mha(q, k, v, bf16_scores=False):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / np.sqrt(64)
    if bf16_scores:
        s = s.to(torch.bfloat16)
    pr = torch.softmax(s, -1).to(v.dtype)
    return torch.matmul(pr, v)


def attn_stack(p, x, bf16_scores=False):
    for i in range(clip._n_blocks(p, "resblocks_img")):
        pre = f"resblocks_img.{i}"
        h = F.layer_norm_p(p, pre + ".ln_1", x)
        qkv = F.linear(h, p[pre + ".in_proj_weight"], p[pre + ".in_proj_bias"])
        q, k, v = (F.split_heads(t, clip.IMG_HEADS) for t in qkv.chunk(3, dim=-1))
        x = x + F.linear(F.merge_heads(_mha(q, k, v, bf16_scores)),
                         p[pre + ".out_proj_weight"], p[pre + ".out_proj_bias"])
    return x


def mlp_stack(p, x):
    for i in range(clip._n_blocks(p, "resblocks_img")):
        pre = f"resblocks_img.{i}"
        h = F.layer_norm_p(p, pre + ".ln_2", x)
        h = F.gelu(F.linear_p(p, pre + ".mlp_c_fc", h))
        x = x + F.linear_p(p, pre + ".mlp_c_proj", h)
    return x


def scalar(fn):
    return lambda p, x: fn(p, x).float().sum()


STAGES = {
    "stem": scalar(stem),
    "attn": scalar(attn_stack),
    "attn_bf16s": scalar(functools.partial(attn_stack, bf16_scores=True)),
    "mlp": scalar(mlp_stack),
    "full": scalar(functools.partial(clip.encode_image, normalize=True, flash=False)),
    "full_flash": scalar(functools.partial(clip.encode_image, normalize=True,
                                           flash=True)),
}
# the stages fed uint8 pixels; the others take [B,257,1024] activations
PIXEL_STAGES = ("stem", "full", "full_flash")
# GF per image per stage (MACs x2): attn qkvo 2.16 + scores/pv 0.27, mlp
# 4.31, per block
GF = {"stem": 0.31, "attn": 24 * 2.43, "attn_bf16s": 24 * 2.43,
      "mlp": 24 * 4.31, "full": GF_PER_IMG, "full_flash": GF_PER_IMG}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def probe(p: dict, batches, steps: int, dev) -> list[dict]:
    """One JSON line per (batch, stage); the rows returned carry the
    stage's attention-kernel launches under ``launches`` besides."""
    out = []
    rng = np.random.default_rng(0)
    for bs in batches:
        pix = torch.from_numpy(rng.integers(
            0, 255, (bs, clip.IMG_RES, clip.IMG_RES, 3), np.uint8)).to(dev)
        tok = torch.from_numpy(rng.normal(0, 1, (bs, 257, clip.IMG_WIDTH)).astype(
            np.float32)).to(dev, torch.bfloat16)
        for name, fn in STAGES.items():
            x = pix if name in PIXEL_STAGES else tok
            n0 = vit_attention.mha_flash.launches
            fn(p, x).item()                    # kernel build + warm + sync
            t0 = time.perf_counter()
            for _ in range(steps):
                fn(p, x)
            _sync(dev)
            dt = (time.perf_counter() - t0) / steps
            ips = bs / dt
            row = {"batch": bs, "stage": name, "ms_per_call": round(dt * 1e3, 2),
                   "images_per_s": round(ips, 1),
                   "mfu_pct": round(ips * GF[name] / 1e3 / PEAK_TF * 100, 1)}
            print(json.dumps(row), flush=True)
            launches = vit_attention.mha_flash.launches - n0
            print(f"# {name}: vit_attention launches {launches}", flush=True)
            out.append({**row, "launches": launches})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="16,128")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    p = clip.params_from_jax(clip.init_params(seed=0), dev, torch.bfloat16)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device {name}", flush=True)
    return probe(p, [int(b) for b in args.batches.split(",")], args.steps, dev)


if __name__ == "__main__":
    main()
