"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: `python3 chip_smoke.py`.

Drives clearcam_tpu_torch's paths, the NVR detect tick (YOLOv9-t, res
640, random weights from seed 0), the NVR's object search (CLIP ViT-L/14
image and text towers, BlazeFace and AdaFace IR-50, random weights from
seed 0), the LLM serving daemon (Qwen3-1.7B widths, random weights from
seed 0, int8 and int4) and the NVR's Qwen3-VL alert summaries (Qwen3-VL-2B
widths, random weights from seed 0), speculative serving, the FMA-rate
probe, RF-DETR nano with the MOT and evaluation tools, the measurement
tools (latency_probe, clip_bench, clip_probe, cotenancy_bench), YOLOv9-t
fine-tuning with the export and parity tools, the multi-device paths, the
UI verifier against the served NVR, the stem and host-link probes, and the
hand-written kernels (stem, ViT attention,
quant-matmul, decode attention in its batched, single-stream and
int8-cache forms, the probe) on the card. Every phase raises on failure,
so the script exits non-zero:

  0  the card: nvidia-smi name and power limit, torch, nvcc; TF32 off
  1  build csrc/*.cu with nvcc for sm_90a, timed
  2  stem kernel vs its plain version (stem_reference, cuDNN) at the main
     path's shapes, a ragged width and an input 2 bytes past a 4-byte
     boundary: bf16 max|d| < 0.05, f32 max|d| < 1e-4; the packed-operand
     call equal to the HWIO one and its gap to gemm_reference; then
     [8|128,384,640,3] bf16 timed as CUDA-graph replays over distinct
     inputs and outputs larger than L2, plain, kernel, kernel, plain, with
     GB/s and the share of the bytes bound
  3  YOLOv9-t 640 on 8 random 1080p frames: GPU f32 vs CPU f32 (forward_raw
     rtol/atol 2e-3, NMS on one head output, detect rows under
     clearcam_tpu_torch.testing's rule), the bf16 default path through
     BatchDetector, and frames/s at batch 1, 8, 32; at 32 one step's
     kernel time and the stem kernel's share of it (torch.profiler)
  4  `python -m clearcam_tpu_torch` on an empty data directory, set up
     through its API as a user does (/edit_settings to YOLOv9-t 640, then
     use_clip and use_face on; /add_camera for two synthetic 1080p
     cameras): /healthz, one /yolo offload request, /metrics (detect_step
     >= 3, no detect or tracker errors), `python -m
     clearcam_tpu_torch.tools.uicheck --url` against it and `--offline`
     (0 problems each) and each camera page's /get_preds overlay tick run
     once in the port's JS engine (one box drawn per row), /v1/embeddings
     (768-d unit rows,
     with a small synthetic BPE merge table), an uploaded-image search,
     and, where the NVR saved object crops, their embeddings.pkl and a
     similar_img search that finds the crop itself first; stem and
     vit_attention launches reported at shutdown
  5  ViT attention kernel vs its plain version (mha_reference) at the CLIP
     tower's shapes and the Qwen3-VL vision lengths: f32 max|d| < 1e-4
     (TF32 off), bf16 max|d| < 2e-2; the CLIP tower at 1, 16 and 64 crops
     (f32), at 16 in bf16 and a summary frame's tower [1,16,2040,64] (f32)
     timed as CUDA-graph replays over distinct q/k/v sets larger than L2,
     plain, kernel, kernel, plain, each with one
     scaled_dot_product_attention call timed the same way, the kernel's
     plan, TFLOP/s and share of the bound (bytes at 3.35 TB/s or bf16
     tensor-core operations, / 3 for f32 inputs)
  6  the towers on the card against the CPU, f32: ViT-L/14 (24 blocks,
     through the kernel) and the text tower (12 blocks), cosine > 1 - 1e-5
     per row; BlazeFace detect and IR-50 AdaFace embed; image-tower img/s
     at batch 1, 16, 64 with the kernel and with the plain attention
  7  the LLM kernels vs their plain versions: int8 and int4 quant-matmul
     at Qwen3-1.7B's five products (the LM head included) and 1, 8, 32,
     256, 520 rows, x f32 (max|d|/max|plain| <= 1e-5) and bf16 (<= 8e-3),
     each timed form with its split plan, GB/s and share of the bound
     (bytes at 3.35 TB/s or bf16 tensor-core operations, / 3 for f32 x);
     one-call yardsticks torch._weight_int8pack_mm at 8, 256 and 520 rows
     and torch._weight_int4pack_mm at 8, 256 and 520 rows (bf16 x, the
     kernel timed on the same bf16 x);
     batched decode attention at B=8 H=16 KvH=8 S=8192 D=128, bf16 and
     f32 caches, per-row positions and pads, f32 q (max|d| < 1e-4) and
     bf16 q (< 2e-2); device times from CUDA-graph replays over operands
     larger than L2 (decode attention: enough distinct caches that the
     live K/V cycled passes 120 MB, at least 2), and per decode-attention
     form its split plan, launches per call, GB/s of live K/V, share of the
     bytes bound and ratio to scaled_dot_product_attention
  8  a 2-block Qwen3-1.7B-width model (vocab 151936), f32 weights, int8
     and int4, through prefill_slot, prefill_many and teacher-forced
     decode_all with the decode kernel: card vs CPU logprob rows and
     decode logits max|d| < 2e-3; bf16 weights with a bf16 KV cache, on
     the card (decode kernel, plain attention) and the CPU, against f32
     products of the same bf16 values: logits within 5% of their range
     and the card within 2x the CPU's gap; then the 28-block model with int4
     weights and a bf16 KV cache in the engine, 8 concurrent requests,
     decode tokens/s with the kernel and with the plain attention
  9  `python -m clearcam_tpu_torch.tools.serve_llm --synthetic --int8
     --pallas` (8 blocks, ctx 8192, 8 slots): /healthz, /v1/models,
     /generate plain and streamed, 8 concurrent /v1/chat/completions (one
     with response_format json_object, whose text must be a JSON prefix),
     /v1/completions with logprobs; quant_matmul and decode_attention
     launches reported at shutdown; then `--int8 --kv-quant --pallas`
     at 4 blocks (the int8 cache through decode_attention_batch_q8 with its
     scales):
     /generate once and 4 at once, its q8 kernel launches reported
 10  decode_attention and decode_attention_q8 (B=1) and
     decode_attention_batch_q8 (B=8, spread positions, pads, a row with no
     live column) vs their plain versions, H=16 KvH=8 D=128, S 2048 and
     8192: f32 q max|d| < 1e-4 (the int8 forms on the same int8 bytes and
     scales), bf16 q < 2e-2; times at the summary path's shapes as CUDA-graph
     replays over enough distinct caches that the live K/V cycled passes
     120 MB (27, 52 and 28 caches), printed as in phase 7, and each
     wrapper's host time per eager call (the enqueue time of 200 calls)
 11  a 2-block Qwen3-VL-2B-width model (2 language + 2 vision blocks, the
     deepstack at vision block 1), f32, card vs CPU: vision embeds and the
     deepstack feature (cosine > 1 - 1e-5 per row), then an image prefill
     and 8 greedy tokens through Transformer.generate on the plain, kernel
     and int8-KV + kernel routes: equal tokens, the logits of every step
     within 2e-3 (2e-2 with the int8 cache) and each step's top-8 ids; the
     int8 cache after the image prefill, card vs CPU: how many int8 values
     differ, by how many steps, and the scales
 12  the 14 (of 28) + 24-block model, int8 weights, in the port's NVR in-process
     with a synthetic camera and a key-colour stand-in detector: seconds
     from the alert to the AI Summary notification (cooperative, bf16 and
     int8 KV), 4 concurrent alerts through VLMServingEngine (4 slots), and
     generate_batch B=8 with the int8 cache and its decode tokens/s; every
     decode-attention form, quant_matmul and vit_attention must launch; the
     summary by layer (vision tower, image prefill, prompt prefill, decode
     step; CUDA events after a sync) for both caches, with the decode
     step's kernel launches, kernel time and decode-attention time
     (torch.profiler), and one summary
     through the engine with CLEARCAM_SPEC_LOOKUP=4, whose notification
     must arrive with no decode kernel launched
 13  the FMA-rate probe kernel (csrc/vpu_probe.cu) vs probe_reference at
     [512,128] x 32768: f32 max|d| <= 1e-5 of max, bf16 <= 1.0 (two bf16
     ulps of the ~95 sum: __hfma2 rounds once, the plain version twice);
     FFMA / HFMA2 counts in its SASS (cuobjdump); then `python -m
     clearcam_tpu_torch.tools.vpu_probe`, its JSON line and T multiply-adds/s
     against the CUDA-core peaks
 14  speculative serving: (a) 2 blocks at Qwen3-1.7B widths, f32, 3
     requests admitted 2 ticks apart on 2 slots (a periodic prompt, a random
     one, one whose greedy output cycles), then the cycling one alone: the
     spec engine's tokens on the card equal the CPU's and the non-spec
     engine's, with more tokens than decode dispatches; (b) 14 of the 28
     blocks (cut for the smoke's time limit), int8 weights, 8 slots,
     200-token prompts: decode tokens/s with
     spec_lookup=4 and without, tokens per dispatch, and the int8 cache
     through the q8 kernel, its decode step; (c) `python -m
     clearcam_tpu_torch.tools.llm_bench --blocks 8 --modes
     int8,int8+kv8+pallas --decode-batch 1,8 --steps 32`, its JSON lines
     (depth cut from 28 for the smoke's time limit: the tool draws its
     weights with numpy on the host)
 15  the MoE, MLA and GatedDeltaNet-hybrid stacks: (a) card vs CPU, f32
     weights drawn on the card from a torch.Generator, f32 and int8 (the
     MoE int4 too),
     prefill_slot, prefill_many and 3 teacher-forced decode_all steps, at
     full width and 2 blocks (the hybrid 4, to hold an attention block):
     Qwen/Qwen3-30B-A3B's widths (through the decode kernel),
     deepseek-ai/DeepSeek-V2-Lite's (MLA + MoE; its YaRN rope scaling has
     no field in TransformerConfig, so both packages run plain RoPE) and
     the JAX package's qwen3_next_cfg: logprob rows and logits within
     phase 8's bounds, greedy tokens equal; (b) each family's 8-slot
     engine at half its published depth (24, 14 and 12 of 48, 27 and 28
     blocks, cut for the smoke's time limit), int8 weights
     quantized tensor by tensor as they are drawn on the card, bf16 KV,
     ctx 2048, one 32-token prefill chunk at B = 1, then 8 requests of
     24-88 tokens admitted two a tick, 24 new: decode tokens/s, the decode
     step's ms after a sync, kernel launches a step, the busy share and
     the expert path's device time (torch.profiler), and the quant and
     decode-attention kernels' launches over the run (the MoE plain, with
     --pallas and with --kv-quant --pallas; MLA with its bf16 and int8
     latent caches; the hybrid plain); (c) `python -m
     clearcam_tpu_torch.tools.llm_bench --ssm --blocks 4 --ctx 512 --modes
     int8 --decode-batch 1,8 --steps 16`, its JSON lines (4 blocks, cut
     from 8, still holding an attention block)
 16  RF-DETR and the tools: (a) RF-DETR nano at its published widths (res
     384, 12 ViT blocks of 192, 300 queries), 4 random 1080p frames, f32,
     card vs CPU: the proposal index sets equal (a set may differ only at a
     near tie of the 300th score, in one frame at most), logits and boxes
     max|d| <= 2e-3 in location order, detect rows under testing's rule;
     RFDETR.detect_many frames/s at batch 1 and 8, and at 8 one step's
     kernels and kernel time (torch.profiler); (b) tools/mot.run_mot on a
     60-frame synthetic 1080p clip through the YOLOv9-t BatchDetector and
     RF-DETR: every frame out, the stem kernel launched on the yolo route;
     (c) tools/evaluate.main on 8 synthetic YOLO-format images through both
     detectors, the AP dict; (d) `python -m clearcam_tpu_torch.tools.X` for
     latency_probe (its five stages), clip_bench --batches 1,16,64,
     clip_probe --batches 16 (the attention kernel launched under
     full_flash and nowhere else) and cotenancy_bench --streams 16 --ticks
     80 --quant int8 --blocks 14 (14 of 28, cut for the smoke's time
     limit; both ladders and the overhead line; the stem, ViT
     attention and quant-matmul kernels launched)
 17  YOLOv9 fine-tuning, export and parity: (a) `python -m
     clearcam_tpu_torch.tools.finetune` on 16 synthetic 1920x1080 JPEGs
     with labelled boxes, YOLOv9-t, res 640, batch 8, 30 steps at lr 3e-4:
     the loss descends, the stem kernel launches once a step; ms a step,
     peak memory and launches, then 3 steps with --remat (its peak beside
     the plain run's, two launches a step), 6 steps with --ckpt-dir and a
     run to 9 that resumes at step 6, and the published output loaded with
     YOLOv9.from_safetensors detecting on a 1080p frame; (b) the autograd
     stem's four weight gradients at [8,640,640,3] f32 vs the plain
     version's on the card, max|d| <= 1e-4 of max|g|; (c) detection_loss
     on the card vs the CPU, same batch and weights, relative <= 1e-4;
     (d) tools/export of the detector (t, 640, [1,1080,1920,3]) replayed in
     a fresh process that loads no models module: 0 row mismatches against
     eager detect, the stem kernel launched at replay, replay ms vs eager
     ms; (e) `python -m clearcam_tpu_torch.tools.parity run`: rc 0 with
     every check SKIP, rc 1 with --strict; a golden of random weights
     recorded on the CPU route passes check_yolo_golden on the card
 18  the multi-device paths (clearcam_tpu_torch.parallel), each part in
     ranks the smoke spawns: (a) at world size device_count() over NCCL,
     one rank a card: BatchDetector(mesh=) (YOLOv9-t 640 bf16, 8 random
     1080p frames) with rows equal to the solo detector, ring_prefill and
     make_sharded_prefill (Qwen3-1.7B widths, 2 blocks, 512 tokens)
     against one-device attention / forward within 2e-5, pipeline_apply
     and both training schedules against the stages in sequence, the int8
     tp engine (2 blocks, the decode kernel) with the one-rank engine's
     tokens, then finetune --mesh's ranks (res 640, batch 8, 3 steps),
     the loss within 1e-4 relative of (b)'s one-device run; (b) 2 ranks,
     sharing card 0 over gloo (2 cards: NCCL), at full published widths:
     the 28-block Qwen3-1.7B-width int8 tp engine through the batched
     decode kernels on bf16 and int8 caches (8 slots, 8 requests of 24-88
     tokens + 24 new) with the one-rank engine's tokens, its decode
     tokens/s, ms a step, the collectives' ms a step and each rank's
     kernel launches; (a)'s ring, sharded prefill and pipelines across the
     2 ranks (under gloo their point-to-point goes through pinned host
     memory, named on the line with the other ops' staging);
     VLMServingEngine(mesh=) at Qwen3-VL-2B widths (2 language + 2 vision
     blocks) with solo Qwen3VL.generate's text and the ViT attention on
     both ranks; 2 data ranks of detect with the stem on each; finetune's
     ranks on a (1, 2) mesh, the loss within 1e-4 relative of one device.
     Two ranks on one card check correctness and the shard shapes, not
     scale-out
 19  `python -m clearcam_tpu_torch.tools.{stem_probe, stem_kernel_probe,
     tunnel_probe}` at their defaults ([128,640,640,3] bf16, 30 steps):
     the cuDNN stem pair whole and by conv with the card's bounds, the
     stem kernel against the pair (max|d| <= 0.05, launched), and the host
     costs of chained calls, uploads and lagged readbacks
The line before the last is the card's name and power limit; before it, a
JSON line with each kernel's launches on a served path (phases 4, 9, 12
and 13; int4 from phase 8's engine run; the stem's adds phase 17's training
runs and replay and phase 19's probe), its error against the plain version,
its time, the plain version's, the bound (the larger of its bytes over
3.35 TB/s and its operations over the data sheet's peak for their type)
and the time of one PyTorch call computing the same function where there
is one (scaled_dot_product_attention, torch._weight_int8pack_mm). The last line is
{"ok": true, "device": {...}}. Without CUDA, or outside the repository, it
exits non-zero and prints no result.

`--phases 0,1,2` runs a subset (the last line is then not printed);
`--package DIR` runs the phases on the clearcam_tpu_torch of another
checkout (e.g. the parent commit, for a before/after in one chip call).
"""
from __future__ import annotations

import argparse
import base64
import gzip
import json
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PKG_ROOT = ROOT     # where subprocesses import clearcam_tpu_torch from (--package)
BF16_TOL, F32_TOL = 0.05, 1e-4      # stem kernel vs plain, max |d|
RAW_TOL = 2e-3                      # forward_raw GPU vs CPU, rtol and atol
STEM_SOURCE = "clearcam_tpu_torch/csrc/stem.cu"
STEM_REPLACES = "clearcam_tpu/ops/stem.py:149"
ATTN_SOURCE = "clearcam_tpu_torch/csrc/vit_attention.cu"
ATTN_REPLACES = "clearcam_tpu/ops/vit_attention.py:54"
# attention kernel vs plain, max |d|: f32 differs by summation order and
# exp2 vs exp only; in bf16 the plain version rounds the probabilities to
# bf16 before the PV product
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# one CROP_BATCH of crops, one crop, and ragged lengths up to the Qwen3-VL
# vision tower's 2040 (a 544x960 frame)
ATTN_SHAPES = [(16, 16, 257, 64), (1, 16, 257, 64)] + [
    (2, 16, t, 64) for t in (1, 7, 128, 129, 784, 1600)] + [(1, 16, 2040, 64)]
# timed forms (B, T, dtype name), 16 heads of 64: the CLIP tower at one
# crop (an image search), one and four CROP_BATCHes (f32, as served), bf16
# at one, and a summary frame's Qwen3-VL tower (f32, as served)
ATTN_TIMED = [(1, 257, "float32"), (16, 257, "float32"), (64, 257, "float32"),
              (16, 257, "bfloat16"), (1, 2040, "float32")]
TOWER_COS = 1 - 1e-5                # towers, GPU vs CPU, cosine per row
# BPE merges for the server's tokenizer: the real vocab is not in the repo
ALL_PHASES = tuple(range(20))
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>")]


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------

def phase0(torch):
    log("== phase 0: the card")
    log(f"nvidia-smi: {smi_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from clearcam_tpu_torch.ops import _build
    log(f"nvcc: {_build.nvcc_version().strip().splitlines()[-1]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN and matmul: f32 comparisons are full f32")


def phase1():
    log("== phase 1: build csrc/*.cu for sm_90a")
    from clearcam_tpu_torch.ops import _build
    _build.load()
    b = _build.last_build
    log(f"build: {b['seconds']:.2f} s ({'cached' if b['cached'] else 'nvcc'}) "
        f"-> {os.path.relpath(b['path'], ROOT)}")
    for line in b["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")
    return b["seconds"]


def _stem_inputs(torch, shape, dtype, seed):
    """Letterbox-like input in [0,1] and the stem's operands as the model
    passes them (models.yolov9.params_from_jax): values rounded to `dtype`,
    held as float32 HWIO."""
    from clearcam_tpu_torch.models import yolov9
    p = yolov9.init_params("t", seed=0)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(shape, np.float32)).to("cuda", dtype)
    # random biases so the bias path is exercised (init_params gives zeros)
    ws = [p["model.0.conv.weight"], rng.normal(0, 0.1, 16).astype(np.float32),
          p["model.1.conv.weight"], rng.normal(0, 0.1, 32).astype(np.float32)]
    return (x, *(torch.from_numpy(w).cuda().to(dtype).float().contiguous() for w in ws))


def _plain_pair(torch, x, w1, b1, w2, b2):
    """The plain version as the model runs a stem without the kernel: two
    cuDNN convs + SiLU on weights packed once (OIHW, channels_last, x's
    dtype), so neither side's time holds per-call weight packing."""
    from clearcam_tpu_torch.nn import functional as F
    cl = torch.channels_last
    pw1, pw2 = (F.hwio_to_oihw(w).to(x.dtype).contiguous(memory_format=cl)
                for w in (w1, w2))
    pb1, pb2 = b1.to(x.dtype), b2.to(x.dtype)

    def plain():
        y = F.silu(F.conv2d_oihw(x, pw1, pb1, stride=2, padding=1))
        return F.silu(F.conv2d_oihw(y, pw2, pb2, stride=2, padding=1))
    return plain


# phase 2's correctness cases: the served shapes (one frame, a CROP_BATCH of
# frames at 384x640), a ragged width whose rows are not 16-byte runs (23
# pixels: 138 bytes), a one-pixel row, and f32 at the GPU-against-CPU shapes
STEM_CASES = [((1, 384, 640, 3), "bfloat16"), ((8, 384, 640, 3), "bfloat16"),
              ((1, 17, 23, 3), "bfloat16"), ((3, 1, 2, 3), "bfloat16"),
              ((2, 100, 68, 3), "bfloat16"), ((2, 100, 68, 3), "float32"),
              ((2, 640, 640, 3), "float32"), ((1, 17, 23, 3), "float32")]


def _stem_timed(torch, mod, b):
    """The stem at [b,384,640,3] bf16 as phase 2 times it: (kernel calls,
    plain calls, bytes a call), one call per distinct input, enough inputs
    that their bytes in and out pass L2_FLUSH; each call keeps its output,
    so a CUDA graph writes every output to a buffer of its own. The kernel
    is called on operands packed once where the package has
    ``stem_packed`` (the served route), else (a package from before it,
    ``--package``) on the f32 HWIO operands the model kept for it then."""
    from clearcam_tpu_torch.ops.stem import out_hw
    h2, w2 = out_hw(384, 640)
    _, *hwio = _stem_inputs(torch, (1, 4, 4, 3), torch.bfloat16, seed=9)
    packed = mod.pack(*hwio) if hasattr(mod, "stem_packed") else None
    read = (packed.w1k, packed.b1, packed.w2k, packed.b2) if packed else hwio
    wbytes = sum(t.numel() * t.element_size() for t in read)
    nbytes = b * 384 * 640 * 3 * 2 + b * h2 * w2 * 32 * 2 + wbytes
    gen = torch.Generator("cuda").manual_seed(b)
    xs = [torch.rand((b, 384, 640, 3), generator=gen, device="cuda").to(torch.bfloat16)
          for _ in range(max(2, -(-L2_FLUSH // nbytes)))]
    if packed is not None:
        kernel = _kept([lambda x=x: mod.stem_packed(x, packed) for x in xs])
    else:
        kernel = _kept([lambda x=x: mod.stem(x, *hwio) for x in xs])
    plain = _kept([_plain_pair(torch, x, *hwio) for x in xs])
    return kernel, plain, nbytes


def _kept(calls: list) -> list:
    """The calls, each keeping its last output alive until its next call,
    so that outputs made in a CUDA graph's capture do not share memory."""
    outs = [None] * len(calls)

    def call(i):
        outs[i] = calls[i]()
        return outs[i]
    return [lambda i=i: call(i) for i in range(len(calls))]


def phase2(torch):
    log("== phase 2: stem kernel vs plain (cuDNN pair) on the card")
    from clearcam_tpu_torch.ops import stem as mod
    from clearcam_tpu_torch.ops.stem import out_hw, stem, stem_reference
    max_err = 0.0
    for i, (shape, dname) in enumerate(STEM_CASES):
        dtype = getattr(torch, dname)
        tol = BF16_TOL if dname == "bfloat16" else F32_TOL
        args = _stem_inputs(torch, shape, dtype, seed=i)
        got = stem(*args)
        ref = stem_reference(*args)
        torch.cuda.synchronize()
        h2, w2 = out_hw(shape[1], shape[2])
        if tuple(got.shape) != (shape[0], h2, w2, 32) or got.dtype != dtype:
            raise AssertionError(f"stem {shape}: got {tuple(got.shape)} {got.dtype}")
        err = (got.float() - ref.float()).abs().max().item()
        max_err = max(max_err, err)
        extra = ""
        if dname == "bfloat16" and hasattr(mod, "stem_packed"):
            packed = mod.pack(*args[1:])
            if not torch.equal(mod.stem_packed(args[0], packed), got):
                raise AssertionError(f"stem {shape}: packed and HWIO calls differ")
            gerr = (got.float() - mod.gemm_reference(args[0], packed).float()).abs().max()
            extra = (f"; packed call equal; max|kernel - gemm_reference| "
                     f"{gerr.item():.3e}")
        log(f"stem {list(shape)} {dname}: max|kernel - plain| = {err:.3e} "
            f"(bound {tol}){extra}")
        if not err < tol:
            raise AssertionError(f"stem {shape} {dtype}: max|d| {err} >= {tol}")
    # an input 2 bytes past a 4-byte boundary: the second image of a batch
    # of 17x23 frames (2346 bytes each)
    args = _stem_inputs(torch, (3, 17, 23, 3), torch.bfloat16, seed=11)
    x = args[0][1:]
    err = (stem(x, *args[1:]).float() - stem_reference(x, *args[1:]).float()).abs().max()
    log(f"stem [2,17,23,3] bfloat16 at data_ptr % 4 = {x.data_ptr() % 4}: "
        f"max|kernel - plain| = {err.item():.3e} (bound {BF16_TOL})")
    if not err.item() < BF16_TOL:
        raise AssertionError(f"stem at an odd offset: max|d| {err.item()}")
    max_err = max(max_err, err.item())

    times = {}
    h1, w1 = (384 + 1) // 2, (640 + 1) // 2
    h2, w2 = out_hw(384, 640)
    for b in (8, 128):
        kernel, plain, nbytes = _stem_timed(torch, mod, b)
        err = (kernel[0]().float() - plain[0]().float()).abs().max().item()
        if not err < BF16_TOL:
            raise AssertionError(f"stem [{b},384,640,3]: timed plain pair off by {err}")
        ms, pms, (k1, k2, p1, p2) = _pair_ms(plain, kernel)
        ops = 2 * b * (h1 * w1 * 16 * 27 + h2 * w2 * 32 * 144)
        bms, by = bound(nbytes, ops, PEAK["bfloat16"])
        times[b] = (ms, pms, bms, by)
        log(f"stem [{b},384,640,3] bf16: kernel {ms:.4f} ms (runs {k1:.4f}, {k2:.4f}) "
            f"= {nbytes / ms / 1e6:.0f} GB/s, {bms / ms:.1%} of the {by} bound "
            f"({bms:.4f} ms); plain {pms:.4f} ms (runs {p1:.4f}, {p2:.4f}) = "
            f"{pms / ms:.2f}x the kernel's time; {b / ms * 1e3:.0f} vs "
            f"{b / pms * 1e3:.0f} frames/s; one PyTorch call: none; CUDA graphs "
            f"over {len(kernel)} distinct inputs and outputs, "
            f"{len(kernel) * nbytes / 1e6:.0f} MB")
        del kernel, plain
    return max_err, times


def phase3(torch):
    log("== phase 3: YOLOv9-t res 640 on 1080p frames")
    from clearcam_tpu_torch.models import yolov9
    from clearcam_tpu_torch.ops import image
    from clearcam_tpu_torch.ops.nms import yolo_postprocess
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    from clearcam_tpu_torch.testing import compared_rows, detection_mismatches

    params = yolov9.init_params("t", seed=0)
    frames = np.random.default_rng(0).integers(0, 256, (8, 1080, 1920, 3), np.uint8)
    out = {}
    with torch.inference_mode():
        p_gpu = yolov9.params_from_jax(params, "cuda", torch.float32)
        p_cpu = yolov9.params_from_jax(params, "cpu", torch.float32)
        f_gpu, f_cpu = torch.from_numpy(frames).cuda(), torch.from_numpy(frames)
        x_gpu = image.letterbox(f_gpu, 640)
        x_cpu = image.letterbox(f_cpu, 640)
        log(f"letterbox 1080p -> {list(x_gpu.shape)}")
        raw_gpu = yolov9.forward_raw(p_gpu, x_gpu, "t").cpu().numpy()
        raw_cpu = yolov9.forward_raw(p_cpu, x_cpu, "t").numpy()
        np.testing.assert_allclose(raw_gpu, raw_cpu, rtol=RAW_TOL, atol=RAW_TOL)
        log(f"forward_raw f32 GPU vs CPU: max|d| {np.abs(raw_gpu - raw_cpu).max():.3e} "
            f"(rtol = atol = {RAW_TOL})")
        # NMS alone, fed the same head output on both devices: random weights
        # put every score near 0.5, so the tie rule below compares few rows
        n_gpu = yolo_postprocess(torch.from_numpy(raw_gpu).cuda()).cpu().numpy()
        n_cpu = yolo_postprocess(torch.from_numpy(raw_gpu)).numpy()
        np.testing.assert_allclose(n_gpu, n_cpu, rtol=0, atol=1e-4)
        log(f"yolo_postprocess on one head output, GPU vs CPU: rows equal "
            f"({int((n_cpu[..., 4] > 0).sum())} live)")
        d_gpu = yolov9.detect(p_gpu, f_gpu, size="t", res=640).cpu().numpy()
        d_cpu = yolov9.detect(p_cpu, f_cpu, size="t", res=640).numpy()
        bad = detection_mismatches(d_cpu, d_gpu)
        if bad:
            raise AssertionError("detect f32 GPU vs CPU:\n" + "\n".join(bad[:20]))
        log(f"detect f32 GPU vs CPU: rows agree ({int((d_cpu[..., 4] > 0).sum())} "
            f"live, {compared_rows(d_cpu)} clear of ties compared)")

        det = BatchDetector("t", 640, params=params, dtype=torch.bfloat16, device="cuda")
        det.detect_many(list(frames[:1]))          # warm up the shapes
        stem.launches = 0
        rows = det.detect_many(list(frames))
        launches = stem.launches
        if launches < 1:
            raise AssertionError("bf16 BatchDetector never launched the stem kernel")
        if not all(r.shape == (300, 6) and np.isfinite(r).all() for r in rows):
            raise AssertionError("bf16 BatchDetector rows not finite [300, 6]")
        log(f"BatchDetector bf16: 8 frames -> finite [300,6] rows, "
            f"{int(sum((r[:, 4] > 0).sum() for r in rows))} live; "
            f"stem launches {launches}")

        p_bf16 = det.params
        for b in (1, 8, 32):
            fb = torch.from_numpy(
                np.random.default_rng(b).integers(0, 256, (b, 1080, 1920, 3), np.uint8)).cuda()
            ms = cuda_ms(lambda: yolov9.detect(p_bf16, fb, size="t", res=640,
                                               compute_dtype=torch.bfloat16),
                         iters=10, warmup=3)
            host = [f.cpu().numpy() for f in fb]
            det.detect_many(host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                det.detect_many(host)
            e2e = (time.perf_counter() - t0) / 3
            out[b] = (b / ms * 1e3, b / e2e)
            log(f"detect bf16 batch {b}: {ms:.3f} ms/step on device = "
                f"{out[b][0]:.1f} frames/s (frames resident); detect_many "
                f"(numpy in, rows out) {e2e * 1e3:.3f} ms = {out[b][1]:.1f} frames/s")
            if b == 32:
                n, kms, sms = _kernels(
                    torch, lambda: yolov9.detect(p_bf16, fb, size="t", res=640,
                                                 compute_dtype=torch.bfloat16), ("stem",))
                out["profile_b32"] = (n, kms, sms)
                log(f"detect bf16 batch 32, one step under torch.profiler: {n} kernels, "
                    f"{kms:.3f} ms of kernel time, the stem kernel {sms:.4f} ms = "
                    f"{sms / kms:.1%} of it")
            del fb, host
    return out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _get(url: str, timeout: float = 5.0) -> bytes:
    return urllib.request.urlopen(url, timeout=timeout).read()


def _post(url: str, body: bytes, timeout: float = 5.0) -> bytes:
    req = urllib.request.Request(url, data=body, method="POST")
    return urllib.request.urlopen(req, timeout=timeout).read()


def _wait(what: str, until, proc, log_path: Path, seconds: float):
    """Poll `until()` until it gives a truthy value; fail if the server
    exits or `seconds` pass."""
    deadline = time.time() + seconds
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"server exited rc={proc.returncode} waiting for "
                                 f"{what}:\n" + log_path.read_text()[-4000:])
        try:
            got = until()
        except OSError:
            got = None
        if got:
            return got
        if time.time() > deadline:
            raise AssertionError(f"no {what} within {seconds} s:\n"
                                 + log_path.read_text()[-4000:])
        time.sleep(0.5)


def phase4():
    log("== phase 4: python -m clearcam_tpu_torch, two synthetic 1080p cameras")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    vocab = tmp / "merges.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        # no trailing newline: the reader takes every line after the header
        f.write("#version: smoke\n" + "\n".join(" ".join(m) for m in MERGES))
    env = dict(os.environ, PYTHONPATH=str(PKG_ROOT), PYTHONUNBUFFERED="1",
               CLEARCAM_BPE_PATH=str(vocab))
    out_path = tmp / "server.log"
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clearcam_tpu_torch", "--port", str(port),
             "--data", str(tmp / "data"), "--weights", str(tmp / "weights")],
            env=env, cwd=str(tmp), stdout=out, stderr=subprocess.STDOUT)
    try:
        health = _wait("/healthz", lambda: json.loads(_get(f"{base}/healthz", 2)),
                       proc, out_path, 300)
        log(f"/healthz: {health}")

        # configure as a user does, through the API: model size and
        # resolution (the detector is rebuilt), then the two cameras
        _post(f"{base}/edit_settings",
              json.dumps({"model_size": "t", "model_res": 640}).encode())
        line = _wait("detector rebuilt at res 640", lambda: re.search(
            r"^detector: YOLOv9-t res 640 .*$", out_path.read_text(), re.M),
            proc, out_path, 120).group(0)
        log(f"/edit_settings -> {line}")
        if "stem kernel on (CUDA" not in line:
            raise AssertionError(f"the detector does not run the stem kernel: {line}")
        for cam in ("cam1", "cam2"):
            q = urllib.parse.urlencode({"cam_name": cam, "src": "synthetic://1920x1080"})
            _get(f"{base}/add_camera?{q}")
        log("/add_camera: cam1, cam2 = synthetic://1920x1080")

        img = np.random.default_rng(5).integers(0, 256, (640, 640, 3), np.uint8)
        body = _post(f"{base}/yolo", img.tobytes(), timeout=120)
        if len(body) % 24:
            raise AssertionError(f"/yolo reply of {len(body)} bytes is not float32[N,6]")
        rows = np.frombuffer(body, np.float32).reshape(-1, 6)
        if not np.isfinite(rows).all():
            raise AssertionError("/yolo rows not finite")
        log(f"/yolo: float32{list(rows.shape)}, {int((rows[:, 4] > 0).sum())} live")

        def three_steps():
            snap = json.loads(_get(f"{base}/metrics"))
            steps = snap["timers"].get("detect_step", {}).get("count", 0)
            return snap if steps >= 3 else None
        snap = _wait("detect_step count >= 3", three_steps, proc, out_path, 180)
        counters = snap["counters"]
        for bad in ("detect_errors", "tracker_errors"):
            if counters.get(bad):
                raise AssertionError(f"{bad}={counters[bad]}:\n"
                                     + out_path.read_text()[-4000:])
        log(f"/metrics: detect_step {snap['timers']['detect_step']}, "
            f"counters {counters}")
        _uicheck(base)
        search = _object_search(base, tmp / "data" / "cameras", proc, out_path)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    text = out_path.read_text()
    shutil.rmtree(tmp, ignore_errors=True)
    for line in text.splitlines():
        log(f"  server| {line}")
    if "object queue error" in text:
        raise AssertionError("the NVR's crop ingest raised (see the server log)")
    launches = {}
    for name, what in (("stem", "the NVR detect path"),
                       ("vit_attention", "the object-search path")):
        m = re.search(rf"^{name}\.launches=(\d+)$", text, re.M)
        if m is None:
            raise AssertionError(f"server printed no {name}.launches line")
        launches[name] = int(m.group(1))
        if launches[name] < 1:
            raise AssertionError(f"{what} never launched the {name} kernel")
    log(f"launches on the served paths: {launches}; object search: {search}")
    return launches


def overlay_tick(base: str, cam: str) -> tuple:
    """The camera page booted against the live server in the port's JS
    engine, its /get_preds overlay tick run once -> (rows that tick's
    /get_preds gave, boxes the overlay drew). tests/test_torch_port_ui.py
    runs it against a CPU detector's rows."""
    from clearcam_tpu_torch.jsengine.dom import Browser, live_fetch
    fetch, seen = live_fetch(base), []

    def recording(method, url, body):
        status, payload = fetch(method, url, body)
        if url.startswith("/get_preds"):
            seen.append(len(json.loads(payload)["preds"]))
        return status, payload
    now = time.time()
    # the page draws only on "today" by the browser's UTC clock
    today = time.strftime("%Y-%m-%d", time.gmtime(now))
    page = _get(f"{base}/?cam={urllib.parse.quote(cam)}&folder={today}", 30).decode()
    b = Browser(page, fetch=recording, hls=False, now_ms=now * 1000)
    b.call("drawPreds")
    ops = b.el("overlay").js_get("getContext")("2d").ops
    return seen[-1], sum(op == "strokeRect" for op, _ in ops)


def _uicheck(base: str) -> dict:
    """The port's UI verifier as a user runs it, against the live server and
    on the repo's pages (each must report 0 problems), then each camera
    page's overlay tick: every /get_preds row drawn."""
    t0 = time.time()
    for args in (["--url", base], ["--offline"]):
        lines, _, _ = _tool(["uicheck", *args, "--json"], 300)
        if lines != [{"ok": True, "problems": []}]:
            raise AssertionError(f"uicheck {args[0]}: {lines}")
    pages = sorted(p.name for p in (PKG_ROOT / "clearcam_tpu_torch" / "server" / "web")
                   .glob("*.html"))
    cams = sorted(json.loads(_get(f"{base}/list_cameras", 30)))
    drawn = {cam: overlay_tick(base, cam) for cam in cams}
    log(f"uicheck --url: 0 problems (mainview, cameraview {cams[:4]}: their scripts "
        f"parsed and resolved, booted, drawPreds and refreshCounts run); --offline: 0 "
        f"problems over {pages}; overlay tick (/get_preds rows, boxes drawn) {drawn}; "
        f"{time.time() - t0:.1f} s")
    if any(rows != boxes for rows, boxes in drawn.values()):
        raise AssertionError(f"the overlay did not draw every /get_preds row: {drawn}")
    return drawn


def _object_search(base: str, cameras: Path, proc, out_path: Path) -> dict:
    """CLIP and faces turned on over HTTP; then the text tower, an
    uploaded-image search, and the crops the NVR saved and embedded."""
    import cv2
    t0 = time.time()
    # the web UI posts every setting: the detector's stay as they are
    _post(f"{base}/edit_settings", json.dumps(
        {"model_size": "t", "model_res": 640, "use_clip": True,
         "use_face": True}).encode(), timeout=600)
    line = _wait("the CLIP line", lambda: re.search(
        r"^clip: ViT-L/14 .*$", out_path.read_text(), re.M),
        proc, out_path, 600).group(0)
    log(f"/edit_settings use_clip, use_face ({time.time() - t0:.1f} s) -> {line}")
    if "attention kernel CUDA" not in line:
        raise AssertionError(f"the CLIP tower does not run the attention kernel: {line}")

    data = json.loads(_post(f"{base}/v1/embeddings", json.dumps(
        {"input": ["hello world", "hello"]}).encode(), timeout=120))["data"]
    embs = np.asarray([d["embedding"] for d in data], np.float32)
    norms = np.linalg.norm(embs, axis=-1)
    if embs.shape != (2, 768) or not np.isfinite(embs).all() \
            or np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"/v1/embeddings: {embs.shape}, norms {norms}")
    log(f"/v1/embeddings: 2 rows of {embs.shape[1]}, norms {norms.tolist()}")

    crop = np.random.default_rng(7).integers(0, 256, (120, 80, 3), np.uint8)
    jpeg = base64.b64encode(cv2.imencode(".jpg", crop)[1].tobytes()).decode()
    found = json.loads(_post(f"{base}/event_thumbs", json.dumps(
        {"uploaded_image": jpeg}).encode(), timeout=120))
    if not isinstance(found.get("images"), list):
        raise AssertionError(f"/event_thumbs uploaded_image: {found}")
    log(f"/event_thumbs uploaded_image: {found['count']} results")
    out = {"uploaded_image_results": found["count"]}

    def embedded():
        """(day cache, its crop paths) once one reads whole."""
        for pkl in sorted(cameras.glob("*/objects/*/embeddings.pkl")):
            try:
                with open(pkl, "rb") as f:
                    return pkl, list(pickle.load(f)["embeddings"])
            except (EOFError, pickle.UnpicklingError, KeyError):
                pass        # being rewritten by the NVR
        return None
    try:
        pkl, keys = _wait("an embeddings.pkl of saved crops", embedded, proc,
                          out_path, 120)
    except AssertionError:
        crops = sorted(cameras.glob("*/objects/*/*.jpg"))
        if crops:
            raise AssertionError(f"{len(crops)} crops saved, none embedded:\n"
                                 + out_path.read_text()[-4000:])
        log("no object crops saved within 120 s: similar_img not checked")
        return dict(out, crops_saved=0)
    rel = Path(keys[0]).resolve().relative_to(cameras.resolve())
    found = json.loads(_post(f"{base}/event_thumbs", json.dumps(
        {"similar_img": str(rel)}).encode(), timeout=120))
    top = (found.get("images") or [{}])[0]
    if abs(top.get("score", 0) - 1.0) > 1e-4:
        raise AssertionError(f"similar_img {rel}: {found}")
    if top["url"] != f"/{rel}":
        # a static scene saves the same pixels twice; either copy may lead
        same = np.array_equal(cv2.imread(str(cameras / rel)),
                              cv2.imread(str(cameras / top["url"].lstrip("/"))))
        if not same:
            raise AssertionError(f"similar_img {rel}: first is {top}")
        log(f"similar_img {rel}: first is {top['url']}, the same pixels")
    n_crops = len(list(cameras.glob("*/objects/*/*.jpg")))
    n_faces = len(list(cameras.glob("*/faces/*/*.jpg")))
    log(f"crops saved {n_crops}, embedded in {pkl.parent.name}: {len(keys)}; "
        f"faces saved {n_faces}; similar_img {rel} -> itself first, score "
        f"{found['images'][0]['score']}")
    return dict(out, crops_saved=n_crops, embedded=len(keys), faces_saved=n_faces,
                similar_score=found["images"][0]["score"])


def _qkv(torch, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to("cuda", dtype)
            for _ in range(3)]


def phase5(torch):
    log("== phase 5: ViT attention kernel vs plain (mha_reference) on the card")
    from clearcam_tpu_torch.ops import vit_attention
    from clearcam_tpu_torch.ops.vit_attention import mha_flash, mha_reference
    max_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for i, shape in enumerate(ATTN_SHAPES):
            q, k, v = _qkv(torch, shape, dtype, seed=i)
            got = mha_flash(q, k, v)
            ref = mha_reference(q, k, v)
            torch.cuda.synchronize()
            if tuple(got.shape) != shape or got.dtype != dtype:
                raise AssertionError(f"attention {shape}: got {tuple(got.shape)} {got.dtype}")
            err = (got.float() - ref.float()).abs().max().item()
            max_err[name] = max(max_err.get(name, 0.0), err)
            log(f"attention {list(shape)} {name}: max|kernel - plain| = {err:.3e} "
                f"(bound {ATTN_TOL[name]})")
            if not err < ATTN_TOL[name]:
                raise AssertionError(f"attention {shape} {name}: max|d| {err} >= "
                                     f"{ATTN_TOL[name]}")
    times = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, t, name in ATTN_TIMED:
        dtype = getattr(torch, name)
        shape = (b, 16, t, 64)
        live = 4 * int(np.prod(shape)) * (4 if name == "float32" else 2)  # q, k, v, out
        pool = []
        sets = _distinct(pool, lambda: _qkv(torch, shape, dtype, seed=1000 + len(pool)), live)
        q, k, v = sets[0]
        lib_err = (sdpa(q, k, v).float() - mha_flash(q, k, v).float()).abs().max().item()
        if not lib_err < ATTN_TOL[name]:
            raise AssertionError(f"SDPA yardstick off the kernel by {lib_err}")
        # plain, kernel, kernel, plain, as CUDA-graph replays over the sets
        kt, pt, _ = _pair_ms([lambda s=s: mha_reference(*s) for s in sets],
                          [lambda s=s: mha_flash(*s) for s in sets])
        lib = _yardstick(lambda: graph_ms([lambda s=s: sdpa(*s) for s in sets]))
        flop = 4 * b * 16 * t * t * 64
        bms, by = bound(live, flop, ATTN_PEAK[name])
        times[(b, t, name)] = (kt, pt, lib, bms, by)
        # a package from before the tensor-core design (--package) has no plan
        plan = getattr(vit_attention, "plan", None)
        grid = (f"plan {plan(b, 16, t, dtype)}" if plan else
                "no plan (one block of 256 threads per 64 query rows)")
        log(f"attention {list(shape)} {name}: {grid}; kernel {kt:.4f} ms = "
            f"{flop / kt / 1e9:.1f} TFLOP/s ({bms / kt:.1%} of the {by} bound, "
            f"{bms:.4f} ms), plain {pt:.4f} ms, scaled_dot_product_attention "
            + ("none" if lib is None else f"{lib:.4f} ms = {lib / kt:.2f}x the kernel's time")
            + f"; timed over {len(sets)} distinct q/k/v sets, {len(sets) * live / 1e6:.0f} MB")
    return max_err, times


def _cos_rows(a, b):
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _tower_check(what, got, ref):
    cos = _cos_rows(got, ref)
    log(f"{what} GPU vs CPU: cosine min {cos.min():.9f}, max|d| "
        f"{np.abs(got - ref).max():.3e} (bound cosine > {TOWER_COS})")
    if not (np.isfinite(got).all() and cos.min() > TOWER_COS):
        raise AssertionError(f"{what}: cosine {cos}")


def phase6(torch):
    log("== phase 6: CLIP ViT-L/14, text tower, BlazeFace, IR-50 on the card vs CPU (f32)")
    from clearcam_tpu_torch.models import adaface, blazeface, clip
    from clearcam_tpu_torch.ops.vit_attention import mha_flash

    t0 = time.time()
    params = clip.init_params(seed=0)
    log(f"clip.init_params(seed=0): {time.time() - t0:.1f} s")
    rng = np.random.default_rng(0)
    px = rng.integers(0, 256, (2, 224, 224, 3), np.uint8)
    toks = np.zeros((2, 77), np.int64)
    toks[0, :4] = [49406, 320, 1929, 49407]
    toks[1, :6] = [49406, 1237, 530, 518, 2368, 49407]
    fps = {}
    with torch.inference_mode():
        p_gpu = clip.params_from_jax(params, "cuda")
        p_cpu = clip.params_from_jax(params, "cpu")
        before = mha_flash.launches
        got = clip.encode_image(p_gpu, torch.from_numpy(px).cuda()).cpu().numpy()
        if mha_flash.launches - before != clip.IMG_BLOCKS:
            raise AssertionError(f"image tower: {mha_flash.launches - before} "
                                 f"kernel launches, not {clip.IMG_BLOCKS}")
        _tower_check("ViT-L/14 image tower (24 blocks, kernel)", got,
                     clip.encode_image(p_cpu, torch.from_numpy(px)).numpy())
        _tower_check("text tower (12 blocks)",
                     clip.encode_text(p_gpu, torch.from_numpy(toks).cuda()).cpu().numpy(),
                     clip.encode_text(p_cpu, torch.from_numpy(toks)).numpy())
        del p_cpu

        # BlazeFace filters scaled by 0.5: He-initialised random weights blow
        # activations up to ~1e8 through 31 residual blocks; at 0.5 they stay
        # O(1) and some scores clear the 0.85 floor
        bp = {k: (v * 0.5 if v.ndim == 4 else v)
              for k, v in blazeface.init_params(seed=0).items()}
        img = rng.integers(0, 256, (256, 256, 3), np.uint8)
        d_gpu = blazeface.detect(blazeface.params_from_jax(bp, "cuda"),
                                 torch.from_numpy(img).cuda()).cpu().numpy()
        d_cpu = blazeface.detect(blazeface.params_from_jax(bp, "cpu"),
                                 torch.from_numpy(img)).numpy()
        live = d_cpu[:, 16] > 0
        if not np.array_equal(d_gpu[:, 16] > 0, live) or \
                np.abs(d_gpu - d_cpu).max() > 1e-2:
            raise AssertionError(f"BlazeFace detect GPU vs CPU: live "
                                 f"{(d_gpu[:, 16] > 0).sum()} vs {live.sum()}, max|d| "
                                 f"{np.abs(d_gpu - d_cpu).max()}")
        log(f"BlazeFace detect GPU vs CPU: the same {int(live.sum())} live rows, "
            f"max|d| {np.abs(d_gpu - d_cpu).max():.3e} px (bound 1e-2)")
        ap = adaface.init_params(seed=0)
        faces = torch.from_numpy(rng.integers(0, 256, (4, 112, 112, 3), np.uint8))
        _tower_check("AdaFace IR-50 (24 blocks)",
                     adaface.embed(adaface.params_from_jax(ap, "cuda"), faces.cuda()).cpu().numpy(),
                     adaface.embed(adaface.params_from_jax(ap, "cpu"), faces).numpy())

        for b in (1, 16, 64):
            x = torch.from_numpy(rng.integers(0, 256, (b, 224, 224, 3), np.uint8)).cuda()
            runs = {}
            for flash in (False, None, None, False):
                ms = cuda_ms(lambda: clip.encode_image(p_gpu, x, flash=flash),
                             iters=5, warmup=2)
                runs.setdefault(flash, []).append(ms)
            kern, plain = (float(np.mean(runs[f])) for f in (None, False))
            fps[b] = (b / kern * 1e3, b / plain * 1e3)
            log(f"image tower f32 batch {b}: kernel {kern:.3f} ms = {fps[b][0]:.1f} "
                f"img/s (runs {runs[None]}), plain attention {plain:.3f} ms = "
                f"{fps[b][1]:.1f} img/s (runs {runs[False]})")
            del x
    return fps


# ---------------------------------------------------------------------------
# the LLM serving slice: quant-matmul and decode-attention kernels

QM_SOURCE = "clearcam_tpu_torch/csrc/quant_matmul.cu"
QM_REPLACES = {8: "clearcam_tpu/ops/quant_matmul.py:198",
               4: "clearcam_tpu/ops/quant_matmul.py:215"}
DEC_SOURCE = "clearcam_tpu_torch/csrc/decode_attention.cu"
DEC_REPLACES = "clearcam_tpu/ops/decode_attention.py:200"
# quant kernel vs plain, max |d| over max |plain|: f32 x differs by the sum
# order only; bf16 x rounds both outputs to bf16
QM_TOL = {"float32": 1e-5, "bfloat16": 8e-3}
# Qwen3-1.7B's products (out, in): q/o, k/v, gate/up, down, the LM head
QM_SHAPES = [(2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144), (151936, 2048)]
QM_ROWS = (1, 8, 32, 256, 520)
# forms timed against a one-call yardstick: (out, in, rows)
QM_YARDSTICK = {(6144, 2048, 8), (6144, 2048, 256), (6144, 2048, 520)}
# decode kernel vs plain (f32 softmax over the whole cache), max |d|
DEC_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DEC_POS = [0, 17, 255, 256, 1000, 4095, 8191, 3000]
QM_JSON_SHAPE = (6144, 2048, 8, "float32")     # (out, in, rows, x dtype)
GROUP_INT4 = 128       # the int4 scale group along the input
HBM = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
# H100 SXM dense peaks (data sheet): f32 outside the tensor cores; bf16 and
# int8 in them
PEAK = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# the quant kernel's rate for x of each type: bf16 products on the tensor
# cores, three of them (bf16 terms) for an f32-exact product
QM_PEAK = {"float32": PEAK["bfloat16"] / 3, "bfloat16": PEAK["bfloat16"]}
# the ViT attention kernel's, by the same rule, whatever terms it splits into
ATTN_PEAK = QM_PEAK
L2_FLUSH = 120_000_000  # bytes a timed run cycles through: > the H100's 50 MB L2
# 2-block full-width model, card vs CPU, f32: max |d| of the logprob rows
# (chosen + top 8) and of the decode step's full logits
LLM_LP_TOL, LLM_LOGIT_TOL = 2e-3, 2e-3
# bf16 weights and a bf16 KV cache, against the JAX package's semantics for
# them (the bf16 values widened, f32 products): the port rounds each
# product's input and output to bf16, ~1% of the logits' range over two
# blocks and the LM head. Bounds: 5% of max|logit|, and the card no further
# from the reference than 2x the port's own bf16 path on the CPU
LLM_BF16_REL, LLM_BF16_RATIO = 0.05, 2.0


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(the least milliseconds the card could take, which of bytes or
    operations sets it): bytes moved over HBM's rate against operations
    over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(calls, reps: int = 5) -> float:
    """Device milliseconds per call: the calls captured once in a CUDA
    graph and replayed, so the host's launch cost is left out. Callers
    cycle the calls' operands through more bytes than the 50 MB L2, as a
    decode step's weights do."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                 # warm-up outside the capture
        for c in calls[:3]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(calls))
    del graph
    return ms


def _pair_ms(plain, kernel):
    """plain, kernel, kernel, plain (lists of calls), so drift on the card
    hits both alike: (kernel mean, plain mean, (k1, k2, p1, p2))."""
    p1 = graph_ms(plain)
    k1 = graph_ms(kernel)
    k2 = graph_ms(kernel)
    p2 = graph_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2, p1, p2)


def _copies(torch, ql, nbytes: int) -> list:
    """ql and enough copies of it to hold more than L2_FLUSH bytes."""
    import dataclasses
    n = min(128, max(4, -(-L2_FLUSH // nbytes)))
    return [ql] + [dataclasses.replace(ql, **{f.name: getattr(ql, f.name).clone()
                                              for f in dataclasses.fields(ql)
                                              if torch.is_tensor(getattr(ql, f.name))})
                   for _ in range(n - 1)]


def _distinct(pool: list, make, live: int) -> list:
    """The first n operands of ``pool``, made with ``make()`` as needed, n
    being enough (and at least 2) that the live bytes cycled, ``live`` per
    operand, pass L2_FLUSH."""
    n = max(2, -(-L2_FLUSH // live))
    while len(pool) < n:
        pool.append(make())
    return pool[:n]


DEC_LAUNCHES = 2        # kernel launches per decode-attention call: split, merge


def _dec_line(dec, kt, pt, lib, bms, live, n, b, kvh, s) -> str:
    """What phases 7 and 10 print per timed form: the split plan, launches
    per call, GB/s of live K/V, the share of the bytes bound, the plain
    version and the one-call yardstick (with its ratio to the kernel). A
    package from before the split design (``--package``) has no plan: one
    block walks each row, one launch a call."""
    plan = getattr(dec, "plan", None)
    chunk, splits = plan(b, kvh, s) if plan else (s, 1)
    return (f"{splits} splits of {chunk} positions, {DEC_LAUNCHES if plan else 1} launches "
            f"a call; kernel "
            f"{kt:.4f} ms = {live / kt / 1e6:.0f} GB/s of live K/V ({bms / kt:.1%} of the "
            f"bytes bound, {bms:.4f} ms), plain {pt:.4f} ms, scaled_dot_product_attention "
            + ("none" if lib is None else f"{lib:.4f} ms = {lib / kt:.2f}x the kernel's time")
            + f"; timed over {n} distinct caches, {n * live / 1e6:.0f} MB of live K/V")


def _qm_line(qm, k, p, lib, bms, by, wbytes, rows, o_pad, k_pad, int4) -> str:
    """What phase 7 prints per timed quant form: the split plan, launches a
    call, GB/s of weights, the share of the bound, the plain version and
    the one-call yardstick. A package from before the split design
    (``--package``) has no plan: one block per 32 outputs and 16 rows."""
    plan = getattr(qm, "plan", None)
    grid = "no splits"
    if plan is not None:
        pl = plan(rows, o_pad, k_pad, int4)
        grid = f"{pl.splits} splits x {pl.tiles} tiles = {pl.splits * pl.tiles} blocks"
    grid += ", 1 launch a call"
    return (f"{grid}; kernel {k:.4f} ms = {wbytes / k / 1e6:.0f} GB/s of weights "
            f"({bms / k:.1%} of the {by} bound, {bms:.4f} ms), plain {p:.4f} ms, one call "
            + ("none" if lib is None else f"{lib:.4f} ms = {lib / k:.2f}x the kernel's time"))


def phase7(torch):
    log("== phase 7: quant-matmul and decode-attention kernels vs plain on the card")
    from clearcam_tpu_torch.ops import quant_matmul as qm
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"qm_err": {8: 0.0, 4: 0.0}, "qm_ms": {}, "dec_err": 0.0, "dec_ms": {}}
    for o, i in QM_SHAPES:
        w = torch.randn((o, i), generator=gen, device="cuda") * 0.05
        for bits in (8, 4):
            ql = qm.quantize_int8(w) if bits == 8 else qm.quantize_int4(w)
            qw = ql.q if bits == 8 else ql.packed
            o_pad, k_pad = qw.shape[0], qw.shape[1] * (1 if bits == 8 else 2)
            wbytes = qw.numel() + ql.s.numel() * 4
            qls = _copies(torch, ql, wbytes)
            for rows in QM_ROWS:
                for dtype in (torch.float32, torch.bfloat16):
                    name = str(dtype)[6:]
                    x = torch.randn((rows, i), generator=gen, device="cuda").to(dtype)
                    got = qm.quant_linear(x, ql)
                    ref = qm.quant_linear_reference(x, ql)
                    torch.cuda.synchronize()
                    rel = (got.float() - ref.float()).abs().max().item() \
                        / ref.float().abs().max().item()
                    if not (got.shape == ref.shape and got.dtype == dtype
                            and rel <= QM_TOL[name]):
                        raise AssertionError(f"quant int{bits} [{rows},{i}]x[{o},{i}] "
                                             f"{name}: max|d|/max|plain| {rel}")
                    if dtype == torch.float32:
                        out["qm_err"][bits] = max(
                            out["qm_err"][bits], (got - ref).abs().max().item())
                        out["qm_rel"] = max(out.get("qm_rel", 0.0), rel)
                    if dtype == torch.float32 or rows == 8 or (
                            bits == 4 and name == "bfloat16" and (o, i, rows) in QM_YARDSTICK):
                        k, p, _ = _pair_ms(
                            [lambda c=c: qm.quant_linear_reference(x, c) for c in qls],
                            [lambda c=c: qm.quant_linear(x, c) for c in qls])
                        lib = None
                        if (o, i, rows) in QM_YARDSTICK and bits == 8 and name == "float32":
                            lib = _int8pack_ms(torch, qls, x, ref)
                        elif (o, i, rows) in QM_YARDSTICK and bits == 4 and name == "bfloat16":
                            lib = _int4pack_ms(torch, qls, x, ref)
                        nb = wbytes + x.numel() * x.element_size() + rows * o * x.element_size()
                        bms, by = bound(nb, 2 * rows * i * o, QM_PEAK[name])
                        out["qm_ms"][(bits, o, i, rows, name)] = (k, p, lib, bms, by)
                        log(f"quant int{bits} x[{rows},{i}] {name} . W[{o},{i}]: max|d|/max "
                            f"{rel:.2e} (bound {QM_TOL[name]}); "
                            + _qm_line(qm, k, p, lib, bms, by, wbytes, rows, o_pad, k_pad,
                                       bits == 4))
            del ql, qls
        del w
    log(f"quant f32 x: largest max|d|/max|plain| {out['qm_rel']:.2e} (bound "
        f"{QM_TOL['float32']}); bounds: bytes over {HBM / 1e12} TB/s against operations "
        "over 989 TFLOP/s bf16 (f32 x: / 3, its three bf16 terms)")
    _phase7_decode(torch, gen, out)
    return out


def _phase7_decode(torch, gen, out):
    """The batched decode kernel against its plain version at B=8 H=16
    KvH=8 S=8192, and its times over distinct caches (out["dec_err"],
    out["dec_ms"])."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    b, h, kvh, s, d = 8, 16, 8, 8192, 128
    zeros = torch.zeros(b, dtype=torch.int32, device="cuda")
    spread = torch.tensor(DEC_POS, dtype=torch.int32, device="cuda")
    cases = {"spread": (spread, zeros),
             "pads": (spread, torch.tensor([0, 5, 200, 0, 999, 1, 4000, 2500],
                                           dtype=torch.int32, device="cuda")),
             "pos256": (torch.full((b,), 256, dtype=torch.int32, device="cuda"), zeros),
             "pos4096": (torch.full((b,), 4096, dtype=torch.int32, device="cuda"), zeros)}
    for cname, cdt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q = torch.randn((b, h, d), generator=gen, device="cuda")

        def make():
            return tuple(torch.randn((b, kvh, s, d), generator=gen, device="cuda").to(cdt)
                         for _ in range(2))
        pool = [make()]
        k, v = pool[0]
        for case, (pos, pads) in cases.items():
            # q f32 (the model's residual stream); a bf16 q too, on a bf16 cache
            for qn, qq in [("float32", q)] + ([("bfloat16", q.bfloat16())]
                                              if cname == "bfloat16" else []):
                got = dec.decode_attention_batch(qq, k, v, pos, pads)
                ref = dec.decode_attention_batch_reference(qq, k, v, pos, pads)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                if not (got.dtype == qq.dtype and err < DEC_TOL[qn]):
                    raise AssertionError(f"decode attention {case} {cname} cache, q {qn}: "
                                         f"max|d| {err}")
                if qn == "float32":
                    out["dec_err"], err32 = max(out["dec_err"], err), err
                else:
                    log(f"decode attention {case}, bf16 q and cache: max|d| {err:.2e} "
                        f"(bound {DEC_TOL[qn]})")
            npos = int((pos - pads + 1).sum().item())
            live = npos * kvh * d * 2 * k.element_size()
            caches = _distinct(pool, make, live)
            kt, pt, _ = _pair_ms(
                [lambda c=c: dec.decode_attention_batch_reference(q, *c, pos, pads)
                 for c in caches],
                [lambda c=c: dec.decode_attention_batch(q, *c, pos, pads) for c in caches])
            lib = _sdpa_decode_ms(torch, q, caches, pos, pads) if cname == "bfloat16" else None
            nb = live + 2 * q.numel() * q.element_size()
            bms, by = bound(nb, 4 * npos * h * d, PEAK["float32"])
            out["dec_ms"][(case, cname)] = (kt, pt, lib, bms, by)
            log(f"decode attention B=8 H=16 KvH=8 S=8192 {cname} cache, {case}: max|d| "
                f"{err32:.2e} (bound {DEC_TOL['float32']}); "
                + _dec_line(dec, kt, pt, lib, bms, live, len(caches), b, kvh, s)
                + "; the plain version reads the whole cache")
        del pool, k, v
        torch.cuda.empty_cache()


def _int8pack_ms(torch, qls, x, ref):
    """One ``torch._weight_int8pack_mm`` call on the same int8 weight and
    scales, where the card's PyTorch has it and it computes the kernel's
    function; else None."""
    try:
        got = torch._weight_int8pack_mm(x, qls[0].q, qls[0].s.reshape(-1))
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError) as e:
        log(f"torch._weight_int8pack_mm on the card: {str(e).splitlines()[0][:160]}")
        return None
    rel = (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()
    if not rel <= QM_TOL["float32"] * 10:
        log(f"torch._weight_int8pack_mm differs from the plain version ({rel:.2e})")
        return None
    return graph_ms([lambda c=c: torch._weight_int8pack_mm(x, c.q, c.s.reshape(-1))
                     for c in qls])


def _int4pack(torch, ql):
    """``ql``'s weights in tinygemm's layout (``torch._convert_weight_to_int4pack``
    of the values + 8, two a byte, the even input in the high nibble, group
    128) and its scales and zero points [groups, O, 2] in bf16: (q + 8 - 8)
    * s + 0 = q * s."""
    u = (ql.unpack() + 8).to(torch.uint8)                       # [O_pad, I_pad], 0..15
    w = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).contiguous(), 8)
    s = ql.s.to(torch.bfloat16)                                 # [groups, O_pad]
    return w, torch.stack([s, torch.zeros_like(s)], -1).contiguous()


def _int4pack_ms(torch, qls, x, ref):
    """One ``torch._weight_int4pack_mm`` call (tinygemm, bf16 x) on the same
    int4 values and scales (the scales rounded to bf16), where the card's
    PyTorch has it and it agrees with the plain version to the bf16 bound;
    else None."""
    try:
        packs = [_int4pack(torch, c) for c in qls]
        got = torch._weight_int4pack_mm(x, packs[0][0], GROUP_INT4, packs[0][1])
        torch.cuda.synchronize()
    except (RuntimeError, AttributeError, NotImplementedError, TypeError) as e:
        log(f"torch._weight_int4pack_mm on the card: {str(e).splitlines()[0][:160]}")
        return None
    rel = (got.float()[:, :ref.shape[1]] - ref.float()).abs().max().item() \
        / ref.float().abs().max().item()
    if not rel <= QM_TOL["bfloat16"]:
        log(f"torch._weight_int4pack_mm differs from the plain version ({rel:.2e})")
        return None
    log(f"torch._weight_int4pack_mm: max|d|/max|plain| {rel:.2e} (bound {QM_TOL['bfloat16']})")
    return _yardstick(lambda: graph_ms(
        [lambda c=c: torch._weight_int4pack_mm(x, c[0], GROUP_INT4, c[1]) for c in packs]))


def _sdpa_decode_ms(torch, q, caches, pos, pads):
    """One ``scaled_dot_product_attention`` call computing the decode step
    over a float cache, timed over the same distinct ``caches`` (k, v) as
    the kernel: q [B,H,D] as [B,H,1,D] in the cache's dtype, the live
    window as a boolean mask, grouped-query heads (``enable_gqa``)."""
    k = caches[0][0]
    s = k.shape[2]
    cols = torch.arange(s, device=q.device)
    mask = ((cols[None] >= pads[:, None]) & (cols[None] <= pos[:, None]))[:, None, None]
    qq = q.to(k.dtype)[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _yardstick(lambda: graph_ms(
        [lambda c=c: sdpa(qq, c[0], c[1], attn_mask=mask, enable_gqa=True) for c in caches]))


def _yardstick(timed):
    """A one-call yardstick's time, or None (logged) where this PyTorch
    cannot run or capture that call."""
    try:
        return timed()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log(f"yardstick not timed: {str(e).splitlines()[0][:160]}")
        return None


def _same_bytes(torch, a, b) -> bool:
    """Two QuantLinear (or QuantLinear4) weights hold equal tensors."""
    names = ("packed", "s") if hasattr(a, "packed") else ("q", "s")
    return all(torch.equal(getattr(a, n), getattr(b, n).cpu()) for n in names)


def _same_tensors(torch, a: dict, b: dict) -> bool:
    """Two dicts of tensors (a block's cache) hold equal tensors."""
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k].cpu()) for k in a)


def _llm_2block_run(torch, llm, cfg, p, dev, state_dtype, pallas, inputs=None,
                    prompt_len=40, kv_quant=False, rows=4):
    """prefill_slot, prefill_many and 3 decode_all steps of a 2-block
    full-width model on ``dev`` over ``rows`` slots, the decode steps fed
    ``inputs`` (teacher forcing; None takes the run's own tokens); then one
    decode forward's full logits, through the decode kernel (pallas; its
    int8-cache form under kv_quant; on the CPU the kernel's plain version)
    or the plain attention. "sampled" holds the tokens each decode step
    drew."""
    n, plen = rows, prompt_len
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (n, plen))
    samp = np.zeros((n, llm.SAMP_W), np.float32)
    samp[:, 1] = samp[:, 6] = 1.0
    fns = llm.make_serving_fns(cfg, use_pallas_decode=pallas, kv_quant=kv_quant)
    st = llm.init_state(cfg, n, dtype=state_dtype, kv_quant=kv_quant, device=dev)
    ft = torch.zeros(n, dtype=torch.int32, device=dev)
    fl = torch.zeros((n, 1 + 2 * llm.LP_K), device=dev)
    cp = torch.zeros((n, cfg.vocab_size), dtype=torch.int32, device=dev)
    co, bias = torch.zeros_like(cp), torch.zeros((n, cfg.vocab_size), device=dev)
    # slot 0: its chunks through prefill_slot; the others through prefill_many
    chunks = -(-plen // 32)
    for c in range(chunks):
        m = min(32, plen - 32 * c)
        chunk = np.pad(prompts[0:1, 32 * c:32 * c + m], ((0, 0), (0, 32 - m)))
        ft, fl, st = fns[0](p, st, ft, fl, chunk, 0, 32 * c, m, samp[0], 1, 0, cp, co, bias)
    for c in range(chunks):
        m = min(32, plen - 32 * c)
        toks = np.zeros((n, 32), np.int32)
        toks[1:, :m] = prompts[1:, 32 * c:32 * c + m]
        meta = np.zeros((4, n), np.int32)
        meta[0], meta[1], meta[2, 1:], meta[3] = 32 * c, m, 1, np.arange(n)
        ft, fl, st = fns[2](p, st, ft, fl, toks, meta, samp, 0, cp, co, bias)
    rows = [fl.cpu().numpy()]
    own = inputs is None
    inputs = [ft.cpu().numpy()] if own else inputs
    sampled = [ft.cpu().numpy()]
    for step in range(3):
        meta = np.zeros((5, n), np.int32)
        meta[0], meta[1], meta[4] = plen + step, 1, plen  # no inject: forced input
        tok, st, co, lp = fns[1](p, st, torch.from_numpy(inputs[step]).to(dev), ft,
                                 meta, samp, 0, co, cp, bias)
        rows.append(lp.cpu().numpy())
        sampled.append(tok.cpu().numpy())
        if own:
            inputs.append(tok.cpu().numpy())
    # the decode steps' route: the kernel (its plain version on the CPU) or
    # the plain attention
    impl = llm.decode_attn_impl(True, kv_quant) if pallas else None
    hidden, _ = llm.forward(p, cfg, st, torch.from_numpy(inputs[3]).to(dev)[:, None],
                            torch.full((n,), plen + 3, device=dev), llm.freqs_for(cfg, dev),
                            decode_attn=impl)
    return {"inputs": inputs, "rows": np.stack(rows), "sampled": sampled,
            "logits": llm.logits_at(p, cfg, hidden, 0).float().cpu().numpy()}


def _llm_gap(a, b, lp_k):
    """(logprob rows max|d| over chosen + top-k, logits max|d|, top-k ids equal)."""
    return (float(np.abs(a["rows"] - b["rows"])[..., :1 + lp_k].max()),
            float(np.abs(a["logits"] - b["logits"]).max()),
            bool(np.array_equal(a["rows"][..., 1 + lp_k:], b["rows"][..., 1 + lp_k:])))


def _llm_2block_check(torch, llm, cfg, p_cpu, p_gpu, what):
    """The f32-activation models (f32, int8, int4 weights, f32 KV): card
    (decode kernel) vs CPU, the card teacher-forced with the CPU's tokens."""
    ref = _llm_2block_run(torch, llm, cfg, p_cpu, "cpu", torch.float32, True)
    got = _llm_2block_run(torch, llm, cfg, p_gpu, "cuda", torch.float32, True, ref["inputs"])
    lp_err, logit_err, same_ids = _llm_gap(ref, got, llm.LP_K)
    log(f"2-block Qwen3-1.7B widths, {what}, decode kernel, serving graphs, card vs CPU: "
        f"logprob rows max|d| {lp_err:.2e} (bound {LLM_LP_TOL}), top-8 ids "
        f"{'equal' if same_ids else 'DIFFER'}; decode logits [4,151936] max|d| "
        f"{logit_err:.2e} (bound {LLM_LOGIT_TOL})")
    if not (lp_err < LLM_LP_TOL and logit_err < LLM_LOGIT_TOL
            and np.isfinite(got["logits"]).all()):
        raise AssertionError(f"2-block model {what}: card vs CPU off")
    return lp_err, logit_err


def _llm_2block_bf16_check(torch, llm, cfg, p_cpu):
    """bf16 weights and a bf16 KV cache (serve_llm's default without
    --int8), on the card through the decode kernel and through the plain
    attention, and the port's bf16 path on the CPU, each against the JAX
    package's semantics for these weights: the bf16 values widened to f32
    and f32 products over the bf16 cache (the port on the CPU with the
    widened weights). All teacher-forced with that reference's tokens."""
    widened = {k: v.bfloat16().float() for k, v in p_cpu.items()}
    ref = _llm_2block_run(torch, llm, cfg, widened, "cpu", torch.bfloat16, False)
    del widened
    b_cpu = {k: v.bfloat16() for k, v in p_cpu.items()}
    runs = {"CPU": _llm_2block_run(torch, llm, cfg, b_cpu, "cpu", torch.bfloat16, False,
                                   ref["inputs"])}
    b_gpu = {k: v.cuda() for k, v in b_cpu.items()}
    del b_cpu
    for pallas in (True, False):
        runs[f"card, {'decode kernel' if pallas else 'plain attention'}"] = _llm_2block_run(
            torch, llm, cfg, b_gpu, "cuda", torch.bfloat16, pallas, ref["inputs"])
    del b_gpu
    scale = float(np.abs(ref["logits"]).max())
    gaps = {k: _llm_gap(ref, r, llm.LP_K) for k, r in runs.items()}
    for k, (lp_err, logit_err, same_ids) in gaps.items():
        log(f"2-block Qwen3-1.7B widths, bf16 weights, bf16 KV, {k} vs the f32-product "
            f"reference: logprob rows max|d| {lp_err:.2e}, top-8 ids "
            f"{'equal' if same_ids else 'DIFFER'}; decode logits max|d| {logit_err:.2e} "
            f"({logit_err / scale:.2%} of max|logit| {scale:.3f})")
    cpu_lp, cpu_logit, _ = gaps["CPU"]
    for k, (lp_err, logit_err, _) in gaps.items():
        if not (logit_err <= LLM_BF16_REL * scale and np.isfinite(runs[k]["logits"]).all()
                and lp_err <= LLM_BF16_RATIO * cpu_lp
                and logit_err <= LLM_BF16_RATIO * cpu_logit):
            raise AssertionError(
                f"2-block model bf16, {k}: off the f32-product reference by more than "
                f"{LLM_BF16_REL:.0%} of max|logit| or {LLM_BF16_RATIO}x the CPU's gap")
    return {k: v[:2] for k, v in gaps.items()}


def _engine_tokens_per_s(torch, engine, prompts, max_new):
    """Submit every prompt, step until all are decoding, then time the
    decode to the end: (decode tokens/s, decode steps/s)."""
    reqs = [engine.submit(list(p), max_new=max_new) for p in prompts]
    while any(len(r.tokens) == 0 for r in reqs):
        engine.step()
    torch.cuda.synchronize()
    t0, steps0 = time.perf_counter(), engine.stats["decode_steps"]
    toks0 = sum(len(r.tokens) for r in reqs)
    engine.run_until_idle()
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in reqs) - toks0
    return toks / dt, (engine.stats["decode_steps"] - steps0) / dt, reqs


_SHARED: dict = {}


def _bf16_28_blocks(torch):
    """The 28-block Qwen3-1.7B-width weights, bf16, drawn on the card from a
    torch.Generator seeded 0 (numpy's seed-0 draws took ~45 s on the host),
    once, and shared by phases 8, 12 and 14: they time and count, and
    compare no value with the CPU. Qwen3-VL-2B's language model has the
    same shapes (its rope theta is not a weight)."""
    if "bf16_28" not in _SHARED:
        from clearcam_tpu_torch.models import llm
        t0 = time.time()
        _SHARED["bf16_28"] = llm.init_params(
            llm.qwen3_2b_cfg(28, 8192), dtype=torch.bfloat16, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        log(f"28-block Qwen3-1.7B-width weights, bf16, drawn on the card: "
            f"{time.time() - t0:.1f} s")
    return _SHARED["bf16_28"]


def _f32_2_blocks():
    """A 2-block Qwen3-1.7B-width model (ctx 512), f32 on the CPU from seed
    0 (~20 s of numpy draws), shared by phases 8 and 14."""
    if "f32_2" not in _SHARED:
        from clearcam_tpu_torch.models import llm
        _SHARED["f32_2"] = llm.init_params(llm.qwen3_2b_cfg(2, 512), seed=0)
    return _SHARED["f32_2"]


def phase8(torch):
    log("== phase 8: the LLM on the card vs the CPU; the 28-block int4 engine")
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.ops import decode_attention as dec
    from clearcam_tpu_torch.ops import quant_matmul as qm
    from clearcam_tpu_torch.serving import ServingEngine
    errs = {}
    cfg = llm.qwen3_2b_cfg(2, 512)
    p_cpu = _f32_2_blocks()
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    with torch.inference_mode():
        for quant in (None, "int8", "int4"):
            fn = getattr(llm, f"quantize_params_{quant}") if quant else dict
            q_cpu, q_gpu = fn(p_cpu), fn(p_gpu)
            # quantized on the card, the weights hold the CPU's bytes
            apart = [k for k, w in q_cpu.items()
                     if not torch.is_tensor(w) and not _same_bytes(torch, w, q_gpu[k])]
            if apart:
                raise AssertionError(f"{quant}: card and CPU quantized {apart} apart")
            errs[quant or "f32"] = _llm_2block_check(
                torch, llm, cfg, q_cpu, q_gpu, f"f32{' ' + quant if quant else ''}")
        del p_gpu
        errs["bf16"] = _llm_2block_bf16_check(torch, llm, cfg, p_cpu)
    del p_cpu
    torch.cuda.empty_cache()
    cfg = llm.qwen3_2b_cfg(28, 8192)
    params = llm.quantize_params_int4(_bf16_28_blocks(torch))
    prompts = np.random.default_rng(2).integers(1, cfg.vocab_size, (8, 200))
    tps = {}
    launches = None
    for pallas in (True, False, False, True):
        eng = ServingEngine(params, cfg, n_slots=8, state_dtype=torch.bfloat16,
                            use_pallas_decode=pallas)
        _engine_tokens_per_s(torch, eng, prompts[:, :40], 4)          # warm up
        if pallas and launches is None:
            qm.quant_linear.launches = dec.decode_attention_batch.launches = 0
        rate, steps, reqs = _engine_tokens_per_s(torch, eng, prompts, 48)
        if pallas and launches is None:
            launches = {"int4": qm.quant_linear.launches,
                        "decode": dec.decode_attention_batch.launches}
        tps.setdefault(pallas, []).append((rate, steps))
        if not all(len(r.tokens) == 48 and all(0 <= t < cfg.vocab_size for t in r.tokens)
                   for r in reqs):
            raise AssertionError("28-block engine: a request did not finish 48 tokens")
        log(f"28-block int4 engine, 8 slots, bf16 KV, 200-token prompts, 48 new: "
            f"{'decode kernel' if pallas else 'plain attention'} {rate:.1f} tokens/s "
            f"({steps:.1f} decode steps/s, {1e3 / steps:.2f} ms/step)")
        del eng
        torch.cuda.empty_cache()
    if launches["int4"] < 1 or launches["decode"] < 1:
        raise AssertionError(f"28-block int4 engine launches: {launches}")
    log(f"launches in the int4 engine run: {launches}")
    del params
    torch.cuda.empty_cache()
    return errs, {k: float(np.mean([r for r, _ in v])) for k, v in tps.items()}, launches


# ---------------------------------------------------------------------------
# the Qwen3-VL summary slice: the single-stream and int8 decode kernels

DEC1_REPLACES = "clearcam_tpu/ops/decode_attention.py:67"      # _chunked_kernel
DEC1Q8_REPLACES = "clearcam_tpu/ops/decode_attention.py:481"   # _chunked_kernel_q8
DECBQ8_REPLACES = "clearcam_tpu/ops/decode_attention.py:336"   # _batch_kernel_q8
# the int8 forms against their plain versions on the same int8 bytes and
# scales: f32 arithmetic on both sides, summation order only
DEC_Q8_TOL = 1e-4
# 2-block full-width Qwen3-VL, card vs CPU: the last decode step's logits,
# max |d|; the int8 cache may quantize a K/V element one step apart where
# the card's and the CPU's f32 values straddle a rounding boundary
VL_LOGIT_TOL = {"plain": 2e-3, "kernel": 2e-3, "int8 KV + kernel": 2e-2}
SUMMARY_RES = (544, 960)            # the NVR's Qwen frame size (__main__.py)


def _smoke_tok():
    """Qwen's chat specials at their Qwen3 ids over a byte-level vocabulary;
    decode maps any id to a printable character (random weights give
    arbitrary ids)."""
    from clearcam_tpu_torch.utils.llm_tokenizer import LLMTokenizer
    from clearcam_tpu_torch.utils.tokenizer import byte_encoder

    class SmokeTok(LLMTokenizer):
        def decode(self, ids):
            return "".join(chr(33 + int(i) % 94) for i in ids)
    be = byte_encoder()
    return SmokeTok({be[b]: b for b in range(256)},
                    {"<|im_start|>": 151644, "<|im_end|>": 151645,
                     "<|vision_start|>": 151652, "<|vision_end|>": 151653},
                    preset="qwen2", bos_id=None, eos_id=151645)


def _q8_operands(torch, gen, b, kvh, s):
    kq, vq = (torch.randint(-127, 128, (b, kvh, s, 128), generator=gen, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, kvh, s), generator=gen, device="cuda") * 0.02 + 0.002
              for _ in range(2))
    return kq, ks, vq, vs


def phase10(torch):
    log("== phase 10: decode_attention, decode_attention_q8, decode_attention_batch_q8 "
        "vs plain on the card")
    from clearcam_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator(device="cuda").manual_seed(10)
    h, kvh, d = 16, 8, 128
    out = {"err": {}, "ms": {}}

    def check(name, got, ref, tol):
        """Raise past ``tol``; the JSON's error is the f32-q cases' max."""
        err = (got.float() - ref.float()).abs().max().item()
        if got.dtype == torch.float32:
            out["err"][name] = max(out["err"].get(name, 0.0), err)
        if not (torch.isfinite(got).all() and err < tol):
            raise AssertionError(f"{name}: max|d| {err} >= {tol}")
        return err

    for s in (2048, 8192):
        q = torch.randn((8, h, d), generator=gen, device="cuda")
        kf, vf = (torch.randn((8, kvh, s, d), generator=gen, device="cuda") for _ in range(2))
        kq, ks, vq, vs = _q8_operands(torch, gen, 8, kvh, s)
        positions = [p for p in (0, 256, 4096, s - 1) if p < s]
        for p in positions:
            for cname, cdt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                for qn, qq in (("float32", q[0]), ("bfloat16", q[0].bfloat16())):
                    if cname == "float32" and qn == "bfloat16":
                        continue
                    k1, v1 = kf[0].to(cdt), vf[0].to(cdt)
                    err = check("decode_attention", dec.decode_attention(qq, k1, v1, p),
                                dec.decode_attention_reference(qq, k1, v1, p), DEC_TOL[qn])
                    if qn == "float32":
                        err32 = err
            err8 = check("decode_attention_q8",
                         dec.decode_attention_q8(q[0], kq[0], ks[0], vq[0], vs[0], p),
                         dec.decode_attention_q8_reference(q[0], kq[0], ks[0], vq[0], vs[0], p),
                         DEC_Q8_TOL)
            log(f"B=1 S={s} pos {p}: decode_attention f32 q max|d| {err32:.2e} (bound "
                f"{DEC_TOL['float32']}), bf16 q and cache {err:.2e} (bound "
                f"{DEC_TOL['bfloat16']}); decode_attention_q8 max|d| {err8:.2e} (bound "
                f"{DEC_Q8_TOL})")
        spread = torch.tensor([0, 17, 255, 256, 1000, 2047, s - 1, 600], dtype=torch.int32,
                              device="cuda")
        pads = torch.tensor([0, 5, 200, 0, 999, 1, s // 2, 700], dtype=torch.int32,
                            device="cuda")        # the last row has no live column
        for case, (pos, pd) in {"spread": (spread, torch.zeros_like(spread)),
                                "pads": (spread, pads),
                                "pos256": (torch.full_like(spread, 256), None)}.items():
            for qn, qq in (("float32", q), ("bfloat16", q.bfloat16())):
                got = dec.decode_attention_batch_q8(qq, kq, ks, vq, vs, pos, pd)
                err = check("decode_attention_batch_q8", got,
                            dec.decode_attention_batch_q8_reference(qq, kq, ks, vq, vs, pos, pd),
                            DEC_Q8_TOL if qn == "float32" else DEC_TOL[qn])
                if case == "pads" and got[7].any():
                    raise AssertionError("the row with no live column is not zeros")
            log(f"B=8 S={s} int8 cache, {case}: max|d| {err:.2e} (bf16 q, bound "
                f"{DEC_TOL['bfloat16']}); f32 q within {DEC_Q8_TOL}")
        del kf, vf, kq, ks, vq, vs
    torch.cuda.empty_cache()

    _phase10_times(torch, gen, out)
    return out


def _phase10_times(torch, gen, out):
    """Times at the summary path's shapes, as CUDA-graph replays over enough
    distinct caches that the live bytes cycled pass L2_FLUSH: one stream at
    the cooperative summary's depth (two images, a prompt and 60 tokens:
    ~1100 positions) over a bf16 or int8 cache of 2048; generate_batch's 8
    rows at ~256 (out["ms"])."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    h, kvh, d = 16, 8, 128
    s, p1 = 2048, 1100
    q = torch.randn((h, d), generator=gen, device="cuda")
    live1 = (p1 + 1) * kvh                      # live (position, KV head) pairs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kv = _distinct([], lambda: tuple(torch.randn((kvh, s, d), generator=gen,
                                                 device="cuda").bfloat16()
                                     for _ in range(2)), live1 * d * 2 * 2)
    kt, pt, _ = _pair_ms([lambda c=c: dec.decode_attention_reference(q, *c, p1) for c in kv],
                      [lambda c=c: dec.decode_attention(q, *c, p1) for c in kv])
    mask = (torch.arange(s, device="cuda") <= p1)[None, None, None]
    qq = q.bfloat16()[None, :, None]
    lib = _yardstick(lambda: graph_ms([lambda c=c: sdpa(qq, c[0][None], c[1][None],
                                                        attn_mask=mask, enable_gqa=True)
                                       for c in kv]))
    nb = live1 * d * 2 * 2 + 2 * q.numel() * 4
    out["ms"]["decode_attention"] = (kt, pt, lib) + bound(nb, 4 * live1 * (h // kvh) * d,
                                                          PEAK["float32"])
    counts = {"decode_attention": len(kv)}
    del kv
    q8 = _distinct([], lambda: tuple(t[0] for t in _q8_operands(torch, gen, 1, kvh, s)),
                   live1 * (d * 2 + 8))
    kt, pt, _ = _pair_ms(
        [lambda c=c: dec.decode_attention_q8_reference(q, *c, p1) for c in q8],
        [lambda c=c: dec.decode_attention_q8(q, *c, p1) for c in q8])
    nb = live1 * (d * 2 + 8) + 2 * q.numel() * 4
    out["ms"]["decode_attention_q8"] = (kt, pt, None) + bound(
        nb, 4 * live1 * (h // kvh) * d, PEAK["float32"])
    counts["decode_attention_q8"] = len(q8)
    del q8
    qb = torch.randn((8, h, d), generator=gen, device="cuda")
    pos = torch.full((8,), 256, dtype=torch.int32, device="cuda")
    liveb = 8 * 257 * kvh
    qb8 = _distinct([], lambda: _q8_operands(torch, gen, 8, kvh, s), liveb * (d * 2 + 8))
    kt, pt, _ = _pair_ms(
        [lambda c=c: dec.decode_attention_batch_q8_reference(qb, *c, pos) for c in qb8],
        [lambda c=c: dec.decode_attention_batch_q8(qb, *c, pos) for c in qb8])
    nb = liveb * (d * 2 + 8) + 2 * qb.numel() * 4
    out["ms"]["decode_attention_batch_q8"] = (kt, pt, None) + bound(
        nb, 4 * liveb * (h // kvh) * d, PEAK["float32"])
    counts["decode_attention_batch_q8"] = len(qb8)
    del qb8
    # the host's cost of one eager call (the decode step is host-bound):
    # the enqueue time of 200 calls, the card left to catch up after
    k1, k8 = (torch.randn((b, kvh, s, d), generator=gen, device="cuda").bfloat16()
              for b in (1, 8))
    q8 = tuple(t[0] for t in _q8_operands(torch, gen, 1, kvh, s))
    qb8 = _q8_operands(torch, gen, 8, kvh, s)
    out["host_us"] = {
        "decode_attention": _host_us(torch, lambda: dec.decode_attention(q, k1[0], k1[0], p1)),
        "decode_attention_q8": _host_us(torch, lambda: dec.decode_attention_q8(q, *q8, p1)),
        "decode_attention_batch_q8": _host_us(
            torch, lambda: dec.decode_attention_batch_q8(qb, *qb8, pos)),
        "decode_attention_batch": _host_us(
            torch, lambda: dec.decode_attention_batch(qb, k8, k8, pos))}
    del k1, k8, q8, qb8
    for name, (kt, pt, lib, bms, by) in out["ms"].items():
        b = 8 if name.startswith("decode_attention_batch") else 1
        live = (liveb if b == 8 else live1) * (d * 4 if name == "decode_attention" else d * 2 + 8)
        log(f"{name} at the summary path's shape (B={b} S={s}): "
            + _dec_line(dec, kt, pt, lib, bms, live, counts[name], b, kvh, s)
            + f"; host {out['host_us'][name]:.1f} us a call")
    log(f"decode_attention_batch (B=8 S={s} bf16): host "
        f"{out['host_us']['decode_attention_batch']:.1f} us a call")
    torch.cuda.empty_cache()


def _host_us(torch, fn, n: int = 200) -> float:
    """Host microseconds per eager call of ``fn``: the time to enqueue n
    calls after a sync, before the card has caught up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t) / n * 1e6
    torch.cuda.synchronize()
    return us


def phase11(torch):
    log("== phase 11: Qwen3-VL-2B widths, 2 language + 2 vision blocks, card vs CPU (f32)")
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.models import qwen3vl as qvl
    from clearcam_tpu_torch.ops import decode_attention as dec
    from clearcam_tpu_torch.ops.vit_attention import mha_flash
    t0 = time.time()
    cfg = qvl.qwen3vl_2b_cfg(2, 2048)
    p_cpu = llm.init_params(cfg, seed=0)
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    vkv, vp = qvl.vision_2b_random(blocks=2, deepstack=(1,))
    towers = {"cpu": qvl.VisionTower(vkv, vp, device="cpu"),
              "cuda": qvl.VisionTower(vkv, vp, device="cuda")}
    log(f"init (numpy draws, upload): {time.time() - t0:.1f} s")
    img = np.random.default_rng(11).integers(0, 256, (*SUMMARY_RES, 3), np.uint8)
    before = mha_flash.launches
    e_gpu, d_gpu = towers["cuda"](torch.from_numpy(img).cuda().float())
    if mha_flash.launches - before != 2:
        raise AssertionError(f"vision tower: {mha_flash.launches - before} vit_attention "
                             "launches, not 2")
    e_cpu, d_cpu = towers["cpu"](torch.from_numpy(img).float())
    if tuple(e_gpu.shape) != (510, 2048) or len(d_gpu) != 1:
        raise AssertionError(f"vision tower: embeds {tuple(e_gpu.shape)}, "
                             f"{len(d_gpu)} deepstack features")
    _tower_check("Qwen3-VL vision embeds [510,2048] (2 blocks, kernel)",
                 e_gpu.cpu().numpy(), e_cpu.numpy())
    _tower_check("deepstack feature of vision block 1", d_gpu[0].cpu().numpy(),
                 d_cpu[0].numpy())
    tok = _smoke_tok()
    prompt = tok.encode("<|im_start|>user\nWhat has been detected on my CCTV camera? "
                        "Write in one short sentence<|im_end|>\n<|im_start|>assistant\n")
    out = {"logits": {}, "cache": None}
    plain_logits_at = llm.logits_at
    for route, q8, pallas in (("plain", False, False), ("kernel", False, True),
                              ("int8 KV + kernel", True, True)):
        runs = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            lang = llm.Transformer(p, cfg, kv_quant=q8, use_pallas_decode=pallas)
            vlm = qvl.Qwen3VL(res=SUMMARY_RES, lang=lang, tok=tok, vision=towers[dev])
            counts = (dec.decode_attention.launches, dec.decode_attention_q8.launches)
            vlm.feed_image(img, reset=True)
            # a copy: .cpu() of a CPU tensor is the tensor, which generate
            # goes on writing
            cache = [{k: v.to("cpu", copy=True) for k, v in s_.items()}
                     for s_ in lang.state] if q8 else None
            steps = []       # every logits row generate samples from, in order

            def recording(p_, cfg_, hidden, index, steps=steps):
                lg = plain_logits_at(p_, cfg_, hidden, index)
                steps.append(lg.float().cpu().numpy()[0])
                return lg
            llm.logits_at = recording
            try:
                toks = list(lang.generate(prompt, temperature=0.0,
                                          cache_offset=vlm.start_pos, max_new=8))
            finally:
                llm.logits_at = plain_logits_at
            launched = (dec.decode_attention.launches - counts[0],
                        dec.decode_attention_q8.launches - counts[1])
            runs[dev] = (toks, np.stack(steps), launched, cache)
        # the prompt's prefill chunk(s) and 7 decode steps: every step's
        # logits, and each step's top-8 ids (where the CPU's 8th and 9th
        # logits are nearer than the bound, either order is right)
        lg_cpu, lg_gpu = runs["cpu"][1], runs["cuda"][1]
        err = float(np.abs(lg_gpu - lg_cpu).max())
        per_step = np.abs(lg_gpu - lg_cpu).max(-1)
        top_cpu, top_gpu = (np.argsort(-x, -1)[:, :8] for x in (lg_cpu, lg_gpu))
        srt = -np.sort(-lg_cpu, -1)
        ties = srt[:, 7] - srt[:, 8] < VL_LOGIT_TOL[route]
        top_ok = all(set(a) == set(b) or t for a, b, t in zip(top_cpu, top_gpu, ties))
        n = 7 * cfg.num_blocks          # 7 decode steps, each through every block
        want = (0, 0) if not pallas else ((0, n) if q8 else (n, 0))
        log(f"image prefill + 8 greedy tokens, {route}: card {runs['cuda'][0]}, CPU "
            f"{runs['cpu'][0]}; logits of all {len(lg_cpu)} steps max|d| {err:.2e} (bound "
            f"{VL_LOGIT_TOL[route]}), per step {[f'{x:.1e}' for x in per_step]}; top-8 ids "
            f"{'equal' if (top_cpu == top_gpu).all() else 'equal as sets' if top_ok else 'DIFFER'}"
            f"; card launches (decode_attention, _q8) {runs['cuda'][2]}")
        if q8:
            out["cache"] = _q8_cache_gap(torch, runs["cpu"][3], runs["cuda"][3])
        if runs["cuda"][0] != runs["cpu"][0] or not err < VL_LOGIT_TOL[route] \
                or not top_ok or runs["cuda"][2] != want or runs["cpu"][2] != (0, 0):
            raise AssertionError(f"Qwen3-VL 2-block {route}: card vs CPU off")
        out["logits"][route] = err
    del p_cpu, p_gpu, towers
    torch.cuda.empty_cache()
    return out


def _q8_cache_gap(torch, cpu, gpu) -> dict:
    """The int8 cache after the image prefill, card against CPU: the int8
    values (where they differ, by how many steps) and the f32 scales."""
    n = diff = 0
    steps = 0
    s_err = 0.0
    for a, b in zip(cpu, gpu):
        for name in ("k", "v"):
            d = (a[name].int() - b[name].int()).abs()
            n += d.numel()
            diff += int((d > 0).sum())
            steps = max(steps, int(d.max()))
            sa, sb = a[name + "_s"], b[name + "_s"]
            s_err = max(s_err, float(((sa - sb).abs() / sa.abs().clamp_min(1e-30)).max()))
    same = all(_same_tensors(torch, a, b) for a, b in zip(cpu, gpu))
    log(f"int8 KV cache after the image prefill, card vs CPU: "
        f"{'bytes equal' if same else 'bytes differ'}; {diff} of {n} int8 values differ "
        f"({diff / n:.2e}), by at most {steps} step(s); scales max rel|d| {s_err:.2e}")
    # the scales follow the f32 K/V, which the card and the CPU compute to
    # ~1e-4 apart through the tower and the blocks; a value may round one
    # step apart where x/s lies that close to a rounding boundary
    if steps > 1 or diff > 1e-2 * n or s_err > 1e-2:
        raise AssertionError("int8 KV cache: card and CPU quantized further apart than one "
                             "rounding step on 1% of values, or scales 1% apart")
    return {"values_differ": diff, "values": n, "max_steps": steps, "scale_rel": s_err}


class KeyColourDetector:
    """Finds the synthetic source's (40,180,240) box by colour and gives one
    class-0 detection per frame: a stand-in detector that makes the NVR
    raise its alert without a trained model."""

    def detect_many(self, frames):
        out = []
        for f in frames:
            mask = np.abs(f.astype(np.int16) - np.array([40, 180, 240], np.int16)).sum(-1) < 30
            ys, xs = np.where(mask)
            out.append(np.zeros((0, 6), np.float32) if len(xs) == 0 else np.array(
                [[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1, 0.9, 0.0]], np.float32))
        return out


def _nvr_summaries(qwen, n_cams: int, slots: int, seconds: float = 300.0) -> dict:
    """The port's NVR in-process, ``n_cams`` synthetic cameras, the
    key-colour detector: run ticks until every camera's alert has an "AI
    Summary" notification. -> {camera: (seconds from its alert to its
    summary, summary text)}."""
    import torch

    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.runtime.settings import GlobalSettings
    from clearcam_tpu_torch.utils.db import KVStore
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_nvr_"))
    db = KVStore(tmp / "kv.db")
    for i in range(n_cams):
        db.run_put("links", f"cam{i}", "synthetic://640x360")
    notes = []
    nvr = NVR(db, tmp / "data", GlobalSettings(userID="smoke", key="k", use_qwen=True),
              detector=KeyColourDetector(), qwen=qwen,
              notifier=lambda *a: notes.append((time.perf_counter(), a)),
              uploader=lambda **kw: True, summary_slots=slots, use_native_ingest=False)
    try:
        for i in range(n_cams):
            nvr.init_cam(f"cam{i}", "synthetic://640x360")
        deadline = time.time() + seconds

        def by_kind(kind):
            found = {}
            for t, (_, title, body) in notes:
                if title.startswith(kind):
                    cam = title[title.index("(") + 1:title.index(")")]
                    found.setdefault(cam, (t, body))
            return found
        while len(by_kind("AI Summary")) < n_cams:
            if time.time() > deadline:
                raise AssertionError(f"summaries within {seconds} s: "
                                     f"{[n[1][1] for n in notes]}")
            nvr.tick()
        torch.cuda.synchronize()
    finally:
        nvr.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    alerts, sums = by_kind("Event Detected"), by_kind("AI Summary")
    return {cam: (sums[cam][0] - alerts[cam][0], sums[cam][1]) for cam in sums}


def _summary_layers(torch, qwen, lang, img, prompt, steps: int = 32) -> dict:
    """The cooperative summary's layers apart, in milliseconds, each timed
    with CUDA events after a sync (3 runs after a warm-up): the vision
    tower alone; the image prefill (feed_image, which runs the tower, less
    the tower); the prompt's prefill and first token; one greedy decode
    step ((prompt + 1 + steps tokens) - (prompt + 1 token)) / steps; and,
    by the same difference under torch.profiler, the decode step's kernel
    launches, their device time and the decode-attention kernels' share."""
    qwen.lang = lang
    x = qwen.image_tensor(img)

    def gen(n):
        qwen.feed_image(img, reset=True)
        for _ in lang.generate(prompt, temperature=0.0, cache_offset=qwen.start_pos,
                               max_new=n):
            pass
    with torch.inference_mode():
        tower = cuda_ms(lambda: qwen.vision.apply(qwen.vision.p, x), iters=3, warmup=1)
        feed = cuda_ms(lambda: qwen.feed_image(img, reset=True), iters=3, warmup=1)
        first = cuda_ms(lambda: gen(1), iters=3, warmup=1)
        more = cuda_ms(lambda: gen(1 + steps), iters=3, warmup=1)
        k_first, k_more = _kernels(torch, lambda: gen(1)), _kernels(torch, lambda: gen(1 + steps))
    per_step = [(b - a) / steps for a, b in zip(k_first, k_more)]
    return {"vision_tower_ms": tower, "image_prefill_ms": feed - tower,
            "prompt_prefill_first_token_ms": first - feed,
            "decode_step_ms": (more - first) / steps,
            "launches_per_decode_step": per_step[0],
            "kernel_ms_per_decode_step": per_step[1],
            "decode_attention_ms_per_decode_step": per_step[2]}


def _kernels(torch, fn, match=("decode_split", "decode_merge")) -> tuple:
    """(kernels launched, their device ms, the device ms of the kernels
    whose name holds one of ``match``, by default the decode-attention
    ones) in one call of ``fn``, from torch.profiler's CUDA rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3,
            sum(e.self_device_time_total for e in rows
                if any(m in e.key for m in match)) / 1e3)


def phase12(torch):
    log("== phase 12: Qwen3-VL-2B alert summaries (14 of 28 language blocks + 24 vision "
        "blocks) in the "
        "port's NVR")
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.models import qwen3vl as qvl
    from clearcam_tpu_torch.ops import decode_attention as dec
    from clearcam_tpu_torch.ops import quant_matmul as qm
    from clearcam_tpu_torch.ops.vit_attention import mha_flash
    t0 = time.time()
    # 14 language blocks (28 until phase 18 joined the smoke: its 1200 s limit)
    cfg = qvl.qwen3vl_2b_cfg(14, 2048)
    params = llm.quantize_params_int8(
        {k: v for k, v in _bf16_28_blocks(torch).items()
         if not k.startswith("blk.") or int(k.split(".")[1]) < cfg.num_blocks})
    tower = qvl.VisionTower(*qvl.vision_2b_random(), device="cuda")
    log(f"{cfg.num_blocks}-block language model (int8 weights) and 24-block vision tower "
        f"(f32), random from seed 0: {time.time() - t0:.1f} s")
    tok = _smoke_tok()
    langs = {"bf16 KV": llm.Transformer(params, cfg, state_dtype=torch.bfloat16,
                                        use_pallas_decode=True),
             "int8 KV": llm.Transformer(params, cfg, kv_quant=True, use_pallas_decode=True)}
    qwen = qvl.Qwen3VL(res=SUMMARY_RES, lang=langs["int8 KV"], tok=tok, vision=tower)
    qwen.prewarm()
    counters = {"decode_attention": dec.decode_attention,
                "decode_attention_q8": dec.decode_attention_q8,
                "decode_attention_batch": dec.decode_attention_batch,
                "decode_attention_batch_q8": dec.decode_attention_batch_q8,
                "quant_matmul": qm.quant_linear, "vit_attention": mha_flash}

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        r = fn()
        torch.cuda.synchronize()
        return r, {k: c.launches for k, c in counters.items()}
    out = {"launches": {}, "summary_s": {}, "layers": {}}
    img = np.random.default_rng(13).integers(0, 256, (*SUMMARY_RES, 3), np.uint8)
    prompt = tok.encode("<|im_start|>user\nWhat has been detected on my CCTV camera? "
                        "Write in one short sentence<|im_end|>\n<|im_start|>assistant\n")
    for name in ("bf16 KV", "int8 KV"):
        out["layers"][name] = _summary_layers(torch, qwen, langs[name], img, prompt)
        log(f"summary by layer, {name}: {out['layers'][name]}")
    for name in ("bf16 KV", "int8 KV"):
        qwen.lang = langs[name]
        res, launches = counted(lambda: _nvr_summaries(qwen, 1, 0))
        (sec, text), = res.values()
        log(f"cooperative summary, {name}, int8 weights: {sec:.2f} s from the alert to "
            f"the notification; text {text!r}; launches {launches}")
        if not text:
            raise AssertionError(f"cooperative summary {name}: empty text")
        out["summary_s"][f"cooperative, {name}"] = sec
        out["launches"][name] = launches
    qwen.lang = langs["bf16 KV"]
    res, launches = counted(lambda: _nvr_summaries(qwen, 4, 4))
    secs = sorted(v[0] for v in res.values())
    log(f"4 concurrent alerts through VLMServingEngine (4 slots, bf16 KV): seconds from "
        f"each alert to its notification {[round(x, 2) for x in secs]}; texts "
        f"{[v[1][:16] for v in res.values()]}; launches {launches}")
    if len(res) != 4 or not all(v[1] for v in res.values()):
        raise AssertionError(f"engine summaries: {res}")
    out["summary_s"]["engine, 4 alerts, slowest"] = secs[-1]
    out["launches"]["engine"] = launches
    # the engine with speculative windows (plain attention: a window has
    # G+1 queries); the summaries sample at TEMP, one token a window
    os.environ["CLEARCAM_SPEC_LOOKUP"] = "4"
    try:
        res, launches = counted(lambda: _nvr_summaries(qwen, 1, 2))
    finally:
        del os.environ["CLEARCAM_SPEC_LOOKUP"]
    (sec, text), = res.values()
    log(f"summary through VLMServingEngine with CLEARCAM_SPEC_LOOKUP=4 (2 slots, bf16 KV): "
        f"{sec:.2f} s from the alert to the notification; text {text!r}; launches {launches}")
    if not text or launches["decode_attention_batch"] or launches["decode_attention"]:
        raise AssertionError("spec summary: no text, or a decode kernel ran under spec")
    out["summary_s"]["engine, spec 4"] = sec
    prompts = [list(r) for r in np.random.default_rng(12).integers(1, 150000, (8, 200))]
    kw = dict(kv_quant=True, use_pallas_decode=True)
    llm.generate_batch(params, cfg, [p[:40] for p in prompts], max_new=2, **kw)   # warm up
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    llm.generate_batch(params, cfg, prompts, max_new=1, **kw)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t1
    t1 = time.perf_counter()
    rows, launches = counted(lambda: llm.generate_batch(params, cfg, prompts, max_new=48, **kw))
    t_all = time.perf_counter() - t1
    tps = 8 * 47 / (t_all - t_prefill)
    log(f"generate_batch B=8, 200-token prompts, 48 new, int8 weights, int8 KV + kernel: "
        f"{t_all:.2f} s ({t_prefill:.2f} s prefill and first token), decode {tps:.1f} "
        f"tokens/s; launches {launches}")
    if not all(len(r) == 48 for r in rows):
        raise AssertionError("generate_batch: a row did not give 48 tokens")
    out["launches"]["generate_batch"] = launches
    out["generate_batch_tps"] = tps
    need = {"bf16 KV": ("decode_attention", "quant_matmul", "vit_attention"),
            "int8 KV": ("decode_attention_q8", "quant_matmul", "vit_attention"),
            "engine": ("decode_attention_batch", "quant_matmul", "vit_attention"),
            "generate_batch": ("decode_attention_batch_q8", "quant_matmul")}
    for run, names in need.items():
        for n in names:
            if out["launches"][run][n] < 1:
                raise AssertionError(f"{run}: the {n} kernel was never launched")
    del langs, qwen, tower, params
    torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# the FMA-rate probe and speculative serving

PROBE_SOURCE = "clearcam_tpu_torch/csrc/vpu_probe.cu"
PROBE_REPLACES = "clearcam_tpu/tools/vpu_probe.py:34"          # _kernel
# probe kernel vs probe_reference, max |d|: f32 rounds each multiply-add
# once on both sides (relative to max|plain|); bf16 __hfma2 rounds once
# where the plain version rounds the product and the sum apart, so each
# chain may settle a few ulps from the plain one's fixed point: within 1.0,
# two bf16 ulps of the ~95 sum
PROBE_TOL = {"float32": 1e-5, "bfloat16": 1.0}
# the data sheet's CUDA-core peaks, FLOP/s (2 per multiply-add): f32, and
# bf16 outside the tensor cores
PROBE_PEAK = {"float32": 67e12, "bfloat16": 133.8e12}


def _sass_fma_count(fun: str) -> dict:
    """FFMA / HFMA2 instructions in the SASS of the probe kernel ``fun``
    in the built library (cuobjdump), or {} where the toolkit has none."""
    from clearcam_tpu_torch.ops import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        log(f"cuobjdump not found beside nvcc ({tool}): SASS not checked")
        return {}
    text = subprocess.run([str(tool), "-sass", "-fun", fun, _build.last_build["path"]],
                          capture_output=True, text=True, timeout=120).stdout
    # bf16x2 multiply-adds issue on both the FMA pipe (HFMA2.BF16_V2) and
    # the MMA pipe (HFMA2.MMA.BF16_V2); HFMA2.MMA without BF16 is a move
    return {"FFMA": len(re.findall(r"\bFFMA\b", text)),
            "HFMA2": len(re.findall(r"\bHFMA2(?:\.MMA)?\.BF16_V2\b", text)),
            "lines": len(text.splitlines())}


def phase13(torch):
    log("== phase 13: the FMA-rate probe kernel vs plain on the card; tools/vpu_probe")
    from clearcam_tpu_torch.tools import vpu_probe as vp
    out = {"err": {}, "ms": {}}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        x = torch.ones((vp.ROWS, 128), dtype=dt, device="cuda")
        got, ref = vp.probe(x), vp.probe_reference(x)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item() if name == "float32" else 1.0
        log(f"probe {name} [{vp.ROWS},128] x {vp.ITERS} multiply-adds per chain: kernel "
            f"{got[0, 0].item():.6f}, plain {ref[0, 0].item():.6f}, max|d| {err:.3e} "
            f"(bound {PROBE_TOL[name]}{' x max|plain|' if name == 'float32' else ''})")
        if not (torch.isfinite(got.float()).all() and err <= PROBE_TOL[name] * scale):
            raise AssertionError(f"probe {name}: kernel vs plain {err}")
        out["err"][name] = err
        k = cuda_ms(lambda: vp.probe(x), iters=30, warmup=2)
        p = cuda_ms(lambda: vp.probe_reference(x), iters=1, warmup=1)
        flops = 2 * vp.macs_per_call()
        out["ms"][name] = (k, p, None) + bound(2 * x.numel() * x.element_size(), flops,
                                              PROBE_PEAK[name])
        log(f"probe {name}: kernel {k:.4f} ms = {vp.macs_per_call() / k / 1e9:.2f} T "
            f"multiply-adds/s ({flops / k / 1e9 / PROBE_PEAK[name] * 1e12:.0%} of the "
            f"{PROBE_PEAK[name] / 1e12:.1f} TFLOP/s CUDA-core peak, bound "
            f"{out['ms'][name][3]:.4f} ms); plain {p:.1f} ms")
    from clearcam_tpu_torch.ops import _build
    lines = _build.last_build["log"].splitlines()
    for fun, op in (("vpu_probe_f32", "FFMA"), ("vpu_probe_bf16", "HFMA2")):
        at = next((i for i, ln in enumerate(lines) if f"entry function '{fun}'" in ln), None)
        used = next((ln.strip() for ln in lines[at:at + 4] if "Used" in ln), "") \
            if at is not None else ""
        m = re.search(r"Used (\d+) registers", used)
        if m:
            # 128-thread blocks: resident blocks per SM by registers (64 K a
            # SM, allocated per warp in units of 256), threads (2048), blocks (32)
            regs = -(-int(m.group(1)) * 32 // 256) * 256
            blocks = min(65536 // (regs * 4), 2048 // 128, 32)
            used += f"; {blocks} blocks of 128 threads per SM by ptxas's count"
        n = _sass_fma_count(fun)
        log(f"ptxas, {fun}: {used or 'not in the build log'}; SASS: {n}")
        # the loop body: 8 chains x the 4-trip unroll, plus a remainder trip
        if n and n[op] < 8 * 4:
            raise AssertionError(f"{fun}: {n[op]} {op} in the SASS, the loop was cut")
    # the tool as a user runs it
    proc = subprocess.run([sys.executable, "-m", "clearcam_tpu_torch.tools.vpu_probe"],
                          capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
    if proc.returncode != 0:
        raise AssertionError(f"tools/vpu_probe: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"python -m clearcam_tpu_torch.tools.vpu_probe: {line}")
    res = json.loads(line)
    for key in ("vpu_f32_tmacs", "vpu_bf16_tmacs", "conv1_ms_at_measured_bf16_rate"):
        if not (np.isfinite(res[key]) and res[key] > 0):
            raise AssertionError(f"tools/vpu_probe: {key} = {res[key]}")
    log(f"probe rates against the CUDA-core peaks: f32 {res['vpu_f32_tmacs']:.2f} of "
        f"{PROBE_PEAK['float32'] / 2e12:.1f} T multiply-adds/s, bf16 "
        f"{res['vpu_bf16_tmacs']:.2f} of {PROBE_PEAK['bfloat16'] / 2e12:.1f}")
    out["tool"] = res
    return out


def _spec_tokens(torch, engine, prompts, max_new, stagger=0):
    """Each prompt's tokens through ``engine``, the requests admitted
    ``stagger`` scheduler ticks apart."""
    reqs = []
    for p in prompts:
        reqs.append(engine.submit(list(p), max_new=max_new))
        for _ in range(stagger):
            engine.step()
    engine.run_until_idle()
    return [r.wait(1) for r in reqs]


# phase 14 (b)'s engine depth: 14 of the 28 blocks (cut when phase 18 joined
# the smoke, for its 1200 s limit)
SPEC_BLOCKS = 14


def phase14(torch):
    log(f"== phase 14: speculative serving: 2 blocks card vs CPU; {SPEC_BLOCKS} blocks int8; "
        "llm_bench")
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.serving import ServingEngine
    out = {}
    # (a) 2 blocks at full width, f32, 3 requests admitted 2 ticks apart on
    # 2 slots: a periodic prompt, a random one, and one repeated token whose
    # greedy continuation cycles through 3 ids on these weights (found by
    # generating from such prompts on the CPU), prompt lookup's regime; then
    # that one alone on 1 slot. No lag, so no dispatch is a junk one
    cfg = llm.qwen3_2b_cfg(2, 512)
    p_cpu = _f32_2_blocks()
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    rng = np.random.default_rng(14)
    pat = rng.integers(1, cfg.vocab_size, 7).tolist()
    cycling = [141544] * 16
    prompts = [pat * 6, rng.integers(1, cfg.vocab_size, 40).tolist(), cycling]
    toks, stats = {}, {}
    for dev, p, spec, batch in (("cpu", p_cpu, 4, prompts), ("cuda", p_gpu, 4, prompts),
                                ("cuda", p_gpu, 0, prompts), ("cuda", p_gpu, 4, [cycling]),
                                ("cuda", p_gpu, 0, [cycling])):
        eng = ServingEngine(p, cfg, n_slots=len(batch) - 1 or 1, spec_lookup=spec,
                            sync_lag=0, fetch_every=1)
        toks[dev, spec, len(batch)] = _spec_tokens(torch, eng, batch, 24, stagger=2)
        stats[dev, spec, len(batch)] = dict(eng.stats)
    st, solo = stats["cuda", 4, 3], stats["cuda", 4, 1]
    log(f"2-block Qwen3-1.7B widths f32, spec 4 vs no spec, 3 requests of 24 tokens on 2 "
        f"slots: card spec {toks['cuda', 4, 3]}; equal to the CPU's spec tokens "
        f"{toks['cuda', 4, 3] == toks['cpu', 4, 3]}, to the card's non-spec tokens "
        f"{toks['cuda', 4, 3] == toks['cuda', 0, 3]}; {st['spec_emitted']} tokens emitted in "
        f"{st['decode_steps']} decode dispatches (non-spec: "
        f"{stats['cuda', 0, 3]['decode_steps']}); the cycling request alone: "
        f"{solo['spec_emitted']} tokens in {solo['decode_steps']} dispatches (non-spec: "
        f"{stats['cuda', 0, 1]['decode_steps']}), tokens equal "
        f"{toks['cuda', 4, 1] == toks['cuda', 0, 1]}")
    if not (toks["cuda", 4, 3] == toks["cpu", 4, 3] == toks["cuda", 0, 3]
            and toks["cuda", 4, 1] == toks["cuda", 0, 1]
            and st["spec_emitted"] > st["decode_steps"]
            and solo["spec_emitted"] > solo["decode_steps"]):
        raise AssertionError("2-block spec engine: tokens differ or no draft accepted")
    out["2block"] = {"emitted": solo["spec_emitted"], "dispatches": solo["decode_steps"],
                     "nonspec_dispatches": stats["cuda", 0, 1]["decode_steps"]}
    del p_cpu, p_gpu
    _SHARED.pop("f32_2", None)
    torch.cuda.empty_cache()

    # (b) SPEC_BLOCKS blocks, int8 weights, 8 slots: decode tokens/s with and without
    # spec windows on the same prompts, 200 tokens: 4 random and 4 of one
    # repeated token (random weights rarely repeat themselves on random
    # text; repeated-token prompts make cycles likelier). Acceptance on
    # random weights says nothing of real text's
    cfg = llm.qwen3_2b_cfg(SPEC_BLOCKS, 8192)
    params = llm.quantize_params_int8(
        {k: v for k, v in _bf16_28_blocks(torch).items()
         if not k.startswith("blk.") or int(k.split(".")[1]) < cfg.num_blocks})
    rng = np.random.default_rng(15)
    prompts = np.concatenate([rng.integers(1, cfg.vocab_size, (4, 200)),
                              np.repeat(rng.integers(1, cfg.vocab_size, (4, 1)), 200, 1)])
    rates = {}
    # spec 4 and no spec on the plain attention (the route spec runs); "q8":
    # the int8 cache through decode_attention_batch_q8, no spec
    for spec in (4, 0, "q8", "q8", 0, 4):
        q8 = spec == "q8"
        eng = ServingEngine(params, cfg, n_slots=8, state_dtype=torch.bfloat16,
                            spec_lookup=0 if q8 else spec, kv_quant=q8,
                            use_pallas_decode=q8)
        _engine_tokens_per_s(torch, eng, prompts[:, :40], 4)          # warm up
        e0, d0 = eng.stats["spec_emitted"], eng.stats["decode_steps"]
        rate, steps, reqs = _engine_tokens_per_s(torch, eng, prompts, 48)
        if not all(len(r.tokens) == 48 for r in reqs):
            raise AssertionError(f"{cfg.num_blocks}-block spec engine: a request did not "
                                 "finish 48 tokens")
        # tokens per dispatch over the timed decode, summed over the slots;
        # the JAX tool's tokens_per_window: windows' emitted tokens (before
        # the eos/max_new cut) per dispatch
        per_dispatch = rate / steps
        per_window = (eng.stats["spec_emitted"] - e0) / max(1, eng.stats["decode_steps"] - d0)
        rates.setdefault(spec, []).append((rate, steps, per_dispatch))
        log(f"{cfg.num_blocks}-block int8 engine, 8 slots, 200-token prompts, 48 new, "
            f"{'int8 KV + q8 kernel' if q8 else f'bf16 KV, spec {spec}'}: {rate:.1f} "
            f"decode tokens/s ({steps:.1f} dispatches/s, {1e3 / steps:.2f} ms each, "
            f"{per_dispatch:.2f} tokens per dispatch"
            + (f", tokens_per_window {per_window:.2f})" if spec == 4 else ")"))
        del eng
        torch.cuda.empty_cache()
    out["engine"] = {str(k): [float(np.mean([x[i] for x in v])) for i in range(3)]
                      for k, v in rates.items()}
    r28 = out["engine"]
    log(f"{cfg.num_blocks}-block spec 4 / no spec: decode tokens/s {r28['4'][0]:.1f} / {r28['0'][0]:.1f}; "
        f"tokens per window per slot ~{r28['4'][2] / r28['0'][2]:.2f} (tokens per dispatch "
        "over the non-spec engine's; random weights, not real text); int8 KV + q8 kernel "
        f"decode step {1e3 / r28['q8'][1]:.2f} ms")
    del params
    _SHARED.pop("bf16_28", None)
    torch.cuda.empty_cache()

    # (c) the micro-benchmark as a user runs it
    cmd = [sys.executable, "-m", "clearcam_tpu_torch.tools.llm_bench", "--blocks", "8",
           "--modes", "int8,int8+kv8+pallas", "--decode-batch", "1,8", "--steps", "32"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
    if proc.returncode != 0:
        raise AssertionError(f"llm_bench: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    for x in proc.stdout.splitlines():
        log(f"  llm_bench| {x}")
    if len(lines) != 4 or not all(x.get("decode_tok_s", 0) > 0 for x in lines):
        raise AssertionError(f"llm_bench: {proc.stdout[-2000:]}")
    out["llm_bench"] = lines
    return out


# ---------------------------------------------------------------------------
# the MoE, MLA and GatedDeltaNet-hybrid stacks

# the engines' depth, half the published 48, 27 and 28 (cut when phase 18
# joined the smoke, for its 1200 s limit: with the MoE at 48 the whole smoke
# took 1199.3 s on a slow host; the hybrid keeps every 4th block attention)
FAMILY_BLOCKS = {"moe": 24, "mla": 14, "hybrid": 12}
# card vs CPU: 2 blocks of each family (the hybrid 4, so that its first
# attention block is in)
FAMILY_CHECK_BLOCKS = {"moe": 2, "mla": 2, "hybrid": 4}


def qwen3_30b_a3b_cfg(llm, blocks: int = 48, ctx: int = 2048):
    """Qwen/Qwen3-30B-A3B's config.json: hidden 2048, 48 layers, 32 query
    and 4 KV heads of 128 with qk-norm, 128 experts of 768 with 8 a token
    (norm_topk_prob), vocab 151936, rope theta 1e6, RMS eps 1e-6."""
    return llm.TransformerConfig(
        num_blocks=blocks, dim=2048, hidden_dim=768, n_heads=32, n_kv_heads=4,
        norm_eps=1e-6, vocab_size=151936, head_dim=128, rope_theta=1e6, rope_dim=128,
        v_head_dim=128, max_context=ctx, qk_norm=128, num_experts=128,
        num_experts_per_tok=8, norm_topk_prob=True)


def deepseek_v2_lite_cfg(llm, blocks: int = 27, ctx: int = 2048):
    """deepseek-ai/DeepSeek-V2-Lite's config.json: hidden 2048, 27 layers, 16
    heads, MLA with kv_lora_rank 512 and no q-LoRA, qk 128 nope + 64 rope, v
    128; 64 routed experts of 1408 with 6 a token (softmax over all, no
    renormalization, scale 1.0), 2 shared experts (2816, no gate), the
    first block dense with FFN 10944; vocab 102400, rope theta 1e4, RMS eps
    1e-6. Its YaRN rope scaling has no field in TransformerConfig (nor in
    the JAX package's): both run plain RoPE."""
    return llm.TransformerConfig(
        num_blocks=blocks, dim=2048, hidden_dim=1408, n_heads=16, n_kv_heads=16,
        norm_eps=1e-6, vocab_size=102400, head_dim=192, rope_theta=1e4, rope_dim=64,
        v_head_dim=128, max_context=ctx, num_experts=64, num_experts_per_tok=6,
        norm_topk_prob=False, kv_lora_rank=512, q_lora_rank=0, shared_expert_dim=2816,
        shared_expert_gate=False, leading_dense_blocks=1, dense_hidden_dim=10944)


def _family_cfg(llm, family: str, blocks: int, ctx: int = 2048):
    return {"moe": qwen3_30b_a3b_cfg, "mla": deepseek_v2_lite_cfg,
            "hybrid": lambda _, b, c: llm.qwen3_next_cfg(b, c)}[family](llm, blocks, ctx)


FAMILY_NAMES = {"moe": "Qwen3-30B-A3B widths", "mla": "DeepSeek-V2-Lite widths (MLA + MoE)",
                "hybrid": "the Qwen3-Next-class hybrid (qwen3_next_cfg)"}


def _family_card_vs_cpu(torch, llm, family: str) -> dict:
    """(a) One family at full width, FAMILY_CHECK_BLOCKS deep, f32 weights
    drawn on the card (a torch.Generator) and copied to the CPU; f32 and
    int8 weights, and int4 on the MoE (quantized on each side, the same
    bytes), through
    prefill_slot, prefill_many and 3 teacher-forced decode_all steps, the
    card (the decode kernel on the MoE's attention) against the CPU (plain
    versions): logprob rows and the last logits within phase 8's bounds,
    the greedy tokens of every step equal."""
    from clearcam_tpu_torch.ops import quant_matmul as qm
    cfg = _family_cfg(llm, family, FAMILY_CHECK_BLOCKS[family], 512)
    gen = torch.Generator(device="cuda").manual_seed(15)
    p_gpu = llm.init_params(cfg, device="cuda", generator=gen)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items()}
    pallas = cfg.ssm is None            # the hybrid refuses the decode kernel
    out = {}
    with torch.inference_mode():
        for quant in (None, "int8") + (("int4",) if family == "moe" else ()):
            fn = getattr(llm, f"quantize_params_{quant}") if quant else dict
            q_cpu, q_gpu = fn(p_cpu), fn(p_gpu)
            apart = [k for k, w in q_cpu.items()
                     if not torch.is_tensor(w) and not _same_bytes(torch, w, q_gpu[k])]
            if apart:
                raise AssertionError(f"{family} {quant}: card and CPU quantized {apart} apart")
            ref = _llm_2block_run(torch, llm, cfg, q_cpu, "cpu", torch.float32, pallas,
                                  prompt_len=24)
            n0 = qm.quant_linear.launches
            got = _llm_2block_run(torch, llm, cfg, q_gpu, "cuda", torch.float32, pallas,
                                  ref["inputs"], prompt_len=24)
            lp_err, logit_err, same_ids = _llm_gap(ref, got, llm.LP_K)
            scale = float(np.abs(ref["logits"]).max())
            same_tok = all(np.array_equal(a, b) for a, b in zip(got["sampled"], ref["inputs"]))
            what = f"f32{' ' + quant if quant else ''}"
            log(f"{cfg.num_blocks}-block {FAMILY_NAMES[family]}, {what}, card vs CPU: logprob "
                f"rows max|d| {lp_err:.2e} (bound {LLM_LP_TOL}), logits max|d| {logit_err:.2e} "
                f"(bound {LLM_LOGIT_TOL}) = {logit_err / scale:.2e} of max|logit| "
                f"{scale:.3f}; greedy tokens of 4 steps x 4 rows "
                f"{'equal' if same_tok else 'DIFFER'}, top-8 ids "
                f"{'equal' if same_ids else 'DIFFER'}; quant launches "
                f"{qm.quant_linear.launches - n0}")
            if not (lp_err < LLM_LP_TOL and logit_err < LLM_LOGIT_TOL and same_tok
                    and np.isfinite(got["logits"]).all()):
                raise AssertionError(f"{family} {what}: card vs CPU off")
            if quant and qm.quant_linear.launches == n0:
                raise AssertionError(f"{family} {what}: no quant kernel launch on the card")
            out[quant or "f32"] = {"lp": lp_err, "logits": logit_err,
                                   "rel": logit_err / scale,
                                   "quant_launches": qm.quant_linear.launches - n0}
            del q_cpu, q_gpu
        out.update(_family_cache_routes(torch, llm, family, p_cpu, p_gpu))
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return out


# the engines' caches card vs CPU (f32 weights), the same route on both
# sides (over a bf16 cache the kernel takes q and the probabilities in f32,
# the plain attention rounds them to bf16, in the JAX package as here; a
# difference that large can flip a token's experts): the card's and the
# CPU's f32 K/V may round one bf16 ulp or one int8 step apart where they
# straddle a rounding boundary (phase 11's int8-cache bound); logits and
# logprob rows
FAMILY_CACHE_TOL = 2e-2
# the routes the engines of (b) serve over a bf16 or int8 cache, held card
# vs CPU at the engines' ctx and slots: (label, state dtype, kv_quant, the
# decode kernel, its launch counter)
FAMILY_CACHE_ROUTES = {
    "moe": [("bf16 KV, decode kernel", "bfloat16", False, True, "decode_attention_batch"),
            ("int8 KV, decode kernel", "float32", True, True, "decode_attention_batch_q8")],
    "mla": [("int8 latent cache", "float32", True, False, None)],
    "hybrid": []}


def _family_cache_routes(torch, llm, family, p_cpu, p_gpu) -> dict:
    """(a) The engines' cache routes of one family (FAMILY_CACHE_ROUTES),
    f32 weights, 2048 positions and 8 rows as the engines run them: card
    (the MoE's attention through decode_attention_batch or _q8 at H 32,
    KvH 4) against the CPU on the same route (the kernels' plain versions)
    within FAMILY_CACHE_TOL; greedy tokens equal, or the CPU's top two
    within the bound."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    cfg = _family_cfg(llm, family, FAMILY_CHECK_BLOCKS[family], 2048)
    out = {}
    for label, sdt, q8, pallas, counter in FAMILY_CACHE_ROUTES[family]:
        sdt = getattr(torch, sdt)
        ref = _llm_2block_run(torch, llm, cfg, p_cpu, "cpu", sdt, pallas, prompt_len=24,
                              kv_quant=q8, rows=8)
        n0 = getattr(dec, counter).launches if counter else 0
        got = _llm_2block_run(torch, llm, cfg, p_gpu, "cuda", sdt, pallas, ref["inputs"],
                              prompt_len=24, kv_quant=q8, rows=8)
        n_dec = getattr(dec, counter).launches - n0 if counter else 0
        lp_err, logit_err, same_ids = _llm_gap(ref, got, llm.LP_K)
        # where the CPU's top two logprobs are within the bound either is right
        top2 = np.sort(ref["rows"][..., 1:1 + llm.LP_K], -1)[..., -2:]
        near = top2[..., 1] - top2[..., 0] < FAMILY_CACHE_TOL
        flips = sum(int(((a != b) & ~t).sum())
                    for a, b, t in zip(got["sampled"], ref["inputs"], near))
        scale = float(np.abs(ref["logits"]).max())
        log(f"{cfg.num_blocks}-block {FAMILY_NAMES[family]}, f32 weights, {label}, ctx "
            f"{cfg.max_context}, 8 rows, card vs CPU: logprob rows max|d| {lp_err:.2e}, "
            f"logits max|d| {logit_err:.2e} (bounds {FAMILY_CACHE_TOL}) = "
            f"{logit_err / scale:.2e} of max|logit| {scale:.3f}; greedy tokens of 4 steps x "
            f"8 rows {'equal' if flips == 0 else f'{flips} DIFFER'} (near ties "
            f"{int(near.sum())}), top-8 ids {'equal' if same_ids else 'differ'}"
            + (f"; {counter} launches {n_dec}" if counter else ""))
        if not (lp_err < FAMILY_CACHE_TOL and logit_err < FAMILY_CACHE_TOL and flips == 0
                and np.isfinite(got["logits"]).all()):
            raise AssertionError(f"{family} {label}: card vs CPU off")
        if counter and n_dec < 1:
            raise AssertionError(f"{family} {label}: no {counter} launch on the card")
        out[label] = {"lp": lp_err, "logits": logit_err, "rel": logit_err / scale,
                      "decode_launches": n_dec}
    return out


def _moe_decode_kernels(torch) -> dict:
    """The batched decode kernels at the shape the MoE engine gives them
    (q [8,32,128] f32 and bf16, caches [8,4,2048,128] bf16 or int8 with
    their scales) against their plain versions, phase 7's and phase 10's
    bounds, over spread positions, left pads with a row of no live column,
    and the last column."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    gen = torch.Generator(device="cuda").manual_seed(15)
    b, h, kvh, s, d = 8, 32, 4, 2048, 128
    q = torch.randn((b, h, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, kvh, s, d), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    kq, ks, vq, vs = _q8_operands(torch, gen, b, kvh, s)
    spread = torch.tensor([0, 17, 255, 256, 1000, 2047, 1500, 600], dtype=torch.int32,
                          device="cuda")
    pads = torch.tensor([0, 5, 200, 0, 999, 1, 1024, 700], dtype=torch.int32, device="cuda")
    cases = {"spread": (spread, None), "pads": (spread, pads),
             "last": (torch.full_like(spread, s - 1), None)}
    err = {"decode_attention_batch": 0.0, "decode_attention_batch_q8": 0.0}
    for case, (pos, pd) in cases.items():
        for qn, qq in (("float32", q), ("bfloat16", q.bfloat16())):
            for name, got, ref, tol in (
                    ("decode_attention_batch", dec.decode_attention_batch(qq, k, v, pos, pd),
                     dec.decode_attention_batch_reference(qq, k, v, pos, pd), DEC_TOL[qn]),
                    ("decode_attention_batch_q8",
                     dec.decode_attention_batch_q8(qq, kq, ks, vq, vs, pos, pd),
                     dec.decode_attention_batch_q8_reference(qq, kq, ks, vq, vs, pos, pd),
                     DEC_Q8_TOL if qn == "float32" else DEC_TOL[qn])):
                e = (got.float() - ref.float()).abs().max().item()
                if not (got.dtype == qq.dtype and torch.isfinite(got).all() and e < tol):
                    raise AssertionError(f"{name} at B 8 H 32 KvH 4 S 2048, {case}, q {qn}: "
                                         f"max|d| {e} >= {tol}")
                if qn == "float32":
                    err[name] = max(err[name], e)
    log(f"decode_attention_batch (bf16 cache) and _q8 at the MoE engine's shape, q "
        f"[8,32,128] over [8,4,2048,128], {'/'.join(cases)}, f32 and bf16 q, vs plain: f32 "
        f"q max|d| {err['decode_attention_batch']:.2e} (bound {DEC_TOL['float32']}) and "
        f"{err['decode_attention_batch_q8']:.2e} (bound {DEC_Q8_TOL}); bf16 q within "
        f"{DEC_TOL['bfloat16']}")
    del k, v, kq, ks, vq, vs
    torch.cuda.empty_cache()
    return err


def _profile_steps(torch, llm, fn) -> dict:
    """torch.profiler over ``fn`` with the MoE expert path
    (``llm._moe_experts``) in a record_function range: kernels launched,
    their device ms, the device ms of the kernels launched inside the
    range, and the five kernels of most device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    moe = llm._moe_experts

    def annotated(*a):
        with record_function("moe_experts"):
            return moe(*a)
    llm._moe_experts = annotated
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        llm._moe_experts = moe
    rows = prof.key_averages()
    cuda = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key != "moe_experts"]
    top = sorted(cuda, key=lambda e: -e.self_device_time_total)[:5]
    return {"launches": sum(e.count for e in cuda),
            "kernel_ms": sum(e.self_device_time_total for e in cuda) / 1e3,
            "experts_ms": sum(e.device_time_total for e in rows if e.key == "moe_experts"
                              and e.device_type == torch.autograd.DeviceType.CPU) / 1e3,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]}


def _family_engine(torch, llm, family, cfg, params, label, **kw) -> dict:
    """(b) One 8-slot engine (int8 weights, bf16 KV, ctx 2048): 8 requests
    of 24-88 tokens admitted two a tick, 24 new tokens each. Once all
    decode: 4 engine steps timed after a sync (the decode step's ms), 4
    under torch.profiler (kernels launched a step, their device time and
    its share of the step: the busy share; the expert path's device time),
    then decode tokens/s to the end. Kernel launch counts over the run,
    counters zeroed before it."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    from clearcam_tpu_torch.ops import quant_matmul as qm
    from clearcam_tpu_torch.serving import ServingEngine
    rng = np.random.default_rng(16)
    eng = ServingEngine(params, cfg, n_slots=8, state_dtype=torch.bfloat16, **kw)
    warm = [eng.submit(rng.integers(1, cfg.vocab_size, 8).tolist(), max_new=3)
            for _ in range(2)]
    eng.run_until_idle()
    assert all(len(w.tokens) == 3 for w in warm)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in np.linspace(24, 88, 8)]
    qm.quant_linear.launches = dec.decode_attention_batch.launches = 0
    dec.decode_attention_batch_q8.launches = 0
    t_run = time.perf_counter()
    reqs = []
    for i, pr in enumerate(prompts):
        reqs.append(eng.submit(pr, max_new=24))
        if i % 2:
            eng.step()
    while any(len(r.tokens) == 0 for r in reqs):
        eng.step()
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t_run
    d0 = eng.stats["decode_steps"]
    t0 = time.perf_counter()
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 4 * 1e3
    prof = _profile_steps(torch, llm, lambda: [eng.step() for _ in range(4)])
    n_k, kern_ms = prof["launches"], prof["kernel_ms"]
    if eng.stats["decode_steps"] - d0 != 8:
        raise AssertionError(f"{label}: the timed steps were not all decode steps")
    torch.cuda.synchronize()
    t1, toks1 = time.perf_counter(), sum(len(r.tokens) for r in reqs)
    eng.run_until_idle()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rate = (sum(len(r.tokens) for r in reqs) - toks1) / (t2 - t1)
    launches = {"quant_matmul": qm.quant_linear.launches,
                "decode_attention_batch": dec.decode_attention_batch.launches,
                "decode_attention_batch_q8": dec.decode_attention_batch_q8.launches}
    if not all(len(r.tokens) == 24 and all(0 <= t < cfg.vocab_size for t in r.tokens)
               for r in reqs):
        raise AssertionError(f"{label}: a request did not finish 24 tokens")
    out = {"decode_tok_s": rate, "step_ms": step_ms, "launches_per_step": n_k / 4,
           "kernel_ms_per_step": kern_ms / 4, "busy": kern_ms / 4 / step_ms,
           "experts_ms_per_step": prof["experts_ms"] / 4, "admit_s": admit_s,
           "prefill_tokens": int(sum(map(len, prompts))), "run_s": t2 - t_run,
           "launches": launches}
    log(f"{label}: decode {rate:.1f} tokens/s, decode step {step_ms:.2f} ms after a sync, "
        f"{n_k / 4:.0f} kernel launches a step, {kern_ms / 4:.2f} ms of kernel time "
        f"(busy {kern_ms / 4 / step_ms:.1%}), of it the expert path "
        + (f"{prof['experts_ms'] / 4:.2f} ms" if prof["experts_ms"] else
           "not measured (no kernel attributed to its range)" if cfg.num_experts else
           "none (no experts)")
        + "; top kernels a step "
        + "; ".join(f"{k} x{c / 4:.0f} {ms / 4:.2f} ms" for k, c, ms in prof["top"])
        + f"; the 8 prompts ({out['prefill_tokens']} tokens) admitted to their first "
        f"token in {admit_s:.2f} s; kernel launches over the run {launches}; "
        f"run {t2 - t_run:.1f} s")
    eng.close()
    return out


def _prefill_chunk_ms(torch, llm, cfg, params) -> float:
    """One CHUNK-token prefill chunk at B = 1 (``llm._prefill_hidden``, bf16
    KV), device ms, the mean of 3 calls after a warm-up: one T = CHUNK
    forward on attention and MLA stacks, CHUNK T = 1 forwards on the
    hybrid."""
    st = llm.init_state(cfg, 1, dtype=torch.bfloat16, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(17).integers(
        1, cfg.vocab_size, (1, llm.CHUNK))).cuda()
    freqs = llm.freqs_for(cfg, "cuda")
    with torch.inference_mode():
        return cuda_ms(lambda: llm._prefill_hidden(params, cfg, st, toks, 0, llm.CHUNK,
                                                   freqs), iters=3, warmup=1)


def phase15(torch):
    log("== phase 15: MoE (Qwen3-30B-A3B widths), MLA (DeepSeek-V2-Lite widths; its YaRN "
        "rope scaling has no field in TransformerConfig, so both packages run plain RoPE) "
        "and the GatedDeltaNet hybrid (qwen3_next_cfg): card vs CPU at "
        f"{FAMILY_CHECK_BLOCKS['moe']} blocks (the hybrid {FAMILY_CHECK_BLOCKS['hybrid']}); "
        "the 8-slot engines at "
        + ", ".join(str(FAMILY_BLOCKS[f]) for f in ("moe", "mla", "hybrid"))
        + " blocks (published 48, 27, 28); llm_bench --ssm")
    from clearcam_tpu_torch.models import llm
    out = {"check": {}, "engine": {}, "prefill_chunk_ms": {}}
    t0 = time.time()
    out["moe_decode_kernels"] = _moe_decode_kernels(torch)
    for family in ("moe", "mla", "hybrid"):
        out["check"][family] = _family_card_vs_cpu(torch, llm, family)
    log(f"(a) card vs CPU: {time.time() - t0:.1f} s")
    # (b) the engines at each family's depth, int8 weights drawn on the card
    # and quantized tensor by tensor as they are drawn
    for family in ("moe", "mla", "hybrid"):
        cfg = _family_cfg(llm, family, FAMILY_BLOCKS[family])
        t0 = time.time()
        gen = torch.Generator(device="cuda").manual_seed(16)
        params = llm.init_params(cfg, dtype=torch.bfloat16, device="cuda", quantize="int8",
                                 generator=gen)
        torch.cuda.synchronize()
        log(f"{cfg.num_blocks}-block {FAMILY_NAMES[family]}, int8 weights drawn and "
            f"quantized on the card in {time.time() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
        routes = {"moe": [("plain attention", {}), ("--pallas", {"use_pallas_decode": True}),
                          ("--kv-quant --pallas", {"use_pallas_decode": True,
                                                   "kv_quant": True})],
                  "mla": [("bf16 latent cache", {}), ("int8 latent cache", {"kv_quant": True})],
                  "hybrid": [("plain attention", {})]}[family]
        chunk_ms = _prefill_chunk_ms(torch, llm, cfg, params)
        out["prefill_chunk_ms"][family] = chunk_ms
        log(f"{cfg.num_blocks}-block {FAMILY_NAMES[family]}, int8: one {llm.CHUNK}-token "
            f"prefill chunk at B = 1 {chunk_ms:.1f} ms ({chunk_ms / llm.CHUNK:.2f} ms a token)")
        for route, kw in routes:
            label = f"{cfg.num_blocks}-block {FAMILY_NAMES[family]}, 8 slots, int8, {route}"
            r = _family_engine(torch, llm, family, cfg, params, label, **kw)
            out["engine"][family, route] = r
            n = r["launches"]
            if n["quant_matmul"] < 1:
                raise AssertionError(f"{label}: no quant kernel launch")
            if family == "moe" and kw.get("use_pallas_decode") and \
                    n["decode_attention_batch_q8" if kw.get("kv_quant")
                      else "decode_attention_batch"] < 1:
                raise AssertionError(f"{label}: no decode-attention kernel launch")
        del params
        torch.cuda.empty_cache()
    # (c) the micro-benchmark's hybrid as a user runs it
    t0 = time.time()
    cmd = [sys.executable, "-m", "clearcam_tpu_torch.tools.llm_bench", "--ssm", "--blocks",
           "4", "--ctx", "512", "--modes", "int8", "--decode-batch", "1,8", "--steps", "16"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT),
                          env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
    if proc.returncode != 0:
        raise AssertionError(f"llm_bench --ssm: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    for x in proc.stdout.splitlines():
        log(f"  llm_bench --ssm| {x}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    if len(lines) != 3 or not all(x.get("decode_tok_s", 0) > 0 for x in lines):
        raise AssertionError(f"llm_bench --ssm: {proc.stdout[-2000:]}")
    out["llm_bench_ssm"] = lines
    log(f"(c) llm_bench --ssm: {time.time() - t0:.1f} s")
    return out


def _post_json(url, body, timeout=300.0):
    return json.loads(_post(url, json.dumps(body).encode(), timeout))


def _serve_llm(flags: list, drive, names: tuple, blocks: int = 28) -> tuple:
    """Boot ``python -m clearcam_tpu_torch.tools.serve_llm --synthetic``
    with ``flags`` (``blocks`` blocks, ctx 8192, 8 slots), call ``drive(base_url)``,
    stop it with SIGTERM, and return (the launch counts it printed for
    ``names``, each >= 1, and drive's result)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_llm_"))
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    env = dict(os.environ, PYTHONPATH=str(PKG_ROOT), PYTHONUNBUFFERED="1")
    out_path = tmp / "server.log"
    t0 = time.time()
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "clearcam_tpu_torch.tools.serve_llm", "--synthetic",
             *flags, "--blocks", str(blocks), "--ctx", "8192", "--slots", "8",
             "--port", str(port), "--data", str(tmp / "data")],
            env=env, cwd=str(tmp), stdout=out, stderr=subprocess.STDOUT)
    try:
        health = _wait("/healthz", lambda: json.loads(_get(f"{base}/healthz", 2)),
                       proc, out_path, 400)
        log(f"/healthz after {time.time() - t0:.1f} s: {health}")
        result = drive(base)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    text = out_path.read_text()
    shutil.rmtree(tmp, ignore_errors=True)
    for line in text.splitlines()[-12:]:
        log(f"  server| {line}")
    launches = {}
    for name in names:
        m = re.search(rf"^{name}\.launches=(\d+)$", text, re.M)
        if m is None or int(m.group(1)) < 1:
            raise AssertionError(f"the served path did not launch {name}: {m}")
        launches[name] = int(m.group(1))
    log(f"launches on the served path (serve_llm {' '.join(flags)}): {launches}")
    return launches, result


def phase9():
    log("== phase 9: python -m clearcam_tpu_torch.tools.serve_llm --synthetic --int8 --pallas, "
        "then --int8 --kv-quant --pallas")

    def drive(base):
        result = {}
        models = json.loads(_get(f"{base}/v1/models"))
        log(f"/v1/models: {[m['id'] for m in models['data']]}")
        g = _post_json(f"{base}/generate", {"prompt": "hello world", "max_new": 16})
        if g["tokens"] != 16 or not g["text"]:
            raise AssertionError(f"/generate: {g}")
        log(f"/generate: {g['tokens']} tokens, text {g['text']!r}")
        t1 = time.time()
        streamed = _post(f"{base}/generate", json.dumps(
            {"prompt": "stream me", "max_new": 24, "stream": True}).encode(), 300).decode()
        log(f"/generate stream: {len(streamed)} chars in {time.time() - t1:.2f} s")
        if not streamed:
            raise AssertionError("/generate stream gave no text")
        import concurrent.futures as cf

        def chat(i):
            body = {"messages": [{"role": "user", "content": f"request {i}"}],
                    "max_tokens": 32}
            if i == 0:
                body["response_format"] = {"type": "json_object"}
            return _post_json(f"{base}/v1/chat/completions", body)
        t1 = time.time()
        with cf.ThreadPoolExecutor(8) as ex:
            chats = list(ex.map(chat, range(8)))
        dt = time.time() - t1
        toks = sum(c["usage"]["completion_tokens"] for c in chats)
        log(f"8 concurrent /v1/chat/completions: {toks} tokens in {dt:.2f} s "
            f"({toks / dt:.1f} tokens/s through HTTP)")
        text = chats[0]["choices"][0]["message"]["content"]
        if not text.startswith("{") or not _json_prefix(text):
            raise AssertionError(f"json_object reply is not a JSON prefix: {text!r}")
        log(f"json_object reply: {text!r} (a JSON prefix)")
        comp = _post_json(f"{base}/v1/completions", {"prompt": "score this", "max_tokens": 6,
                                                     "logprobs": 3})
        lp = comp["choices"][0]["logprobs"]
        if len(lp["token_logprobs"]) != len(lp["tokens"]) or not lp["tokens"] \
                or not all(np.isfinite(x) and x <= 0 for x in lp["token_logprobs"]):
            raise AssertionError(f"/v1/completions logprobs: {lp}")
        log(f"/v1/completions logprobs: {len(lp['tokens'])} tokens, token_logprobs "
            f"{[round(x, 3) for x in lp['token_logprobs']]}")
        result.update(http_tokens_per_s=toks / dt, json_reply=text)
        return result

    # 8 blocks (28 before phase 18 joined the smoke): the served route is the
    # same at any depth, and the 28-block boot's weight draws took ~60 s
    launches, result = _serve_llm(["--int8", "--pallas"], drive,
                                  ("quant_matmul", "decode_attention"), blocks=8)

    def drive_q8(base):
        """The int8-cache kernel route: one /generate and 4 concurrent ones."""
        g = _post_json(f"{base}/generate", {"prompt": "int8 cache", "max_new": 16})
        if g["tokens"] != 16 or not g["text"]:
            raise AssertionError(f"/generate (--kv-quant --pallas): {g}")
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(4) as ex:
            gs = list(ex.map(lambda i: _post_json(
                f"{base}/generate", {"prompt": f"camera {i}", "max_new": 24}), range(4)))
        if any(x["tokens"] != 24 for x in gs):
            raise AssertionError(f"/generate x4 (--kv-quant --pallas): {gs}")
        log(f"--kv-quant --pallas /generate: {g['tokens']} tokens, text {g['text']!r}; "
            f"4 concurrent: {[x['tokens'] for x in gs]} tokens")
        return g
    # 4 blocks: the route is the same at any depth, and a 28-block boot
    # costs ~70 s of weight draws
    q8, _ = _serve_llm(["--int8", "--kv-quant", "--pallas"], drive_q8,
                       ("quant_matmul", "decode_attention_batch_q8"), blocks=4)
    launches["decode_attention_batch_q8"] = q8["decode_attention_batch_q8"]
    return launches, result


# ---------------------------------------------------------------------------
# RF-DETR, the MOT and evaluation tools, and the measurement tools
# ---------------------------------------------------------------------------

# RF-DETR nano card vs CPU, f32 with TF32 off, max |d| of the forward's
# logits and boxes; a proposal set may differ only where the CPU's scores of
# the swapped locations sit within RF_TIE of the 300th score (a near tie)
RF_TOL, RF_TIE = 2e-3, 1e-5
# the frames a proposal near tie may reorder, of the 4
RF_MAX_SWAPPED = 1


def _rf_proposals(rfdetr, p, x, cfg):
    """The two-stage head's (scores [B, N], top-Q indices [B, Q])."""
    taps, hw = rfdetr.backbone_forward(p, x, cfg)
    scores, top, _ = rfdetr.proposals(p, rfdetr.projector_forward(p, taps, hw, cfg), cfg)
    return scores.cpu(), top.cpu()


def _phase16_rfdetr(torch) -> dict:
    """(a) RF-DETR nano at its published widths on the card."""
    from clearcam_tpu_torch.models import rfdetr
    from clearcam_tpu_torch.testing import compared_rows, detection_mismatches
    cfg = rfdetr.VARIANTS["nano"]
    params = rfdetr.init_params(cfg, seed=0)
    p_cpu = rfdetr.params_from_jax(params, "cpu")
    p_gpu = rfdetr.params_from_jax(params, "cuda")
    frames = np.random.default_rng(0).integers(0, 256, (4, 1080, 1920, 3), np.uint8)
    out = {}
    with torch.inference_mode():
        x_cpu = rfdetr.preprocess(torch.from_numpy(frames), cfg.resolution)
        x_gpu = rfdetr.preprocess(torch.from_numpy(frames).cuda(), cfg.resolution)
        log(f"RF-DETR nano: letterbox 1080p -> {list(x_gpu.shape)} (square canvas), "
            f"preprocess card vs CPU max|d| {(x_gpu.cpu() - x_cpu).abs().max().item():.2e}")
        rl, rb = rfdetr.forward(p_cpu, x_cpu, cfg)
        gl, gb = (t.cpu() for t in rfdetr.forward(p_gpu, x_gpu, cfg))
        scores, rt = _rf_proposals(rfdetr, p_cpu, x_cpu, cfg)
        _, gt = _rf_proposals(rfdetr, p_gpu, x_gpu, cfg)
        same = []
        for i in range(len(frames)):
            a, b = set(rt[i].tolist()), set(gt[i].tolist())
            if a == b:
                same.append(i)
                continue
            kth = scores[i].sort(descending=True).values[cfg.num_queries - 1].item()
            gaps = [abs(scores[i, j].item() - kth) for j in a ^ b]
            log(f"frame {i}: proposal sets differ in {len(a ^ b)} locations, CPU scores "
                f"{max(gaps):.2e} from the 300th at most")
            if max(gaps) > RF_TIE:
                raise AssertionError(f"RF-DETR proposals, frame {i}: not a near tie ({gaps})")
        if len(frames) - len(same) > RF_MAX_SWAPPED:
            raise AssertionError(f"RF-DETR proposals differ in {len(frames) - len(same)} "
                                 f"of {len(frames)} frames")
        # rows in location order, so a reordered near tie compares like with like
        errs = []
        for i in same:
            ro, go = rt[i].argsort(), gt[i].argsort()
            errs += [(gl[i, go] - rl[i, ro]).abs().max().item(),
                     (gb[i, go] - rb[i, ro]).abs().max().item()]
        err = max(errs)
        log(f"RF-DETR nano forward, 4 frames, f32, card vs CPU: proposal index sets equal in "
            f"{len(same)} of 4 ({sum(torch.equal(rt[i], gt[i]) for i in same)} in the same "
            f"order); logits and boxes max|d| {err:.2e} (bound {RF_TOL})")
        if not err <= RF_TOL:
            raise AssertionError(f"RF-DETR forward card vs CPU: max|d| {err}")
        out["max_abs_err"] = err
        d_cpu = rfdetr.detect(p_cpu, torch.from_numpy(frames), cfg=cfg,
                              conf_threshold=0.0).numpy()[same]
        d_gpu = rfdetr.detect(p_gpu, torch.from_numpy(frames).cuda(), cfg=cfg,
                              conf_threshold=0.0).cpu().numpy()[same]
        bad = detection_mismatches(d_cpu, d_gpu, conf_threshold=0.0)
        if bad:
            raise AssertionError("RF-DETR detect card vs CPU:\n" + "\n".join(bad[:20]))
        log(f"RF-DETR detect card vs CPU (threshold 0): rows agree "
            f"({compared_rows(d_cpu, conf_threshold=0.0)} clear of ties compared)")

        det = rfdetr.RFDETR("nano", params=params, device="cuda")
        for b in (1, 8):
            host = list(np.random.default_rng(b).integers(0, 256, (b, 1080, 1920, 3),
                                                          np.uint8))
            det.detect_many(host)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                rows = det.detect_many(host)
            e2e = (time.perf_counter() - t0) / 5
            if not all(r.shape == (300, 6) and np.isfinite(r).all() for r in rows):
                raise AssertionError("RF-DETR detect_many rows not finite [300, 6]")
            fb = torch.from_numpy(np.stack(host)).cuda()
            step = lambda: rfdetr.detect(det.params, fb, cfg=cfg)      # noqa: E731
            ms = cuda_ms(step, iters=10, warmup=2)
            out[b] = {"detect_many_fps": b / e2e, "step_ms": ms}
            msg = (f"RF-DETR nano f32 batch {b}: detect_many (numpy in, rows out) "
                   f"{e2e * 1e3:.2f} ms = {b / e2e:.1f} frames/s; one step on resident "
                   f"frames {ms:.3f} ms")
            if b == 8:
                n, kms, _ = _kernels(torch, step, ())
                out[b].update(kernels=n, kernel_ms=kms, busy=kms / ms)
                msg += (f"; under torch.profiler (CUDA rows): {n} kernels, {kms:.3f} ms of "
                        f"kernel time = {kms / ms:.1%} of the step")
            log(msg)
    return out


def _synthetic_clip(path: Path, n_frames: int = 60):
    """A 1080p mp4 of three coloured boxes moving over noise."""
    import cv2
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (1920, 1080))
    base = np.random.default_rng(1).integers(0, 60, (1080, 1920, 3), np.uint8)
    for t in range(n_frames):
        f = base.copy()
        for k, colour in enumerate(((40, 180, 240), (240, 40, 180), (180, 240, 40))):
            x, y = 100 + 400 * k + 12 * t, 200 + 250 * k
            f[y:y + 360, x:x + 180] = colour
        vw.write(f)
    vw.release()


def _synthetic_dataset(root: Path, n: int = 8):
    """YOLO-format images/ + labels/: one bright box per 640x480 image."""
    import cv2
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 60, (480, 640, 3), np.uint8)
        cx, cy, w, h = 0.3 + 0.05 * i, 0.5, 0.25, 0.5
        img[int((cy - h / 2) * 480):int((cy + h / 2) * 480),
            int((cx - w / 2) * 640):int((cx + w / 2) * 640)] = (40, 180, 240)
        cv2.imwrite(str(root / "images" / f"im{i}.jpg"), img)
        (root / "labels" / f"im{i}.txt").write_text(f"0 {cx} {cy} {w} {h}\n")


def _tool(args: list, timeout: int) -> tuple:
    """``python -m clearcam_tpu_torch.tools.<args>`` as a user runs it ->
    (its JSON lines, its ``# launches`` counts or None, its stdout)."""
    proc = subprocess.run([sys.executable, "-m", f"clearcam_tpu_torch.tools.{args[0]}",
                           *args[1:]], capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
    if proc.returncode != 0:
        raise AssertionError(f"{args[0]}: rc {proc.returncode}\n{proc.stdout[-2000:]}"
                             f"{proc.stderr[-3000:]}")
    for x in proc.stdout.splitlines():
        log(f"  {args[0]}| {x}")
    lines = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    m = re.search(r"^# launches (\{.*\})$", proc.stdout, re.M)
    return lines, (json.loads(m.group(1)) if m else None), proc.stdout


def phase16(torch):
    log("== phase 16: RF-DETR nano card vs CPU and its rate; tools/mot and tools/evaluate "
        "through both detectors; latency_probe, clip_bench, clip_probe, cotenancy_bench")
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.tools import evaluate, mot
    t0 = time.time()
    out = {"rfdetr": _phase16_rfdetr(torch)}
    log(f"(a) RF-DETR: {time.time() - t0:.1f} s")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mot_"))
    try:
        # (b) run_mot through each detector, (c) evaluate.main through each
        t1 = time.time()
        _synthetic_clip(tmp / "clip.mp4")
        _synthetic_dataset(tmp / "ds")
        for kind in ("yolo", "rfdetr"):
            stem.launches = 0
            count, frames = mot.run_mot(str(tmp / "clip.mp4"), size="t", res=640,
                                        weights_dir=str(tmp / "none"), detector_kind=kind)
            n_stem = stem.launches
            if len(frames) != 60:
                raise AssertionError(f"run_mot {kind}: {len(frames)} of 60 frames came out")
            if kind == "yolo" and n_stem < 60:
                raise AssertionError(f"run_mot yolo launched the stem kernel {n_stem} times")
            log(f"run_mot --detector {kind} (random weights): {len(frames)} frames, "
                f"{sum(len(f) for f in frames)} live tracks over them, {count} unique "
                f"persons; stem launches {n_stem}")
            out[f"mot_{kind}"] = count
            stem.launches = 0
            ap = evaluate.main([str(tmp / "ds"), "--detector", kind, "--res", "640",
                                "--weights", str(tmp / "none")])
            n_stem = stem.launches
            if ap.keys() != {"mAP50", "mAP50-95", "classes"} or set(ap["classes"]) != {0}:
                raise AssertionError(f"evaluate {kind}: {ap}")
            if kind == "yolo" and n_stem < 8:
                raise AssertionError(f"evaluate yolo launched the stem kernel {n_stem} times")
            log(f"evaluate --detector {kind} on 8 synthetic images (random weights): {ap}; "
                f"stem launches {n_stem}")
            out[f"evaluate_{kind}"] = ap
        log(f"(b, c) MOT and evaluate: {time.time() - t1:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (d) the tools as users run them, each a process of its own (its kernel
    # counts start at 0 and it prints them)
    t1 = time.time()
    lines, n, _ = _tool(["latency_probe"], 300)
    stages = [x["stage"] for x in lines]
    if stages != ["http_overhead", "device_step", "dispatch_sync", "upload_1080p",
                  "e2e_single"] or not all(x["p50_ms"] >= 0 for x in lines) \
            or not (n and n["stem"] >= 50):
        raise AssertionError(f"latency_probe: {lines} {n}")
    out["latency"] = {x["stage"]: x for x in lines}
    lines, n, _ = _tool(["clip_bench", "--batches", "1,16,64"], 300)
    if [x["batch"] for x in lines] != [1, 16, 64] or not (n and n["vit_attention"] > 0):
        raise AssertionError(f"clip_bench: {lines} {n}")
    out["clip_bench"] = lines
    lines, _, text = _tool(["clip_probe", "--batches", "16"], 300)
    launches = {k: int(v) for k, v in re.findall(
        r"^# (\w+): vit_attention launches (\d+)$", text, re.M)}
    if [x["stage"] for x in lines] != list(launches) or launches.pop("full_flash") < 1 \
            or any(launches.values()):
        raise AssertionError(f"clip_probe: the kernel must launch under full_flash only: "
                             f"{text[-2000:]}")
    out["clip_probe"] = lines
    # 14 of the summary model's 28 language blocks (cut when phase 18 joined
    # the smoke, for its 1200 s limit)
    lines, n, _ = _tool(["cotenancy_bench", "--streams", "16", "--ticks", "80",
                         "--quant", "int8", "--blocks", "14"], 600)
    final = lines[-1] if lines else {}
    if final.get("metric") != "cotenancy_detect_p50_overhead_ms" \
            or not final["full"]["summaries_done"] > 0 \
            or not (n and all(n[k] > 0 for k in ("stem", "vit_attention", "quant_matmul"))):
        raise AssertionError(f"cotenancy_bench: {lines} {n}")
    log(f"co-tenancy: detect p50 +{final['value']} ms beside CLIP, faces and summaries "
        f"({final['full']['summary_tok_s']} summary tokens/s); launches {n}")
    out["cotenancy"] = {**final, "launches": n}
    log(f"(d) the four tools: {time.time() - t1:.1f} s")
    return out


# ---------------------------------------------------------------------------
# YOLOv9 fine-tuning through the stem kernel, then the export and parity tools
# ---------------------------------------------------------------------------

FT_STEPS, FT_LR = 30, 3e-4          # the training run of phase 17 (a)
GRAD_TOL = 1e-4                     # autograd stem vs plain: max|d| / max|g|
LOSS_TOL = 1e-4                     # detection_loss card vs CPU, relative


def _ft_dataset(root: Path, n: int = 16):
    """YOLO-format images/ + labels/: n random 1920x1080 JPEGs, each with
    one to three solid boxes drawn in and labelled (classes 0-2)."""
    import cv2
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(17)
    colours = ((40, 180, 240), (240, 40, 180), (180, 240, 40))
    for i in range(n):
        img = rng.integers(0, 80, (1080, 1920, 3), np.uint8)
        rows = []
        for k in range(1 + i % 3):
            bw, bh = rng.uniform(0.08, 0.3), rng.uniform(0.1, 0.4)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            x1, y1 = int((cx - bw / 2) * 1920), int((cy - bh / 2) * 1080)
            x2, y2 = int((cx + bw / 2) * 1920), int((cy + bh / 2) * 1080)
            img[y1:y2, x1:x2] = colours[k]
            rows.append(f"{k} {cx} {cy} {bw} {bh}")
        cv2.imwrite(str(root / "images" / f"im{i:02d}.jpg"), img)
        (root / "labels" / f"im{i:02d}.txt").write_text("\n".join(rows) + "\n")


def _ft_summary(text: str) -> dict:
    """The ``# finetune {...}`` line a finetune run ends with, and the
    losses its log lines print (step 0 and the last among them)."""
    m = re.search(r"^# finetune (\{.*\})$", text, re.M)
    if not m:
        raise AssertionError(f"finetune printed no summary:\n{text[-2000:]}")
    out = json.loads(m.group(1))
    out["logged"] = {int(a): float(b) for a, b in
                     re.findall(r"^step\s+(\d+)\s+loss (\S+)$", text, re.M)}
    return out


def _mib(n) -> str:
    return f"{n / 2 ** 20:.1f} MiB"


_REPLAY = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False          # as phase 0 sets it
torch.backends.cuda.matmul.allow_tf32 = False
from clearcam_tpu_torch.tools.export import Replayer
from clearcam_tpu_torch.ops.stem import stem
bundle, frames, out = sys.argv[1:4]
rep = Replayer(bundle)
x = torch.from_numpy(np.load(frames)).cuda()
stem.launches = 0
rows = rep(x.cpu().numpy())
launches = stem.launches
np.save(out, rows)
with torch.no_grad():
    for _ in range(3):
        rep.module(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        rep.module(x)
    end.record()
    torch.cuda.synchronize()
print(json.dumps({"launches": launches, "ms": start.elapsed_time(end) / 20,
                  "models_loaded": sorted(m for m in sys.modules
                                          if m.startswith("clearcam_tpu_torch.models"))}))
"""


def phase17(torch):
    log("== phase 17: YOLOv9-t fine-tuning through the stem kernel (res 640, batch 8), "
        "the autograd stem vs plain, the loss card vs CPU, export + replay, parity")
    from clearcam_tpu_torch.models import yolo_loss, yolov9
    from clearcam_tpu_torch.ops.stem import stem, stem_reference, stem_train
    from clearcam_tpu_torch.testing import compared_rows, detection_mismatches
    from clearcam_tpu_torch.tools import export, finetune, parity
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ft_"))
    try:
        # (a) the tool as a user runs it, then --remat, then a checkpointed
        # run and its resume
        t1 = time.time()
        _ft_dataset(tmp / "ds")
        log(f"16 1080p JPEGs written: {time.time() - t1:.1f} s")
        _, _, text = _tool(["finetune", str(tmp / "ds"), "--steps", str(FT_STEPS), "--lr",
                            str(FT_LR), "--out", str(tmp / "ft.safetensors")], 600)
        run = _ft_summary(text)
        first, last = run["logged"][0], run["logged"][FT_STEPS - 1]
        if not last < first or run["steps"] != FT_STEPS:
            raise AssertionError(f"finetune: loss {first} -> {last} over {run['steps']} steps")
        if run["stem_launches"] < FT_STEPS:
            raise AssertionError(f"finetune: the stem kernel launched {run['stem_launches']} "
                                 f"times in {FT_STEPS} steps")
        _, _, text = _tool(["finetune", str(tmp / "ds"), "--steps", "3", "--lr", str(FT_LR),
                            "--remat", "--out", str(tmp / "remat.safetensors")], 300)
        remat = _ft_summary(text)
        log(f"the two finetune processes: {time.time() - t1:.1f} s")
        if remat["stem_launches"] != 6:
            raise AssertionError(f"finetune --remat: {remat['stem_launches']} stem launches "
                                 "in 3 steps, not 2 a step")
        for r, what in ((run, f"{FT_STEPS} steps"), (remat, "3 steps --remat")):
            ms = r["step_ms"]
            log(f"finetune t/640/batch 8, {what}: {ms['median']:.1f} ms a step median "
                f"(range {ms['min']:.1f}-{ms['max']:.1f}, first {ms['first']:.1f}); peak "
                f"{_mib(r['peak_bytes'])} (max_memory_allocated); stem launches "
                f"{r['stem_launches']} = {r['stem_launches'] / r['steps']:g} a step")
        log(f"finetune: loss {first:.4f} at step 0 -> {last:.4f} at step {FT_STEPS - 1}; "
            f"peak memory plain {_mib(run['peak_bytes'])}, --remat {_mib(remat['peak_bytes'])}")
        stem.launches = 0
        ck = tmp / "ck"
        finetune.train(str(tmp / "ds"), steps=6, lr=FT_LR, out=str(tmp / "a.safetensors"),
                       ckpt_dir=str(ck), ckpt_every=3)
        resumed = finetune.train(str(tmp / "ds"), steps=9, lr=FT_LR,
                                 out=str(tmp / "b.safetensors"), ckpt_dir=str(ck),
                                 ckpt_every=3)
        ckpt_launches = stem.launches
        state = torch.load(ck / "state", map_location="cpu", weights_only=True)
        if len(resumed) != 3 or state["step"] != 9 or ckpt_launches != 9:
            raise AssertionError(f"resume: {len(resumed)} steps after the checkpoint, state "
                                 f"at {state['step']}, {ckpt_launches} stem launches")
        log(f"checkpoint: 6 steps, then a run to 9 resumed at step 6 ({len(resumed)} steps, "
            f"losses {[round(x, 4) for x in resumed]}); stem launches {ckpt_launches}")
        model = yolov9.YOLOv9.from_safetensors(tmp / "ft.safetensors", size="t", res=640)
        frame = np.random.default_rng(5).integers(0, 256, (1080, 1920, 3), np.uint8)
        rows = model(frame).cpu().numpy()
        if rows.shape != (300, 6) or not np.isfinite(rows).all():
            raise AssertionError(f"the fine-tuned weights detect {rows.shape}")
        log(f"the published output loads through YOLOv9.from_safetensors and detects on a "
            f"1080p frame: {int((rows[:, 4] > 0).sum())} live rows")
        out["train"] = {"steps": FT_STEPS, "loss_first": first, "loss_last": last,
                        "step_ms": run["step_ms"], "peak_bytes": run["peak_bytes"],
                        "launches_per_step": run["stem_launches"] / run["steps"],
                        "remat_step_ms": remat["step_ms"],
                        "remat_peak_bytes": remat["peak_bytes"]}
        out["train_launches"] = run["stem_launches"] + remat["stem_launches"] + ckpt_launches
        log(f"(a) training: {time.time() - t1:.1f} s")

        # (b) the autograd stem's gradients on the card against the plain version's
        params = yolov9.init_params("t", seed=0)
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.random((8, 640, 640, 3), np.float32)).cuda()
        ws = [torch.from_numpy(a).cuda().requires_grad_() for a in (
            params["model.0.conv.weight"], rng.normal(0, 0.1, 16).astype(np.float32),
            params["model.1.conv.weight"], rng.normal(0, 0.1, 32).astype(np.float32))]
        g = torch.randn((8, 160, 160, 32), device="cuda")
        got = torch.autograd.grad(stem_train(x, *ws), ws, g)
        ref = torch.autograd.grad(stem_reference(x, *ws), ws, g)
        rel = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref)]
        if max(rel) > GRAD_TOL:
            raise AssertionError(f"autograd stem grads vs plain: {rel}")
        log(f"(b) autograd stem [8,640,640,3] f32, the four weight gradients vs plain: "
            f"max|d|/max|g| {['%.2e' % r for r in rel]} (bound {GRAD_TOL})")

        # (c) one loss value on the card and on the CPU
        imgs, boxes, clss = finetune.load_dataset(tmp / "ds", 640)
        batch = [torch.from_numpy(a[:8]) for a in (imgs, boxes, clss.astype(np.int32))]
        with torch.no_grad():
            loss = {dev: yolo_loss.detection_loss(finetune.train_params(params, dev),
                                                  *(t.to(dev) for t in batch)).item()
                    for dev in ("cpu", "cuda")}
        rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
        if rel > LOSS_TOL:
            raise AssertionError(f"detection_loss card {loss['cuda']} vs CPU {loss['cpu']}")
        log(f"(c) detection_loss t/640/batch 8: card {loss['cuda']:.6f}, CPU "
            f"{loss['cpu']:.6f}, relative |d| {rel:.2e} (bound {LOSS_TOL})")
        out["loss_card_vs_cpu"] = rel
        # one training step by kernel (torch.profiler), after two warm ones
        step, opt = yolo_loss.make_finetune_step("t", lr=FT_LR, clip_norm=1.0)
        tp = finetune.train_params(params, "cuda")
        state = opt.init(tp)
        dev_batch = [t.cuda() for t in batch]
        for _ in range(2):
            step(tp, state, *dev_batch)[2].item()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(tp, state, *dev_batch)[2].item()
        host_ms = (time.perf_counter() - t1) * 1e3
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(tp, state, *dev_batch)[2].item()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        n, kms = sum(e.count for e in rows), sum(e.self_device_time_total for e in rows) / 1e3
        top = [(e.key[:70], e.count, round(e.self_device_time_total / 1e3, 3))
               for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]]
        stem_rows = [(e.key[:70], e.count, round(e.self_device_time_total / 1e3, 4))
                     for e in rows if "stem" in e.key]
        log(f"(c) one training step, batch resident: {host_ms:.1f} ms (host clock, loss read "
            f"back); under torch.profiler {n} kernels, {kms:.3f} ms of kernel time = "
            f"{kms / host_ms:.0%} busy; the stem kernel's rows {stem_rows}; the top six "
            f"{top}")
        out["step_profile"] = {"host_ms": host_ms, "kernels": n, "kernel_ms": kms,
                               "stem": stem_rows, "top": top}
        del tp, state, dev_batch

        # (d) the detector exported, then replayed in a process of its own
        t1 = time.time()
        meta = export.export_detector(tmp / "det.ccprog", "t", 640, (1080, 1920), 1,
                                      params=params)
        export_s = time.time() - t1
        frames = np.random.default_rng(7).integers(0, 256, (1, 1080, 1920, 3), np.uint8)
        np.save(tmp / "frames.npy", frames)
        proc = subprocess.run([sys.executable, "-c", _REPLAY, str(tmp / "det.ccprog"),
                               str(tmp / "frames.npy"), str(tmp / "rows.npy")],
                              capture_output=True, text=True, timeout=300, cwd=str(tmp),
                              env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
        if proc.returncode != 0:
            raise AssertionError(f"replay: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        rep = json.loads(proc.stdout.splitlines()[-1])
        p_gpu = yolov9.params_from_jax(params, "cuda")
        fg = torch.from_numpy(frames).cuda()
        with torch.inference_mode():
            eager = yolov9.detect(p_gpu, fg, size="t", res=640).cpu().numpy()
            eager_ms = cuda_ms(lambda: yolov9.detect(p_gpu, fg, size="t", res=640))
        replayed = np.load(tmp / "rows.npy")
        bad = detection_mismatches(eager, replayed)
        if bad or rep["models_loaded"] or rep["launches"] < 1:
            raise AssertionError(f"replay: {bad[:10]}, models {rep['models_loaded']}, "
                                 f"stem launches {rep['launches']}")
        log(f"(d) export t/640 [1,1080,1920,3] in {export_s:.1f} s ({meta['device']}); replay "
            f"in a fresh process (no models module loaded): rows vs eager detect 0 mismatches "
            f"({int((eager[..., 4] > 0).sum())} live, {compared_rows(eager)} clear of ties), "
            f"max|d| {np.abs(replayed - eager).max():.3e}; stem launches {rep['launches']}; "
            f"replay {rep['ms']:.3f} ms vs eager detect {eager_ms:.3f} ms a call (f32, "
            f"CUDA events over 20 calls, each in its own process)")
        out["replay"] = {"ms": rep["ms"], "eager_ms": eager_ms, "launches": rep["launches"]}

        # (e) parity: every check SKIPs here (no file it needs is in the
        # repository), --strict fails; then a golden of random weights
        # recorded on the CPU route passes check_yolo_golden on the card
        empty = tmp / "empty"
        empty.mkdir()
        rcs = []
        for flags in ([], ["--strict"]):
            proc = subprocess.run([sys.executable, "-m", "clearcam_tpu_torch.tools.parity",
                                   "run", *flags], capture_output=True, text=True,
                                  timeout=120, cwd=str(empty),
                                  env=dict(os.environ, PYTHONPATH=str(PKG_ROOT)))
            for line in proc.stdout.splitlines():
                log(f"  parity {' '.join(flags)}| {line}")
            rcs.append(proc.returncode)
            statuses = [line.split()[1] for line in proc.stdout.splitlines()
                        if line.split() and line.split()[0] in parity.CHECKS]
            if statuses != ["SKIP"] * len(parity.CHECKS):
                raise AssertionError(f"parity {flags}: {proc.stdout}\n{proc.stderr[-2000:]}")
        if rcs != [0, 1]:
            raise AssertionError(f"parity run rc {rcs[0]}, --strict rc {rcs[1]} (want 0, 1)")
        (tmp / "weights").mkdir()
        (tmp / "fixtures").mkdir()
        finetune.save_published(params, tmp / "weights" / "yolov9-t.safetensors")
        parity.record_golden(str(tmp / "ds" / "images" / "im00.jpg"),
                             str(tmp / "fixtures" / "yolo_golden.npz"), "t", 640,
                             str(tmp / "weights"), device="cpu")
        if parity.run(tmp / "weights", tmp / "fixtures", checks=["yolo"], strict=True) != 0:
            raise AssertionError("check_yolo_golden failed on the card")
        log("(e) parity run: rc 0, every check SKIP; --strict rc 1; a golden recorded on "
            "the CPU route passes check_yolo_golden on the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _json_prefix(text: str) -> bool:
    """True when ``text`` is a prefix of some JSON object."""
    for end in ("", "}", "\"}", "\":0}", "0}", "]}", "\"]}", "}}", "\"}}", "]}}", "\"]}}"):
        try:
            json.loads(text + end)
            return True
        except ValueError:
            pass
    from clearcam_tpu_torch.serving import constrain
    return constrain.run_char_dfa(constrain.json_char_dfa(4), text.encode()) >= 0


# ---------------------------------------------------------------------------
# phase 18: the multi-device paths (clearcam_tpu_torch.parallel)
# ---------------------------------------------------------------------------

P18_DEADLINE = 600           # s, one spawn of phase 18's ranks
P18_RING_TOL = 2e-5          # ring / sharded prefill vs one device (f32, TF32 off)
P18_FT_TOL = 1e-4            # finetune --mesh loss vs one rank, relative


def _p18_entry(rank, world, rdv, backend, part, args, q):
    """One rank of a phase-18 spawn: join the group (``parallel.comm``),
    run ``part``, send its result back."""
    import traceback
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from clearcam_tpu_torch.parallel import comm
        comm.init_group(rank, world, f"file://{rdv}", "cuda", backend)
        out = globals()[part](rank, world, backend, *args)
        q.put((rank, "ok", out))
        comm.shutdown(120)
    except BaseException:  # noqa: BLE001
        q.put((rank, "error", traceback.format_exc()))
        raise


def _p18_spawn(part: str, world: int, backend: str, *args) -> list:
    """``part`` on ``world`` spawned ranks; every rank's result, or a raise
    (a rank's traceback, a dead rank, or the deadline: all ranks killed)."""
    import multiprocessing as mp
    import queue as queue_mod
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_p18_entry, args=(r, world, os.path.join(tmp, "rdv"),
                                                       backend, part, args, q))
                 for r in range(world)]
        for p_ in procs:
            p_.start()
        results, err, deadline = {}, None, time.time() + P18_DEADLINE
        try:
            while len(results) < world and err is None:
                try:
                    r, status, out = q.get(timeout=2)
                except queue_mod.Empty:
                    if time.time() > deadline:
                        err = f"{part}: past the {P18_DEADLINE} s deadline"
                    elif any(p_.exitcode not in (None, 0) for p_ in procs):
                        err = f"{part}: a rank died ({[p_.exitcode for p_ in procs]})"
                    continue
                if status != "ok":
                    err = f"{part} rank {r}:\n{out}"
                results[r] = out
            for p_ in procs:
                p_.join(120 if err is None else 1)
        finally:
            for p_ in procs:
                if p_.is_alive():
                    p_.kill()
                    p_.join()
    if err is not None:
        raise AssertionError(err)
    return [results[r] for r in range(world)]


def _p18_sdpa(torch, q, k, v):
    """One-device causal attention, [B,T,H,D] with GQA, f32."""
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (z.transpose(1, 2).float() for z in (q, k.repeat_interleave(rep, 2),
                                                       v.repeat_interleave(rep, 2)))
    return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True) \
        .transpose(1, 2)


def _p18_detect(torch, mesh, frames, dtype):
    """BatchDetector(mesh=) on rank 0's frames, the others following: ->
    (rows on rank 0 or None, host ms, this rank's stem launches)."""
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    det = BatchDetector("t", res=640, dtype=dtype, mesh=mesh)

    def lead(fn):
        if not mesh.is_leader:
            return mesh.follow()
        r = fn()
        mesh.stop_followers()
        return r
    lead(lambda: det.detect_many(list(frames[:1])))          # warm
    s0, t0 = stem.launches, time.perf_counter()
    rows = lead(lambda: np.stack(det.detect_many(list(frames))))
    return rows, (time.perf_counter() - t0) * 1e3, stem.launches - s0


def _p18_engine(torch, mesh, cfg, params, requests, **kw):
    """A tp engine on every rank; rank 0 serves ``requests`` [(prompt,
    max_new)] all at once. -> per rank: tokens (rank 0), decode steps, the
    decode phase's seconds, the step's collectives (command channel and
    token broadcast; the block reductions, calls and host seconds) and this
    rank's quant_linear / decode-attention launches."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    from clearcam_tpu_torch.ops.quant_matmul import quant_linear
    from clearcam_tpu_torch.parallel import mesh as pmesh
    eng = pmesh.serving_engine_tp(params, cfg, mesh, **kw)
    l0 = (quant_linear.launches, dec.decode_attention_batch.launches,
          dec.decode_attention_batch_q8.launches)
    out = {"kv_heads": int(eng.state[0]["k"].shape[1])}
    t0 = time.perf_counter()
    if mesh.is_leader:
        reqs = [eng.submit(list(pr), max_new=n) for pr, n in requests]
        eng.run_until_idle()
        torch.cuda.synchronize()
        out["tokens"] = [r.wait(5) for r in reqs]
        out["ttft_s"] = max(r.ttft_s for r in reqs)
        eng.close()
        mesh.stop_followers()
    else:
        mesh.follow()
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    out["decode_steps"] = eng.ranks.steps if mesh.is_leader else None
    out["channel_s"] = eng.ranks.comm_s
    out["reduce"] = dict(eng.params.tp.stats)
    out["launches"] = {"quant_linear": quant_linear.launches - l0[0],
                       "decode_attention_batch": dec.decode_attention_batch.launches - l0[1],
                       "decode_attention_batch_q8":
                           dec.decode_attention_batch_q8.launches - l0[2]}
    del eng
    torch.cuda.empty_cache()
    return out


def _p18_solo_tokens(torch, cfg, params, requests, **kw):
    from clearcam_tpu_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, **kw)
    reqs = [eng.submit(list(pr), max_new=n) for pr, n in requests]
    t0 = time.perf_counter()
    eng.run_until_idle()
    torch.cuda.synchronize()
    out = [r.wait(5) for r in reqs], time.perf_counter() - t0, eng.stats["decode_steps"]
    eng.close()
    return out


def _p18_seq(torch, out, mesh, axis, world, dev):
    """ring_prefill and make_sharded_prefill (Qwen3-1.7B widths, 2 blocks,
    512 tokens) over ``mesh``'s ``axis``, pipeline_apply and both training
    schedules over ``world`` stages, each against one device on this rank
    (f32, TF32 off): their errors into ``out``. -> the 2-block params."""
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.parallel import pipeline as pp
    from clearcam_tpu_torch.parallel.long_prefill import gather_seq, make_sharded_prefill
    from clearcam_tpu_torch.parallel.ringattn import ring_prefill
    t0 = time.perf_counter()
    # ring attention and the sequence-parallel prefill vs one device
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 1024, 16, 128), device=dev, generator=g)
    k, v = (torch.randn((1, 1024, 8, 128), device=dev, generator=g) for _ in range(2))
    got = ring_prefill(mesh, axis)(q, k, v)
    out["ring_err"] = float((got - _p18_sdpa(torch, q, k, v)).abs().max())
    cfg = llm.qwen3_2b_cfg(2, 1024)
    params = llm.init_params(cfg, device=dev, generator=torch.Generator(device=dev)
                             .manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    hidden, _ = make_sharded_prefill(mesh, cfg, axis)(params, toks)
    hidden = gather_seq(hidden, mesh.group(axis))
    with torch.no_grad():
        ref, _ = llm.forward(params, cfg, llm.init_state(cfg, device=dev), toks, 0,
                             llm.freqs_for(cfg, dev))
    out["sharded_prefill_rel"] = float((hidden - ref).abs().max() / ref.abs().max())
    # pipelines: pipeline_apply and both training schedules vs sequential
    pmesh_ = pp.make_pp_mesh(world)
    s = pmesh_.coord("stage")
    gs = torch.Generator(device=dev).manual_seed(7)
    stages = [{"w1": torch.randn((256, 512), device=dev, generator=gs) * 0.05,
               "w2": torch.randn((512, 256), device=dev, generator=gs) * 0.05}
              for _ in range(world)]
    x = torch.randn((4, 8, 256), device=dev, generator=gs)
    y = torch.randn((4, 8, 256), device=dev, generator=gs)

    def stage_fn(p_, z):
        return torch.nn.functional.silu(z @ p_["w1"]) @ p_["w2"]

    def mse(a, b):
        return torch.mean((a - b) ** 2)
    ap = pp.pipeline_apply(pmesh_, "stage", stage_fn, stages[s], x)
    seq = x
    for sp in stages:
        seq = stage_fn(sp, seq)
    out["pipeline_apply_err"] = float((ap - seq).abs().max())
    leaves = [{k_: v_.clone().requires_grad_() for k_, v_ in sp.items()} for sp in stages]
    h = x
    for lp in leaves:
        h = torch.stack([stage_fn(lp, h[i]) for i in range(4)])
    ref_loss = torch.stack([mse(h[i], y[i]) for i in range(4)]).mean()
    ref_loss.backward()
    for name, fn in (("1f1b", pp.pipeline_train_step_1f1b),
                     ("gpipe", pp.pipeline_train_step_gpipe)):
        loss, grads = fn(pmesh_, "stage", stage_fn, mse, stages[s], x, y)
        ref = ref_loss.detach()
        out[f"{name}_loss_rel"] = float(abs(loss - ref) / abs(ref))
        out[f"{name}_grad_err"] = max(float((grads[k_] - leaves[s][k_].grad).abs().max())
                                      for k_ in grads)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["seq_s"] = time.perf_counter() - t0
    return params


def _p18_finetune(ds, mesh_n):
    """finetune --mesh's ranks (``mesh_n``; None: one device) at res 640,
    batch 8, 3 steps -> the losses and the stem kernel's launches."""
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.tools import finetune
    s0 = stem.launches
    losses = finetune._train(
        dataset=ds, size="t", res=640, batch=8, steps=3, lr=3e-4, clip_norm=1.0,
        remat=False, init=None, out=os.devnull, seed=0, log_every=1, ckpt_dir=None,
        ckpt_every=0, device="cuda", mesh_n=mesh_n)
    return {"losses": losses, "stem_launches": stem.launches - s0}


def _p18a(rank, world, backend, frames, prompts, ds):
    """Phase 18 (a): one rank a card over NCCL, every path end to end."""
    import torch
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    from clearcam_tpu_torch.testing import detection_mismatches
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"backend": backend, "world": world, "t": {}}
    # BatchDetector(mesh=), YOLOv9-t 640 bf16, 8 random 1080p frames
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh(world, data=world)
    rows, ms, stem_n = _p18_detect(torch, mesh, frames, torch.bfloat16)
    out["detect"] = {"ms": ms, "stem_launches": stem_n}
    if rank == 0:
        solo = np.stack(BatchDetector("t", res=640, dtype=torch.bfloat16,
                                      device=dev).detect_many(list(frames)))
        bad = detection_mismatches(solo, rows)
        out["detect"]["mismatches"] = len(bad)
        if bad:
            raise AssertionError(f"(a) sharded detect vs solo: {bad[:5]}")
    out["t"]["detect"] = time.perf_counter() - t0
    # ring attention, the sequence-parallel prefill and the pipelines
    params = _p18_seq(torch, out, mesh, "data", world, dev)
    out["t"]["seq"] = out.pop("seq_s")
    # the tp engine (Qwen3-1.7B widths, 2 blocks, int8, the decode kernel)
    t0 = time.perf_counter()
    cfg = llm.qwen3_2b_cfg(2, 1024)
    qp = llm.quantize_params_int8(params)
    tp_mesh = pmesh.make_mesh(world, data=1)
    reqs = [(p_, 8) for p_ in prompts[:4]]
    kw = dict(n_slots=4, state_dtype=torch.bfloat16, use_pallas_decode=True)
    out["engine"] = _p18_engine(torch, tp_mesh, cfg, qp, reqs, **kw)
    if rank == 0:
        solo, _, _ = _p18_solo_tokens(torch, cfg, qp, reqs, **kw)
        out["engine"]["tokens_equal"] = out["engine"]["tokens"] == solo
        del out["engine"]["tokens"]
    del params, qp
    torch.cuda.empty_cache()
    out["t"]["engine"] = time.perf_counter() - t0
    # finetune --mesh's ranks, 3 steps (its command line is held on the CPU
    # by the tests; the losses are held against (b)'s one-device run)
    t0 = time.perf_counter()
    out["finetune"] = _p18_finetune(ds, world)
    out["t"]["finetune"] = time.perf_counter() - t0
    return out


def _p18b(rank, world, backend, frames, prompts, ds):
    """Phase 18 (b): the sharded shapes at full published width, 2 ranks
    (sharing card 0 over gloo, or on 2 cards over NCCL)."""
    import torch
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.models import qwen3vl as qvl
    from clearcam_tpu_torch.ops.vit_attention import mha_flash
    from clearcam_tpu_torch.parallel import comm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = pmesh.make_mesh(2, data=1)
    probe = torch.empty(1, device=dev)
    out = {"backend": backend, "world": world, "device": str(dev), "t": {},
           # which ops go through pinned host memory on this backend
           "host_staged": {op: comm.staged(op, probe, mesh.group("model"))
                           for op in ("p2p", "all_reduce", "broadcast", "all_gather")}}
    # the tp engine at Qwen3-1.7B widths and depth, int8, the decode kernels
    cfg = llm.qwen3_2b_cfg(28, 512)
    t0 = time.perf_counter()
    params = llm.init_params(cfg, device=dev, quantize="int8",
                             generator=torch.Generator(device=dev).manual_seed(0))
    out["init_s"] = time.perf_counter() - t0
    reqs = [(p_, 24) for p_ in prompts]
    for name, kw in (("bf16 KV", {}), ("int8 KV", {"kv_quant": True})):
        t0 = time.perf_counter()
        kw = dict(n_slots=8, state_dtype=torch.bfloat16, use_pallas_decode=True, **kw)
        row = _p18_engine(torch, mesh, cfg, params, reqs, **kw)
        if rank == 0:
            solo, solo_s, solo_steps = _p18_solo_tokens(torch, cfg, params, reqs, **kw)
            row["tokens_equal"] = row["tokens"] == solo
            row["one_rank_s"], row["one_rank_steps"] = solo_s, solo_steps
            row["new_tokens"] = sum(len(t) for t in row.pop("tokens"))
        out[name] = row
        out["t"][name] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    # ring attention, the sequence-parallel prefill and the pipelines across
    # the 2 ranks: their point-to-point exchanges on CUDA tensors
    _p18_seq(torch, out, mesh, "model", 2, dev)
    out["t"]["seq"] = out.pop("seq_s")
    torch.cuda.empty_cache()
    # VLMServingEngine(mesh=), Qwen3-VL-2B widths, 2 language + 2 vision blocks
    t0 = time.perf_counter()
    vcfg = qvl.qwen3vl_2b_cfg(2, 2048)
    vparams = llm.init_params(vcfg, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(3))
    vkv, vp = qvl.vision_2b_random(blocks=2, deepstack=(1,))
    tower = qvl.VisionTower(vkv, vp, device=dev)
    tok = _smoke_tok()
    lang = llm.Transformer(vparams, vcfg, use_pallas_decode=True)
    qwen = qvl.Qwen3VL(res=SUMMARY_RES, lang=lang, tok=tok, vision=tower)
    img = np.random.default_rng(11).integers(0, 256, (*SUMMARY_RES, 3), np.uint8)
    v0 = mha_flash.launches
    eng = VLMServingEngine(qwen, n_slots=2, mesh=mesh)
    vlm = {"kv_heads": int(eng.engine.state[0]["k"].shape[1])}
    if mesh.is_leader:
        r = eng.submit([img], "What has been detected on my CCTV camera?", max_new=8,
                       temperature=0.0)
        eng.run_until_idle()
        text = eng.text(r)
        eng.close()
        mesh.stop_followers()
        # read before the one-device reference, which launches the kernel too
        vlm["vit_attention_launches"] = mha_flash.launches - v0
        solo = qwen.generate(prompt="What has been detected on my CCTV camera?", image=img,
                             reset=True, temperature=0.0, max_new=8)
        vlm["text_equal"] = text == solo
    else:
        mesh.follow()
        vlm["vit_attention_launches"] = mha_flash.launches - v0
    out["vlm"] = vlm
    del eng, qwen, lang, vparams, tower
    torch.cuda.empty_cache()
    out["t"]["vlm"] = time.perf_counter() - t0
    # 2 data ranks of YOLOv9-t detect: the stem kernel on each
    t0 = time.perf_counter()
    rows, ms, stem_n = _p18_detect(torch, pmesh.make_mesh(2, data=2), frames,
                                   torch.bfloat16)
    out["detect"] = {"ms": ms, "stem_launches": stem_n,
                     "rows": None if rows is None else list(rows.shape)}
    out["t"]["detect"] = time.perf_counter() - t0
    # finetune --mesh's ranks: res 640, batch 8, 3 steps on a (1, 2) mesh,
    # and the one-device run that (a) and (b) are held against
    t0 = time.perf_counter()
    out["finetune"] = _p18_finetune(ds, 2)
    if rank == 0:
        out["finetune"]["one_rank"] = _p18_finetune(ds, None)["losses"]
    out["t"]["finetune"] = time.perf_counter() - t0
    return out


P18_SEQ_CHECKS = (("ring_err", P18_RING_TOL), ("sharded_prefill_rel", P18_RING_TOL),
                  ("pipeline_apply_err", 1e-4), ("1f1b_loss_rel", 1e-5),
                  ("gpipe_loss_rel", 1e-5), ("1f1b_grad_err", 1e-4),
                  ("gpipe_grad_err", 1e-4))


def _p18_seq_line(r) -> str:
    return (f"ring max|d| {r['ring_err']:.2e}, sharded prefill rel "
            f"{r['sharded_prefill_rel']:.2e}; pipeline_apply {r['pipeline_apply_err']:.2e}, "
            f"1f1b loss rel {r['1f1b_loss_rel']:.1e} grads {r['1f1b_grad_err']:.1e}, gpipe "
            f"{r['gpipe_loss_rel']:.1e} / {r['gpipe_grad_err']:.1e}")


def _p18_seq_check(part, r) -> None:
    for key, tol in P18_SEQ_CHECKS:
        if not r[key] <= tol:
            raise AssertionError(f"phase 18 ({part}): {key} {r[key]} > {tol}")


def phase18(torch):
    n = torch.cuda.device_count()
    log(f"== phase 18: multi-device paths (clearcam_tpu_torch.parallel): (a) {n} rank(s), "
        "one a card over NCCL; (b) 2 ranks "
        + ("on 2 cards over NCCL" if n >= 2 else "sharing card 0 over gloo (checks the "
           "sharded shapes, not scale-out)"))
    rng = np.random.default_rng(18)
    frames = rng.integers(0, 256, (8, 1080, 1920, 3), np.uint8)
    prompts = [list(rng.integers(1, 151000, int(t))) for t in np.linspace(24, 88, 8)]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = Path(tmp) / "ds"
        _ft_dataset(ds, n=8)
        t0 = time.time()
        a = _p18_spawn("_p18a", n, "nccl", frames, prompts, str(ds))
        out["a"] = a[0]
        out["a"]["seconds"] = round(time.time() - t0, 1)
        backend = "nccl" if n >= 2 else "gloo"
        t2 = time.time()
        b = _p18_spawn("_p18b", 2, backend, frames, prompts, str(ds))
    out["a"]["engine_launches_by_rank"] = [x["engine"]["launches"] for x in a]
    e = a[0]["engine"]
    fa = a[0]["finetune"]
    fa["rel"] = max(abs(x - y) / abs(y)
                    for x, y in zip(fa["losses"], b[0]["finetune"]["one_rank"]))
    log(f"(a) NCCL x{n}: detect rows vs solo {a[0]['detect']['mismatches']} mismatches, "
        f"stem launches by rank {[x['detect']['stem_launches'] for x in a]}; "
        f"{_p18_seq_line(a[0])}; tp engine tokens equal {e['tokens_equal']}, launches "
        f"{e['launches']}; finetune x{n} losses {fa['losses']} (rel {fa['rel']:.1e} to one "
        f"device), stem launches by rank {[x['finetune']['stem_launches'] for x in a]}; "
        f"seconds {a[0]['t']}")
    _p18_seq_check("a", a[0])
    if not e["tokens_equal"] or min(x["detect"]["stem_launches"] for x in a) < 1 \
            or min(x["engine"]["launches"]["quant_linear"] for x in a) < 1 \
            or min(x["engine"]["launches"]["decode_attention_batch"] for x in a) < 1 \
            or min(x["finetune"]["stem_launches"] for x in a) < 3 \
            or not fa["rel"] <= P18_FT_TOL:
        raise AssertionError("phase 18 (a): tokens differ, a kernel did not launch or the "
                             "finetune loss is off")
    out["b"] = b[0]
    out["b"]["seconds"] = round(time.time() - t2, 1)
    if n < 2:
        out["b"]["note"] = ("2 ranks share one card: a check of correctness and the "
                            "shard shapes, not a measure of scale-out")
    for name in ("bf16 KV", "int8 KV"):
        r0 = b[0][name]
        steps = r0["decode_steps"]
        r0["launches_by_rank"] = [x[name]["launches"] for x in b]
        r0["reduce_by_rank"] = [x[name]["reduce"] for x in b]
        r0["decode_tokens_per_s"] = r0["new_tokens"] / r0["seconds"]
        r0["ms_a_step"] = 1e3 * r0["seconds"] / max(steps, 1)
        r0["collective_ms_a_step"] = 1e3 * (r0["channel_s"] + r0["reduce"]["seconds"]) \
            / max(steps, 1)
        r0["one_rank_ms_a_step"] = 1e3 * r0["one_rank_s"] / max(r0["one_rank_steps"], 1)
        kern = "decode_attention_batch_q8" if name == "int8 KV" else "decode_attention_batch"
        log(f"(b) {backend} x2, Qwen3-1.7B 28 blocks int8, {name}, 8 slots, 8 requests "
            f"24-88 tokens + 24 new: tokens equal one rank {r0['tokens_equal']}; "
            f"{r0['decode_tokens_per_s']:.1f} new tokens/s over the run, "
            f"{r0['ms_a_step']:.1f} ms a step ({steps} steps; one rank "
            f"{r0['one_rank_ms_a_step']:.1f} ms), collectives {r0['collective_ms_a_step']:.2f}"
            f" ms a step (channel {1e3 * r0['channel_s'] / max(steps, 1):.2f}, "
            f"{r0['reduce']['calls']} block reductions {1e3 * r0['reduce']['seconds']:.1f} ms "
            f"in all); KV heads a rank {r0['kv_heads']}; launches by rank "
            f"{r0['launches_by_rank']}")
        if not r0["tokens_equal"] or r0["kv_heads"] != 4 or min(
                x[name]["launches"]["quant_linear"] for x in b) < 1 or min(
                x[name]["launches"][kern] for x in b) < 1:
            raise AssertionError(f"phase 18 (b) {name}: tokens differ or a kernel did "
                                 "not launch at the shard's shapes")
    v = b[0]["vlm"]
    v["vit_by_rank"] = [x["vlm"]["vit_attention_launches"] for x in b]
    d = b[0]["detect"]
    d["stem_by_rank"] = [x["detect"]["stem_launches"] for x in b]
    f = b[0]["finetune"]
    f["rel"] = max(abs(x - y) / abs(y) for x, y in zip(f["losses"], f["one_rank"]))
    log(f"(b) {backend} x2, host-staged ops {b[0]['host_staged']}: {_p18_seq_line(b[0])}; "
        f"VLMServingEngine(mesh=) Qwen3-VL-2B widths, 2 blocks: text equal solo "
        f"{v['text_equal']}, KV heads a rank {v['kv_heads']}, vit_attention launches by "
        f"rank {v['vit_by_rank']}; detect x2 data ranks: stem launches by rank "
        f"{d['stem_by_rank']}; finetune (1, 2) mesh losses {f['losses']} vs one rank "
        f"{f['one_rank']} (rel {f['rel']:.1e}); seconds {b[0]['t']}")
    _p18_seq_check("b", b[0])
    if not v["text_equal"] or min(v["vit_by_rank"]) < 1 or min(d["stem_by_rank"]) < 1 \
            or not f["rel"] <= P18_FT_TOL:
        raise AssertionError("phase 18 (b): VLM text, a kernel launch or the finetune "
                             "loss off")
    print(json.dumps({"phase18": out}, default=str), flush=True)
    return out


# ---------------------------------------------------------------------------
# the stem's and the host link's probes
# ---------------------------------------------------------------------------

def phase19(torch):
    log("== phase 19: tools.stem_probe, tools.stem_kernel_probe, tools.tunnel_probe at "
        "their defaults")
    out = {}
    lines, _, _ = _tool(["stem_probe"], 300)
    out["stem_probe"] = lines[-1]
    lines, n, _ = _tool(["stem_kernel_probe"], 300)
    k = lines[-1]
    if not (n and n["stem"] > 0) or not k["max_abs_diff"] <= BF16_TOL \
            or k["s2d_layout_ms_unfused"] is not None:
        raise AssertionError(f"stem_kernel_probe: {k}, launches {n}")
    out["stem_kernel_probe"] = {**k, "launches": n["stem"]}
    lines, _, text = _tool(["tunnel_probe"], 120)
    m = re.search(r"^# kernel launches a call: (\d+)$", text, re.M)
    if m is None or int(m.group(1)) < 1:
        raise AssertionError(f"tunnel_probe launched no kernel:\n{text[-2000:]}")
    out["tunnel_probe"] = {**lines[-1], "launches_a_call": int(m.group(1))}
    sp = out["stem_probe"]
    log(f"stem [128,640,640,3] bf16: kernel {k['kernel_stem_ms']:.4f} ms, cuDNN pair "
        f"{k['cudnn_stem_ms']:.4f} ms ({k['speedup_vs_cudnn']:.2f}x), max|d| "
        f"{k['max_abs_diff']:.3e}, {n['stem']} launches; pair by conv {sp['conv1_ms']:.4f} + "
        f"{sp['conv2_ms']:.4f} ms, s2d conv1 {sp['conv1_s2d_2x2s1_ms']:.4f} ms; bounds "
        f"{sp['roofline_ms_min_traffic']:.4f} ms (bytes), "
        f"{sp['roofline_ms_with_mid_roundtrip']:.4f} (with the intermediate), "
        f"{sp['tensor_core_ms_at_peak']:.4f} (operations)")
    print(json.dumps({"phase19": out}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated subset of phases to run")
    ap.add_argument("--package", default=None,
                    help="import clearcam_tpu_torch from this checkout instead (e.g. "
                         "a parent commit unpacked with git archive), to time two "
                         "versions with the same phases in one run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    if args.package:
        global PKG_ROOT
        PKG_ROOT = Path(args.package).resolve()
        sys.path.insert(0, str(PKG_ROOT))

    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; "
                 "this script needs an NVIDIA GPU")
    try:
        import clearcam_tpu_torch
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the repository root ({e})")
    log(f"package: {Path(clearcam_tpu_torch.__file__).parent}")

    t0 = time.time()
    build_s = max_err = times = fps = launches = attn_err = attn_times = clip_fps = None
    kern = llm_errs = llm_tps = int4_launches = served = k10 = vl_errs = vlm = None
    probe = spec = fam = tools = ft = multi = probes = None
    phase_s = {}

    def run(n, fn, *a):
        t = time.time()
        r = fn(*a)
        phase_s[n] = round(time.time() - t, 1)
        log(f"-- phase {n}: {phase_s[n]} s (total {time.time() - t0:.1f} s)")
        return r
    if 0 in phases:
        run(0, phase0, torch)
    if 1 in phases:
        build_s = run(1, phase1)
    if 2 in phases:
        max_err, times = run(2, phase2, torch)
    if 3 in phases:
        fps = run(3, phase3, torch)
    if 4 in phases:
        launches = run(4, phase4)
    if 5 in phases:
        attn_err, attn_times = run(5, phase5, torch)
    if 6 in phases:
        clip_fps = run(6, phase6, torch)
    if 7 in phases:
        kern = run(7, phase7, torch)
    if 8 in phases:
        llm_errs, llm_tps, int4_launches = run(8, phase8, torch)
    if 9 in phases:
        served, _ = run(9, phase9)
    if 10 in phases:
        k10 = run(10, phase10, torch)
    if 11 in phases:
        vl_errs = run(11, phase11, torch)
    if 12 in phases:
        vlm = run(12, phase12, torch)
    if 13 in phases:
        probe = run(13, phase13, torch)
    if 14 in phases:
        spec = run(14, phase14, torch)
    if 15 in phases:
        fam = run(15, phase15, torch)
    if 16 in phases:
        tools = run(16, phase16, torch)
    if 17 in phases:
        ft = run(17, phase17, torch)
    if 18 in phases:
        multi = run(18, phase18, torch)
    if 19 in phases:
        probes = run(19, phase19, torch)
    log(f"== done in {time.time() - t0:.1f} s (phases {phase_s}); build {build_s} s; detect "
        f"fps {fps}; image tower img/s (kernel, plain) {clip_fps}; 28-block int4 engine "
        f"decode tokens/s (kernel: True, plain: False) {llm_tps}; summaries "
        f"{None if vlm is None else vlm['summary_s']}; probe "
        f"{None if probe is None else probe['tool']}; spec {SPEC_BLOCKS}-block [tokens/s, "
        f"dispatches/s, tokens per dispatch] {None if spec is None else spec['engine']}")
    if vlm is not None:
        print(json.dumps({"summary_layers_ms": vlm["layers"]}))
    if vl_errs is not None:
        print(json.dumps({"qwen3vl_2block_card_vs_cpu": vl_errs}))
    if fam is not None:
        print(json.dumps({"families": {
            "card_vs_cpu": fam["check"],
            "moe_decode_kernels_max_abs_err": fam["moe_decode_kernels"],
            "engines": {f"{f}, {r}": v for (f, r), v in fam["engine"].items()},
            "prefill_chunk_ms": fam["prefill_chunk_ms"],
            "llm_bench_ssm": fam["llm_bench_ssm"]}}))
    if tools is not None:
        print(json.dumps({"rfdetr_and_tools": tools}, default=str))
    if ft is not None:
        print(json.dumps({"finetune_export_parity": ft}))
    if phases != set(ALL_PHASES):
        return 0
    # the attention row: f32, the CLIP tower's dtype; times at one CROP_BATCH.
    # The LLM rows: times at the served decode shapes (8 slots, f32 residual
    # stream): x[8,2048] . W[6144,2048] for the quant kernels, the bf16 cache
    # with spread positions for decode attention; the summary slice's rows
    # at phase 10's summary shapes, launches from phase 12's runs, the int8
    # batch form's from phase 9's --kv-quant --pallas server; the probe's
    # f32 tile, launches from phase 13's run of the tool. The stem's launches
    # add phase 17's training and replay and phase 19's stem_kernel_probe, its
    # error the larger of phase 2's and the probe's
    def row(name, source, replaces, n, err, t):
        ms, plain, lib, bms, by = t
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bms, "bound_by": by, "library_ms": lib}
    st = times[8]
    at = attn_times[(16, 257, "float32")]
    vl = vlm["launches"]
    print(json.dumps({"kernels": [
        row("stem", STEM_SOURCE, STEM_REPLACES,
            launches["stem"] + ft["train_launches"] + ft["replay"]["launches"]
            + probes["stem_kernel_probe"]["launches"],
            max(max_err, probes["stem_kernel_probe"]["max_abs_diff"]),
            (st[0], st[1], None, st[2], st[3])),
        row("vit_attention", ATTN_SOURCE, ATTN_REPLACES, launches["vit_attention"],
            attn_err["float32"], (at[0], at[1], at[2], at[3], at[4])),
        row("quant_matmul_int8", QM_SOURCE, QM_REPLACES[8], served["quant_matmul"],
            kern["qm_err"][8], kern["qm_ms"][(8,) + QM_JSON_SHAPE]),
        row("quant_matmul_int4", QM_SOURCE, QM_REPLACES[4], int4_launches["int4"],
            kern["qm_err"][4], kern["qm_ms"][(4,) + QM_JSON_SHAPE]),
        row("decode_attention_batch", DEC_SOURCE, DEC_REPLACES,
            served["decode_attention"], kern["dec_err"],
            kern["dec_ms"][("spread", "bfloat16")]),
        row("decode_attention", DEC_SOURCE, DEC1_REPLACES,
            vl["bf16 KV"]["decode_attention"], k10["err"]["decode_attention"],
            k10["ms"]["decode_attention"]),
        row("decode_attention_q8", DEC_SOURCE, DEC1Q8_REPLACES,
            vl["int8 KV"]["decode_attention_q8"], k10["err"]["decode_attention_q8"],
            k10["ms"]["decode_attention_q8"]),
        row("decode_attention_batch_q8", DEC_SOURCE, DECBQ8_REPLACES,
            served["decode_attention_batch_q8"],
            k10["err"]["decode_attention_batch_q8"], k10["ms"]["decode_attention_batch_q8"]),
        row("vpu_probe", PROBE_SOURCE, PROBE_REPLACES, probe["tool"]["launches"],
            probe["err"]["float32"], probe["ms"]["float32"]),
    ]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
