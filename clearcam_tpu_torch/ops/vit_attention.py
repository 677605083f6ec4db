"""Non-causal attention for ViT towers as one hand-written CUDA kernel
(csrc/vit_attention.cu), the counterpart of ``clearcam_tpu.ops.vit_attention``.

``mha_flash`` is the wrapper: a CPU tensor goes to ``mha_reference``, a
CUDA tensor launches the kernel or raises (wrong dtype, head dim, shape,
strides or device, failed build or launch). Nothing falls back.
``mha_flash.launches`` counts kernel launches, so a run can show that its
path went through the kernel.

Contract (the JAX ``mha_flash``'s): q, k, v [B,H,T,D] -> [B,H,T,D],
non-causal, scale 1/sqrt(D) unless ``sm_scale`` is given, any T; the
result is unpadded attention. The kernel takes f32 or bf16 with D = 64
(CLIP ViT-L/14: 1024 wide, 16 heads), multiplies on the tensor cores
(bf16 products, f32 accumulators; f32 inputs as sums of bf16 terms),
takes the softmax in f32, and reads strided views in place: the heads that
``split_heads`` cuts out of the fused qkv projection cost no copy. The
output is a [B,H,T,D] view of a [B,T,H,D] buffer, so ``merge_heads`` of it
is free. ``plan`` sizes the grid from the shapes alone, so a call can be
captured in a CUDA graph.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..nn import functional as F
from . import _build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS = 16            # query rows a warp
# the warps a block may take, (fewest, most): an f32 block holds 160 KB of
# shared memory, so an SM holds one and it wants many warps (9 cover T =
# 257's 17 warps of rows in 2 blocks); a bf16 block 48 KB and 128 registers
# a thread, two an SM
WARPS = {torch.float32: (8, 9), torch.bfloat16: (4, 8)}
# a grid smaller than the card spreads over it, with blocks of no fewer
# warps than this (fewer leave each thread more of the K/V split and loads)
SPREAD_WARPS = 4
SMS = 132            # the H100 SXM's streaming multiprocessors
# K/V ring slots, the kernel's per type (it refuses others): an f32 slot is
# 32 KB beside 96 KB of bf16 planes, a bf16 slot 16 KB
STAGES = {torch.float32: 2, torch.bfloat16: 3}


class Plan(NamedTuple):
    warps: int       # a block's warps, ROWS query rows each
    stages: int      # K/V ring slots
    blocks: int      # the grid: query blocks x B*H


def plan(b: int, h: int, t: int, dtype) -> Plan:
    """The kernel's grid for [b,h,t,64] inputs of ``dtype``, from the
    shapes alone (nothing is read back): the warps a block in WARPS[dtype]
    that leave the fewest warps past t, the more on a tie (fewer blocks
    load and split each head's K/V). A grid of fewer blocks than SMs
    spreads instead: the fewest warps from SPREAD_WARPS whose grid is still
    at most one block an SM. T = 257 (17 warps of rows) takes 2 blocks of 9
    a head in f32 and 3 of 6 in bf16; T = 2040 (128) 16 blocks of 8; one
    crop's 16 heads at T = 257 5 blocks of 4."""
    warps_t = -(-t // ROWS)

    def blocks(w: int) -> int:
        return -(-warps_t // w) * b * h

    lo, hi = WARPS[dtype]
    w = min(range(lo, hi + 1), key=lambda w: (-(-warps_t // w) * w - warps_t, -w))
    if blocks(w) < SMS:
        w = next((v for v in range(SPREAD_WARPS, hi + 1) if blocks(v) <= SMS), w)
    return Plan(w, STAGES[dtype], blocks(w))


def mha_reference(q, k, v, sm_scale: float | None = None):
    """Plain version: f32 scores, softmax, PV product (``nn.functional.mha``
    with no mask)."""
    return F.mha(q, k, v, scale=sm_scale)


def prepare(device) -> str:
    """Build and load the kernel library and set the kernel up on the CUDA
    ``device``, once; returns the library's path. Raises when nvcc, the
    build or the device refuses."""
    return _build.prepare("vit_attention_prepare", device)


def _aligned(t: torch.Tensor) -> bool:
    """The kernel copies 16 bytes at a time (cp.async): unit last stride,
    the other strides (of dims longer than 1) multiples of 16 bytes, and a
    16-byte aligned base pointer."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1
            and all(s % per == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
            and t.data_ptr() % 16 == 0)


def _check(q, k, v):
    if q.dtype not in _DTYPES:
        raise TypeError(f"mha_flash: dtype {q.dtype} not in {list(_DTYPES)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"mha_flash: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"mha_flash: {name} on {t.device}, q on {q.device}")
        if t.shape != q.shape:
            raise ValueError(f"mha_flash: {name} shape {tuple(t.shape)} != "
                             f"q shape {tuple(q.shape)}")
    if q.dim() != 4:
        raise ValueError(f"mha_flash: q must be [B,H,T,D], got {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"mha_flash: head dim {q.shape[-1]} != {HEAD_DIM}, "
                         "the only one the kernel takes")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(
                f"mha_flash: {name} strides {t.stride()} (offset "
                f"{t.storage_offset()}) are not a unit last stride with the "
                "others and the base aligned to 16 bytes; pass .contiguous()")
    if q.shape[0] * q.shape[1] > 65535:
        raise ValueError(f"mha_flash: B*H = {q.shape[0] * q.shape[1]} > 65535")


def mha_flash(q, k, v, sm_scale: float | None = None):
    """[B,H,T,D] q, k, v -> [B,H,T,D] non-causal attention."""
    if q.device.type == "cpu":
        return mha_reference(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha_flash: unsupported device {q.device}")
    _check(q, k, v)
    b, h, t, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    scale = float(d ** -0.5) if sm_scale is None else float(sm_scale)
    strides = (ctypes.c_longlong * 12)(*(s for x in (q, k, v, out)
                                         for s in x.stride()[:3]))
    pl = plan(b, h, t, q.dtype)
    prepare(q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vit_attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), b, h, t, strides, scale,
                                        _DTYPES[q.dtype], pl.warps, pl.stages, stream)
    _build.check(err, "vit_attention kernel launch")
    mha_flash.launches += 1
    return out


mha_flash.launches = 0
