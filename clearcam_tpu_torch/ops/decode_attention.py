"""Batched GQA decode attention as one hand-written CUDA kernel
(csrc/decode_attention.cu), the counterpart of
``clearcam_tpu.ops.decode_attention.decode_attention_batch``.

``decode_attention_batch`` is the wrapper: a CPU tensor goes to
``decode_attention_batch_reference``, a CUDA tensor launches the kernel or
raises (wrong dtype, head dim, shape, contiguity or device, failed build
or launch). Nothing falls back. ``decode_attention_batch.launches`` counts
kernel launches, so a run can show that its path went through the kernel.

Contract (the JAX function's): q [B,H,D], k_cache and v_cache [B,KvH,S,D]
-> [B,H,D] in q's dtype. ``pos`` is a shared scalar or a per-row [B]
vector (continuous batching: every slot at its own position), ``pads`` [B]
each row's first live position (None = 0). Row b attends exactly to cache
positions pads[b]..pos[b], with rep = H/KvH query heads per KV head and
scale 1/sqrt(D). The kernel takes f32 or bf16 q and caches, D = 128, any
S, and reads only each row's own window.
"""
from __future__ import annotations

import torch

from . import _build

HEAD_DIM = 128
MAX_REP = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rows(x, b: int, device) -> torch.Tensor:
    """A scalar or [B] position as an int32 [B] tensor on ``device`` (a
    Python int is filled in on the device: no host copy)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), int(x), dtype=torch.int32, device=device)
    x = x.to(device=device, dtype=torch.int32)
    return x.expand(b).contiguous() if x.dim() == 0 else x.contiguous()


def decode_attention_batch_reference(q, k_cache, v_cache, pos, pads=None):
    """Plain version: masked dense softmax over the whole cache in f32 (the
    llm.py:295-309 math of the JAX package), output in q's dtype."""
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    pos_v = _rows(pos, b, q.device)
    pad_v = _rows(0 if pads is None else pads, b, q.device)
    qg = (q.float() * (1.0 / (d ** 0.5))).reshape(b, kvh, rep, d)
    scores = torch.matmul(qg, k_cache.float().transpose(-1, -2))      # [B,KvH,rep,S]
    cols = torch.arange(s, device=q.device)
    live = (cols[None] >= pad_v[:, None]) & (cols[None] <= pos_v[:, None])
    scores = scores.masked_fill(~live[:, None, None], float("-inf"))
    out = torch.matmul(torch.softmax(scores, -1), v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k_cache", k), ("v_cache", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"decode_attention_batch: {name} dtype {t.dtype} "
                            f"not in {list(_DTYPES)}")
        if t.device != q.device:
            raise ValueError(f"decode_attention_batch: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention_batch: {name} must be contiguous "
                             "and 16-byte aligned")
    if v.dtype != k.dtype:
        raise TypeError(f"decode_attention_batch: v_cache {v.dtype}, k_cache {k.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention_batch: q {tuple(q.shape)} must be "
                         f"[B,H,D] and the caches {tuple(k.shape)}, "
                         f"{tuple(v.shape)} one [B,KvH,S,D]")
    b, h, d = q.shape
    if d != HEAD_DIM or k.shape[3] != HEAD_DIM:
        raise ValueError(f"decode_attention_batch: head dim {d} / {k.shape[3]}; "
                         f"the kernel takes {HEAD_DIM}")
    kvh = k.shape[1]
    if k.shape[0] != b or h % kvh or h // kvh > MAX_REP:
        raise ValueError(f"decode_attention_batch: q {tuple(q.shape)} against "
                         f"caches {tuple(k.shape)}: need equal B, H % KvH == 0 "
                         f"and H / KvH <= {MAX_REP}")
    if b > 65535:
        raise ValueError(f"decode_attention_batch: B = {b} > 65535")


def decode_attention_batch(q, k_cache, v_cache, pos, pads=None):
    """q [B,H,D], caches [B,KvH,S,D] -> [B,H,D]; row b attends to
    positions pads[b]..pos[b]."""
    if q.device.type == "cpu":
        return decode_attention_batch_reference(q, k_cache, v_cache, pos, pads)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_batch: unsupported device {q.device}")
    _check(q, k_cache, v_cache)
    b, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    pos_v = _rows(pos, b, q.device)
    pad_v = _rows(0 if pads is None else pads, b, q.device)
    out = torch.empty_like(q)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            pos_v.data_ptr(), pad_v.data_ptr(), b, h, kvh, s,
            float(1.0 / (d ** 0.5)), _DTYPES[q.dtype], _DTYPES[k_cache.dtype], stream)
    _build.check(err, "decode_attention kernel launch")
    decode_attention_batch.launches += 1
    return out


decode_attention_batch.launches = 0
