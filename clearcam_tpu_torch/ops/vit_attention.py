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
(CLIP ViT-L/14: 1024 wide, 16 heads), accumulates and takes the softmax in
f32, and reads strided views in place: the heads that ``split_heads`` cuts
out of the fused qkv projection cost no copy. The output is a [B,H,T,D]
view of a [B,T,H,D] buffer, so ``merge_heads`` of it is free.
"""
from __future__ import annotations

import ctypes

import torch

from ..nn import functional as F
from . import _build

HEAD_DIM = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """The kernel reads 4 elements at a time: unit last stride, the other
    strides (of dims longer than 1) multiples of 4, and a base pointer
    aligned to 4 elements."""
    return (t.stride(-1) == 1
            and all(s % 4 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1)
            and t.data_ptr() % (4 * t.element_size()) == 0)


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
                "others and the base aligned to 4 elements; pass .contiguous()")
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
    prepare(q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vit_attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                        out.data_ptr(), b, h, t, strides, scale,
                                        _DTYPES[q.dtype], stream)
    _build.check(err, "vit_attention kernel launch")
    mha_flash.launches += 1
    return out


mha_flash.launches = 0
