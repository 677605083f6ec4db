"""Functional primitives over torch, the counterpart of
``clearcam_tpu.nn.functional`` for what the ported models use: NHWC
convolution and pooling (YOLOv9, BlazeFace, AdaFace), and linear layers,
norms, activations and attention (the CLIP towers).

Public functions keep the JAX package's layout: NHWC activations and HWIO
filters, so tests compare like with like. Internally ``x.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is already a ``channels_last`` NCHW view, so
cuDNN receives it without a copy and returns ``channels_last`` output, which
permutes back to contiguous NHWC for free. The model converts its filters
to OIHW once, stored ``channels_last`` (``models.yolov9.params_from_jax``),
and calls ``conv2d_oihw``.

These ops ran in XLA outside any Pallas kernel in the JAX package, so
torch's own convolution (cuDNN on the GPU) and matrix products serve them.
Parameter dicts of the port hold torch tensors: filters OIHW (``conv2d_p``),
linear weights (out, in) as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..ops.quant_matmul import QuantLinear, QuantLinear4, quant_linear


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_oihw(x, w, b=None, *, stride=1, padding=0, groups=1):
    """NHWC conv with an OIHW (torch layout) filter; symmetric padding."""
    return _nhwc(tF.conv2d(_nchw(x), w, b, stride=stride, padding=padding,
                           groups=groups))


def conv2d(x, w, b=None, *, stride=1, padding=0, groups=1):
    """NHWC conv with an HWIO filter (the JAX package's signature)."""
    return conv2d_oihw(x, hwio_to_oihw(w), b, stride=stride, padding=padding,
                       groups=groups)


def conv2d_p(p: dict, prefix: str, x, **kw):
    """Conv from port params: ``{prefix}.weight`` (OIHW) and optional
    ``.bias``."""
    return conv2d_oihw(x, p[prefix + ".weight"], p.get(prefix + ".bias"), **kw)


def max_pool2d(x, window, stride=None, padding=0):
    """Max pool; the implicit padding is -inf, as in the JAX package."""
    stride = window if stride is None else stride
    return _nhwc(tF.max_pool2d(_nchw(x), window, stride, padding))


def avg_pool2d(x, window, stride=None, padding=0, count_include_pad=True):
    """Average pool with the reference's count_include_pad semantics
    (ADown, clearcam_tpu/nn/functional.py:84-97)."""
    stride = window if stride is None else stride
    return _nhwc(tF.avg_pool2d(_nchw(x), window, stride, padding,
                               count_include_pad=count_include_pad))


def upsample_nearest(x, scale=2):
    """Nearest-neighbour integer upsample."""
    return _nhwc(tF.interpolate(_nchw(x), scale_factor=scale, mode="nearest"))


silu = tF.silu
relu = tF.relu


def gelu(x):
    """Exact (erf) GELU, ``jax.nn.gelu(approximate=False)``."""
    return tF.gelu(x, approximate="none")


def prelu(x, weight):
    """Channel-wise PReLU over the last (channel) axis."""
    return torch.where(x > 0, x, weight * x)


def linear(x, w, b=None):
    """``x @ w.T + b`` with a torch-style (out, in) weight, or a
    ``QuantLinear``/``QuantLinear4`` (``ops.quant_matmul.quant_linear``:
    the hand-written kernel on the card). The product accumulates in f32
    (cuBLAS and torch's CPU kernels do so for bf16 too) and comes back in
    x's dtype; in bf16 torch may add the bias after that rounding, one
    rounding more than the JAX package's f32 bias add. A dense weight of
    another dtype than x (bf16 weights under the LLM's f32 residual
    stream) multiplies x rounded to the weight's dtype, where the JAX
    package promotes the weight to f32."""
    if isinstance(w, (QuantLinear, QuantLinear4)):
        return quant_linear(x, w, b)
    if x.dtype != w.dtype:
        return tF.linear(x.to(w.dtype), w, b).to(x.dtype)
    return tF.linear(x, w, b)


def linear_p(p: dict, prefix: str, x):
    return linear(x, p[prefix + ".weight"], p.get(prefix + ".bias"))


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    """Layer norm over the last axis (biased variance, as the JAX package)."""
    return tF.layer_norm(x, x.shape[-1:], weight, bias, eps)


def layer_norm_p(p: dict, prefix: str, x, eps=1e-5):
    return layer_norm(x, p.get(prefix + ".weight"), p.get(prefix + ".bias"), eps)


def rms_norm(x, weight, eps=1e-5):
    """RMS norm over the last axis, taken in f32, back in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * weight).to(x.dtype)


def batch_norm_inference(x, weight, bias, mean, var, eps=1e-5):
    """Inference-mode batch norm over the channel (last) axis, unfolded as
    in the JAX package so checkpoints load one to one."""
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def batch_norm_p(p: dict, prefix: str, x, eps=1e-5):
    return batch_norm_inference(
        x, p[prefix + ".weight"], p[prefix + ".bias"],
        p[prefix + ".running_mean"], p[prefix + ".running_var"], eps)


def embedding(table, ids):
    return tF.embedding(ids.long(), table)


def mha(q, k, v, mask=None, scale=None):
    """Multi-head attention on [B,H,L,D] tensors: f32 scores, an optional
    additive mask, f32 softmax, the probabilities cast to v's dtype before
    the PV product, the output in v's dtype (the JAX package's numerics;
    scores of bf16 inputs are taken in f32)."""
    scale = 1.0 / float(np.sqrt(q.shape[-1])) if scale is None else scale
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out.to(v.dtype)


def split_heads(x, n_heads: int):
    """[B,L,H*D] -> [B,H,L,D], a strided view (no copy)."""
    b, l, d = x.shape
    return x.view(b, l, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x):
    """[B,H,L,D] -> [B,L,H*D]; free when x is a transposed [B,L,H,D]
    buffer, as the attention kernel returns it."""
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def oihw_to_hwio(w):
    """(O,I,H,W) -> (H,W,I,O), for numpy arrays or torch tensors."""
    if isinstance(w, torch.Tensor):
        return w.permute(2, 3, 1, 0).contiguous()
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def hwio_to_oihw(w):
    """(H,W,I,O) -> (O,I,H,W), for numpy arrays or torch tensors."""
    if isinstance(w, torch.Tensor):
        return w.permute(3, 2, 0, 1).contiguous()
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def tensors_from_numpy(params: dict, device, dtype=torch.float32) -> dict:
    """Flat params in the JAX layout (numpy or JAX arrays; filters HWIO)
    -> torch tensors on ``device`` in ``dtype``; 4-D filters become OIHW,
    stored ``channels_last`` so cuDNN reads them beside NHWC activations
    without a per-call transpose."""
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v, np.float32))
        if t.ndim == 4:
            t = hwio_to_oihw(t)
        t = t.to(device=device, dtype=dtype)
        if t.ndim == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        out[k] = t
    return out
