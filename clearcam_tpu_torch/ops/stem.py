"""YOLOv9 stem — blocks 0-1 (conv 3x3 s2 3->16 + SiLU, conv 3x3 s2 16->32
+ SiLU) — as one hand-written CUDA kernel (csrc/stem.cu), the counterpart
of ``clearcam_tpu.ops.stem``.

``stem`` is the wrapper: a CPU tensor goes to ``stem_reference``, a CUDA
tensor launches the kernel or raises (wrong dtype, shape, contiguity or
device, failed build or launch). Nothing falls back. ``stem.launches``
counts kernel launches, so a run can show that its path went through the
kernel.

Contract (the JAX ``stem()``'s, for any H and W):
  x  letterboxed NHWC [B,H,W,3], bfloat16 or float32, contiguous
  w1 HWIO [3,3,3,16], w2 HWIO [3,3,16,32], b1 [16], b2 [32]
  -> NHWC [B,H2,W2,32] in x's dtype, H1 = ceil(H/2), H2 = ceil(H1/2)
The kernel reads weights and biases as float32 (bf16 weights widen
exactly), accumulates, adds the bias and takes SiLU in float32, and rounds
the conv1 output to x's dtype. Weights that are already float32 and
contiguous, as ``models.yolov9.params_from_jax`` keeps them, go to the
kernel without a copy.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPES = {"w1": (3, 3, 3, 16), "b1": (16,), "w2": (3, 3, 16, 32), "b2": (32,)}


def out_hw(h: int, w: int) -> tuple[int, int]:
    """Spatial size after the two stride-2, pad-1 3x3 convs."""
    h1, w1 = (h + 1) // 2, (w + 1) // 2
    return (h1 + 1) // 2, (w1 + 1) // 2


def stem_reference(x, w1, b1, w2, b2):
    """Plain version: two convs + SiLU in x's dtype (cuDNN on the GPU).

    In bf16 the convolution also rounds its pre-activation to bf16 before
    SiLU, one rounding more than the kernel; the two agree to bf16 rounding.
    """
    dt = x.dtype
    y = F.silu(F.conv2d(x, w1.to(dt), b1.to(dt), stride=2, padding=1))
    return F.silu(F.conv2d(y, w2.to(dt), b2.to(dt), stride=2, padding=1))


def _check(x, params):
    if x.dtype not in _DTYPES:
        raise TypeError(f"stem: x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem: x must be NHWC [B,H,W,3], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stem: x must be contiguous NHWC")
    for name, t in params.items():
        if tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"stem: {name} must be {_SHAPES[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"stem: {name} on {t.device}, x on {x.device}")


def prepare(device) -> str:
    """Build and load the kernel library, and set the kernel up on the CUDA
    ``device``, once; returns the library's path. Raises when nvcc, the
    build or the device refuses, so a detector fails when it is made and
    not on its first frame."""
    return _build.prepare("stem_prepare", device)


def _f32(t):
    return t if t.dtype == torch.float32 and t.is_contiguous() \
        else t.to(torch.float32).contiguous()


def stem(x, w1, b1, w2, b2):
    """Fused stem: letterboxed NHWC [B,H,W,3] -> NHWC [B,H2,W2,32]."""
    if x.device.type == "cpu":
        return stem_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"stem: unsupported device {x.device}")
    _check(x, dict(w1=w1, b1=b1, w2=w2, b2=b2))
    b, h, w, _ = x.shape
    h2, w2_ = out_hw(h, w)
    out = torch.empty((b, h2, w2_, 32), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    w1, b1, w2, b2 = (_f32(t) for t in (w1, b1, w2, b2))
    prepare(x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.stem_forward(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                               w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                               b, h, w, _DTYPES[x.dtype], stream)
    _build.check(err, "stem kernel launch")
    stem.launches += 1
    return out


stem.launches = 0
