"""YOLOv9 stem — blocks 0-1 (conv 3x3 s2 3->16 + SiLU, conv 3x3 s2 16->32
+ SiLU) — as one hand-written CUDA kernel (csrc/stem.cu), the counterpart
of ``clearcam_tpu.ops.stem``.

``stem`` is the wrapper: a CPU tensor goes to ``stem_reference``, a CUDA
tensor launches the kernel or raises (wrong dtype, shape, contiguity or
device, failed build or launch). Nothing falls back. ``stem.launches``
counts kernel launches (through ``stem`` and ``stem_packed``), so a run
can show that its path went through the kernel.

Contract (the JAX ``stem()``'s, for any H and W):
  x  letterboxed NHWC [B,H,W,3], bfloat16 or float32, contiguous
  w1 HWIO [3,3,3,16], w2 HWIO [3,3,16,32], b1 [16], b2 [32]
  -> NHWC [B,H2,W2,32] in x's dtype, H1 = ceil(H/2), H2 = ceil(H1/2)

``pack`` turns the HWIO operands into the kernel's, once (``Packed``):
float32 HWIO ones, and the bf16 route's GEMM operands (bf16, K-major, K
padded to the MMA depth). ``stem`` packs on every call; ``stem_packed``
takes operands packed once, as ``models.yolov9.params_from_jax`` keeps
them, so no detect step packs again. bf16 x runs an implicit GEMM on the
tensor cores (``gemm_reference`` is its plain version), float32 x a
direct convolution on the CUDA cores. Both accumulate, add the bias and
take SiLU in float32, and round the conv1 output to x's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as tF

from ..nn import functional as F
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHAPES = {"w1": (3, 3, 3, 16), "b1": (16,), "w2": (3, 3, 16, 32), "b2": (32,)}
K1, K2 = 48, 144        # the GEMMs' depths: conv1 3 dy x 4 dx x 4 c, conv2 9 taps x 16
_PACKED = {"w1": ((3, 3, 3, 16), torch.float32), "b1": ((16,), torch.float32),
           "w2": ((3, 3, 16, 32), torch.float32), "b2": ((32,), torch.float32),
           "w1k": ((16, K1), torch.bfloat16), "w2k": ((32, K2), torch.bfloat16)}
# the operands each route's kernel reads, in its argument order
_ROUTE = {torch.float32: ("w1", "b1", "w2", "b2"),
          torch.bfloat16: ("w1k", "b1", "w2k", "b2")}


class Packed(NamedTuple):
    """The kernel's operands, made once by ``pack``."""
    w1: torch.Tensor    # [3,3,3,16] float32 HWIO (the float32 route, the CPU's)
    b1: torch.Tensor    # [16] float32
    w2: torch.Tensor    # [3,3,16,32] float32 HWIO
    b2: torch.Tensor    # [32] float32
    w1k: torch.Tensor   # [16, 48] bf16: w1k[n, 16*dy + 4*dx + c]; dx = 3 and c = 3 zero
    w2k: torch.Tensor   # [32, 144] bf16: w2k[n, 16*(3*dy + dx) + ci]


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


def pack(w1, b1, w2, b2) -> Packed:
    """HWIO operands -> ``Packed``: them as float32, and the bf16 GEMM's,
    K-major (a row per output channel), conv1's K laid out as the kernel
    reads its input, 3 rows (dy) of 4 pixels (dx, the fourth a zero
    weight) of 4 channels (the fourth zero), 48 deep. bf16 rounds the
    weights: exact for the values ``params_from_jax`` keeps in bf16."""
    _check_params(dict(w1=w1, b1=b1, w2=w2, b2=b2), w1.device)
    w1, b1, w2, b2 = (t.float().contiguous() for t in (w1, b1, w2, b2))
    w1k = torch.zeros((3, 4, 4, 16), dtype=torch.float32, device=w1.device)
    w1k[:, :3, :3] = w1
    return Packed(w1, b1, w2, b2,
                  w1k.reshape(K1, 16).t().to(torch.bfloat16).contiguous(),
                  w2.reshape(K2, 32).t().to(torch.bfloat16).contiguous())


def _taps(x, k: int, rows: int, cols: int):
    """[B,Hp,Wp,C] padded -> [B,rows,cols,3*k*C]: the stride-2 patches of 3
    rows by k columns, in (dy, dx, c) order."""
    return torch.cat([x[:, dy:dy + 2 * rows - 1:2, dx:dx + 2 * cols - 1:2]
                      for dy in range(3) for dx in range(k)], dim=-1)


def gemm_reference(x, ops: Packed):
    """Plain version of the GEMM the bf16 kernel computes, from ``ops``'s
    K-major operands: conv1 as [pixels, 48] patches (channels padded to 4,
    a fourth zero-weight column) times w1k^T, conv2 as [pixels, 144]
    patches of the conv1 output, zero outside it, times w2k^T; products of
    x's dtype summed in float32, bias and SiLU in float32, the conv1 output
    rounded to x's dtype. For float32 x, exact against ``stem_reference`` on the same
    (bf16-representable) weights up to summation order."""
    dt = x.dtype
    b, h, w, _ = x.shape
    h1, w1_ = (h + 1) // 2, (w + 1) // 2
    h2, w2_ = out_hw(h, w)
    # input rows -1 .. 2*h1, cols -1 .. 2*w1+1, channel 4 zero
    xp = tF.pad(x, (0, 1, 1, 2 * w1_ + 2 - w, 1, 2 * h1 + 1 - h))
    y = _taps(xp, 4, h1, w1_).float() @ ops.w1k.float().t() + ops.b1
    y = F.silu(y).to(dt)
    # conv1 output rows -1 .. 2*h2-1: conv2's zero padding
    yp = tF.pad(y, (0, 0, 1, 2 * w2_ - w1_, 1, 2 * h2 - h1))
    z = _taps(yp, 3, h2, w2_).float() @ ops.w2k.float().t() + ops.b2
    return F.silu(z).to(dt)


def _check_x(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"stem: x dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem: x must be NHWC [B,H,W,3], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("stem: x must be contiguous NHWC")


def _check_params(params, device):
    for name, t in params.items():
        if tuple(t.shape) != _SHAPES[name]:
            raise ValueError(f"stem: {name} must be {_SHAPES[name]}, "
                             f"got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"stem: {name} on {t.device}, x on {device}")


def _check_packed(params, device):
    for name, t in params.items():
        shape, dtype = _PACKED[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"stem: packed {name} must be {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != device:
            raise ValueError(f"stem: {name} on {t.device}, x on {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"stem: packed {name} must be contiguous and "
                             "16-byte aligned (as pack makes it)")


def prepare(device) -> str:
    """Build and load the kernel library, and set the kernel up on the CUDA
    ``device``, once; returns the library's path. Raises when nvcc, the
    build or the device refuses, so a detector fails when it is made and
    not on its first frame."""
    return _build.prepare("stem_prepare", device)


def _launch(x, w1, b1, w2, b2):
    b, h, w, _ = x.shape
    h2, w2_ = out_hw(h, w)
    out = torch.empty((b, h2, w2_, 32), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
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


def _device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem: unsupported device {x.device}")
    return x.device.type


def stem(x, w1, b1, w2, b2):
    """Fused stem from HWIO operands: letterboxed NHWC [B,H,W,3] -> NHWC
    [B,H2,W2,32]. Packs the operands on each call."""
    if _device(x) == "cpu":
        return stem_reference(x, w1, b1, w2, b2)
    _check_x(x)
    _check_params(dict(w1=w1, b1=b1, w2=w2, b2=b2), x.device)
    return stem_packed(x, pack(w1, b1, w2, b2))


def stem_packed(x, ops: Packed):
    """Fused stem from operands packed once (the served route): the kernel
    of x's dtype on the operands it reads. A CPU tensor goes to
    ``stem_reference`` on the float32 HWIO operands."""
    if _device(x) == "cpu":
        return stem_reference(x, ops.w1, ops.b1, ops.w2, ops.b2)
    _check_x(x)
    names = _ROUTE[x.dtype]
    operands = dict(zip(names, (getattr(ops, n) for n in names)))
    _check_packed(operands, x.device)
    return _launch(x, *operands.values())


stem.launches = 0
