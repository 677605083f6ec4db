"""Weight-only quantized linear layers (int8 W8A16 and packed int4 W4A16)
as one hand-written CUDA kernel (csrc/quant_matmul.cu), the counterpart of
``clearcam_tpu.ops.quant_matmul``.

``quant_linear`` is the wrapper: a CPU tensor goes to
``quant_linear_reference``, a CUDA tensor launches the kernel or raises
(wrong dtype, shape, contiguity or device, failed build or launch).
Nothing falls back. ``quant_linear.launches`` counts kernel launches, so a
run can show that its path went through the kernel.

Formats, byte for byte the JAX package's, so one quantized checkpoint
serves both packages and ``models.llm.params_from_jax`` carries the
tensors across unchanged:

  QuantLinear   q [O_pad, I_pad] int8, s [1, O_pad] f32; W = q * s
  QuantLinear4  packed [O_pad, I_pad/2] int8: in each 1024-wide K tile,
                byte j holds element j (low nibble) and j + 512 (high
                nibble); s [I_pad/128, O_pad] f32, group-major; W = q * s
                per (group of 128 inputs, output)
  QuantExpert   q [E, O, I] int8, s [E, O, 1] f32, unpadded; W = q * s
                (MoE expert stacks; no kernel reads them)

O is padded to 256 and I to 1024 at quantization time; symmetric scales
(amax/127, amax/7), values rounded half to even. Semantics of
``quant_linear(x, w, b)`` (quant_matmul.py:282-303 of the JAX package):
any leading dims, the product in f32 with the scale applied after the K
sum (int4: to each group's partial sum), the bias added in f32, the result
cast to x's dtype.

The kernel runs on the tensor cores (f32 x as three exact bf16 terms) and
splits K over the card's SMs: ``plan`` sizes the grid from the shapes
alone, so a call can be captured in a CUDA graph. With more than one
split, the wrapper passes f32 scratch for the splits' sums and the
device's arrival counters, which every call leaves at zero; calls on one
device run in stream order (the port issues them on one stream).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import _build

TO = 256        # output padding (the JAX layout's output tile)
TI = 1024       # input padding (its contraction tile)
GROUP = 128     # int4 scale group along the input
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's grid (csrc/quant_matmul.cu): tiles of 64 outputs x 8 or 16
# rows (decode, N <= 16) or 256 outputs x 32 or 64 rows (prefill), K splits
# of whole UNITs
UNIT = 256      # split granularity in inputs: an int4 128-byte slice holds whole groups
SMS = 132       # the H100 SXM's streaming multiprocessors
# blocks the plan asks for, one an SM: at decode the fewest splits that
# reach it (each split adds scratch traffic and a reduction; on the H100
# two an SM read a layer's seven products no faster); at prefill, where
# one block of 8 warps fills an SM, the most splits that fit in it (a
# part-empty second wave gains nothing)
TARGET_BLOCKS = SMS
COUNTERS = 1024  # the split counters a device keeps (> TARGET_BLOCKS tiles)


@dataclass
class QuantLinear:
    """int8 weight + per-output scale, standing in for a dense (out, in)
    weight in a params dict."""
    q: torch.Tensor      # [O_pad, I_pad] int8
    s: torch.Tensor      # [1, O_pad] f32
    out_features: int
    in_features: int

    @property
    def shape(self):
        return (self.out_features, self.in_features)

    def dequantize(self) -> torch.Tensor:
        """Dense f32 (out, in) weight."""
        return (self.q.float() * self.s.T)[:self.out_features, :self.in_features]

    def to(self, device) -> "QuantLinear":
        return QuantLinear(self.q.to(device), self.s.to(device),
                           self.out_features, self.in_features)


@dataclass
class QuantLinear4:
    """Packed int4 weight + per-(group of 128, output) scales."""
    packed: torch.Tensor  # [O_pad, I_pad // 2] int8
    s: torch.Tensor       # [I_pad // GROUP, O_pad] f32
    out_features: int
    in_features: int

    @property
    def shape(self):
        return (self.out_features, self.in_features)

    def unpack(self) -> torch.Tensor:
        """The int4 values as int32 [O_pad, I_pad], sign-extended."""
        opad = self.packed.shape[0]
        p32 = self.packed.to(torch.int32).reshape(opad, -1, TI // 2)
        lo = (p32 << 28) >> 28
        hi = p32 >> 4
        return torch.cat([lo, hi], -1).reshape(opad, -1)

    def dequantize(self) -> torch.Tensor:
        w = self.unpack().float()
        opad, ipad = w.shape
        w = w.reshape(opad, ipad // GROUP, GROUP) * self.s.T[:, :, None]
        return w.reshape(opad, ipad)[:self.out_features, :self.in_features]

    def to(self, device) -> "QuantLinear4":
        return QuantLinear4(self.packed.to(device), self.s.to(device),
                            self.out_features, self.in_features)


@dataclass
class QuantExpert:
    """An int8 stack of per-expert weights [E, O, I] with per-(expert,
    output) f32 scales [E, O, 1], byte for byte the JAX package's
    QuantExpert. The MoE feed-forward (``models.llm._moe_experts``) reads
    the experts it routes to and widens them in plain torch: the JAX
    package runs this as plain XLA too, with no kernel."""
    q: torch.Tensor      # [E, O, I] int8
    s: torch.Tensor      # [E, O, 1] f32

    @property
    def shape(self):
        return tuple(self.q.shape)

    def __getitem__(self, sel) -> torch.Tensor:
        """The selected experts dequantized, f32 [..., O, I]."""
        return self.q[sel].float() * self.s[sel]

    def dequantize(self) -> torch.Tensor:
        return self.q.float() * self.s

    def to(self, device) -> "QuantExpert":
        return QuantExpert(self.q.to(device), self.s.to(device))


def _pad_to(x: torch.Tensor, m: int, dim: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % m
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` correctly rounded on any device. CUDA divides by a Python
    float as a product with its reciprocal, one bit off at times, and one
    bit of a scale moves values across a rounding edge: the quantized
    bytes would then depend on the device they were made on. The divisor
    is filled in on a's device (no host copy), so a CUDA graph can hold
    the division (the int8 cache's quantize-on-write in a decode step)."""
    return a / a.new_full((), d)


def quantize_int8(w: torch.Tensor) -> QuantLinear:
    """Symmetric per-output int8 of an (out, in) weight, on w's device."""
    w = w.float()
    o, i = w.shape
    amax = w.abs().amax(1, keepdim=True)
    s = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    q = _pad_to(_pad_to(q, TO, 0), TI, 1).contiguous()
    s = _pad_to(s, TO, 0).reshape(1, -1).contiguous()
    return QuantLinear(q, s, o, i)


def quantize_int4(w: torch.Tensor) -> QuantLinear4:
    """Symmetric per-(output, group of 128) int4 of an (out, in) weight,
    packed two to a byte, on w's device."""
    o, i = w.shape
    w = _pad_to(_pad_to(w.float(), TO, 0), TI, 1)
    o_pad, i_pad = w.shape
    g = w.reshape(o_pad, i_pad // GROUP, GROUP)
    amax = g.abs().amax(2, keepdim=True)
    s = torch.where(amax > 0, true_div(amax, 7.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(g / s), -8, 7).to(torch.int32) \
        .reshape(o_pad, i_pad // TI, TI)
    lo, hi = q[..., :TI // 2], q[..., TI // 2:]
    packed = ((hi << 4) | (lo & 0xF)).to(torch.int8).reshape(o_pad, i_pad // 2)
    return QuantLinear4(packed.contiguous(), s[..., 0].T.contiguous(), o, i)


def quantize_experts_int8(w: torch.Tensor) -> QuantExpert:
    """Symmetric per-(expert, output) int8 of an [E, O, I] stack, on w's
    device, rounded half to even as ``jnp.round``."""
    w = w.float()
    amax = w.abs().amax(2, keepdim=True)                           # [E, O, 1]
    s = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return QuantExpert(q.contiguous(), s.contiguous())


def _pack4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int32 [O_pad, I_pad], I_pad a multiple of TI) packed two
    to a byte, as ``quantize_int4`` packs them."""
    o_pad, i_pad = q.shape
    q = q.reshape(o_pad, i_pad // TI, TI)
    lo, hi = q[..., :TI // 2], q[..., TI // 2:]
    return ((hi << 4) | (lo & 0xF)).to(torch.int8).reshape(o_pad, i_pad // 2).contiguous()


def slice_rows(w, start: int, stop: int):
    """Output rows [start, stop) of a QuantLinear / QuantLinear4, exactly:
    the int8 scales follow their rows, the int4 scales their columns; the
    slice is padded again to the kernel's tiles (contiguous)."""
    n = stop - start
    if isinstance(w, QuantLinear):
        q = _pad_to(w.q[start:stop], TO, 0).contiguous()
        s = _pad_to(w.s[0, start:stop], TO, 0).reshape(1, -1).contiguous()
        return QuantLinear(q, s, n, w.in_features)
    packed = _pad_to(w.packed[start:stop], TO, 0).contiguous()
    s = w.s[:, start:stop]
    s = torch.cat([s, s.new_ones((s.shape[0], (-n) % TO))], 1).contiguous()
    return QuantLinear4(packed, s, n, w.in_features)


def slice_cols(w, start: int, stop: int):
    """Input columns [start, stop) of a QuantLinear / QuantLinear4, exactly
    (the partial product of a row-split matmul). int4 columns must be whole
    scale groups of GROUP: a split inside a group raises."""
    n = stop - start
    if isinstance(w, QuantLinear):
        q = _pad_to(w.q[:, start:stop], TI, 1).contiguous()
        return QuantLinear(q, w.s.clone(), w.out_features, n)
    if start % GROUP or stop % GROUP:
        raise ValueError(f"int4 columns [{start}, {stop}) split a scale group of "
                         f"{GROUP}")
    q = _pad_to(w.unpack()[:, start:stop], TI, 1)
    s = w.s[start // GROUP:stop // GROUP]
    s = torch.cat([s, s.new_ones(((q.shape[1] - n) // GROUP, s.shape[1]))], 0)
    return QuantLinear4(_pack4(q), s.contiguous(), w.out_features, n)


def quant_linear_reference(x, w, b=None):
    """Plain version: dequantize, multiply in f32, scale (int8: after the
    product), add the bias in f32, cast to x's dtype. It is the XLA
    expression the TPU kernel replaced."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    if isinstance(w, QuantLinear4):
        y = x2 @ w.dequantize().T
    else:
        q = w.q[:w.out_features, :w.in_features].float()
        y = (x2 @ q.T) * w.s[:, :w.out_features]
    if b is not None:
        y = y + b.float()
    return y.reshape(*lead, w.out_features).to(x.dtype)


class Plan(NamedTuple):
    block_o: int     # outputs a block: 64 (decode) or 256 (prefill)
    block_n: int     # rows a block: 8, 16 (decode) or 32, 64 (prefill)
    tiles: int       # output tiles x row tiles
    units: int       # K_pad / UNIT
    splits: int      # K splits of whole units, 1 <= splits <= units


def plan(n: int, o_pad: int, k_pad: int, int4: bool = False) -> Plan:
    """The kernel's grid for ``n`` rows against an [o_pad, k_pad] weight,
    from the shapes alone (nothing is read back, so a call can be captured
    in a CUDA graph): at decode the fewest K splits that give
    ``TARGET_BLOCKS`` blocks, at prefill as many as fit in one wave of
    ``TARGET_BLOCKS``; at most one a unit. A split is whole units of 256
    inputs, so it never cuts an int4 group; the plan is the same for both
    formats."""
    del int4
    block_o, block_n = ((64, 8) if n <= 8 else (64, 16) if n <= 16
                        else (256, 32) if n <= 32 else (256, 64))
    tiles = (o_pad // block_o) * -(-n // block_n)
    units = k_pad // UNIT
    if n <= 16:
        splits = -(-TARGET_BLOCKS // tiles)          # the fewest that reach it
    else:
        splits = TARGET_BLOCKS // tiles              # one wave at most
    return Plan(block_o, block_n, tiles, units, min(units, max(1, splits)))


_counters: dict[int, torch.Tensor] = {}


def _split_counters(device) -> torch.Tensor:
    """The device's arrival counters of the split reduction, zero between
    calls (each call's last block resets its tile's). Made once per device,
    on the first call: not inside a CUDA graph capture, whose memory pool
    would own them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quant_linear: call it once on this device before "
                               "capturing it in a CUDA graph")
        _counters[index] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return _counters[index]


def prepare(device) -> str:
    """Build and load the kernel library and set the kernel up on the CUDA
    ``device``, once; returns the library's path."""
    return _build.prepare("quant_matmul_prepare", device)


def _check(x, w, b):
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_linear: x dtype {x.dtype} not in {list(_DTYPES)}")
    int4 = isinstance(w, QuantLinear4)
    qw = w.packed if int4 else w.q
    if x.shape[-1] != w.in_features:
        raise ValueError(f"quant_linear: x has {x.shape[-1]} features, the "
                         f"weight takes {w.in_features}")
    o_pad, k_cols = qw.shape
    k_pad = k_cols * 2 if int4 else k_cols
    if qw.dtype != torch.int8 or w.s.dtype != torch.float32:
        raise TypeError(f"quant_linear: weight {qw.dtype}, scales {w.s.dtype}; "
                        "want int8 and float32")
    want_s = (k_pad // GROUP, o_pad) if int4 else (1, o_pad)
    if (o_pad % TO or k_pad % TI or tuple(w.s.shape) != want_s
            or w.out_features > o_pad or w.in_features > k_pad):
        raise ValueError(f"quant_linear: weight {tuple(qw.shape)} / scales "
                         f"{tuple(w.s.shape)} are not a quantize_int8/int4 layout")
    for name, t in (("weight", qw), ("scales", w.s)) + \
            ((("bias", b),) if b is not None else ()):
        if t.device != x.device:
            raise ValueError(f"quant_linear: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_linear: {name} is not contiguous")
    if b is not None and tuple(b.shape) != (w.out_features,):
        raise ValueError(f"quant_linear: bias {tuple(b.shape)} != ({w.out_features},)")
    if qw.data_ptr() % 16:
        raise ValueError("quant_linear: weight not 16-byte aligned")
    return int4, o_pad, k_pad


def quant_linear(x, w, b=None):
    """``x @ W.T + b`` for a QuantLinear / QuantLinear4 ``w``."""
    if x.device.type == "cpu":
        return quant_linear_reference(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"quant_linear: unsupported device {x.device}")
    int4, o_pad, k_pad = _check(x, w, b)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if not x2.is_contiguous():
        raise ValueError("quant_linear: x is not contiguous in its last dims")
    n = x2.shape[0]
    out = torch.empty((n, w.out_features), dtype=x.dtype, device=x.device)
    if n == 0:
        return out.reshape(*lead, w.out_features)
    bias = None if b is None else b.float().contiguous()
    p = plan(n, o_pad, k_pad, int4)
    prepare(x.device)
    lib = _build.load()
    part = counters = None
    if p.splits > 1:
        assert p.tiles <= COUNTERS, p
        counters = _split_counters(x.device)
        part = torch.empty(p.splits * n * o_pad, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_matmul_forward(
            x2.data_ptr(), (w.packed if int4 else w.q).data_ptr(), w.s.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(),
            n, w.in_features, k_pad, w.out_features, o_pad, p.splits, int(int4),
            _DTYPES[x.dtype], stream)
    _build.check(err, "quant_matmul kernel launch")
    quant_linear.launches += 1
    return out.reshape(*lead, w.out_features)


quant_linear.launches = 0
