"""GQA decode attention as hand-written CUDA kernels
(csrc/decode_attention.cu), the counterpart of
``clearcam_tpu.ops.decode_attention``:

- ``decode_attention_batch``: q [B,H,D], caches [B,KvH,S,D] f32 or bf16;
- ``decode_attention_batch_q8``: the same over int8 caches with f32
  per-token scales k_s, v_s [B,KvH,S];
- ``decode_attention`` and ``decode_attention_q8``: one stream, q [H,D],
  caches [KvH,S,D] (and scales [KvH,S]), a scalar position. They launch
  the batch kernels with B = 1 and no pads: the TPU's chunked kernels
  compute that case of the batch kernels' function.

Each wrapper takes its plain version (``*_reference``) for a CPU tensor,
and for a CUDA tensor launches its kernel or raises (wrong dtype, head dim,
shape, contiguity or device, failed build or launch). Nothing falls back.
Each wrapper counts its own kernel calls in ``.launches`` (one per call,
one launch on the card), so a run can show which entry points its path
went through.

Contract (the JAX functions'): ``pos`` is a shared scalar or a per-row [B]
vector, ``pads`` [B] each row's first live position (None = 0). Row b
attends exactly to cache positions pads[b]..pos[b], with rep = H/KvH query
heads per KV head and scale 1/sqrt(D). On the int8 caches K's scale
multiplies the score and V's scale the probability before the PV product,
as the TPU kernels apply them. A row with no live column (pads > pos) gives
zeros; the TPU kernels give 0/0 there. The kernels take f32 or bf16 q,
any head dim that is a multiple of ``HEAD_DIM_STEP`` up to
``MAX_HEAD_DIM``, any rep = H / KvH, any S, and read only each row's own
window. A head dim runs on the smallest of the built ``WIDTHS`` that holds
it (at a head dim below the width, with the dims past it zero).

On the card every call is one launch (flash-decoding): one block per
(chunk, head group, KV head, row) walks its chunk of the window, and the
last block of a (row, KV head, head group) to finish merges the chunks'
softmax partials, counting arrivals on a per-device buffer of counters
that each call leaves at zero. ``plan`` picks the path (tensor cores for
bf16 and int8 caches from ``TC_MIN_REP`` query heads a KV head on, CUDA
cores otherwise), the heads a block takes and the chunk from the shapes
alone, so a call reads nothing back and can be captured in a CUDA graph.
Calls on one device run on one stream (they share the counters), and the
first call on a device is made before any capture.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import _build

# the widths the kernels are built at (HeadDims in csrc/decode_attention.cu):
# 64 (Llama-3.2-1B, Qwen2.5-0.5B), 128 (Qwen3, Llama-3.x 3B/8B), 256
# (Qwen3-Next's attention blocks). Any head dim D <= MAX_HEAD_DIM that is a
# multiple of HEAD_DIM_STEP runs, on the smallest width >= D (80 and 96,
# H2O-Danube2/3, on 128); a wider D or another step raises (an int8 row is
# copied 8 bytes at a time at least). Any number of query heads per KV head
WIDTHS = (64, 128, 256)
MAX_HEAD_DIM = WIDTHS[-1]
HEAD_DIM_STEP = 8
SMS = 132               # the H100's streaming multiprocessors
# the CUDA-core path (f32 caches, small rep): positions per ring slot, and
# the query heads a block may take (4 at most above head dim 128)
TILE = 32
CC_HEADS = (1, 2, 4, 8)
# the tensor-core path (bf16 and int8 caches): positions per ring slot,
# query heads a block (the MMA's 16 rows), and the rep = H / KvH it starts
# at (timed against the CUDA-core path on the H100, chip_smoke.py phase 7,
# PERF.md §6: 5-31% slower at rep 2, 24-30% faster at rep 4)
TC_TILE = 64
TC_HEADS = 16
TC_MIN_REP = 4
# a chunk reads at least this many bytes of K/V (scales included): on the
# CUDA cores also at least 2 tiles, unless a whole-cache window would then
# leave SMs idle; on the tensor cores also as many as the merge reads back
# (`plan`). The splits of a cache stay at most MAX_SPLITS (the merge's
# weights in shared memory) and the blocks of a head group at most
# MAX_BLOCKS (1,024 and 4,096 each read slower at a served shape on the
# H100). All timed on the H100: chip_smoke.py phase 7, PERF.md
CC_TARGET_BYTES = 16 << 10
TC_TARGET_BYTES = 32 << 10
MAX_SPLITS = 64
MAX_BLOCKS = 2048
MAX_GRID_YZ = 65535     # CUDA's limit on grid.y (KV heads) and grid.z (rows)
# the merge's arrival counters a device holds: one per (row, KV head, head
# group) of a call
COUNTERS = 1 << 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_FLOAT_CACHES = (torch.float32, torch.bfloat16)


def _rows(x, b: int, device) -> torch.Tensor:
    """A scalar or [B] position as an int32 [B] tensor on ``device`` (a
    Python int is filled in on the device: no host copy)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), int(x), dtype=torch.int32, device=device)
    x = x.to(device=device, dtype=torch.int32)
    return x.expand(b).contiguous() if x.dim() == 0 else x.contiguous()


def _masked_attention(q, k, v, pos, pads, k_s=None, v_s=None):
    """The plain math: a masked dense softmax over the whole cache in f32,
    scales on scores and probabilities when given; zeros for a row with
    no live column. q [B,H,D], caches [B,KvH,S,D] -> [B,H,D] in q's dtype."""
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    rep = h // kvh
    pos_v = _rows(pos, b, q.device)
    pad_v = _rows(0 if pads is None else pads, b, q.device)
    qg = (q.float() * (1.0 / (d ** 0.5))).reshape(b, kvh, rep, d)
    scores = torch.matmul(qg, k.float().transpose(-1, -2))          # [B,KvH,rep,S]
    if k_s is not None:
        scores = scores * k_s.float()[:, :, None]
    cols = torch.arange(s, device=q.device)
    live = (cols[None] >= pad_v[:, None]) & (cols[None] <= pos_v[:, None])   # [B,S]
    scores = scores.masked_fill(~live[:, None, None], float("-inf"))
    probs = torch.softmax(scores, -1).nan_to_num(0.0)     # dead rows: all zeros
    if v_s is not None:
        probs = probs * v_s.float()[:, :, None]
    out = torch.matmul(probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_batch_reference(q, k_cache, v_cache, pos, pads=None):
    """Plain version of ``decode_attention_batch`` (the llm.py:295-309 math
    of the JAX package)."""
    return _masked_attention(q, k_cache, v_cache, pos, pads)


def decode_attention_batch_q8_reference(q, k_q8, k_s, v_q8, v_s, pos, pads=None):
    """Plain version of ``decode_attention_batch_q8``: the int8 values in
    f32, scores times k_s, probabilities times v_s."""
    return _masked_attention(q, k_q8, v_q8, pos, pads, k_s, v_s)


def decode_attention_reference(q, k_cache, v_cache, pos):
    """Plain version of ``decode_attention``: q [H,D], caches [KvH,S,D]."""
    return _masked_attention(q[None], k_cache[None], v_cache[None], pos, None)[0]


def decode_attention_q8_reference(q, k_q8, k_s, v_q8, v_s, pos):
    """Plain version of ``decode_attention_q8``: q [H,D], int8 caches
    [KvH,S,D], scales [KvH,S]."""
    return _masked_attention(q[None], k_q8[None], v_q8[None], pos, None,
                             k_s[None], v_s[None])[0]


def _check(name, q, k, v, scales=()) -> Plan:
    """Raise on what the kernel does not take; else the call's plan."""
    tensors = (("q", q), ("k_cache", k), ("v_cache", v)) + tuple(
        (n, t) for n, t in zip(("k_s", "v_s"), scales))
    for what, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name}: {what} on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")
    if q.dtype not in _FLOAT_CACHES:
        raise TypeError(f"{name}: q dtype {q.dtype} not in {list(_FLOAT_CACHES)}")
    want = (torch.int8,) if scales else _FLOAT_CACHES
    if k.dtype not in want or v.dtype != k.dtype:
        raise TypeError(f"{name}: caches {k.dtype}, {v.dtype}; the kernel takes "
                        f"one of {list(want)} for both")
    for what, t in zip(("k_s", "v_s"), scales):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(k.shape[:3]):
            raise ValueError(f"{name}: {what} {t.dtype} {tuple(t.shape)} must be "
                             f"float32 {tuple(k.shape[:3])}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [B,H,D] and the caches "
                         f"{tuple(k.shape)}, {tuple(v.shape)} one [B,KvH,S,D]")
    b, h, d = q.shape
    if not 0 < d <= MAX_HEAD_DIM or d % HEAD_DIM_STEP or k.shape[3] != d:
        raise ValueError(f"{name}: head dim {d} / {k.shape[3]}; the kernel takes a multiple "
                         f"of {HEAD_DIM_STEP} up to {MAX_HEAD_DIM}")
    kvh = k.shape[1]
    if k.shape[0] != b or kvh == 0 or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} against caches {tuple(k.shape)}: "
                         f"need equal B and H % KvH == 0")
    if b > MAX_GRID_YZ or kvh > MAX_GRID_YZ:
        raise ValueError(f"{name}: B = {b}, KvH = {kvh}; the grid takes at most "
                         f"{MAX_GRID_YZ} of each")
    pl = plan(b, kvh, k.shape[2], d, k.element_size(), h // kvh)
    if b * kvh * pl.groups > COUNTERS:
        raise ValueError(f"{name}: B x KvH x head groups = {b * kvh * pl.groups} merges; "
                         f"the kernel counts at most {COUNTERS}")
    return pl


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's grid for one call: (splits x groups, KvH, B) blocks."""
    tensor_cores: bool  # the path: tensor cores, or CUDA cores
    heads: int          # query heads a block takes
    groups: int         # blocks a KV head's query heads take: ceil(rep / heads)
    chunk: int          # positions a block's chunk holds, a multiple of the path's tile
    splits: int         # chunks the cache is cut into: ceil(S / chunk), at least 1


def plan(b: int, kvh: int, s: int, d: int, cache_bytes: int, rep: int) -> Plan:
    """The kernel's plan for B rows, KvH KV heads, S positions of head dim
    D, a cache of ``cache_bytes`` bytes an element (4 f32, 2 bf16, 1 int8)
    and rep = H / KvH query heads a KV head, from the shapes alone (pos and
    pads stay on the card, so a call can be captured in a CUDA graph).

    The path: tensor cores for a bf16 or int8 cache from ``TC_MIN_REP`` on
    (16 query heads a block), else CUDA cores (the smallest group of
    ``CC_HEADS`` that holds rep, else the largest that registers allow).
    The chunk, in whole tiles of the path: on the tensor cores at least
    ``TC_TARGET_BYTES`` of K/V, and enough that the partials the last block
    of a row reads back (a chunk's query heads x D in f32, for every chunk
    of the cache) are no more bytes than its own chunk's K/V; on the CUDA
    cores, whose partials are a few heads, at least ``CC_TARGET_BYTES`` and
    2 tiles, halved while a whole-cache window would give fewer blocks
    than the SMs. Then grown to keep the cache within ``MAX_SPLITS`` chunks
    and a head group within ``MAX_BLOCKS`` blocks; never past the cache."""
    tc = cache_bytes in (1, 2) and rep >= TC_MIN_REP
    if tc:
        heads, tile = TC_HEADS, TC_TILE
    else:
        cap = 4 if d > 128 else 8
        heads, tile = next((h for h in CC_HEADS if h >= rep and h <= cap), cap), TILE
    groups = -(-rep // heads)
    per_pos = 2 * d * cache_bytes + (8 if cache_bytes == 1 else 0)

    def tiles(n):
        return max(1, -(-n // tile)) * tile
    if tc:
        # the last block of a row reads every chunk's partials (16 query
        # heads' acc at most): no more bytes than its own chunk's K/V
        partial = min(rep, heads) * d * 4
        chunk = max(tiles(-(-TC_TARGET_BYTES // per_pos)),
                    tiles(math.isqrt(max(s, 1) * partial // per_pos)))
        while -(-s // chunk) * partial > chunk * per_pos:
            chunk += tile
    else:
        chunk = max(tiles(-(-CC_TARGET_BYTES // per_pos)), 2 * tile)
        while chunk > tile and b * kvh * groups * -(-s // chunk) < SMS:
            chunk = tiles(chunk // 2)
    splits = min(MAX_SPLITS, max(1, MAX_BLOCKS // (b * kvh)))
    chunk = min(max(chunk, tiles(-(-s // splits))), tiles(s))
    return Plan(tc, heads, groups, chunk, max(1, -(-s // chunk)))


def prepare(device) -> str:
    """Build and load the kernel library and set the kernels up on the CUDA
    ``device`` (their shared-memory limit), once; returns the library's path."""
    return _build.prepare("decode_attention_prepare", device)


_counters: dict[int, torch.Tensor] = {}


def _split_counters(device) -> torch.Tensor:
    """The device's arrival counters of the merge, zero between calls (each
    call's last block of a row and head group resets its own). Made once
    per device, on the first call: not inside a CUDA graph capture, whose
    memory pool would own them."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention: call it once on this device before "
                               "capturing it in a CUDA graph")
        _counters[index] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return _counters[index]


def _launch(name, q, k, v, pos, pads, k_s=None, v_s=None):
    """Check the operands and launch the kernel on q's stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    scales = () if k_s is None else (k_s, v_s)
    p = _check(name, q, k, v, scales)
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    # a position shared by every row goes in as a value (no tensor to fill)
    pos_v = _rows(pos, b, q.device) if isinstance(pos, torch.Tensor) else None
    pad_v = _rows(pads, b, q.device) if isinstance(pads, torch.Tensor) else None
    pos0 = 0 if pos_v is not None else int(pos)
    pad0 = 0 if pad_v is not None or pads is None else int(pads)
    out = torch.empty_like(q)
    # the partials: acc [B,H,splits,D], then m and l [B,H,splits,2]
    part = torch.empty(b * h * p.splits * (d + 2), dtype=torch.float32, device=q.device)
    prepare(q.device)
    counters = _split_counters(q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if scales else None, v_s.data_ptr() if scales else None,
            out.data_ptr(), None if pos_v is None else pos_v.data_ptr(),
            None if pad_v is None else pad_v.data_ptr(), pos0, pad0,
            part.data_ptr(), part.data_ptr() + b * h * p.splits * d * 4, counters.data_ptr(),
            b, h, kvh, s, d, p.chunk, p.splits, p.heads, int(p.tensor_cores),
            float(1.0 / (d ** 0.5)), _DTYPES[q.dtype], _DTYPES[k.dtype], stream)
    _build.check(err, f"{name} kernel launch")
    return out


def decode_attention_batch(q, k_cache, v_cache, pos, pads=None):
    """q [B,H,D], caches [B,KvH,S,D] -> [B,H,D]; row b attends to
    positions pads[b]..pos[b]."""
    if q.device.type == "cpu":
        return decode_attention_batch_reference(q, k_cache, v_cache, pos, pads)
    out = _launch("decode_attention_batch", q, k_cache, v_cache, pos, pads)
    decode_attention_batch.launches += 1
    return out


def decode_attention_batch_q8(q, k_q8, k_s, v_q8, v_s, pos, pads=None):
    """q [B,H,D], int8 caches [B,KvH,S,D] with f32 scales [B,KvH,S] ->
    [B,H,D]; row b attends to positions pads[b]..pos[b]."""
    if q.device.type == "cpu":
        return decode_attention_batch_q8_reference(q, k_q8, k_s, v_q8, v_s, pos, pads)
    out = _launch("decode_attention_batch_q8", q, k_q8, v_q8, pos, pads, k_s, v_s)
    decode_attention_batch_q8.launches += 1
    return out


def _scalar_pos(name, pos):
    if isinstance(pos, torch.Tensor) and pos.numel() != 1:
        raise ValueError(f"{name}: pos must be a scalar, got shape {tuple(pos.shape)}")
    return pos.reshape(()) if isinstance(pos, torch.Tensor) else pos


def decode_attention(q, k_cache, v_cache, pos):
    """One stream: q [H,D], caches [KvH,S,D], scalar pos -> [H,D] over
    positions 0..pos (the batch kernel at B = 1)."""
    pos = _scalar_pos("decode_attention", pos)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, pos)
    out = _launch("decode_attention", q[None], k_cache[None], v_cache[None], pos, None)
    decode_attention.launches += 1
    return out[0]


def decode_attention_q8(q, k_q8, k_s, v_q8, v_s, pos):
    """One stream over an int8 cache: q [H,D], caches [KvH,S,D], scales
    [KvH,S], scalar pos -> [H,D] (the int8 batch kernel at B = 1)."""
    pos = _scalar_pos("decode_attention_q8", pos)
    if q.device.type == "cpu":
        return decode_attention_q8_reference(q, k_q8, k_s, v_q8, v_s, pos)
    out = _launch("decode_attention_q8", q[None], k_q8[None], v_q8[None], pos, None,
                  k_s[None], v_s[None])
    decode_attention_q8.launches += 1
    return out[0]


decode_attention_batch.launches = 0
decode_attention_batch_q8.launches = 0
decode_attention.launches = 0
decode_attention_q8.launches = 0
