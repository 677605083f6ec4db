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
which on the card is the split and merge pair), so a run can show which
entry points its path went through.

Contract (the JAX functions'): ``pos`` is a shared scalar or a per-row [B]
vector, ``pads`` [B] each row's first live position (None = 0). Row b
attends exactly to cache positions pads[b]..pos[b], with rep = H/KvH query
heads per KV head and scale 1/sqrt(D). On the int8 caches K's scale
multiplies the score and V's scale the probability before the PV product,
as the TPU kernels apply them. A row with no live column (pads > pos) gives
zeros; the TPU kernels give 0/0 there. The kernels take f32 or bf16 q,
a head dim in ``HEAD_DIMS``, any rep = H / KvH, any S, and read only each
row's own window.

On the card every call is two launches (flash-decoding): one block per
(split, KV head, row) writes the softmax partials of its chunk of the
window into scratch, and a merge combines them. ``plan`` picks the chunk
from the shapes alone, so a call reads nothing back and can be captured in
a CUDA graph.
"""
from __future__ import annotations

import torch

from . import _build

# the head dims the kernels are built for (HeadDims in csrc/decode_attention.cu):
# 64 (Llama-3.2-1B, Qwen2.5-0.5B), 128 (Qwen3, Llama-3.x 3B/8B), 256
# (Qwen3-Next's attention blocks); any number of query heads per KV head
HEAD_DIMS = (64, 128, 256)
TILE = 32               # positions per shared-memory ring slot (csrc/decode_attention.cu)
# the plan's grid size: the live blocks of a long window fill 132 SMs
# (1,024 and 4,096 each read slower at a served shape on the H100)
MAX_BLOCKS = 2048
MAX_GRID_YZ = 65535     # CUDA's limit on grid.y (KV heads) and grid.z (rows)
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


def _check(name, q, k, v, scales=()):
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
    if d not in HEAD_DIMS or k.shape[3] != d:
        raise ValueError(f"{name}: head dim {d} / {k.shape[3]}; the kernel takes one of "
                         f"{HEAD_DIMS}")
    kvh = k.shape[1]
    if k.shape[0] != b or kvh == 0 or h % kvh:
        raise ValueError(f"{name}: q {tuple(q.shape)} against caches {tuple(k.shape)}: "
                         f"need equal B and H % KvH == 0")
    if b > MAX_GRID_YZ or kvh > MAX_GRID_YZ:
        raise ValueError(f"{name}: B = {b}, KvH = {kvh}; the grid takes at most "
                         f"{MAX_GRID_YZ} of each")


def plan(b: int, kvh: int, s: int) -> tuple[int, int]:
    """(chunk, splits) of the split kernel's grid (splits, KvH, B): the
    cache's positions 0..S-1 cut into ``splits`` chunks of ``chunk``
    positions, a multiple of ``TILE``. The chunk starts at two tiles (one
    read slower at B = 1 on the H100) and doubles while the grid would
    pass ``MAX_BLOCKS`` blocks and the cache still needs more than one
    chunk. From the shapes alone: pos and pads stay on the card."""
    chunk = 2 * TILE
    while b * kvh * -(-s // chunk) > MAX_BLOCKS and chunk < s:
        chunk *= 2
    return chunk, max(1, -(-s // chunk))


def prepare(device) -> str:
    """Build and load the kernel library and set the kernels up on the CUDA
    ``device`` (their shared-memory limit), once; returns the library's path."""
    return _build.prepare("decode_attention_prepare", device)


def _launch(name, q, k, v, pos, pads, k_s=None, v_s=None):
    """Check the operands and launch the split and merge kernels on q's
    stream."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    scales = () if k_s is None else (k_s, v_s)
    _check(name, q, k, v, scales)
    b, h, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    chunk, splits = plan(b, kvh, s)
    pos_v = _rows(pos, b, q.device)
    pad_v = _rows(0 if pads is None else pads, b, q.device)
    out = torch.empty_like(q)
    # the partials: acc [B,H,splits,D], then m and l [B,H,splits,2]
    part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32, device=q.device)
    prepare(q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_s.data_ptr() if scales else None, v_s.data_ptr() if scales else None,
            out.data_ptr(), pos_v.data_ptr(), pad_v.data_ptr(),
            part.data_ptr(), part.data_ptr() + b * h * splits * d * 4, b, h, kvh, s, d,
            chunk, splits, float(1.0 / (d ** 0.5)), _DTYPES[q.dtype], _DTYPES[k.dtype],
            stream)
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
