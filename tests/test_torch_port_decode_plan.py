"""The decode-attention kernels' plan (clearcam_tpu_torch.ops.decode_attention
.plan), on the CPU: it is pure Python over shapes. The path (tensor cores
for bf16 and int8 caches from TC_MIN_REP query heads a KV head on), the
heads a block takes, the chunk each block reads and the merge's counters.
The kernels it plans for run on the card (test_torch_port_cuda.py)."""
import inspect
import itertools

import pytest
import torch

from clearcam_tpu_torch.ops import decode_attention as tdec

SMS = 132
# (B, KvH, S): the served shapes of PERF.md §6, one-row caches, long and
# tiny caches, many rows
SHAPES = [(1, 8, 2048), (8, 8, 8192), (8, 8, 2048), (8, 2, 8192), (8, 4, 2048),
          (1, 2, 2048), (8, 8, 8192), (4, 4, 517), (1, 1, 17), (2, 1, 1), (1, 8, 131072),
          (64, 8, 8192), (512, 8, 4096), (1, 1, 0)]
# (D, cache bytes, rep): Qwen3's rep 2 in f32, bf16 and int8, Llama-3.2-1B's
# rep 4 at 64, Qwen2.5's rep 7, Qwen3-Next's rep 8 at 256, GLM-4.5-Air's 12,
# Qwen3-235B's 16, and past one tensor-core group (20, 32)
HEADS = [(128, 4, 2), (128, 2, 2), (128, 1, 2), (64, 2, 4), (64, 1, 4), (64, 2, 7),
         (256, 2, 8), (128, 2, 12), (128, 1, 16), (256, 4, 8), (128, 2, 20), (64, 1, 32)]


def _per_pos(d, cache_bytes):
    return 2 * d * cache_bytes + (8 if cache_bytes == 1 else 0)


def test_plan_reads_shapes_only():
    """Integers in, a frozen plan out, the same for the same shapes: nothing
    of pos or pads (a call's plan holds across a CUDA graph's replays)."""
    assert list(inspect.signature(tdec.plan).parameters) == [
        "b", "kvh", "s", "d", "cache_bytes", "rep"]
    for (b, kvh, s), (d, cb, rep) in itertools.product(SHAPES, HEADS):
        pl = tdec.plan(b, kvh, s, d, cb, rep)
        assert pl == tdec.plan(b, kvh, s, d, cb, rep)
        assert all(isinstance(getattr(pl, f), (int, bool)) for f in
                   ("tensor_cores", "heads", "groups", "chunk", "splits"))
        with pytest.raises(AttributeError):
            pl.chunk = 1


@pytest.mark.parametrize("d,cb,rep", HEADS)
@pytest.mark.parametrize("b,kvh,s", SHAPES)
def test_plan_meets_the_byte_target_or_takes_the_whole_cache(b, kvh, s, d, cb, rep):
    """A chunk holds at least its path's byte target of K/V, unless it holds
    the whole cache or (CUDA cores) a whole-cache window would leave SMs
    idle at the larger chunk; on the tensor cores the partials a row's
    merge reads back are no more bytes than a chunk's K/V. At most
    MAX_SPLITS chunks cover the cache (the merge's weights), and the grid
    keeps within CUDA's limits (tiles and coverage: test_torch_port_decode_
    attention.py's test_plan_covers_every_position_once)."""
    pl = tdec.plan(b, kvh, s, d, cb, rep)
    tile = tdec.TC_TILE if pl.tensor_cores else tdec.TILE
    target = tdec.TC_TARGET_BYTES if pl.tensor_cores else tdec.CC_TARGET_BYTES
    chunk_bytes = pl.chunk * _per_pos(d, cb)
    assert pl.splits <= tdec.MAX_SPLITS
    whole = pl.chunk >= s
    if pl.tensor_cores:
        assert chunk_bytes >= target or whole, pl
        assert pl.splits * min(rep, pl.heads) * d * 4 <= chunk_bytes or whole, pl
    else:
        halved = b * kvh * pl.groups * -(-s // (2 * pl.chunk)) < SMS
        assert (chunk_bytes >= target and pl.chunk >= 2 * tile) or whole or halved, pl
    assert pl.splits * pl.groups <= 2 ** 31 - 1


@pytest.mark.parametrize("d,cb,rep", HEADS)
def test_plan_path_and_heads(d, cb, rep):
    """The tensor cores take bf16 and int8 caches from TC_MIN_REP on, 16
    query heads a block; f32 caches and smaller reps stay on the CUDA cores
    (the smallest group of 1, 2, 4, 8 that holds rep, 4 at most above head
    dim 128); the groups cover rep."""
    pl = tdec.plan(8, 8, 8192, d, cb, rep)
    assert pl.tensor_cores == (cb in (1, 2) and rep >= tdec.TC_MIN_REP)
    if pl.tensor_cores:
        assert pl.heads == tdec.TC_HEADS
    else:
        cap = 4 if d > 128 else 8
        assert pl.heads == min([h for h in tdec.CC_HEADS if h >= rep and h <= cap] or [cap])
    assert pl.groups == -(-rep // pl.heads) and (pl.groups - 1) * pl.heads < rep


def test_the_counters_cover_every_grid_the_check_passes():
    """Each (row, KV head, head group) of a call counts on its own counter,
    (b * KvH + g) * groups + grp: every call `_check` passes indexes inside
    the device's COUNTERS, and a call past them is refused before a launch."""
    dtypes = {4: torch.float32, 2: torch.bfloat16, 1: torch.int8}
    refused = 0
    for (b, kvh), (d, cb, rep) in itertools.product(
            [(1, 1), (8, 8), (4096, 16), (2048, 8), (65535, 1), (1, 65535)], HEADS):
        q = torch.empty(b, kvh * rep, d, device="meta")
        k = torch.empty(b, kvh, 64, d, device="meta", dtype=dtypes[cb])
        scales = (torch.empty(b, kvh, 64, device="meta"),) * 2 if cb == 1 else ()
        groups = tdec.plan(b, kvh, 64, d, cb, rep).groups
        if b * kvh * groups > tdec.COUNTERS:
            with pytest.raises(ValueError, match="merges"):
                tdec._check("decode_attention_batch", q, k, k, scales)
            refused += 1
            continue
        pl = tdec._check("decode_attention_batch", q, k, k, scales)
        assert ((b - 1) * kvh + kvh - 1) * pl.groups + pl.groups - 1 < tdec.COUNTERS
    assert refused


@pytest.mark.parametrize("b,kvh,s,d,cb,rep,chunk", [
    (1, 8, 2048, 128, 2, 2, 64),      # row 4: Qwen3 single stream, bf16
    (1, 8, 2048, 128, 1, 2, 64),      # row 7: int8
    (8, 8, 8192, 128, 2, 2, 256),     # row 5: 8 rows, capped by MAX_BLOCKS
    (8, 8, 2048, 128, 1, 2, 64),      # row 6
    (8, 2, 8192, 64, 2, 7, 256),      # row 5c: Qwen2.5-0.5B's rep 7
    (8, 4, 2048, 128, 2, 16, 192),    # row 5e: Qwen3-235B's rep 16
    (8, 2, 2048, 256, 2, 8, 128),     # row 5d: Qwen3-Next's D 256
    (8, 8, 8192, 64, 1, 4, 256),      # row 6b: Llama-3.2-1B's heads, int8
    (1, 8, 2048, 64, 2, 4, 128),      # row 4b: Llama-3.2-1B single stream
])
def test_plan_at_the_timed_rows(b, kvh, s, d, cb, rep, chunk):
    """The chunks PERF.md §6's rows were timed with on the H100."""
    assert tdec.plan(b, kvh, s, d, cb, rep).chunk == chunk
