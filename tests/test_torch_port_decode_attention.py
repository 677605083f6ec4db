"""The port's batched decode attention (clearcam_tpu_torch.ops.decode_attention)
against the JAX package's ``decode_attention_batch`` (its Pallas kernel in
interpret mode), on the CPU: scalar and per-row positions, left pads, a
one-column window, f32 and bf16 caches. The CUDA kernel against the plain
version is in test_torch_port_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.ops.decode_attention import decode_attention_batch as jax_dec
from clearcam_tpu_torch.ops import decode_attention as tdec
from clearcam_tpu_torch.testing import torch_threads

# f32: summation order only; bf16 caches: both widen the same bf16 values
# to f32, and the output is rounded to q's dtype
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, H, KVH, S, D = 3, 4, 2, 512, 128


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    k, v = (rng.standard_normal((B, KVH, S, D), np.float32) for _ in range(2))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in (q, k, v)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,pads", [
    (300, None),                                   # shared scalar position
    ([0, 255, 511], None),                         # per-row positions
    ([300, 300, 300], [0, 37, 290]),               # left pads
    ([256, 17, 400], [256, 0, 399]),               # one-column window; two
])
def test_plain_matches_jax_kernel(dtype, pos, pads):
    (jq, jk, jv), (tq, tk, tv) = _inputs(dtype, seed=len(str(pos)))
    jpos = pos if np.isscalar(pos) else jnp.asarray(pos, jnp.int32)
    ref = jax_dec(jq, jk, jv, jpos, None if pads is None else jnp.asarray(pads, jnp.int32),
                  interpret=True)
    tpos = pos if np.isscalar(pos) else torch.tensor(pos, dtype=torch.int32)
    before = tdec.decode_attention_batch.launches
    got = tdec.decode_attention_batch(tq, tk, tv, tpos,
                                      None if pads is None else torch.tensor(pads))
    assert tdec.decode_attention_batch.launches == before     # CPU: plain version
    assert got.shape == (B, H, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=TOL[dtype])


def test_plain_is_the_masked_softmax():
    """Each row attends exactly to pads[b]..pos[b]: junk outside the
    window changes nothing."""
    _, (q, k, v) = _inputs("float32", seed=9)
    pos, pads = torch.tensor([10, 200, 511]), torch.tensor([3, 0, 500])
    got = tdec.decode_attention_batch(q, k, v, pos, pads)
    k2, v2 = k.clone(), v.clone()
    for b in range(B):
        lo, hi = int(pads[b]), int(pos[b])
        k2[b, :, :lo], k2[b, :, hi + 1:] = 1e3, -1e3
        v2[b, :, :lo], v2[b, :, hi + 1:] = 1e3, -1e3
    out = tdec.decode_attention_batch(q, k2, v2, pos, pads)
    np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_rejects_other_devices():
    _, (q, k, v) = _inputs("float32", seed=1)
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_attention_batch(q.to("meta"), k.to("meta"), v.to("meta"), 3)


# ---------------------------------------------------------------------------
# the single-stream forms and the int8 forms against the JAX kernels

def _q8_inputs(seed, b=B):
    """q f32, int8 caches and f32 per-token scales, as numpy."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, D), np.float32)
    kq, vq = (rng.integers(-127, 128, (b, KVH, S, D)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, (b, KVH, S)).astype(np.float32) for _ in range(2))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 255, 300, 511])
def test_single_stream_plain_matches_jax_kernel(dtype, pos):
    from clearcam_tpu.ops.decode_attention import decode_attention as jax_single
    (jq, jk, jv), (tq, tk, tv) = _inputs(dtype, seed=pos)
    ref = jax_single(jq[0], jk[0], jv[0], pos, interpret=True)
    before = tdec.decode_attention.launches
    got = tdec.decode_attention(tq[0], tk[0], tv[0], pos)
    assert tdec.decode_attention.launches == before         # CPU: plain version
    assert got.shape == (H, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("pos", [0, 255, 300, 511])
def test_single_stream_q8_plain_matches_jax_kernel(pos):
    from clearcam_tpu.ops.decode_attention import decode_attention_q8 as jax_q8
    q, kq, ks, vq, vs = _q8_inputs(pos, b=1)
    ref = jax_q8(*(jnp.asarray(a[0]) for a in (q, kq, ks, vq, vs)), pos, interpret=True)
    before = tdec.decode_attention_q8.launches
    got = tdec.decode_attention_q8(*(torch.from_numpy(a[0]) for a in (q, kq, ks, vq, vs)),
                                   pos)
    assert tdec.decode_attention_q8.launches == before
    assert got.shape == (H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pos,pads", [
    (300, None),                                   # shared scalar position
    ([0, 255, 511], None),                         # spread per-row positions
    ([300, 300, 300], [0, 37, 290]),               # left pads
    ([256, 17, 400], [256, 0, 399]),               # one-column windows
    ([100, 300, 511], [200, 0, 3]),                # row 0 has no live column
])
def test_batch_q8_plain_matches_jax_kernel(pos, pads):
    """Live rows agree with the TPU kernel to 1e-5; a row with no live
    column is zeros in the port, where the TPU kernel divides 0 by 0."""
    from clearcam_tpu.ops.decode_attention import decode_attention_batch_q8 as jax_bq8
    q, kq, ks, vq, vs = _q8_inputs(len(str(pos)))
    jpos = pos if np.isscalar(pos) else jnp.asarray(pos, jnp.int32)
    jpads = None if pads is None else jnp.asarray(pads, jnp.int32)
    ref = np.asarray(jax_bq8(*(jnp.asarray(a) for a in (q, kq, ks, vq, vs)), jpos, jpads,
                             interpret=True))
    tpos = pos if np.isscalar(pos) else torch.tensor(pos, dtype=torch.int32)
    before = tdec.decode_attention_batch_q8.launches
    got = tdec.decode_attention_batch_q8(*(torch.from_numpy(a) for a in (q, kq, ks, vq, vs)),
                                         tpos, None if pads is None else torch.tensor(pads))
    assert tdec.decode_attention_batch_q8.launches == before
    got = got.numpy()
    live = np.broadcast_to(np.asarray(pos), (B,)) >= np.asarray(pads or [0] * B)
    np.testing.assert_allclose(got[live], ref[live], rtol=0, atol=1e-5)
    assert not got[~live].any()


def test_q8_plain_is_the_dequantized_attention():
    """Scales on scores and probabilities give the attention over the
    dequantized cache (k * k_s, v * v_s), and junk outside the window
    changes nothing."""
    q, kq, ks, vq, vs = (torch.from_numpy(a) for a in _q8_inputs(4))
    pos, pads = torch.tensor([10, 200, 511]), torch.tensor([3, 0, 500])
    got = tdec.decode_attention_batch_q8(q, kq, ks, vq, vs, pos, pads)
    dense = tdec.decode_attention_batch(q, kq.float() * ks[..., None],
                                        vq.float() * vs[..., None], pos, pads)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
    kq2, vq2 = kq.clone(), vq.clone()
    for b in range(B):
        lo, hi = int(pads[b]), int(pos[b])
        kq2[b, :, :lo], kq2[b, :, hi + 1:] = 127, -127
        vq2[b, :, :lo], vq2[b, :, hi + 1:] = -127, 127
    out = tdec.decode_attention_batch_q8(q, kq2, ks, vq2, vs, pos, pads)
    np.testing.assert_allclose(out.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_plain_row_without_live_column_is_zeros():
    _, (q, k, v) = _inputs("float32", seed=5)
    got = tdec.decode_attention_batch(q, k, v, torch.tensor([100, 7, 300]),
                                      torch.tensor([101, 0, 0]))
    assert not got[0].any() and got[1:].abs().sum() > 0


def test_new_forms_reject_other_devices():
    q, kq, ks, vq, vs = (torch.from_numpy(a).to("meta") for a in _q8_inputs(1))
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_attention_batch_q8(q, kq, ks, vq, vs, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_attention_q8(q[0], kq[0], ks[0], vq[0], vs[0], 3)
    with pytest.raises(ValueError, match="unsupported device"):
        tdec.decode_attention(q[0], q[0, :2, None].expand(2, S, D), q[0, :2, None].expand(2, S, D), 3)


# ---------------------------------------------------------------------------
# the split plan of the CUDA kernels (pure Python: it runs here too)

SMS = 132                   # the H100's streaming multiprocessors
GRID_X = 2 ** 31 - 1        # CUDA's grid limits
GRID_YZ = 65535


def _live_blocks(chunk, kvh, pos, pads):
    """Blocks whose chunk meets the row's window pads[b]..pos[b]: the ones
    that do work (the rest exit at once)."""
    return kvh * sum(max(0, p // chunk - lo // chunk + 1) if lo <= p else 0
                     for p, lo in zip(pos, pads))


@pytest.mark.parametrize("b,kvh,s", [
    (1, 8, 2048), (8, 8, 8192), (8, 8, 2048),      # the served shapes (PERF.md rows 4-7)
    (1, 8, 17), (8, 2, 17), (1, 2, 1),             # S under one tile
    (4, 4, 517), (8, 2, 517), (1, 8, 100),         # S not a multiple of 64
    (1, 2, 8192), (8, 2, 8192), (1, 8, 131072),    # KvH 2 and 8, long caches
    (64, 8, 8192), (512, 8, 4096), (1, 1, 0),      # past MAX_BLOCKS rows; an empty cache
])
@pytest.mark.parametrize("d,cache_bytes,rep", [(128, 2, 2), (128, 1, 2), (128, 4, 2),
                                               (64, 2, 7), (256, 2, 8), (128, 1, 16)])
def test_plan_covers_every_position_once(b, kvh, s, d, cache_bytes, rep):
    pl = tdec.plan(b, kvh, s, d, cache_bytes, rep)
    tile = tdec.TC_TILE if pl.tensor_cores else tdec.TILE
    assert pl.chunk % tile == 0 and pl.chunk >= tile
    cover = np.zeros(max(s, 1), np.int64)
    for j in range(pl.splits):
        cover[j * pl.chunk:(j + 1) * pl.chunk] += 1
    assert (cover[:s] == 1).all()                  # each position in exactly one split
    assert pl.splits == max(1, -(-s // pl.chunk))  # no split past the cache
    assert pl.splits <= tdec.MAX_SPLITS
    assert pl.splits * pl.groups <= GRID_X and kvh <= GRID_YZ and b <= GRID_YZ
    assert b * kvh * pl.splits <= max(tdec.MAX_BLOCKS, b * kvh)


@pytest.mark.parametrize("b,kvh,s,d,cache_bytes,rep,pos,pads,max_tiles", [
    (1, 8, 2048, 128, 2, 2, [1100], [0], 2),                                 # row 4
    (1, 8, 2048, 128, 1, 2, [1100], [0], 2),                                 # row 7
    (8, 8, 8192, 128, 2, 2, [0, 17, 255, 256, 1000, 4095, 8191, 3000], [0] * 8, 8),   # row 5
    (8, 8, 2048, 128, 1, 2, [256] * 8, [0] * 8, 2),                          # row 6
])
def test_plan_fills_the_card_at_the_served_shapes(b, kvh, s, d, cache_bytes, rep, pos, pads,
                                                  max_tiles):
    """The live blocks cover the 132 SMs at least once where the window is
    long enough, and no block walks more than ``max_tiles`` tiles."""
    pl = tdec.plan(b, kvh, s, d, cache_bytes, rep)
    tile = tdec.TC_TILE if pl.tensor_cores else tdec.TILE
    assert pl.chunk // tile <= max_tiles
    live = _live_blocks(pl.chunk, kvh, pos, pads) * pl.groups
    assert live >= SMS, (pl, live)
