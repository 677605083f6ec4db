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
