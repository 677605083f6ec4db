"""The port's ViT attention (clearcam_tpu_torch.ops.vit_attention) and the
attention ops of its nn.functional against the JAX package's, on the CPU.

The JAX ``mha_flash`` runs only on a TPU (the stock Pallas flash kernel has
no CPU path, tests/test_vit_flash.py); its contract is unpadded attention,
which is ``clearcam_tpu.nn.functional.mha`` with no mask, so that is the
reference here. The CUDA kernel against the plain version is in
test_torch_port_cuda.py; here a model of the kernel's arithmetic (bf16
terms, 64-key tiles in 16-key steps, truncating tensor-core sums) is held
against both references, and the kernel's ``plan`` is checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.nn import functional as jF
from clearcam_tpu_torch.nn import functional as F
from clearcam_tpu_torch.ops import vit_attention as tattn
from clearcam_tpu_torch.testing import torch_threads

F32_TOL = 1e-5      # f32 max |d|: summation order only
# the kernel model's bounds: a fifth of the card's f32 bound (1e-4), so the
# arithmetic leaves the card 5x room; bf16 the card's own
MODEL_TOL = {torch.float32: 1e-4 / 5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32) for _ in range(3)]


@pytest.mark.parametrize("t", [1, 7, 128, 129, 257])
def test_mha_reference_matches_jax_mha(t):
    q, k, v = _qkv((2, 4, t, 64), seed=t)
    ref = np.asarray(jF.mha(*map(jnp.asarray, (q, k, v))))
    got = tattn.mha_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


def test_mha_flash_on_cpu_takes_the_plain_route():
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 33, 64), seed=1))
    before = tattn.mha_flash.launches
    got = tattn.mha_flash(q, k, v, sm_scale=0.2)
    assert tattn.mha_flash.launches == before
    torch.testing.assert_close(got, tattn.mha_reference(q, k, v, sm_scale=0.2),
                               rtol=0, atol=0)


def test_mha_flash_raises_on_other_devices():
    q = torch.zeros((1, 1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.mha_flash(q, q, q)


def test_masked_mha_matches_jax():
    """The text tower's causal mha: additive -inf mask, f32 softmax."""
    q, k, v = _qkv((2, 3, 77, 64), seed=3)
    mask = np.triu(np.full((77, 77), -np.inf, np.float32), 1)
    ref = np.asarray(jF.mha(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(mask)))
    got = F.mha(*map(torch.from_numpy, (q, k, v)), mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


def test_bf16_mha_matches_jax():
    """bf16 numerics: f32 scores and softmax, probabilities rounded to bf16
    before the PV product, output in bf16; the two differ by bf16 rounding
    of the products."""
    q, k, v = _qkv((1, 2, 40, 64), seed=4)
    ref = np.asarray(jF.mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))),
                     np.float32)
    got = F.mha(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=2e-2)


def test_split_merge_heads_match_jax_and_are_views():
    x = np.random.default_rng(5).standard_normal((2, 9, 48), np.float32)
    xt = torch.from_numpy(x)
    heads = F.split_heads(xt, 4)
    assert heads.data_ptr() == xt.data_ptr()            # a view, no copy
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jF.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(F.merge_heads(heads).numpy(), x)


@pytest.mark.parametrize("bf16", [False, True])
def test_linear_matches_jax(bf16):
    rng = np.random.default_rng(6)
    x, w, b = (rng.standard_normal(s, np.float32) for s in ((3, 5, 32), (16, 32), (16,)))
    if bf16:
        ref = np.asarray(jF.linear(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b))),
                         np.float32)
        got = F.linear(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
        assert got.dtype == torch.bfloat16
        # the port adds the bias after the bf16 rounding of the product
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2e-2, atol=5e-2)
    else:
        ref = np.asarray(jF.linear(*map(jnp.asarray, (x, w, b))))
        got = F.linear(*map(torch.from_numpy, (x, w, b))).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_norms_and_activations_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 5, 8), np.float32) * 3
    w, b, mean = (rng.standard_normal(8, np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2, 8).astype(np.float32)
    X, W, B, M, V = map(torch.from_numpy, (x, w, b, mean, var))
    jx = jnp.asarray(x)
    cases = [
        (F.layer_norm(X, W, B), jF.layer_norm(jx, w, b)),
        (F.layer_norm(X), jF.layer_norm(jx)),
        (F.batch_norm_inference(X, W, B, M, V), jF.batch_norm_inference(jx, w, b, mean, var)),
        (F.gelu(X), jF.gelu(jx, approximate=False)),
        (F.relu(X), jF.relu(jx)),
        (F.prelu(X, W), jF.prelu(jx, w)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    table = rng.standard_normal((11, 4), np.float32)
    ids = np.array([[0, 3, 10], [5, 5, 1]], np.int32)
    np.testing.assert_array_equal(
        F.embedding(torch.from_numpy(table), torch.from_numpy(ids)).numpy(),
        np.asarray(jF.embedding(jnp.asarray(table), jnp.asarray(ids))))


# ---------------------------------------------------------------------------
# A model of csrc/vit_attention.cu's arithmetic, in float64 torch on the CPU.
# Each mma.sync.m16n8k16 is modelled as the tensor cores add: the 16 exact
# products in two groups of 8, each group with the accumulator aligned to
# the largest of them and cut (toward zero) to its f32 grid, summed, and the
# sum cut toward zero to f32. No guard bits are kept: the model errs on the
# harsh side of the card's adders.

S_PRODUCTS = [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]   # (q term, k term)
PV_PRODUCTS = [(0, 2), (1, 0), (0, 1), (0, 0)]                  # (p term, v term)
MMA_GROUP = 8


def _terms(x, n):
    """x (float64 holding f32 values) -> n bf16 terms, each bf16 (rounded to
    nearest) of what the terms before it left (the kernel's split2, for p)."""
    out = []
    for _ in range(n):
        t = x.float().bfloat16().double()
        out.append(t)
        x = (x - t).float().double()
    return out


def _cut_terms(x, n):
    """x (float64 holding f32 values) -> n bf16 terms cut toward zero: the
    top 16 bits of what the terms before it left (the kernel's cut2, for q,
    k, v; three terms are exact)."""
    out = []
    for _ in range(n):
        bits = x.float().view(torch.int32) & -65536
        t = bits.view(torch.float32).double()
        out.append(t)
        x = x - t
    return out


def _rz32(x):
    """x cut toward zero to f32 (x exact in float64)."""
    _, e = torch.frexp(x)
    u = torch.ldexp(torch.ones_like(x), e - 24)
    return torch.trunc(x / u) * u


def _mma(acc, a, b):
    """acc [..., R, N] += a [..., R, 16] @ b [..., N, 16]^T, as the tensor
    cores add (see above)."""
    for g0 in range(0, a.shape[-1], MMA_GROUP):
        prods = a[..., :, None, g0:g0 + MMA_GROUP] * b[..., None, :, g0:g0 + MMA_GROUP]
        big = torch.maximum(prods.abs().amax(-1), acc.abs())
        _, e = torch.frexp(big)
        inv_u = torch.ldexp(torch.ones_like(big), 24 - e)
        total = (torch.trunc(prods * inv_u[..., None]).sum(-1)
                 + torch.trunc(acc * inv_u)) / inv_u
        acc = _rz32(total)
    return acc


def _f32(x):
    return x.float().double()


def mha_kernel_model(q, k, v, sm_scale=None, s_products=S_PRODUCTS,
                     pv_products=PV_PRODUCTS, qkv_terms=_cut_terms):
    """The kernel's arithmetic on [B,H,T,64] f32 or bf16 tensors: q, k, v
    cut into 3 bf16 terms (f32, exact) or taken as they are (bf16); per 64-key
    tile, S from its 16-key steps (6 products per k-step, smallest first),
    keys past T at -inf, the online softmax in f32 (p = exp2(s c - m c)),
    then PV: f32 p in 2 terms, 4 products a step into a fresh fragment and
    o = o alpha + fresh; bf16 p rounded to bf16, o scaled and summed into.
    The f32 products and q, k, v's split can be swapped for others."""
    f32 = q.dtype == torch.float32
    terms = lambda prods, side: 1 + max(pr[side] for pr in prods)
    nt, npt = (terms(s_products, 0), terms(pv_products, 0)) if f32 else (1, 1)
    s_prods, pv_prods = (s_products, pv_products) if f32 else ([(0, 0)], [(0, 0)])
    d, t = q.shape[-1], k.shape[-2]          # q may hold a subset of the rows
    scale = d ** -0.5 if sm_scale is None else sm_scale
    c = float(np.float32(np.float32(scale) * np.float32(1.4426950408889634)))
    qs = qkv_terms(q.double(), nt)
    k, v = k.double(), v.double()
    lead = q.shape[:-1]
    m = torch.full(lead, -np.inf, dtype=torch.float64)
    l = torch.zeros(lead, dtype=torch.float64)
    o = torch.zeros(q.shape, dtype=torch.float64)
    for k0 in range(0, t, 64):
        nk = min(64, t - k0)
        kw = 16 * -(-nk // 16)                   # the tile's 16-key steps
        kt = torch.zeros(q.shape[:-2] + (kw, d), dtype=torch.float64)
        vt = torch.zeros_like(kt)
        kt[..., :nk, :], vt[..., :nk, :] = k[..., k0:k0 + nk, :], v[..., k0:k0 + nk, :]
        ks, vs = qkv_terms(kt, nt), [x.transpose(-1, -2) for x in qkv_terms(vt, nt)]
        s = torch.zeros(lead + (kw,), dtype=torch.float64)
        for kk in range(0, d, 16):
            for i, j in s_prods:
                s = _mma(s, qs[i][..., kk:kk + 16], ks[j][..., kk:kk + 16])
        s[..., nk:] = -np.inf
        m_new = torch.maximum(m, s.amax(-1))
        mc = _f32(m_new * c)
        alpha = _f32(torch.exp2(_f32(m * c - mc)))
        p = _f32(torch.exp2(_f32(s * c - mc[..., None])))
        l = _f32(_f32(l * alpha) + _f32(p.sum(-1)))
        ps = _terms(p, npt)
        if f32:
            acc = torch.zeros_like(o)
        else:
            acc = o = _f32(o * alpha[..., None])
        for st in range(0, kw, 16):
            for i, j in pv_prods:
                acc = _mma(acc, ps[i][..., st:st + 16], vs[j][..., st:st + 16])
        o = _f32(o * alpha[..., None] + acc) if f32 else acc
        m = m_new
    out = o * _f32(1.0 / l)[..., None]
    return out.float().to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 1, 64), (1, 8, 7, 64), (1, 4, 129, 64),
                                   (1, 4, 257, 64), (1, 2, 784, 64)])
def test_kernel_model_matches_mha_reference_and_jax(shape, dtype):
    """The kernel's arithmetic holds the f32 bound with 5x to spare, against
    the plain version and the JAX package's mha on the same numpy inputs."""
    q, k, v = _qkv(shape, seed=shape[2])
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = mha_kernel_model(tq, tk, tv).float()
    ref = tattn.mha_reference(tq, tk, tv).float()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jref = np.asarray(jF.mha(*(jnp.asarray(a, jdt) for a in (q, k, v))), np.float32)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() < MODEL_TOL[dtype]
    assert np.abs(got.numpy() - jref).max() < MODEL_TOL[dtype]


def test_kernel_model_at_the_summary_length():
    """T = 2040 (the Qwen3-VL tower at a 544x960 frame), 2 heads: every key
    through 32 tiles (the last of 56 keys in 4 steps); the rows are the
    first, a middle and the last 64 (the last warp holds 8 rows), since each
    row's walk over the keys is independent of the others'."""
    q, k, v = _qkv((1, 2, 2040, 64), seed=2040)
    rows = np.r_[0:64, 1000:1064, 1976:2040]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = mha_kernel_model(tq[:, :, rows], tk, tv)
    ref = tattn.mha_reference(tq, tk, tv)[:, :, rows]
    jref = np.asarray(jF.mha(*map(jnp.asarray, (q, k, v))))[:, :, rows]
    assert (got - ref).abs().max().item() < MODEL_TOL[torch.float32]
    assert np.abs(got.numpy() - jref).max() < MODEL_TOL[torch.float32]


def test_kernel_model_needs_its_terms():
    """Fewer terms break the 5x margin: with two bf16 terms a side, rounded
    to nearest (three products for S and for PV), the model misses 2e-5 at
    T = 7, where a few keys carry each row. This is why the kernel takes
    three for q, k, v."""
    q, k, v = map(torch.from_numpy, _qkv((1, 16, 7, 64), seed=7))
    ref = tattn.mha_reference(q, k, v)
    three_products = [(1, 0), (0, 1), (0, 0)]
    two = mha_kernel_model(q, k, v, s_products=three_products,
                           pv_products=three_products, qkv_terms=_terms)
    three = mha_kernel_model(q, k, v)
    assert (three - ref).abs().max().item() < MODEL_TOL[torch.float32]
    assert (two - ref).abs().max().item() >= MODEL_TOL[torch.float32]


SERVED = [(16, 16, 257), (1, 16, 2040)]          # CLIP crop batch; a summary frame
TESTED = SERVED + [(1, 16, 257), (64, 16, 257)] + [
    (2, 16, t) for t in (1, 7, 16, 17, 63, 64, 65, 128, 129, 784, 1600)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bht", TESTED)
def test_plan_covers_the_rows(bht, dtype):
    """The grid covers T; fewer than a block's warps lie past T (they skip
    their MMAs), so every block has rows inside T; the plan is a function
    of the shape."""
    b, h, t = bht
    pl = tattn.plan(b, h, t, dtype)
    assert 1 <= pl.warps <= tattn.WARPS[dtype][1]
    assert pl.stages == tattn.STAGES[dtype]
    qblocks = pl.blocks // (b * h)
    assert qblocks * b * h == pl.blocks
    assert qblocks * pl.warps * tattn.ROWS >= t
    assert (qblocks - 1) * pl.warps * tattn.ROWS < t
    assert tattn.plan(b, h, t, dtype) == pl


@pytest.mark.parametrize("bht", SERVED)
def test_plan_fills_the_card_at_the_served_shapes(bht):
    for dtype in (torch.float32, torch.bfloat16):
        assert tattn.plan(*bht, dtype).blocks >= tattn.SMS
