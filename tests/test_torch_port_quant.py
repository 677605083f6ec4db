"""The port's weight-only quantized linears (clearcam_tpu_torch.ops.quant_matmul)
against the JAX package's, on the CPU: the quantized tensors byte for byte,
the plain version against the Pallas kernel in interpret mode, the
``nn.functional.linear`` dispatch, and the LLM quantization rules. The CUDA
kernel against the plain version is in test_torch_port_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.ops import quant_matmul as jqm
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.nn import functional as F
from clearcam_tpu_torch.ops import quant_matmul as tqm
from clearcam_tpu_torch.testing import torch_threads

TOL = 1e-5      # rtol = atol: the f32 sums run in another order across K tiles


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _w(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    w[0] = 0.0                          # an all-zero row takes scale 1
    return w


@pytest.mark.parametrize("shape", [(300, 700), (256, 1024), (520, 2100)])
def test_quantize_int8_bytes_equal_jax(shape):
    w = _w(shape, seed=shape[0])
    j = jqm.quantize_int8(w)
    t = tqm.quantize_int8(torch.from_numpy(w))
    assert (t.out_features, t.in_features) == (j.out_features, j.in_features) == shape
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
    np.testing.assert_array_equal(t.dequantize().numpy(), np.asarray(j.dequantize()))


@pytest.mark.parametrize("shape", [(300, 700), (256, 1024), (520, 2100)])
def test_quantize_int4_bytes_equal_jax(shape):
    w = _w(shape, seed=shape[1])
    j = jqm.quantize_int4(w)
    t = tqm.quantize_int4(torch.from_numpy(w))
    assert (t.out_features, t.in_features) == (j.out_features, j.in_features) == shape
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
    np.testing.assert_array_equal(t.dequantize().numpy(), np.asarray(j.dequantize()))


def test_int4_nibble_layout():
    """Byte j of each 1024-wide K tile: element j low, element j + 512 high."""
    w = np.zeros((256, 2048), np.float32)
    w[:, :1024] = np.tile(np.arange(-8, 8), 64)          # one group's scale 8/7
    ql = tqm.quantize_int4(torch.from_numpy(w))
    q = ql.unpack()
    np.testing.assert_array_equal(q[:, :1024].numpy(), np.round(w[:, :1024] / (8 / 7)))
    p = ql.packed.to(torch.int32)
    np.testing.assert_array_equal(((p[:, :512] << 28) >> 28).numpy(), q[:, :512].numpy())
    np.testing.assert_array_equal((p[:, :512] >> 4).numpy(), q[:, 512:1024].numpy())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 5, 16, 17, 130])
def test_quant_linear_plain_matches_jax_kernel(bits, rows):
    rng = np.random.default_rng(rows + bits)
    w = _w((300, 1100), seed=rows)
    x = rng.standard_normal((rows, 1100), np.float32)
    b = rng.normal(0, 0.1, 300).astype(np.float32)
    quant = jqm.quantize_int8 if bits == 8 else jqm.quantize_int4
    jq = quant(w)
    ref = np.asarray(jqm.quant_linear(jnp.asarray(x), jq, jnp.asarray(b), interpret=True))
    tq = tllm.params_from_jax({"w": jq})["w"]
    got = tqm.quant_linear(torch.from_numpy(x), tq, torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (rows, 300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_quant_linear_leading_dims():
    rng = np.random.default_rng(3)
    w = _w((260, 300), seed=3)
    x = rng.standard_normal((2, 3, 300), np.float32)
    jq = jqm.quantize_int4(w)
    ref = np.asarray(jqm.quant_linear(jnp.asarray(x), jq, interpret=True))
    got = tqm.quant_linear(torch.from_numpy(x), tllm.params_from_jax({"w": jq})["w"])
    assert got.shape == (2, 3, 260)
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


def test_quant_linear_bf16_x_comes_back_bf16():
    rng = np.random.default_rng(4)
    ql = tqm.quantize_int8(torch.from_numpy(_w((256, 512), seed=4)))
    x = torch.from_numpy(rng.standard_normal((3, 512), np.float32)).bfloat16()
    got = tqm.quant_linear(x, ql)
    assert got.dtype == torch.bfloat16
    want = (x.float() @ ql.dequantize().T).bfloat16()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), rtol=1e-2, atol=1e-2)


def test_functional_linear_dispatches_quantized_weights():
    rng = np.random.default_rng(5)
    w = torch.from_numpy(_w((256, 1024), seed=5))
    x = torch.from_numpy(rng.standard_normal((4, 1024), np.float32))
    for ql in (tqm.quantize_int8(w), tqm.quantize_int4(w)):
        np.testing.assert_allclose(F.linear(x, ql).numpy(),
                                   tqm.quant_linear_reference(x, ql).numpy())
        np.testing.assert_allclose(F.linear(x, ql).numpy(),
                                   F.linear(x, ql.dequantize()).numpy(),
                                   rtol=TOL, atol=TOL)


def test_quant_linear_rejects_other_devices():
    ql = tqm.quantize_int8(torch.zeros(256, 1024))
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.quant_linear(torch.zeros(1, 1024, device="meta"), ql)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_picks_the_jax_keys(bits):
    from test_llm import tiny_cfg
    cfg = tiny_cfg(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=64,
                   rope_dim=64, v_head_dim=64, vocab_size=300, num_blocks=1)
    jp = jllm.init_params(cfg, seed=2)
    jq = getattr(jllm, f"quantize_params_int{bits}")(jp)
    tq = getattr(tllm, f"quantize_params_int{bits}")(tllm.params_from_jax(jp))
    assert set(tq) == set(jq)
    for k, v in jq.items():
        quantized = isinstance(v, (jqm.QuantLinear, jqm.QuantLinear4))
        assert isinstance(tq[k], (tqm.QuantLinear, tqm.QuantLinear4)) == quantized, k
        if quantized:
            assert type(tq[k]).__name__ == type(v).__name__, k
            qj = v.q if bits == 8 else v.packed
            qt = tq[k].q if bits == 8 else tq[k].packed
            np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
            np.testing.assert_array_equal(tq[k].s.numpy(), np.asarray(v.s))
    assert not isinstance(tq["token_embd.weight"], (tqm.QuantLinear, tqm.QuantLinear4))
    assert isinstance(tq["output.weight"], tqm.QuantLinear if bits == 8 else tqm.QuantLinear4)


# ---------------------------------------------------------------------------
# the CUDA kernel's grid and arithmetic, as far as the CPU can hold them

# Qwen3-1.7B's products (out, in): q/o, k/v, gate/up, down, the LM head
SERVED = [(2048, 2048), (1024, 2048), (6144, 2048), (2048, 6144), (151936, 2048)]
TESTED = [(300, 700), (1024, 2048), (256, 1024), (300, 1100)]
ROWS = [1, 2, 3, 5, 8, 16, 17, 32, 130, 256, 520]
QM_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}   # the card's bounds, max|d|/max|ref|


def _pads(o, i):
    return -(-o // tqm.TO) * tqm.TO, -(-i // tqm.TI) * tqm.TI


def _split_units(p, split):
    """The units [u0, u1) that split ``split`` of plan ``p`` sums, cut as the
    kernel's ``split_stages`` cuts them. Unit u is inputs 256u.. of an int8
    row, and packed bytes 128u.. of an int4 row: one low and one high group
    of 128."""
    return split * p.units // p.splits, (split + 1) * p.units // p.splits


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("oi", SERVED + TESTED)
def test_plan_splits_cover_k_in_whole_units(oi, bits):
    """At every served and tested shape and row count: the splits cover the
    padded K exactly, none is empty, every boundary is a multiple of 256
    inputs, so an int4 split holds whole groups (a unit's 128 packed bytes
    are one low and one high group), and the grid stays in the kernel's
    counters."""
    o_pad, k_pad = _pads(*oi)
    for n in ROWS:
        p = tqm.plan(n, o_pad, k_pad, bits == 4)
        assert (p.block_o, p.block_n) == ((64, 8) if n <= 8 else (64, 16) if n <= 16
                                          else (256, 32) if n <= 32 else (256, 64))
        assert p.tiles == (o_pad // p.block_o) * -(-n // p.block_n)
        assert p.units * tqm.UNIT == k_pad and 1 <= p.splits <= p.units
        bounds = [_split_units(p, j) for j in range(p.splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == p.units
        assert all(a < b for a, b in bounds)
        assert all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
        if bits == 4:
            for u0, _ in bounds:                      # packed byte 128 u0 starts a group pair
                tile, sub = divmod(u0 * tqm.UNIT // 2, tqm.TI // 2)
                assert sub % tqm.GROUP == 0 and (tile * tqm.TI + sub) % tqm.GROUP == 0
        assert p.splits == 1 or p.tiles <= tqm.COUNTERS
        # decode: the fewest splits that reach the target, unless K runs out
        # of units; prefill: the most that fit in one wave
        blocks = p.tiles * p.splits
        target = tqm.TARGET_BLOCKS
        if n <= 16:
            assert blocks >= min(target, p.tiles * p.units)
            assert p.splits == 1 or p.tiles * (p.splits - 1) < target
        else:
            assert p.splits == 1 or blocks <= target
            assert p.splits == p.units or p.tiles * (p.splits + 1) > target


@pytest.mark.parametrize("oi", SERVED)
def test_plan_fills_the_card_at_decode(oi):
    """8 rows (the serving slots) at each served product: a block for
    every SM where the shape has that many units of work (k and v, [1024,
    2048], have 16 tiles x 8 units = 128), and no more splits than that
    needs."""
    p = tqm.plan(8, *_pads(*oi))
    blocks = p.tiles * p.splits
    assert blocks >= tqm.SMS or (oi == (1024, 2048) and blocks == p.tiles * p.units == 128)
    assert p.splits == 1 or p.tiles * (p.splits - 1) < tqm.SMS


def _terms(x, n):
    """x as the sum of n bf16 terms, each widened back to f32 (the
    kernel's split of f32 x; bf16 x is its own single term)."""
    out, r = [], x.float()
    for _ in range(n):
        t = r.bfloat16().float()
        out.append(t)
        r = r - t
    return out


def _kernel_model(x, w, b=None, terms=3):
    """Plain torch of the kernel's arithmetic: x in bf16 terms (one for bf16
    x), products with the integer weights exact (f32 here, < 2^24), f32
    sums per split (int4: per group, then scaled), the splits added in
    split order, then the int8 scale, the bias and the cast."""
    int4 = isinstance(w, tqm.QuantLinear4)
    q = (w.unpack() if int4 else w.q.to(torch.int32)).float()   # [O_pad, K_pad]
    o_pad, k_pad = q.shape
    x2 = x.reshape(-1, x.shape[-1])
    xs = _terms(x2, 1 if x.dtype == torch.bfloat16 else terms)
    xs = [torch.nn.functional.pad(t, (0, k_pad - t.shape[1])) for t in xs]
    p = tqm.plan(x2.shape[0], o_pad, k_pad, int4)
    out = torch.zeros(x2.shape[0], o_pad)
    for j in range(p.splits):
        u0, u1 = _split_units(p, j)
        acc = torch.zeros(x2.shape[0], o_pad)
        for u in range(u0, u1):
            if int4:                                   # unit u: one low and one high group
                tile, sub = divmod(u * tqm.UNIT // 2, tqm.TI // 2)
                for k0 in (tile * tqm.TI + sub, tile * tqm.TI + tqm.TI // 2 + sub):
                    ks = slice(k0, k0 + tqm.GROUP)
                    part = sum(t[:, ks] @ q[:, ks].T for t in reversed(xs))
                    acc = acc + part * w.s[k0 // tqm.GROUP]
            else:
                ks = slice(u * tqm.UNIT, (u + 1) * tqm.UNIT)
                acc = acc + sum(t[:, ks] @ q[:, ks].T for t in reversed(xs))
        out = out + acc
    if not int4:
        out = out * w.s
    y = out[:, :w.out_features]
    if b is not None:
        y = y + b
    return y.reshape(*x.shape[:-1], w.out_features).to(x.dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [2048, 6144])
@pytest.mark.parametrize("rows", [1, 8, 256])
def test_kernel_arithmetic_model_holds_the_bounds(bits, k, rows, capsys):
    """Three bf16 terms of f32 x hold the card's f32 bound against the plain
    version at the served K; the test prints the error of two terms and of
    one (bf16 x's own bound holds for bf16 x)."""
    rng = np.random.default_rng(k + rows + bits)
    w = torch.from_numpy(rng.normal(0, 0.05, (256, k)).astype(np.float32))
    ql = tqm.quantize_int8(w) if bits == 8 else tqm.quantize_int4(w)
    x = torch.from_numpy(rng.standard_normal((rows, k), np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 256).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        xx = x.to(dtype)
        ref = tqm.quant_linear_reference(xx, ql, b).float()
        rel = {n: ((_kernel_model(xx, ql, b, n).float() - ref).abs().max()
                   / ref.abs().max()).item() for n in (3, 2, 1)}
        assert rel[3] <= QM_TOL[dtype], rel
        if dtype == torch.float32:
            with capsys.disabled():
                print(f"\nint{bits} K={k} rows={rows}: max|d|/max|ref| by terms {rel}")
            assert rel[1] > QM_TOL[dtype]             # one bf16 term is not f32


@pytest.mark.parametrize("bits", [8, 4])
def test_kernel_arithmetic_model_matches_the_jax_kernel(bits):
    """The model against the JAX package's Pallas kernel in interpret mode,
    at a small size with split K (3 splits of 1 to 2 units)."""
    rng = np.random.default_rng(20 + bits)
    w = _w((300, 1500), seed=bits)
    x = rng.standard_normal((5, 1500), np.float32)
    b = rng.normal(0, 0.1, 300).astype(np.float32)
    quant = jqm.quantize_int8 if bits == 8 else jqm.quantize_int4
    jq = quant(w)
    ref = np.asarray(jqm.quant_linear(jnp.asarray(x), jq, jnp.asarray(b), interpret=True))
    tq = tllm.params_from_jax({"w": jq})["w"]
    assert tqm.plan(5, 512, 2048, bits == 4).splits == 8
    got = _kernel_model(torch.from_numpy(x), tq, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)
