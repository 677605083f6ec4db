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
