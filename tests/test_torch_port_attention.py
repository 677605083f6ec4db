"""The port's ViT attention (clearcam_tpu_torch.ops.vit_attention) and the
attention ops of its nn.functional against the JAX package's, on the CPU.

The JAX ``mha_flash`` runs only on a TPU (the stock Pallas flash kernel has
no CPU path, tests/test_vit_flash.py); its contract is unpadded attention,
which is ``clearcam_tpu.nn.functional.mha`` with no mask, so that is the
reference here. The CUDA kernel against the plain version is in
test_torch_port_cuda.py.
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
