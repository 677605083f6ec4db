"""The port's LLM (clearcam_tpu_torch.models.llm) against the JAX package's,
on the CPU at tiny widths: init_params, forward and logits over the dense
variants, the GGUF path, the scorer, and sampling fed the same Gumbel
noise. Serving is in test_torch_port_serving.py; the MoE, MLA and
GatedDeltaNet stacks are in test_torch_port_llm_families.py.
"""
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.io import gguf
from clearcam_tpu.models import llm as jllm
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.testing import torch_threads

from test_llm import tiny_cfg

RTOL, ATOL = 1e-4, 1e-5     # tests/test_llm_torch_parity.py's bounds


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def port_cfg(cfg) -> tllm.TransformerConfig:
    d = asdict(cfg)
    ssm = d.pop("ssm")
    return tllm.TransformerConfig(**d, ssm=tllm.SSMConfig(**ssm) if ssm else None)


VARIANTS = {
    "plain": dict(),
    "qk_norm_per_head": dict(qk_norm=8),
    "qk_norm_whole": dict(qk_norm=32, n_kv_heads=4),
    "qkv_bias": dict(qkv_bias=True),
    "output_gate": dict(attn_output_gate=True),
}


def _params(cfg, seed=3):
    jp = jllm.init_params(cfg, seed=seed)
    if cfg.qkv_bias:        # init_params gives zero biases: make them matter
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(rng.normal(0, 0.1, v.shape), jnp.float32)
                  if k.endswith(".bias") else v) for k, v in jp.items()}
    return jp, tllm.params_from_jax(jp)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_params_equal_jax(name):
    cfg = tiny_cfg(**VARIANTS[name])
    jp = jllm.init_params(cfg, seed=7)
    tp = tllm.init_params(port_cfg(cfg), seed=7)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)


def test_init_params_bf16():
    cfg = tiny_cfg()
    tp = tllm.init_params(port_cfg(cfg), seed=7, dtype=torch.bfloat16)
    jp = jllm.init_params(cfg, seed=7)
    w = tp["blk.0.attn_q.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_allclose(w.float().numpy(), np.asarray(jp["blk.0.attn_q.weight"]),
                               rtol=2 ** -8)


# the int8 KV cache on the plain stack: its bf16 dequant (the JAX
# package's) would turn the qk-norm's f32 ulp differences into bf16 ones
@pytest.mark.parametrize("name,kv_quant", [(n, False) for n in VARIANTS]
                         + [("plain", True), ("qkv_bias", True)])
def test_forward_matches_jax(name, kv_quant):
    cfg = tiny_cfg(**VARIANTS[name])
    tc = port_cfg(cfg)
    jp, tp = _params(cfg)
    jfr = jnp.asarray(jllm.precompute_freqs(cfg.rope_dim, cfg.max_context, cfg.rope_theta))
    tfr = tllm.freqs_for(tc, "cpu")
    js = jllm.init_state(cfg, 2, kv_quant=kv_quant)
    ts = tllm.init_state(tc, 2, kv_quant=kv_quant)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    # a prefill chunk at a shared position, then T = 1 at per-row positions
    for tok, pos in ((toks, 0), (toks[:, :1] + 1, np.array([32, 45]))):
        jh, js = jllm.forward(jp, cfg, js, jnp.asarray(tok),
                              pos if np.isscalar(pos) else jnp.asarray(pos), jfr)
        th, ts = tllm.forward(tp, tc, ts, torch.from_numpy(tok),
                              pos if np.isscalar(pos) else torch.from_numpy(pos), tfr)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
        last = tok.shape[1] - 1
        np.testing.assert_allclose(tllm.logits_at(tp, tc, th, last).numpy(),
                                   np.asarray(jllm.logits_at(jp, cfg, jh, last)),
                                   rtol=RTOL, atol=ATOL)
    for jst, tst in zip(js, ts):
        for k in jst:
            np.testing.assert_allclose(tst[k].float().numpy(),
                                       np.asarray(jst[k], np.float32), rtol=RTOL, atol=ATOL)


# bf16 weights: the port rounds each product's f32 input to bf16 (the
# weight's dtype), where the JAX package widens the weight and multiplies
# in f32. At tiny_cfg's widths (logits ~1) that moves hidden states and
# logits by up to 4.7e-3; the bound allows ~4x that.
BF16_ATOL = 2e-2


@pytest.mark.parametrize("name", ["plain", "qk_norm_per_head"])
def test_forward_bf16_weights_and_cache_near_jax(name):
    cfg = tiny_cfg(**VARIANTS[name])
    tc = port_cfg(cfg)
    jp = {k: v.astype(jnp.bfloat16) for k, v in jllm.init_params(cfg, seed=3).items()}
    tp = tllm.params_from_jax(jp)
    assert {v.dtype for v in tp.values()} == {torch.bfloat16}
    jfr = jnp.asarray(jllm.precompute_freqs(cfg.rope_dim, cfg.max_context, cfg.rope_theta))
    tfr = tllm.freqs_for(tc, "cpu")
    js = jllm.init_state(cfg, 2, dtype=jnp.bfloat16)
    ts = tllm.init_state(tc, 2, dtype=torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    for tok, pos in ((toks, 0), (toks[:, :1] + 1, np.array([32, 45]))):
        jh, js = jllm.forward(jp, cfg, js, jnp.asarray(tok),
                              pos if np.isscalar(pos) else jnp.asarray(pos), jfr)
        th, ts = tllm.forward(tp, tc, ts, torch.from_numpy(tok),
                              pos if np.isscalar(pos) else torch.from_numpy(pos), tfr)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=BF16_ATOL)
        last = tok.shape[1] - 1
        np.testing.assert_allclose(tllm.logits_at(tp, tc, th, last).float().numpy(),
                                   np.asarray(jllm.logits_at(jp, cfg, jh, last), np.float32),
                                   rtol=0, atol=BF16_ATOL)


def test_forward_write_mask_leaves_rows_untouched():
    cfg = tiny_cfg()
    tc = port_cfg(cfg)
    _, tp = _params(cfg)
    ts = tllm.init_state(tc, 3)
    for s in ts:
        for t in s.values():
            t.normal_()
    before = [{k: t.clone() for k, t in s.items()} for s in ts]
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (3, 32)))
    tllm.forward(tp, tc, ts, toks, torch.tensor([0, 32, 50]), tllm.freqs_for(tc, "cpu"),
                 write_mask=[True, False, True])
    for s, b in zip(ts, before):
        for k in s:
            assert torch.equal(s[k][1], b[k][1])
            assert not torch.equal(s[k][0], b[k][0])


def _qwen3_gguf(tmp_path, arch="qwen3"):
    cfg = tiny_cfg(qk_norm=8 if arch == "qwen3" else 0)
    params = {k: np.asarray(v) for k, v in jllm.init_params(cfg, seed=11).items()}
    params["blk.0.ffn_up.weight"] = params["blk.0.ffn_up.weight"].astype(np.float16)
    kv = {"general.architecture": arch, f"{arch}.block_count": cfg.num_blocks,
          f"{arch}.context_length": 80, f"{arch}.embedding_length": cfg.dim,
          f"{arch}.feed_forward_length": cfg.hidden_dim,
          f"{arch}.attention.head_count": cfg.n_heads,
          f"{arch}.attention.head_count_kv": cfg.n_kv_heads,
          f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
          f"{arch}.rope.freq_base": 10000.0,
          "tokenizer.ggml.tokens": [f"t{i}" for i in range(cfg.vocab_size)]}
    path = tmp_path / f"{arch}.gguf"
    gguf.save(path, kv, params)
    return path


@pytest.mark.parametrize("arch", ["qwen3", "llama"])
def test_gguf_loads_like_jax(tmp_path, arch):
    path = _qwen3_gguf(tmp_path, arch)
    kv, sd = gguf.load(path)
    jcfg = jllm.config_from_gguf(kv, sd, max_context=64)
    jp = jllm.convert_state_dict(sd, kv, jnp.float32)
    cfg, tp, kv2 = tllm.load_gguf(path, max_context=64, dtype=torch.float32)
    assert asdict(cfg) == asdict(jcfg)
    assert kv2["general.architecture"] == arch
    assert set(tp) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)


def test_score_fn_matches_jax():
    cfg = tiny_cfg(max_context=64)
    jp, tp = _params(cfg)
    toks = list(np.random.default_rng(4).integers(1, 64, 40))
    want = jllm.make_score_fn(cfg)(jp, toks)
    got = tllm.make_score_fn(port_cfg(cfg))(tp, toks)
    assert len(got) == len(want) == 39
    for (gc, galt), (wc, walt) in zip(got, want):
        assert abs(gc - wc) < 1e-5
        assert [i for i, _ in galt] == [i for i, _ in walt]
        np.testing.assert_allclose([x for _, x in galt], [x for _, x in walt], atol=1e-5)


# ---------------------------------------------------------------------------
# sampling, fed the same Gumbel noise
# ---------------------------------------------------------------------------

V = 64
SPECS = {
    "greedy": [0.0, 1.0, 0, 0.0, 0.0, 0.0, 1.0, 0.0],
    "temperature": [0.8, 1.0, 0, 0.0, 0.0, 0.0, 1.0, 0.0],
    "top_k": [1.5, 1.0, 5, 0.0, 0.0, 0.0, 1.0, 0.0],
    "top_p": [1.2, 0.7, 0, 0.0, 0.0, 0.0, 1.0, 0.0],
    "min_p": [1.2, 1.0, 0, 0.2, 0.0, 0.0, 1.0, 0.0],
    "penalties": [0.9, 1.0, 0, 0.0, 0.5, 0.3, 1.3, 0.0],
    "bias": [0.7, 1.0, 0, 0.0, 0.0, 0.0, 1.0, 1.0],
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("spec", list(SPECS))
def test_sampling_matches_jax_with_the_same_noise(spec, masked):
    rng = np.random.default_rng(len(spec))
    b = 6
    logits = (rng.standard_normal((b, V)) * 3).astype(np.float32)
    samp = np.tile(np.asarray(SPECS[spec], np.float32), (b, 1))
    samp[::3, 0] = 0.0                     # greedy rows beside the others
    cnt_p = rng.integers(0, 3, (b, V)).astype(np.int32)
    cnt_o = rng.integers(0, 3, (b, V)).astype(np.int32)
    bias = (rng.standard_normal((b, V)) * 2).astype(np.float32)
    cmask = rng.random((b, V)) < 0.5 if masked else np.zeros((b, V), bool)
    keys = jllm.serving_row_keys(jax.random.PRNGKey(0), jnp.arange(b) + 3,
                                 jnp.arange(b))
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys))
    jtok, jlp = jllm.sample_filtered_lp(
        jnp.asarray(logits), jnp.asarray(samp), None, jnp.asarray(cnt_p),
        jnp.asarray(cnt_o), jnp.asarray(bias), row_keys=keys, cmask=jnp.asarray(cmask))
    ttok, tlp = tllm.sample_filtered_lp(
        torch.from_numpy(logits), torch.from_numpy(samp), torch.from_numpy(noise),
        torch.from_numpy(cnt_p), torch.from_numpy(cnt_o), torch.from_numpy(bias),
        cmask=torch.from_numpy(cmask))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=0, atol=1e-5)
    only = tllm.sample_filtered(torch.from_numpy(logits), torch.from_numpy(samp),
                                torch.from_numpy(noise), torch.from_numpy(cnt_p),
                                torch.from_numpy(cnt_o), torch.from_numpy(bias),
                                cmask=torch.from_numpy(cmask))
    np.testing.assert_array_equal(only.numpy(), ttok.numpy())


def test_pack_samp_and_old_layouts():
    np.testing.assert_array_equal(tllm.pack_samp(0.5, 0.9, 3).numpy(),
                                  np.asarray(jllm.pack_samp(0.5, 0.9, 3)))
    row = np.array(jllm._samp_of([0.7, 0.9, 2.0, 0.1, 0.2, 0.3, 1.1]))
    for t in (row, np.stack([row, row])):
        np.testing.assert_array_equal(tllm._samp_of(t).numpy(), t)
    # the JAX package's earlier layouts (0-d, [4], [7]) have no caller in the port
    for t in (0.7, [0.7, 0.9, 2.0, 0.1], [0.7, 0.9, 2.0, 0.1, 0.2, 0.3, 1.1]):
        with pytest.raises(ValueError, match="pack_samp"):
            tllm._samp_of(t)


def test_row_noise_depends_on_seed_and_index_only():
    both = tllm.row_noise(5, [11, 12], [3, 0], V, "cpu")
    assert both.shape == (2, V) and torch.isfinite(both).all()
    assert torch.equal(both[0], tllm.row_noise(5, [11], [3], V, "cpu")[0])
    assert torch.equal(both[1], tllm.row_noise(5, [7, 12], [9, 0], V, "cpu")[1])
    assert not torch.equal(both[0], tllm.row_noise(5, [11], [4], V, "cpu")[0])
    assert not torch.equal(both[0], tllm.row_noise(6, [11], [3], V, "cpu")[0])
