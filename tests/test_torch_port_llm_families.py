"""The port's MoE, MLA and GatedDeltaNet-hybrid LLM stacks
(clearcam_tpu_torch.models.llm) against the JAX package's, on the CPU at
the tiny widths of tests/test_llm_torch_parity.py: init_params, forward
logits and states over every routing variant, MLA with and without
q-LoRA and its int8 latent cache, the hybrid; QuantExpert codes; the int8
and int4 parameter routes; the grouped-by-expert MoE against the JAX
gather form; the SSM prefill, left-padded generate_batch, the scorer,
Transformer's reuse rules, per-tensor quantized init, and a synthetic
GGUF per architecture. Serving is in test_torch_port_serving_families.py.

Routing ties: ``torch.topk`` promises no order for equal router scores,
nor does a gather form against a grouped one. Every case here draws its
weights and inputs from a seed with numpy at f32, where no two router
scores of a token tie, so the tests never hinge on a tie.
"""
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.io import gguf
from clearcam_tpu.models import llm as jllm
from clearcam_tpu.ops import quant_matmul as jqm
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.ops import quant_matmul as tqm
from clearcam_tpu_torch.testing import torch_threads

from test_llm import tiny_cfg
from test_torch_port_llm import port_cfg

RTOL, ATOL = 1e-4, 1e-5     # tests/test_llm_torch_parity.py's bounds


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


SSM = jllm.SSMConfig(conv_kernel=3, state_size=8, group_count=2, time_step_rank=4,
                     inner_size=32)
# tests/test_llm_torch_parity.py:287-330
FAMILIES = {
    "qwen_moe": dict(num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
                     shared_expert_dim=16),
    "deepseek_bias": dict(num_experts=4, num_experts_per_tok=2, norm_topk_prob=True,
                          expert_bias=True, routed_scaling_factor=2.5,
                          leading_dense_blocks=1, dense_hidden_dim=48),
    "softmax_all": dict(num_experts=4, num_experts_per_tok=2, norm_topk_prob=False,
                        shared_expert_dim=16, shared_expert_gate=False),
    "mla": dict(kv_lora_rank=16, q_lora_rank=24, head_dim=12, rope_dim=4, v_head_dim=8),
    "mla_no_qlora": dict(kv_lora_rank=16, q_lora_rank=0, head_dim=12, rope_dim=4,
                         v_head_dim=8),
    "ssm_hybrid": dict(ssm=SSM, full_attention_interval=2, qk_norm=8),
}
# a Qwen3-Next-shaped hybrid (llm_bench --ssm): one block of each kind at
# head_dim 128, a small vocab
NEXT = tiny_cfg(num_blocks=2, head_dim=128, rope_dim=64, v_head_dim=128, n_heads=2,
                n_kv_heads=1, max_context=256, dim=64, hidden_dim=128, qk_norm=128,
                full_attention_interval=2,
                ssm=jllm.SSMConfig(conv_kernel=4, state_size=16, group_count=2,
                                   time_step_rank=4, inner_size=64))


def _params(cfg, seed=13):
    """JAX params (routing biases drawn, not zero, so they pick experts)
    and the port's copy."""
    jp = dict(jllm.init_params(cfg, seed=seed))
    rng = np.random.default_rng(5)
    for k in list(jp):
        if k.endswith(".exp_probs_b.bias"):
            jp[k] = jnp.asarray(rng.normal(0, 0.5, jp[k].shape), jnp.float32)
    return jp, tllm.params_from_jax(jp)


def _freqs(cfg):
    return (jnp.asarray(jllm.precompute_freqs(cfg.rope_dim, cfg.max_context, cfg.rope_theta)),
            tllm.freqs_for(port_cfg(cfg), "cpu"))


def _steps(cfg, toks):
    """A chunk at a shared position and a T = 1 step at per-row positions;
    SSM stacks step one token at a time."""
    if cfg.ssm is None:
        return [(toks, 0), (toks[:, :1] + 1, np.array([32, 45]))]
    return [(toks[:, i:i + 1], i) for i in range(6)] + [(toks[:, :1] + 1, np.array([6, 6]))]


def _forward_both(cfg, jp, tp, kv_quant=False):
    tc = port_cfg(cfg)
    jfr, tfr = _freqs(cfg)
    js = jllm.init_state(cfg, 2, kv_quant=kv_quant)
    ts = tllm.init_state(tc, 2, kv_quant=kv_quant)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    for tok, pos in _steps(cfg, toks):
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
        assert set(jst) == set(tst)
        for k in jst:
            assert tst[k].dtype == getattr(torch, np.asarray(jst[k]).dtype.name)
            np.testing.assert_allclose(tst[k].float().numpy(),
                                       np.asarray(jst[k], np.float32), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_init_params_equal_jax(name):
    cfg = tiny_cfg(**FAMILIES[name])
    jp = jllm.init_params(cfg, seed=7)
    tp = tllm.init_params(port_cfg(cfg), seed=7)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(name):
    cfg = tiny_cfg(**FAMILIES[name])
    _forward_both(cfg, *_params(cfg))


@pytest.mark.parametrize("name", ["mla", "mla_no_qlora"])
def test_mla_int8_latent_cache_matches_jax(name):
    """One int8 scale per position covers the row's K and V."""
    cfg = tiny_cfg(**FAMILIES[name])
    _forward_both(cfg, *_params(cfg), kv_quant=True)
    st = tllm.init_state(port_cfg(cfg), 2, kv_quant=True)[0]
    assert st["kv"].dtype == torch.int8 and tuple(st["kv_s"].shape) == (2, 1, 64)


def test_block_kinds_and_configs_equal_jax():
    for name, kw in FAMILIES.items():
        cfg = tiny_cfg(num_blocks=4, **kw)
        tc = port_cfg(cfg)
        for i in range(4):
            assert tc.block_kind(i) == cfg.block_kind(i), (name, i)
            assert asdict(port_cfg(cfg.block_cfg(i))) == asdict(tc.block_cfg(i)), (name, i)


def test_quant_expert_codes_equal_jax():
    """Codes and scales bit for bit (both round half to even), an all-zero
    output row (scale 1) included; the gather and dequantize views."""
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.05, (5, 24, 40)).astype(np.float32)
    w[1, 3] = 0.0
    w[2, 0, :4] = [0.5, -0.5, 0.25, 127 / 254]      # values at rounding edges
    jq = jqm.quantize_experts_int8(jnp.asarray(w))
    tq = tqm.quantize_experts_int8(torch.from_numpy(w))
    assert tq.q.dtype == torch.int8 and tq.s.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.s.numpy(), np.asarray(jq.s))
    assert tq.shape == jq.shape and float(tq.s[1, 3, 0]) == 1.0
    sel = np.array([[4, 0], [2, 2]])
    np.testing.assert_array_equal(tq[torch.from_numpy(sel)].numpy(), np.asarray(jq[sel]))
    np.testing.assert_array_equal(tq.dequantize().numpy(), np.asarray(jq.dequantize()))
    back = tllm.params_from_jax({"blk.0.ffn_up_exps.weight": jq})["blk.0.ffn_up_exps.weight"]
    assert torch.equal(back.q, tq.q) and torch.equal(back.s, tq.s)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", ["qwen_moe", "mla", "ssm_hybrid"])
def test_quantized_params_match_jax(name, bits):
    """The int8 and int4 routes: the same tensors quantized (expert stacks
    int8 under both; MLA's 3-D projections and the SSM's small weights
    float), the port's own quantization equal to the JAX package's byte for
    byte, and the forward through them."""
    cfg = tiny_cfg(**FAMILIES[name])
    jp, tp = _params(cfg)
    jq = getattr(jllm, f"quantize_params_int{bits}")(jp, min_dim=8)
    tq = getattr(tllm, f"quantize_params_int{bits}")(tp, min_dim=8)
    assert {k: type(v).__name__ for k, v in tq.items()} == \
        {k: type(v).__name__.replace("ArrayImpl", "Tensor") for k, v in jq.items()}
    kinds = {type(v).__name__ for v in tq.values()}
    assert ("QuantExpert" in kinds) == (name == "qwen_moe")
    assert f"QuantLinear{'4' if bits == 4 else ''}" in kinds
    for k, v in tllm.params_from_jax(jq).items():
        for f in ("q", "s", "packed"):
            if hasattr(v, f):
                assert torch.equal(getattr(v, f), getattr(tq[k], f)), (k, f)
    if "mla" in name:
        assert isinstance(tq["blk.0.attn_k_b.weight"], torch.Tensor)
    if "ssm" in name:
        for k in ("ssm_alpha.weight", "ssm_conv1d.weight", "ssm_dt.bias", "ssm_a"):
            assert isinstance(tq[f"blk.0.{k}"], torch.Tensor), k
    _forward_both(cfg, jq, tq)


def test_ssm_quantization_rules_at_full_width_thresholds():
    """At the default min_dim 256: attn_qkv, attn_gate and ssm_out qualify;
    ssm_alpha / ssm_beta (value heads wide) stay float."""
    ssm = jllm.SSMConfig(conv_kernel=4, state_size=64, group_count=2, time_step_rank=4,
                         inner_size=256)
    cfg = port_cfg(tiny_cfg(ssm=ssm, full_attention_interval=2, qk_norm=8, dim=256,
                            hidden_dim=256, n_heads=2, n_kv_heads=1, head_dim=128,
                            rope_dim=64, v_head_dim=128, num_blocks=2))
    q = tllm.quantize_params_int8(tllm.init_params(cfg, seed=1))
    for k in ("attn_qkv", "attn_gate", "ssm_out"):
        assert isinstance(q[f"blk.0.{k}.weight"], tqm.QuantLinear), k
    for k in ("ssm_alpha.weight", "ssm_beta.weight", "ssm_conv1d.weight", "ssm_norm.weight"):
        assert isinstance(q[f"blk.0.{k}"], torch.Tensor), k


@pytest.mark.parametrize("quant", [True, False])
def test_moe_grouped_equals_the_jax_gather_form(quant):
    """The port's grouped-by-expert MoE (sorted pairs, one product per
    weight over the used experts) against the JAX package's [B,T,k,hid,dim]
    gather form, on a block with 16 experts, 4 a token, 2 x 24 tokens (some
    experts unused, groups of unequal size), float and int8 stacks."""
    cfg = tiny_cfg(num_experts=16, num_experts_per_tok=4, norm_topk_prob=True,
                   shared_expert_dim=16, num_blocks=1)
    jp, _ = _params(cfg, seed=21)
    if quant:
        jp = jllm.quantize_params_int8(jp, min_dim=1024)      # experts only
        assert isinstance(jp["blk.0.ffn_gate_exps.weight"], jqm.QuantExpert)
    tp = tllm.params_from_jax(jp)
    rng = np.random.default_rng(9)
    for shape in ((2, 24), (1, 2)):
        x = rng.normal(0, 1, shape + (cfg.dim,)).astype(np.float32)
        want = np.asarray(jllm._ffn(jp, "blk.0", cfg, jnp.asarray(x)))
        got = tllm._ffn(tp, "blk.0", port_cfg(cfg), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
        sel, _ = tllm._route(tp, "blk.0", port_cfg(cfg), torch.from_numpy(x))
        counts = torch.bincount(sel.flatten(), minlength=16).tolist()
        assert len(set(counts)) > 1 and (shape == (2, 24) or 0 in counts)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_dead_rows_keep_their_state_bit_for_bit(dtype):
    """A GatedDeltaNet step with live = [True, False, True]: row 1's conv
    window and recurrent state are the same bits afterwards (a select, not
    a blend), the live rows' moved; the output and states match JAX's
    block (a bf16 state within 1e-2: one bf16 step where the two f32
    results straddle a rounding edge)."""
    cfg = tiny_cfg(**FAMILIES["ssm_hybrid"])
    jp, tp = _params(cfg)
    js = jllm.init_state(cfg, 3, dtype=jnp.bfloat16 if dtype == torch.bfloat16
                         else jnp.float32)[0]
    rng = np.random.default_rng(8)
    ts = {k: torch.from_numpy(rng.normal(0, 1, v.shape).astype(np.float32)).to(dtype)
          for k, v in js.items()}
    js = {k: jnp.asarray(v.float().numpy()).astype(js[k].dtype) for k, v in ts.items()}
    before = {k: v.clone() for k, v in ts.items()}
    x = rng.normal(0, 1, (3, 1, cfg.dim)).astype(np.float32)
    live = np.array([True, False, True])
    jout, jst = jllm._ssm_block(jp, "blk.0", cfg, jnp.asarray(x), js, 0, None,
                                live=jnp.asarray(live))
    tout, _ = tllm._ssm_block(tp, "blk.0", port_cfg(cfg), torch.from_numpy(x), ts, 0, None,
                              live=live)
    for k in ts:
        assert torch.equal(ts[k][1], before[k][1]) and not torch.equal(ts[k][0], before[k][0])
        np.testing.assert_allclose(ts[k].float().numpy(), np.asarray(jst[k], np.float32),
                                   rtol=RTOL, atol=ATOL if dtype == torch.float32 else 1e-2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=RTOL,
                               atol=ATOL if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("pads", [None, [0, 3, 5]])
def test_prefill_hidden_ssm_matches_jax(pads):
    """A 7-token chunk of a CHUNK-wide prefill (the padded steps do not
    run), with and without left pads: the hidden at n_real - 1 and every
    state."""
    cfg = tiny_cfg(**FAMILIES["ssm_hybrid"])
    jp, tp = _params(cfg)
    jfr, tfr = _freqs(cfg)
    toks = np.random.default_rng(2).integers(1, 64, (3, jllm.CHUNK))
    pj = None if pads is None else jnp.asarray(pads, jnp.int32)
    pt = None if pads is None else torch.tensor(pads, dtype=torch.int32)
    js, ts = jllm.init_state(cfg, 3), tllm.init_state(port_cfg(cfg), 3)
    for start in (0, 7):
        jh, js = jllm._prefill_hidden(jp, cfg, js, jnp.asarray(toks), start, 7, jfr,
                                      pad_start=pj)
        th, ts = tllm._prefill_hidden(tp, port_cfg(cfg), ts, torch.from_numpy(toks), start,
                                      7, tfr, pad_start=pt)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    for jst, tst in zip(js, ts):
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), rtol=RTOL,
                                       atol=ATOL)
    if pads is not None:        # row 2's pad steps left its recurrence at zero
        fresh = tllm.init_state(port_cfg(cfg), 3)
        tllm._prefill_hidden(tp, port_cfg(cfg), fresh, torch.from_numpy(toks), 0, 5, tfr,
                             pad_start=pt)
        assert not fresh[0]["rec"][2].any() and fresh[0]["rec"][1].any()


@pytest.mark.parametrize("name", ["ssm_hybrid", "qwen_moe", "mla"])
def test_generate_batch_left_padded_tokens_equal_jax(name):
    """Prompts of 3, 11 and 6 tokens right-aligned in one batch: every
    row's greedy tokens equal the JAX package's (SSM rows hold their
    recurrence over their pads)."""
    cfg = tiny_cfg(max_context=64, **FAMILIES[name])
    jp, tp = _params(cfg)
    prompts = [[5, 9, 2], list(range(3, 14)), [7, 1, 7, 1, 7, 1]]
    want = jllm.generate_batch(jp, cfg, prompts, max_new=6)
    got = tllm.generate_batch(tp, port_cfg(cfg), prompts, max_new=6)
    assert got == want
    if name == "ssm_hybrid":
        with pytest.raises(ValueError, match="attention-only"):
            tllm.generate_batch(tp, port_cfg(cfg), prompts, max_new=2,
                                use_pallas_decode=True)


@pytest.mark.parametrize("name", ["ssm_hybrid", "mla"])
def test_score_fn_matches_jax(name):
    cfg = tiny_cfg(max_context=64, **FAMILIES[name])
    jp, tp = _params(cfg)
    toks = list(np.random.default_rng(4).integers(1, 64, 40))
    want = jllm.make_score_fn(cfg)(jp, toks)
    got = tllm.make_score_fn(port_cfg(cfg))(tp, toks)
    assert len(got) == len(want) == 39
    for (gc, galt), (wc, walt) in zip(got, want):
        assert abs(gc - wc) < 1e-5
        assert [i for i, _ in galt] == [i for i, _ in walt]
        np.testing.assert_allclose([x for _, x in galt], [x for _, x in walt], atol=1e-5)


@pytest.mark.parametrize("quantize", ["int8", "int4"])
@pytest.mark.parametrize("draws", ["numpy", "generator"])
def test_quantized_init_equals_init_then_quantize(quantize, draws):
    """init_params(quantize=...) quantizes each tensor as it is drawn: the
    same tensors as init_params then quantize_params_*, for the numpy draws
    and for a torch.Generator's, on a stack with every block kind."""
    cfg = port_cfg(tiny_cfg(num_blocks=3, dim=256, hidden_dim=256, num_experts=3,
                            num_experts_per_tok=2, shared_expert_dim=256,
                            leading_dense_blocks=1, dense_hidden_dim=256, head_dim=64,
                            rope_dim=32, v_head_dim=64, n_heads=4, n_kv_heads=4,
                            vocab_size=300, ssm=SSM, full_attention_interval=2))

    def gen():
        return torch.Generator().manual_seed(3) if draws == "generator" else None
    kw = dict(seed=3, dtype=torch.bfloat16, generator=gen())
    once = tllm.init_params(cfg, quantize=quantize, **kw)
    kw["generator"] = gen()
    after = getattr(tllm, f"quantize_params_{quantize}")(tllm.init_params(cfg, **kw))
    assert once.keys() == after.keys()
    kinds = {type(v).__name__ for v in once.values()}
    assert {"QuantExpert", "Tensor"} <= kinds and len(kinds) == 3
    for k, v in once.items():
        assert type(v) is type(after[k]), k
        for f in ("q", "s", "packed"):
            if hasattr(v, f):
                assert torch.equal(getattr(v, f), getattr(after[k], f)), (k, f)
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, after[k]), k


def test_transformer_ssm_reuse_and_spec_rules():
    """The hybrid's single-stream generator: tokens equal the JAX
    Transformer's, a prompt that extends the cached one continues its
    recurrence, a diverging one starts over (reusable_prefix 0); spec is
    refused, where the JAX Transformer turns it off."""
    cfg = tiny_cfg(max_context=64, **FAMILIES["ssm_hybrid"])
    jp, tp = _params(cfg)
    jt, tt = jllm.Transformer(jp, cfg), tllm.Transformer(tp, port_cfg(cfg))
    first = [3, 1, 4, 1, 5]

    def gen(m, prompt):
        return list(m.generate(prompt, max_new=4))
    a = gen(tt, first)
    assert a == gen(jt, first)
    longer = first + a[:-1] + [9]
    assert tt.reusable_prefix(longer) == len(tt._cached_tokens) > 0
    assert gen(tt, longer) == gen(jt, longer)
    other = [2, 7, 1, 8]
    assert tt.reusable_prefix(other) == 0
    assert gen(tt, other) == gen(jt, other)
    with pytest.raises(ValueError, match="rolled back"):
        tllm.Transformer(tp, port_cfg(cfg), spec_lookup=3)


def _arch_gguf(tmp_path, arch):
    """A tiny GGUF of ``arch`` from the JAX package's random params, with
    the metadata config_from_gguf reads for it."""
    kw = {"qwen3moe": dict(num_experts=4, num_experts_per_tok=2, qk_norm=8),
          "glm4moe": dict(num_experts=4, num_experts_per_tok=2, expert_bias=True,
                          shared_expert_dim=16, shared_expert_gate=False,
                          leading_dense_blocks=1, dense_hidden_dim=48,
                          routed_scaling_factor=2.5, norm_topk_prob=True),
          "deepseek2": dict(num_experts=4, num_experts_per_tok=2, kv_lora_rank=16,
                            q_lora_rank=0, head_dim=12, rope_dim=4, v_head_dim=8,
                            shared_expert_dim=32, shared_expert_gate=False,
                            leading_dense_blocks=1, dense_hidden_dim=48),
          "qwen35": dict(ssm=SSM, full_attention_interval=2, qk_norm=8,
                         attn_output_gate=True),
          "qwen35moe": dict(ssm=SSM, full_attention_interval=2, qk_norm=8,
                            attn_output_gate=True, num_experts=4, num_experts_per_tok=2,
                            shared_expert_dim=16)}[arch]
    cfg = tiny_cfg(**kw)
    params = {k: np.asarray(v) for k, v in _params(cfg, seed=11)[0].items()}
    kv = {"general.architecture": arch, f"{arch}.block_count": cfg.num_blocks,
          f"{arch}.context_length": 80, f"{arch}.embedding_length": cfg.dim,
          f"{arch}.feed_forward_length": cfg.dense_hidden_dim or cfg.hidden_dim,
          f"{arch}.attention.head_count": cfg.n_heads,
          f"{arch}.attention.head_count_kv": cfg.n_kv_heads,
          f"{arch}.attention.layer_norm_rms_epsilon": 1e-6,
          f"{arch}.rope.freq_base": 10000.0,
          f"{arch}.attention.key_length": cfg.head_dim,
          f"{arch}.rope.dimension_count": cfg.rope_dim,
          "tokenizer.ggml.tokens": [f"t{i}" for i in range(cfg.vocab_size)],
          "tokenizer.ggml.token_type": [1] * cfg.vocab_size}
    if cfg.num_experts:
        kv.update({f"{arch}.expert_count": cfg.num_experts,
                   f"{arch}.expert_used_count": cfg.num_experts_per_tok,
                   f"{arch}.expert_feed_forward_length": cfg.hidden_dim,
                   f"{arch}.expert_shared_feed_forward_length": cfg.shared_expert_dim,
                   f"{arch}.leading_dense_block_count": cfg.leading_dense_blocks,
                   f"{arch}.expert_weights_scale": cfg.routed_scaling_factor})
        if arch in ("glm4moe", "deepseek2"):
            kv[f"{arch}.expert_weights_norm"] = cfg.norm_topk_prob
    if cfg.kv_lora_rank:
        kv.update({f"{arch}.attention.kv_lora_rank": cfg.kv_lora_rank,
                   f"{arch}.attention.key_length_mla": cfg.head_dim,
                   f"{arch}.attention.value_length_mla": cfg.v_head_dim})
    if cfg.ssm:
        kv.update({f"{arch}.ssm.{k}": v for k, v in asdict(cfg.ssm).items()})
        kv[f"{arch}.full_attention_interval"] = cfg.full_attention_interval
        params = {k.replace("ffn_norm", "post_attention_norm"): v for k, v in params.items()}
    path = tmp_path / f"{arch}.gguf"
    gguf.save(path, kv, params)
    return path


@pytest.mark.parametrize("arch", ["qwen3moe", "glm4moe", "deepseek2", "qwen35", "qwen35moe"])
def test_gguf_loads_and_runs_like_jax(tmp_path, arch):
    """The architectures serve_llm refused: config, converted tensors and
    the forward's logits equal the JAX package's; serve_llm builds an
    engine from the file and serves a request on the CPU."""
    path = _arch_gguf(tmp_path, arch)
    kv, sd = gguf.load(path)
    jcfg = jllm.config_from_gguf(kv, sd, max_context=64)
    jp = jllm.convert_state_dict(sd, kv, jnp.float32)
    cfg, tp, _ = tllm.load_gguf(path, max_context=64, dtype=torch.float32)
    assert asdict(cfg) == asdict(port_cfg(jcfg))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(v), err_msg=k)
    _forward_both(jcfg, jp, tp)

    from clearcam_tpu_torch.tools import serve_llm
    eng = serve_llm.build_engine(serve_llm.parse_args(
        ["--gguf", str(path), "--device", "cpu", "--ctx", "64", "--slots", "2",
         "--json-depth", "0"])).engine
    assert eng.prefix_cache == (cfg.ssm is None)
    r = eng.submit([5, 6, 7], max_new=4)
    eng.run_until_idle()
    assert len(r.wait(1)) == 4

