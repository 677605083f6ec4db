"""The LLM runtime over torch, the counterpart of ``clearcam_tpu.models.llm``:
the model (dense, MoE, MLA and GatedDeltaNet-hybrid blocks), its sampler,
and the continuous-batching serving graphs that ``serving.engine`` drives.

Covered: GQA attention blocks with qk-norm (per head or over the whole
projection), qkv bias, the output gate and RoPE (half-split layout); the
dense SwiGLU FFN and the MoE FFN (softmax or sigmoid routers, the
expert-bias term, ``routed_scaling_factor``, a shared expert with or
without its gate, leading dense blocks), run grouped by expert; DeepSeek
MLA latent-KV attention (q_nope absorbed through ``attn_k_b``, one cache
row of [c_kv || k_rope] per position); GatedDeltaNet linear-attention
blocks stepped one token at a time (conv window and f32 delta-rule state);
f32, bf16 or int8 (per-token scales) KV caches; int8 and int4 weight-only
quantized linears (``ops.quant_matmul``) and int8 expert stacks
(``QuantExpert``); the batched decode-attention kernel as the attention
blocks' decode step (``use_pallas_decode``, ``ops.decode_attention``;
MLA blocks keep the plain product, SSM stacks refuse it); penalties,
logit bias, top-k/top-p/min-p, grammar masks and Gumbel-max sampling;
echo logprob scoring; speculative serving graphs (prompt-lookup verify
windows drafted on the card, ``make_serving_fns(spec_lookup=G)``,
attention and MLA stacks); GGUF loading through the port's copy of
``io.gguf``.

Where the JAX package threads a functional copy of the state through a
jitted step and donates the old one (llm.py:1321-1326), the port writes the
preallocated caches in place: ``forward`` and the serving graphs mutate
``state`` and return the same list. Tokens sampled on the device
(``first_tok``, decode outputs) are fresh tensors every call, never
updated in place, since the engine's lagged records still hold earlier
ones.

Sampling noise: the JAX package folds threefry keys from (engine seed,
request seed, token index); the port seeds one ``torch.Generator`` per row
from a fixed integer mix of the same three (``row_noise``), so a row's
draws never depend on its slot or batch companions. The bits differ from
JAX's; ``_draw`` takes its Gumbel noise as an argument so tests feed both
packages the same noise.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device
from ..nn import functional as F
from ..ops.quant_matmul import (QuantExpert, QuantLinear, QuantLinear4,
                                quantize_experts_int8, quantize_int4, quantize_int8, true_div)
from ..runtime import metrics

# Prefill chunk width (the JAX package's CLEARCAM_CHUNK, llm.py:39).
CHUNK = int(os.environ.get("CLEARCAM_CHUNK", "32"))
LP_K = 8        # top alternatives in every logprob row
SAMP_W = 8      # packed sampling-spec row width (pack_samp columns)
_NEG = float(np.finfo(np.float32).min)
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class SSMConfig:
    conv_kernel: int
    state_size: int
    group_count: int
    time_step_rank: int
    inner_size: int


@dataclass(frozen=True)
class TransformerConfig:
    num_blocks: int
    dim: int
    hidden_dim: int
    n_heads: int
    n_kv_heads: int
    norm_eps: float
    vocab_size: int
    head_dim: int
    rope_theta: float
    rope_dim: int
    v_head_dim: int
    max_context: int = 2048
    qk_norm: int = 0
    num_experts: int = 0
    num_experts_per_tok: int = 0
    norm_topk_prob: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    shared_expert_dim: int = 0
    full_attention_interval: int = 0
    attn_output_gate: bool = False
    ssm: SSMConfig | None = None
    shared_expert_gate: bool = True
    leading_dense_blocks: int = 0
    dense_hidden_dim: int = 0
    routed_scaling_factor: float = 1.0
    qkv_bias: bool = False
    expert_bias: bool = False

    def block_kind(self, i: int) -> str:
        """"ssm", "mla" or "attn": a hybrid's every
        ``full_attention_interval``-th block is attention."""
        if self.ssm and (i + 1) % max(self.full_attention_interval, 1) != 0:
            return "ssm"
        if self.kv_lora_rank > 0:
            return "mla"
        return "attn"

    def block_cfg(self, i: int) -> "TransformerConfig":
        """Block i's config: the leading dense blocks of an MoE stack have no
        experts and ``dense_hidden_dim`` for their FFN."""
        if i < self.leading_dense_blocks:
            return replace(self, num_experts=0, num_experts_per_tok=0,
                           shared_expert_dim=0,
                           hidden_dim=self.dense_hidden_dim or self.hidden_dim)
        return self


def qwen3_2b_cfg(blocks: int = 28, ctx: int = 8192) -> TransformerConfig:
    """Qwen/Qwen3-1.7B's published widths (its config.json): hidden 2048,
    28 layers, 16 heads, 8 KV heads, head_dim 128, intermediate 6144,
    vocab 151936, rope theta 1e6, RMS eps 1e-6, qk-norm per head.
    ``blocks`` cuts the depth; ``ctx`` is the cache length."""
    return TransformerConfig(
        num_blocks=blocks, dim=2048, hidden_dim=6144, n_heads=16,
        n_kv_heads=8, norm_eps=1e-6, vocab_size=151936, head_dim=128,
        rope_theta=1e6, rope_dim=128, v_head_dim=128, max_context=ctx,
        qk_norm=128)


def qwen3_next_cfg(blocks: int = 28, ctx: int = 2048) -> TransformerConfig:
    """The JAX package's Qwen3-Next-class hybrid (clearcam_tpu/tools/
    llm_bench.py:42-54): GatedDeltaNet blocks with every 4th block full
    attention (output-gated, qk-norm per head), hidden 2048, 16/4 heads of
    128 (rope on 64), FFN 5120, vocab 151936; the SSM's 32 value heads and
    16 key groups of 128, conv kernel 4."""
    return TransformerConfig(
        num_blocks=blocks, dim=2048, hidden_dim=5120, n_heads=16,
        n_kv_heads=4, norm_eps=1e-6, vocab_size=151936, head_dim=128,
        rope_theta=1e6, rope_dim=64, v_head_dim=128, max_context=ctx,
        qk_norm=128, full_attention_interval=4,
        ssm=SSMConfig(conv_kernel=4, state_size=128, group_count=16,
                      time_step_rank=32, inner_size=4096))


def precompute_freqs(dim: int, end: int, theta: float) -> np.ndarray:
    """[end, dim] = concat(cos, sin) of position * inv_freq."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    ang = np.arange(end)[:, None] * inv[None, :]
    return np.concatenate([np.cos(ang), np.sin(ang)], -1).astype(np.float32)


def freqs_for(cfg: TransformerConfig, device) -> torch.Tensor:
    return torch.from_numpy(precompute_freqs(cfg.rope_dim, cfg.max_context,
                                             cfg.rope_theta)).to(device)


def _freqs_per_device(cfg: TransformerConfig):
    """freqs_for(cfg, device), built once per device a graph runs on."""
    cache: dict = {}

    def get(dev):
        if dev not in cache:
            cache[dev] = freqs_for(cfg, dev)
        return cache[dev]
    return get


def apply_rope(x, freqs):
    """Half-split RoPE on [B,H,T,D]; freqs [T,D] (cos||sin) shared across
    rows, or [B,T,D] per row."""
    d = x.shape[-1] // 2
    if freqs.dim() == 3:
        cos, sin = freqs[:, None, :, :d], freqs[:, None, :, d:]
    else:
        cos, sin = freqs[None, None, :, :d], freqs[None, None, :, d:]
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _is_vec(start_pos) -> bool:
    """Per-row [B] positions (continuous batching) rather than one scalar."""
    return isinstance(start_pos, torch.Tensor) and start_pos.dim() == 1


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _route(p, pre, cfg: TransformerConfig, x):
    """The MoE router: (expert ids [..., k], their weights [..., k]). The
    softmax router takes the top-k logits, weighted by the softmax of
    those k (norm_topk_prob) or of all experts; the sigmoid router
    (expert_bias) picks by sigmoid + ``exp_probs_b`` and weights by the
    unbiased sigmoid. Ties between router scores have no promised order
    (``torch.topk``)."""
    logits = F.linear(x, p[f"{pre}.ffn_gate_inp.weight"])
    k = cfg.num_experts_per_tok
    if cfg.expert_bias:
        probs = torch.sigmoid(logits)
        sel = torch.topk(probs + p[f"{pre}.exp_probs_b.bias"], k).indices
        probs = probs.gather(-1, sel)
        if cfg.norm_topk_prob:
            probs = probs / probs.sum(-1, keepdim=True)
    else:
        vals, sel = torch.topk(logits, k)
        probs = torch.softmax(vals, -1) if cfg.norm_topk_prob else \
            torch.softmax(logits, -1).gather(-1, sel)
    return sel, probs * cfg.routed_scaling_factor


def _expert_products(xs, w, used):
    """xs [U, C, I] times the used experts' weights (w [E, O, I], a tensor
    or a QuantExpert; ``used`` [U] expert ids) -> [U, C, O] in xs's dtype.
    An int8 stack is widened exactly to f32 and its per-output scale applied
    after the product; a float stack of another dtype than xs multiplies xs
    rounded to it, as ``nn.functional.linear`` does."""
    if isinstance(w, QuantExpert):
        q = w.q[used].float()
        return (torch.matmul(xs.float(), q.transpose(1, 2))
                * w.s[used].transpose(1, 2)).to(xs.dtype)
    wu = w[used]
    if xs.dtype != wu.dtype:
        return torch.matmul(xs.to(wu.dtype), wu.transpose(1, 2)).to(xs.dtype)
    return torch.matmul(xs, wu.transpose(1, 2))


def _moe_experts(p, pre, cfg: TransformerConfig, x2, sel, probs):
    """The routed experts' SwiGLU outputs summed with their weights:
    x2 [N, D], sel and probs [N, k] -> [N, D].

    The JAX package gathers each (token, choice)'s three weight slices,
    [N, k, hid, dim] apiece; at 8 slots x a 32-token chunk, 8 of 128
    experts and 768 x 2048 that is ~13 GB of f32 per weight. Here the
    pairs are sorted by expert instead, each expert used is read and
    widened once, and one batched product per weight runs over [used
    experts, most pairs of one expert, D], short groups padded with zero
    rows. The group sizes are read back to the host once a call. The
    weighted sum runs over the k choices in their order, as the JAX
    package's does."""
    n, k = sel.shape
    dev, d = x2.device, x2.shape[-1]
    flat = sel.reshape(-1)
    # an expert-parallel rank holds experts [e0, e0 + n_e) (parallel.mesh):
    # pairs routed elsewhere sort last, under the out-of-range id n_e, and
    # leave zero rows here
    n_e = p[f"{pre}.ffn_gate_exps.weight"].shape[0]
    tp = getattr(p, "tp", None)
    if tp is not None and f"{pre}.ffn_down_exps.weight" in tp.split:
        flat = flat - tp.rank * n_e
        flat = torch.where((flat >= 0) & (flat < n_e), flat, n_e)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_e + 1)[:n_e]
    counts_h = counts.cpu()
    used_h = torch.nonzero(counts_h).flatten()
    if used_h.numel() == 0:
        return x2.new_zeros((n, d))
    mine = int(counts_h.sum())
    order = order[:mine]
    used = used_h.to(dev)
    e_sorted = flat[order]
    group = torch.zeros(n_e, dtype=torch.long, device=dev)
    group[used] = torch.arange(used_h.numel(), device=dev)
    g = group[e_sorted]                                     # each pair's group
    row = torch.arange(mine, device=dev) - (torch.cumsum(counts, 0) - counts)[e_sorted]
    xs = x2.new_zeros((used_h.numel(), int(counts_h.max()), d))
    xs[g, row] = x2[order // k]
    gate = _expert_products(xs, p[f"{pre}.ffn_gate_exps.weight"], used)
    up = _expert_products(xs, p[f"{pre}.ffn_up_exps.weight"], used)
    down = _expert_products(F.silu(gate) * up, p[f"{pre}.ffn_down_exps.weight"], used)
    y = torch.zeros((n * k, d), dtype=down.dtype, device=dev)
    y[order] = down[g, row]
    return (y.reshape(n, k, d) * probs[..., None]).sum(1)


def _ffn(p, pre, cfg: TransformerConfig, x):
    """Dense SwiGLU or MoE feed-forward (clearcam_tpu/models/llm.py:123-161):
    the routed experts (``_moe_experts``) plus the shared expert, scaled
    by its sigmoid gate where the block has one."""
    if cfg.num_experts > 0 and f"{pre}.ffn_gate_exps.weight" in p:
        sel, probs = _route(p, pre, cfg, x)
        out = _moe_experts(p, pre, cfg, x.reshape(-1, x.shape[-1]),
                           sel.reshape(-1, sel.shape[-1]),
                           probs.reshape(-1, probs.shape[-1])).reshape(x.shape)
        tp = getattr(p, "tp", None)
        if tp is not None and f"{pre}.ffn_down_exps.weight" in tp.split:
            out = tp.reduce(out.contiguous())
        if f"{pre}.ffn_gate_shexp.weight" in p:
            sh = F.linear(F.silu(F.linear(x, p[f"{pre}.ffn_gate_shexp.weight"]))
                          * F.linear(x, p[f"{pre}.ffn_up_shexp.weight"]),
                          p[f"{pre}.ffn_down_shexp.weight"])
            if f"{pre}.ffn_gate_inp_shexp.weight" in p:
                sh = sh * torch.sigmoid((x * p[f"{pre}.ffn_gate_inp_shexp.weight"])
                                        .sum(-1, keepdim=True))
            out = out + sh
        return out
    gate = F.linear(x, p[f"{pre}.ffn_gate.weight"])
    up = F.linear(x, p[f"{pre}.ffn_up.weight"])
    return _linear_out(p, f"{pre}.ffn_down.weight", F.silu(gate) * up)


def _linear_out(p, key: str, x):
    """``F.linear(x, p[key])`` for the products that end a block's branch
    (``attn_output``, ``ffn_down``). Under tensor parallelism, where ``key``
    is row-split (``p.tp.split``, parallel.mesh), this rank's input columns
    give a partial product and one ``all_reduce`` over the ``model`` group
    completes it. A dense weight of another dtype than x (bf16 weights,
    f32 residual) is multiplied with an f32 result, summed, then rounded to
    the weight's dtype once, as the one-device product rounds its whole
    sum."""
    w = p[key]
    tp = getattr(p, "tp", None)
    if tp is None or key not in tp.split:
        return F.linear(x, w)
    if isinstance(w, torch.Tensor) and x.dtype != w.dtype:
        part = _product_f32(x.to(w.dtype).reshape(1, -1, x.shape[-1]), w.T[None]) \
            .reshape(*x.shape[:-1], w.shape[0])
        return tp.reduce(part).to(w.dtype).to(x.dtype)
    return tp.reduce(F.linear(x, w).contiguous())


def _attn_mask(start_pos, t, ctx, pad_start=None, device=None):
    """Additive causal mask [1|B, 1, T, ctx]: token row r (at absolute
    position start_pos + r) sees cache columns <= start_pos + r; pad_start
    [B] also hides columns < pad_start[b], except from a pad position's
    own query (a fully masked row would softmax to NaN)."""
    rows = torch.arange(t, device=device)[:, None]
    cols = torch.arange(ctx, device=device)[None, :]
    if _is_vec(start_pos):
        reach = start_pos[:, None, None] + rows                     # [B,T,1]
        m = torch.where(cols <= reach, 0.0, float("-inf"))[:, None]
        if pad_start is not None:
            hide = (cols[None] < pad_start[:, None, None]) & (cols != reach)
            m = m + torch.where(hide, float("-inf"), 0.0)[:, None]
        return m
    m = torch.where(cols <= start_pos + rows, 0.0, float("-inf"))[None, None]
    if pad_start is not None:
        hide = (cols[None] < pad_start[:, None, None]) & (cols != start_pos + rows)[None]
        m = m + torch.where(hide, float("-inf"), 0.0)[:, None]
    return m


def _kv_quantize(x):
    """[B,KvH,T,D] -> (int8 values, f32 scales [B,KvH,T]): symmetric
    per-token, per-head absmax quantization of new cache entries."""
    x = x.float()
    s = true_div(torch.clamp_min(x.abs().amax(-1), 1e-8), 127.0)
    q = torch.clamp(torch.round(x / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def _row_index(write_mask, device):
    """Row indices of a write mask (numpy/list on the host: no device sync)."""
    if isinstance(write_mask, torch.Tensor):
        return torch.nonzero(write_mask.to(device)).flatten()
    return upload(np.nonzero(np.asarray(write_mask, bool))[0], device)


def _cache_update(cache, new, start_pos, write_mask=None):
    """Write new [B,H,T,D] values (or [B,H,T] scales) into the cache IN
    PLACE at start_pos: a shared scalar or a per-row [B] vector. A window
    that would run past the cache end starts earlier instead, as JAX's
    dynamic_update_slice clamps. write_mask [B] (host bools, or a bool
    tensor) leaves unmasked rows' bytes untouched."""
    s, t = cache.shape[2], new.shape[2]
    new = new.to(cache.dtype)
    if not _is_vec(start_pos):
        assert write_mask is None
        p0 = max(0, min(int(start_pos), s - t))
        cache[:, :, p0:p0 + t] = new
        return cache
    rows = torch.arange(cache.shape[0], device=cache.device)
    if write_mask is not None:
        rows = _row_index(write_mask, cache.device)
        if rows.numel() == 0:
            return cache
        new, start_pos = new[rows], start_pos[rows]
    idx = torch.clamp(start_pos, 0, s - t)[:, None] + torch.arange(t, device=cache.device)
    cache[rows[:, None], :, idx] = new.movedim(2, 1)               # [R,T,H(,D)]
    return cache


def _product_f32(a, b):
    """``a @ b`` ([..., M, K] by [..., K, N]) with an f32 result, for the
    attention products, as the JAX package takes them: f32 operands in
    f32; bf16 operands (the bf16 and int8 KV caches) with f32 accumulation
    and an f32 output, so the scores are never rounded to bf16. On the card
    cuBLAS's bf16 GEMM writes the f32 output itself (``bmm``'s
    ``out_dtype``) and the cache is read as bf16; the CPU has no such GEMM,
    so there the bf16 operands are widened (exactly) and multiplied in f32."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def _rope_rows(freqs, start_pos, t: int):
    """The rope rows of positions start_pos .. start_pos + t - 1: [T,D] for
    a shared position, [B,T,D] per row (junk rows parked near the table's
    end clamp)."""
    s_len = freqs.shape[0]
    if _is_vec(start_pos):
        idx = torch.clamp(start_pos[:, None] + torch.arange(t, device=freqs.device),
                          max=s_len - 1)
        return freqs[idx]
    p0 = max(0, min(int(start_pos), s_len - t))
    return freqs[p0:p0 + t]


def _attention_block(p, pre, cfg: TransformerConfig, x, state, start_pos, freqs,
                     decode_attn=None, pad_start=None, write_mask=None):
    """GQA attention with a KV cache written in place. decode_attn, when
    given, replaces the T = 1 attention math (the decode kernel). A state
    with "k_s"/"v_s" holds int8 K/V with per-token scales."""
    b, t, _ = x.shape
    hd = cfg.head_dim
    q = F.linear(x, p[f"{pre}.attn_q.weight"], p.get(f"{pre}.attn_q.bias"))
    k = F.linear(x, p[f"{pre}.attn_k.weight"], p.get(f"{pre}.attn_k.bias"))
    v = F.linear(x, p[f"{pre}.attn_v.weight"], p.get(f"{pre}.attn_v.bias"))
    # head counts from the shapes: a tensor-parallel rank holds whole heads
    # (parallel.mesh.shard_llm_params)
    nkv = k.shape[-1] // hd
    nh = q.shape[-1] // (2 * hd if cfg.attn_output_gate else hd)
    if cfg.qk_norm and cfg.qk_norm != hd:
        q = F.rms_norm(q, p[f"{pre}.attn_q_norm.weight"], cfg.norm_eps)
        k = F.rms_norm(k, p[f"{pre}.attn_k_norm.weight"], cfg.norm_eps)
    gate = None
    if cfg.attn_output_gate:
        qg = q.reshape(b, t, nh, 2, hd)
        q, gate = qg[:, :, :, 0], qg[:, :, :, 1].reshape(b, t, nh * hd)
        q = q.reshape(b, t, nh * hd)
    q = q.reshape(b, t, nh, hd).transpose(1, 2)
    k = k.reshape(b, t, nkv, hd).transpose(1, 2)
    v = v.reshape(b, t, nkv, hd).transpose(1, 2)
    if cfg.qk_norm == hd:
        q = F.rms_norm(q, p[f"{pre}.attn_q_norm.weight"], cfg.norm_eps)
        k = F.rms_norm(k, p[f"{pre}.attn_k_norm.weight"], cfg.norm_eps)
    fr = _rope_rows(freqs, start_pos, t)
    rd = cfg.rope_dim
    q = torch.cat([apply_rope(q[..., :rd], fr), q[..., rd:]], -1)
    k = torch.cat([apply_rope(k[..., :rd], fr), k[..., rd:]], -1)

    if "k_s" in state:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        for name, val in (("k", kq), ("v", vq), ("k_s", ks), ("v_s", vs)):
            _cache_update(state[name], val, start_pos, write_mask)
    else:
        _cache_update(state["k"], k, start_pos, write_mask)
        _cache_update(state["v"], v, start_pos, write_mask)
    if decode_attn is not None and t == 1:
        out = decode_attn(q, state, start_pos, pad_start)
    else:
        if "k_s" in state:
            # the plain route's dequantized bf16 copy of the whole cache
            # (the decode kernels read the int8 bytes and their scales)
            ck_a = (state["k"].float() * state["k_s"][..., None]).to(torch.bfloat16)
            cv_a = (state["v"].float() * state["v_s"][..., None]).to(torch.bfloat16)
        else:
            ck_a, cv_a = state["k"], state["v"]
        # grouped-query products, no repeat of the cache
        rep = nh // nkv
        qg = (q.float() * cfg.head_dim ** -0.5).reshape(b, nkv, rep * t, hd) \
            .to(ck_a.dtype)
        scores = _product_f32(qg, ck_a.transpose(-1, -2)) \
            .reshape(b, nkv, rep, t, -1)
        mask = _attn_mask(start_pos, t, cfg.max_context, pad_start, x.device)
        probs = torch.softmax(scores + mask[:, :, None], -1)
        out = _product_f32(probs.reshape(b, nkv, rep * t, -1).to(cv_a.dtype), cv_a)
        out = out.reshape(b, nh, t, hd)
    out = out.transpose(1, 2).reshape(b, t, nh * hd).to(x.dtype)
    if gate is not None:
        out = out * torch.sigmoid(gate)
    return _linear_out(p, f"{pre}.attn_output.weight", out), state


def _mla_block(p, pre, cfg: TransformerConfig, x, state, start_pos, freqs,
               pad_start=None, write_mask=None):
    """DeepSeek MLA latent-KV attention (clearcam_tpu/models/llm.py:316-365),
    in the latent-absorbed form: q_nope is projected through ``attn_k_b``
    into the latent space, each position's cache row is [c_kv || k_rope]
    (kv_lora_rank + rope_dim wide, one head), V is the row's latent slice,
    and the attended latent goes out through ``attn_v_b``; the scale is
    head_dim ** -0.5 with head_dim = nope + rope. A state with "kv_s" holds
    the rows in int8 with one scale per position, for K and V at once.
    The products run in f32 (the JAX package widens the bf16 3-D
    projections and the cache)."""
    b, t, _ = x.shape
    nope = cfg.head_dim - cfg.rope_dim
    if cfg.q_lora_rank > 0:
        qa = F.rms_norm(F.linear(x, p[f"{pre}.attn_q_a.weight"]),
                        p[f"{pre}.attn_q_a_norm.weight"], cfg.norm_eps)
        qp = F.linear(qa, p[f"{pre}.attn_q_b.weight"])
    else:
        qp = F.linear(x, p[f"{pre}.attn_q.weight"])
    q = qp.reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    fr = _rope_rows(freqs, start_pos, t)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    # [B,H,T,nope] through attn_k_b [H, lora, nope] -> [B,H,T,lora]
    q_lat = torch.einsum("bhtn,hln->bhtl", q_nope.float(),
                         p[f"{pre}.attn_k_b.weight"].float())
    q = torch.cat([q_lat, apply_rope(q_rope.float(), fr)], -1)

    kv_a = F.linear(x, p[f"{pre}.attn_kv_a_mqa.weight"])
    lora = cfg.kv_lora_rank
    c_kv = F.rms_norm(kv_a[..., :lora], p[f"{pre}.attn_kv_a_norm.weight"], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., lora:].reshape(b, t, 1, cfg.rope_dim).transpose(1, 2), fr)
    k_new = torch.cat([c_kv[:, None], k_rope], -1)               # [B,1,T,lora+rope]
    if "kv_s" in state:
        kq, ks = _kv_quantize(k_new)
        _cache_update(state["kv"], kq, start_pos, write_mask)
        _cache_update(state["kv_s"], ks, start_pos, write_mask)
        k = state["kv"].float() * state["kv_s"][..., None]
    else:
        _cache_update(state["kv"], k_new, start_pos, write_mask)
        k = state["kv"].float()
    v = k[..., :lora]
    mask = _attn_mask(start_pos, t, cfg.max_context, pad_start, x.device)
    # the one latent head serves all H query heads: [B,1,H*T,.] products,
    # not a broadcast over H (which would copy the cache H times)
    h = cfg.n_heads
    scores = torch.matmul(q.reshape(b, 1, h * t, -1), k.transpose(-1, -2)) \
        .reshape(b, h, t, -1) * (cfg.head_dim ** -0.5) + mask
    ctx_lat = torch.matmul(torch.softmax(scores, -1).reshape(b, 1, h * t, -1), v) \
        .reshape(b, h, t, lora)
    # through attn_v_b [H, v, lora] -> [B,H,T,v]
    out = torch.einsum("bhtl,hvl->bhtv", ctx_lat, p[f"{pre}.attn_v_b.weight"].float())
    out = out.transpose(1, 2).reshape(b, t, -1).to(x.dtype)
    return F.linear(out, p[f"{pre}.attn_output.weight"]), state


def _as_mask(m, device) -> torch.Tensor:
    """A [B] bool mask (host bools or a tensor) on ``device``."""
    if isinstance(m, torch.Tensor):
        return m.to(device=device, dtype=torch.bool)
    return upload(np.asarray(m, bool), device)


def _ssm_block(p, pre, cfg: TransformerConfig, x, state, start_pos, freqs, live=None):
    """One GatedDeltaNet step, T = 1 (clearcam_tpu/models/llm.py:368-420):
    the causal conv over a window of conv_kernel - 1 earlier rows and this
    one, L2-normed q and k tiled over the nv // nk value heads, the gated
    delta rule on rec [B, nv, dv, dv] in f32 (stored in the state's dtype),
    an RMS norm and the SiLU output gate. The state is written in place;
    rows where ``live`` [B] is False keep their conv window and recurrent
    state bit for bit (the left pads of a batched prompt, slots not
    prefilling or decoding), as a recurrence would ingest junk forever."""
    ssm = cfg.ssm
    b = x.shape[0]
    nk, nv = ssm.group_count, ssm.time_step_rank
    dk, dv = ssm.state_size, ssm.inner_size // nv
    conv_ch = ssm.inner_size + 2 * nk * dk
    q_dim = nk * dk

    out_gate = F.linear(x, p[f"{pre}.attn_gate.weight"]).reshape(b, 1, nv, dv)
    beta = torch.sigmoid(F.linear(x, p[f"{pre}.ssm_beta.weight"])).reshape(b, nv, 1, 1)
    alpha_in = F.linear(x, p[f"{pre}.ssm_alpha.weight"]).float()
    alpha = torch.exp((torch.nn.functional.softplus(alpha_in + p[f"{pre}.ssm_dt.bias"])
                       * p[f"{pre}.ssm_a"]).reshape(b, nv, 1, 1))

    qkv = F.linear(x, p[f"{pre}.attn_qkv.weight"])                  # [B,1,conv_ch]
    conv, rec0 = state["conv"], state["rec"]
    wdt = torch.promote_types(conv.dtype, qkv.dtype)
    window = torch.cat([conv.to(wdt), qkv.reshape(b, 1, conv_ch).to(wdt)], 1)
    conv_out = F.silu((window * p[f"{pre}.ssm_conv1d.weight"].T[None]).sum(1))
    q, k, v = (conv_out[:, :q_dim], conv_out[:, q_dim:2 * q_dim],
               conv_out[:, 2 * q_dim:])

    def _norm(u):
        return u / torch.sqrt((u ** 2).sum(-1, keepdim=True) + 1e-6)

    q = _norm(q.reshape(b, nk, dk)).repeat(1, nv // nk, 1) * dk ** -0.5
    k = _norm(k.reshape(b, nk, dk)).repeat(1, nv // nk, 1)
    v = v.reshape(b, nv, dv)
    q, k, v = q[..., None], k[..., None], v[..., None]

    rec = rec0.float() * alpha
    rec = rec + ((v - rec @ k) * beta) @ k.transpose(-1, -2)
    core = (rec @ q)[..., 0].reshape(b, 1, nv, dv)
    core = F.rms_norm(core, p[f"{pre}.ssm_norm.weight"], cfg.norm_eps)
    out = F.linear((core * F.silu(out_gate)).reshape(b, 1, -1).to(x.dtype),
                   p[f"{pre}.ssm_out.weight"])
    new_conv, new_rec = window[:, 1:].to(conv.dtype), rec.to(rec0.dtype)
    if live is not None:
        lv = _as_mask(live, x.device)
        new_conv = torch.where(lv[:, None, None], new_conv, conv)
        new_rec = torch.where(lv[:, None, None, None], new_rec, rec0)
    conv.copy_(new_conv)
    rec0.copy_(new_rec)
    return out, state


# ---------------------------------------------------------------------------
# full model step
# ---------------------------------------------------------------------------

def init_state(cfg: TransformerConfig, batch: int = 1, dtype=torch.float32,
               kv_quant: bool = False, device="cpu") -> list:
    """Preallocated per-block states, zero-filled: attention blocks a
    [B,KvH,S,D] K/V cache (f32, bf16, or int8 with f32 per-token scales
    [B,KvH,S] under kv_quant); MLA blocks one [B,1,S,lora+rope] latent
    cache (int8 with one scale per position [B,1,S] under kv_quant);
    GatedDeltaNet blocks a conv window [B,conv_kernel-1,conv channels] and
    a recurrent state [B,nv,dv,dv] in ``dtype``."""
    dev = resolve_device(device)

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    state = []
    for i in range(cfg.num_blocks):
        kind = cfg.block_kind(i)
        if kind == "attn":
            shape = (batch, cfg.n_kv_heads, cfg.max_context, cfg.head_dim)
            if kv_quant:
                state.append({"k": z(shape, torch.int8), "k_s": z(shape[:3], torch.float32),
                              "v": z(shape, torch.int8), "v_s": z(shape[:3], torch.float32)})
            else:
                state.append({"k": z(shape), "v": z(shape)})
        elif kind == "mla":
            shape = (batch, 1, cfg.max_context, cfg.kv_lora_rank + cfg.rope_dim)
            if kv_quant:
                state.append({"kv": z(shape, torch.int8), "kv_s": z(shape[:3], torch.float32)})
            else:
                state.append({"kv": z(shape)})
        else:
            ssm = cfg.ssm
            conv_ch = ssm.inner_size + 2 * ssm.group_count * ssm.state_size
            dv = ssm.inner_size // ssm.time_step_rank
            state.append({"conv": z((batch, ssm.conv_kernel - 1, conv_ch)),
                          "rec": z((batch, ssm.time_step_rank, dv, dv))})
    return state


def reset_recurrent(cfg: TransformerConfig, state: list) -> list:
    """Zero the GatedDeltaNet states in place after a prefix-cache
    divergence; attention caches need no reset (their rows are rewritten
    before any causal mask reaches them)."""
    for i, s in enumerate(state):
        if cfg.block_kind(i) == "ssm":
            for t in s.values():
                t.zero_()
    return state


def forward(p: dict, cfg: TransformerConfig, state: list, tokens, start_pos,
            freqs, hidden_override=None, deepstack=None, decode_attn=None,
            pad_start=None, write_mask=None, row_live=None):
    """Embeds -> blocks -> final hidden states [B,T,D] (f32), and ``state``
    written in place. start_pos: an int, or a [B] tensor of per-row
    positions; write_mask [B] keeps masked rows' caches untouched (batched
    multi-slot prefill). hidden_override [B,T,D] replaces the token
    embeddings (the VLM image splice); deepstack {block index: [B,T,D]} is
    added to the residual after that block (qwen3vl's deepstack features,
    as the JAX package's forward adds them). GatedDeltaNet blocks step one
    token (T = 1); row_live [B] keeps a row's recurrence where it is, and
    an SSM stack with pad_start or write_mask needs it (the recurrence
    would ingest the pads or the masked rows' junk)."""
    x = hidden_override if hidden_override is not None else \
        F.embedding(p["token_embd.weight"], tokens).float()
    for i in range(cfg.num_blocks):
        bc = cfg.block_cfg(i)
        pre = f"blk.{i}"
        kind = cfg.block_kind(i)
        h = F.rms_norm(x, p[f"{pre}.attn_norm.weight"], cfg.norm_eps)
        if kind == "attn":
            attn_out, _ = _attention_block(p, pre, bc, h, state[i], start_pos, freqs,
                                           decode_attn=decode_attn, pad_start=pad_start,
                                           write_mask=write_mask)
        elif kind == "mla":
            attn_out, _ = _mla_block(p, pre, bc, h, state[i], start_pos, freqs,
                                     pad_start=pad_start, write_mask=write_mask)
        else:
            assert write_mask is None or row_live is not None, \
                "a write-masked forward over SSM blocks needs row_live"
            assert pad_start is None or row_live is not None, \
                "left-padded rows over SSM blocks need row_live"
            attn_out, _ = _ssm_block(p, pre, bc, h, state[i], start_pos, freqs,
                                     live=row_live)
        x = x + attn_out
        x = x + _ffn(p, pre, bc, F.rms_norm(x, p[f"{pre}.ffn_norm.weight"],
                                            cfg.norm_eps))
        if deepstack is not None and i in deepstack:
            x = x + deepstack[i]
    return x, state


def logits_at(p: dict, cfg: TransformerConfig, hidden, index: int):
    h = F.rms_norm(hidden[:, index], p["output_norm.weight"], cfg.norm_eps)
    return F.linear(h, p["output.weight"])


def make_score_fn(cfg: TransformerConfig):
    """Chunked teacher-forcing scorer (the OpenAI completions ``echo``
    surface): ``score(params, tokens) -> [N-1] rows`` where row i-1 is
    (chosen_lp, [(alt_id, alt_lp) x LP_K]) scoring tokens[i] given
    tokens[:i]. SSM stacks step each chunk a token at a time, its padding
    included (it follows the last real token, so nothing reads it)."""
    kk = min(LP_K, cfg.vocab_size)
    sc = 128 if cfg.max_context % 128 == 0 else CHUNK

    @torch.inference_mode()
    def score(params, tokens):
        toks = [int(t) for t in tokens]
        n = len(toks)
        n_chunks = -(-n // sc)
        assert n >= 1 and n_chunks * sc <= cfg.max_context, \
            "prompt (chunk-padded) must fit max_context"
        dev = params["output_norm.weight"].device
        freqs = freqs_for(cfg, dev)
        state = init_state(cfg, 1, device=dev)
        padded = toks + [0] * (n_chunks * sc - n)
        rows = []
        for c in range(n_chunks):
            lo = c * sc
            tgt = torch.tensor([(padded + [0])[lo + 1:lo + 1 + sc]], device=dev)
            toks = torch.tensor([padded[lo:lo + sc]], device=dev)
            if cfg.ssm is None:
                hidden, _ = forward(params, cfg, state, toks, lo, freqs)
            else:       # the recurrence steps the chunk one token at a time
                hidden = torch.cat([forward(params, cfg, state, toks[:, j:j + 1], lo + j,
                                            freqs)[0] for j in range(sc)], 1)
            h = F.rms_norm(hidden, params["output_norm.weight"], cfg.norm_eps)
            lp = torch.log_softmax(F.linear(h, params["output.weight"]).float(), -1)
            chosen = lp.gather(-1, tgt[..., None])[..., 0]
            top_lp, top_id = torch.topk(lp, kk)
            rows.append((chosen[0], top_lp[0], top_id[0]))
        rows = [tuple(a.cpu().numpy() for a in r) for r in rows]
        out = []
        for i in range(1, n):
            c, o = divmod(i - 1, sc)
            ch, tl, ti = rows[c]
            out.append((float(ch[o]), list(zip(ti[o].astype(np.int64).tolist(),
                                               tl[o].tolist()))))
        return out

    return score


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def pack_samp(temperature=0.0, top_p=1.0, top_k=0, min_p=0.0, presence=0.0,
              frequency=0.0, repetition=1.0, bias_active=0.0) -> torch.Tensor:
    """The [8] f32 sampling row: (temperature, top_p, top_k, min_p,
    presence, frequency, repetition, bias_active); everything off is
    (t, 1, 0, 0, 0, 0, 1, 0)."""
    return torch.tensor([temperature, top_p, float(top_k), min_p, presence,
                         frequency, repetition, bias_active], dtype=torch.float32)


def _samp_of(t) -> torch.Tensor:
    """A packed spec as f32: an [8] or [B, 8] row (pack_samp's layout)."""
    t = torch.as_tensor(t, dtype=torch.float32)
    if t.dim() not in (1, 2) or t.shape[-1] != SAMP_W:
        raise ValueError(f"a sampling spec is an [{SAMP_W}] or [B, {SAMP_W}] row "
                         f"(pack_samp), got shape {tuple(t.shape)}")
    return t


def samp_flags(samp) -> tuple[bool, bool, bool]:
    """(penalties on, logit bias on, filters on) for a packed spec, read on
    the host: the serving graphs pass their host copy, so no step waits on
    the card to decide."""
    s = np.asarray(samp.cpu() if isinstance(samp, torch.Tensor) else samp,
                   np.float32).reshape(-1, SAMP_W)
    pen = bool(np.any((s[:, 4] != 0) | (s[:, 5] != 0) | (s[:, 6] != 1)))
    return pen, bool(np.any(s[:, 7] != 0)), \
        bool(np.any((s[:, 1] < 1) | (s[:, 2] > 0.5) | (s[:, 3] > 0)))


def _col(x, lg):
    """A per-row scalar aligned against logits' last (vocab) axis."""
    return x[..., None] if x.dim() == lg.dim() - 1 else x


def _processed_logits(logits, samp, counts_p=None, counts_o=None, bias=None,
                      cmask=None, flags=None):
    """Penalties, logit bias and the grammar mask applied, in f32: the
    distribution logprobs report over (before temperature and filters).
    samp is a normalized [8] or [B,8] row on logits' device."""
    pen_on, bias_on, _ = samp_flags(samp) if flags is None else flags
    lg = logits.float()
    if counts_o is not None and pen_on:
        pres, freq, rep = (_col(samp[..., i], lg) for i in (4, 5, 6))
        c_o = counts_o.float()
        c_all = c_o if counts_p is None else c_o + counts_p.float()
        lg = torch.where(c_all > 0, torch.where(lg > 0, lg / rep, lg * rep), lg)
        lg = lg - freq * c_o - pres * (c_o > 0).float()
    if bias is not None and bias_on:
        has = _col(samp[..., 7], lg)
        lg = lg + torch.where(has != 0, bias, 0.0)
    if cmask is not None:
        lg = torch.where(cmask, _NEG, lg)
    return lg


def gumbel(u):
    """Gumbel noise from uniforms in [0, 1), floored at f32's tiny as
    ``jax.random.gumbel`` draws them."""
    return -torch.log(-torch.log(torch.clamp_min(u, _TINY)))


def _mix(*vals) -> int:
    """A fixed 63-bit integer mix (splitmix64 steps) of the given ints."""
    h = 0x9E3779B97F4A7C15
    for v in vals:
        h = (h ^ (int(v) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        h = (h + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h >> 1


def row_noise(base_seed: int, seeds, idx, vocab: int, device) -> torch.Tensor:
    """[B, vocab] Gumbel noise, row b from its own generator seeded by
    (base_seed, seeds[b], idx[b]) only: a seeded request redraws the same
    noise on any slot, beside any companions (the port's form of the JAX
    package's serving_row_keys contract)."""
    return gumbel(_row_uniforms(base_seed, seeds, idx, vocab, device))


def _row_uniforms(base_seed: int, seeds, idx, vocab: int, device, out=None) -> torch.Tensor:
    """row_noise's uniforms before the Gumbel transform, [B, vocab]; drawn
    into the rows of ``out`` where given (a CUDA graph's static input)."""
    rows = []
    for b, (s, i) in enumerate(zip(np.asarray(seeds).tolist(), np.asarray(idx).tolist())):
        g = torch.Generator(device=device)
        g.manual_seed(_mix(base_seed, s, i))
        if out is None:
            rows.append(torch.rand(vocab, generator=g, device=device))
        else:
            torch.rand(vocab, generator=g, out=out[b])
    return torch.stack(rows) if out is None else out


def _draw(lg, samp, noise, flags=None):
    """Temperature scale -> top-k/top-p/min-p filters -> Gumbel-max with
    the given noise (same shape as lg)."""
    _, _, filt_on = samp_flags(samp) if flags is None else flags
    t, top_p, top_k, min_p = (_col(samp[..., i], lg) for i in range(4))
    scaled = lg / torch.clamp_min(t, 1e-12)
    if filt_on:
        s = torch.sort(scaled, -1, descending=True).values
        v = s.shape[-1]
        k = torch.clamp(top_k.to(torch.int32) - 1, 0, v - 1).long()
        kth = s.gather(-1, k.expand(*s.shape[:-1], 1))
        thr_k = torch.where(top_k > 0.5, kth, _NEG)
        pr = torch.softmax(s, -1)
        before = torch.cumsum(pr, -1) - pr
        keep = before < top_p
        keep[..., 0] = True
        n_keep = keep.sum(-1, keepdim=True)
        thr_p = s.gather(-1, n_keep - 1)
        thr_m = torch.where(min_p > 0.0,
                            s[..., :1] + torch.log(torch.clamp_min(min_p, 1e-12)), _NEG)
        thr = torch.maximum(torch.maximum(thr_k, thr_p), thr_m)
        scaled = torch.where(scaled >= thr, scaled, _NEG)
    return torch.argmax(scaled + noise, -1)


def sample_filtered(logits, samp, noise, counts_p=None, counts_o=None, bias=None,
                    cmask=None, flags=None):
    """Gumbel-max sampling with penalties, logit bias, the grammar mask and
    top-p/k/min-p filters (the JAX package's sample_filtered, with the
    noise given). Greedy rows (temperature 0) take the argmax."""
    samp = _samp_of(samp).to(logits.device)
    flags = samp_flags(samp) if flags is None else flags
    lg = _processed_logits(logits, samp, counts_p, counts_o, bias, cmask, flags)
    return _draw(lg, samp, noise, flags)


def sample_filtered_lp(logits, samp, noise, counts_p=None, counts_o=None,
                       bias=None, k: int = LP_K, cmask=None, flags=None):
    """sample_filtered and a packed logprob row per sample, [chosen_lp,
    top-k lps (desc), top-k ids (as f32)] -> [..., 1 + 2k], over the
    post-penalty/bias, pre-temperature distribution."""
    samp = _samp_of(samp).to(logits.device)
    flags = samp_flags(samp) if flags is None else flags
    lg = _processed_logits(logits, samp, counts_p, counts_o, bias, cmask, flags)
    tok = _draw(lg, samp, noise, flags)
    lp = torch.log_softmax(lg, -1)
    kk = min(k, logits.shape[-1])
    top_lp, top_id = torch.topk(lp, kk)
    if kk < k:              # pad to the fixed [1+2k] row
        shp = top_lp.shape[:-1] + (k - kk,)
        top_lp = torch.cat([top_lp, top_lp.new_full(shp, _NEG)], -1)
        top_id = torch.cat([top_id, top_id.new_zeros(shp)], -1)
    chosen = lp.gather(-1, tok[..., None])
    return tok, torch.cat([chosen, top_lp, top_id.float()], -1)


# ---------------------------------------------------------------------------
# continuous-batching serving graphs
# ---------------------------------------------------------------------------

def upload(a, device) -> torch.Tensor:
    """A host array on ``device``. CUDA uploads go through pinned memory
    without blocking, so a step never waits for the card's queue to drain."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def _stack_refusal(cfg: TransformerConfig) -> str | None:
    """The blocks' part of ``_graph_refusal``, fixed with the config."""
    kinds = {cfg.block_kind(i) for i in range(cfg.num_blocks)}
    if "ssm" in kinds:
        return "ssm"
    if "mla" in kinds:
        return "mla"
    if any(cfg.block_cfg(i).num_experts > 0 for i in range(cfg.num_blocks)):
        return "moe"
    return None


def _graph_refusal(stack: str | None, params, device) -> str | None:
    """Why decode_all runs eagerly rather than as a CUDA graph, or None,
    from what the call can see: ``stack``, ``_stack_refusal``'s reason
    (``ssm`` and ``mla``, a stack with GatedDeltaNet or MLA blocks;
    ``moe``, routed experts: ``_moe_experts`` reads each call's expert
    counts to the host); ``tp``, params with tensor-parallel splits (their
    reductions go over gloo or NCCL outside any graph); else the device's
    type where it is not CUDA."""
    why = stack
    if why is None:
        tp = getattr(params, "tp", None)
        if tp is not None and tp.split:
            why = "tp"
        elif device.type != "cuda":
            why = device.type
    return why


def _launch_counters():
    """The hand kernels' wrappers a decode step can call, each counting its
    launches in ``.launches``."""
    from ..ops import decode_attention as dec
    from ..ops.quant_matmul import quant_linear
    return (quant_linear, dec.decode_attention_batch, dec.decode_attention_batch_q8,
            dec.decode_attention, dec.decode_attention_q8)


class _Graph:
    """One captured decode step and its static inputs and outputs. The host
    inputs (meta, samp) go in as one copy of their bytes, the uniforms are
    drawn into their buffer, and the device tensors the engine replaces
    between calls (prev_tok, first_tok, cstate) are copied in; the outputs
    are copied out, since the engine holds them for ``sync_lag`` steps.
    The capture runs no kernel, so the hand kernels' ``launches`` counters
    take back what it counted, and each replay adds it again."""

    def __init__(self, step, vocab: int, params, state, prev_tok, first_tok, meta, samp,
                 flags, cnt_o, cnt_p, bias, ctab, cstate):
        dev = first_tok.device
        self.host = torch.empty(meta.nbytes + samp.nbytes, dtype=torch.uint8, device=dev)
        m = self.host[:meta.nbytes].view(torch.int32).view(meta.shape)
        s = self.host[meta.nbytes:].view(torch.float32).view(samp.shape)
        self.u = torch.empty((samp.shape[0], vocab), device=dev)
        self.ins = [torch.empty_like(t) for t in (prev_tok, first_tok, cstate)]
        self.graph = torch.cuda.CUDAGraph()
        counters = _launch_counters()
        before = [f.launches for f in counters]
        with torch.cuda.device(dev), \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outs = step(params, state, self.ins[0], self.ins[1], m, s, self.u, cnt_o,
                             cnt_p, bias, ctab, self.ins[2], flags)
        self.launches = [(f, f.launches - n) for f, n in zip(counters, before)
                         if f.launches != n]
        for f, n in self.launches:
            f.launches -= n

    def __call__(self, draw, prev_tok, first_tok, meta, samp, cstate):
        host = np.concatenate([meta.reshape(-1).view(np.uint8), samp.reshape(-1).view(np.uint8)])
        with torch.cuda.device(self.host.device):
            self.host.copy_(torch.from_numpy(host).pin_memory(), non_blocking=True)
            draw(self.u)
            for dst, src in zip(self.ins, (prev_tok, first_tok, cstate)):
                dst.copy_(src)
            self.graph.replay()
            for f, n in self.launches:
                f.launches += n
            return tuple(t.clone() for t in self.outs)


class _DecodeGraphs:
    """decode_all as CUDA graphs, one per key: the sampling flags, the batch,
    the params and the data pointers of the buffers the engine keeps and
    updates in place (state, cnt_o, cnt_p, bias, ctab). A key's first call
    runs eagerly, which makes what the step keeps across calls (the rope
    and inert tables, the kernels' counters) and warms the allocator; its
    second captures the step and replays it; later calls replay. A call
    with other buffers (after ``reset_device`` or a recovery) drops every
    graph of the old ones. Where ``_graph_refusal`` gives a reason every
    call runs eagerly. Each call is a ``serving.decode_graph`` span whose
    attribute is ``replay``, ``capture`` or ``eager:<reason>`` (the reason
    ``warmup`` for a key's first call), and counts one of
    ``serving.graph.replays``, ``.captures``, ``.eager``."""

    def __init__(self, step, vocab: int):
        self.step, self.vocab = step, vocab
        self.params = self.ptrs = None   # what the graphs kept were captured on
        self.graphs: dict = {}           # (flags, batch) -> _Graph, or None once warm

    def __call__(self, why, draw, params, state, prev_tok, first_tok, meta, samp, flags,
                 cnt_o, cnt_p, bias, ctab, cstate):
        key = graph = None
        if why is None:
            ptrs = (cnt_o.data_ptr(), cnt_p.data_ptr(), bias.data_ptr(), ctab.data_ptr(),
                    *(t.data_ptr() for s in state for t in s.values()))
            if params is not self.params or ptrs != self.ptrs:
                self.params, self.ptrs, self.graphs = params, ptrs, {}
            key = (flags, first_tok.shape[0])
            if key in self.graphs:
                graph = self.graphs[key]
            else:
                why = "warmup"
        mode = f"eager:{why}" if why else "replay" if graph is not None else "capture"
        with metrics.timer("serving.decode_graph", attr=mode):
            if why:
                metrics.count("serving.graph.eager")
                if key is not None:
                    self.graphs[key] = None
                dev = first_tok.device
                return self.step(params, state, prev_tok, first_tok, upload(meta, dev),
                                 upload(samp, dev), draw(), cnt_o, cnt_p, bias, ctab, cstate,
                                 flags)
            if graph is None:
                metrics.count("serving.graph.captures")
                graph = self.graphs[key] = _Graph(
                    self.step, self.vocab, params, state, prev_tok, first_tok, meta, samp,
                    flags, cnt_o, cnt_p, bias, ctab, cstate)
            else:
                metrics.count("serving.graph.replays")
            return graph(draw, prev_tok, first_tok, meta, samp, cstate)


def make_serving_fns(cfg: TransformerConfig, use_pallas_decode: bool = False,
                     constraints: bool = False, kv_quant: bool = False,
                     spec_lookup: int = 0):
    """The serving graphs ``serving.engine.ServingEngine`` drives
    (clearcam_tpu.models.llm.make_serving_fns). Host inputs (tokens, meta
    rows, sampling specs) arrive as numpy and are uploaded once per call;
    device buffers (state, first_tok, counts, bias, the constraint table
    and states) stay on the card. spec_lookup=G returns the speculative
    graphs instead (``_make_spec_serving_fns``).

    prefill_slot(params, state, first_tok[B], first_lp[B,1+2K],
                 tokens[1,CHUNK], slot, start_pos, n_real, samp[8], seed,
                 base_seed, cnt_p, cnt_o, bias) -> (first_tok', first_lp', state)
        advances one slot's prompt by a chunk, on the slot's view of the
        state in place; the chunk's sampled token lands in a NEW first_tok
        tensor at ``slot``.
    decode_all(params, state, prev_tok[B], first_tok[B], meta[5,B],
               samp[B,8], base_seed, cnt_o, cnt_p, bias)
        -> (token [B], state, cnt_o, lp [B,1+2K])
        one token for every slot; meta rows are [pos, live, inject, seed,
        plen]. Row b consumes first_tok[b] where inject, prev_tok[b]
        otherwise, writes its K/V at pos[b] and attends cols <= pos[b];
        its noise is keyed by (seed, pos - plen + 1). cnt_o is updated in
        place with each live row's consumed token. On CUDA it replays a
        CUDA graph of the whole step (``_DecodeGraphs``: the same kernels,
        one launch from the host) unless ``_graph_refusal`` says why not.
    prefill_many(params, state, first_tok, first_lp, tokens[B,CHUNK],
                 meta[4,B] [start_pos, n_real, valid, seed], samp[B,8],
                 base_seed, cnt_p, cnt_o, bias) -> (first_tok', first_lp', state)
        advances every valid row by a chunk in one weight sweep; invalid
        rows' caches stay bit-identical (write_mask).

    GatedDeltaNet stacks (clearcam_tpu/models/llm.py:1333-1341, 1437-1500):
    a slot's first chunk (start_pos 0) zeroes its recurrent state, since a
    new occupant must not inherit the retired request's; decode_all steps
    only live rows' recurrences; prefill_many steps the chunk one token at
    a time over every valid row, row_live and write_mask both
    valid & (t < n_real) per token, up to the longest valid n_real.

    constraints=True: the graphs also take (ctab [S,V] int16, cinit [B],
    cstate [B]) — decode_all only (ctab, cstate) — mask disallowed tokens
    and return the advanced grammar states last (serving/constrain.py).

    use_pallas_decode routes decode_all's attention through the batched
    decode kernel (``ops.decode_attention``; its plain version on the CPU):
    ``decode_attention_batch`` over f32/bf16 caches, or, with kv_quant,
    ``decode_attention_batch_q8`` over the int8 cache and its scales (the
    JAX package's graphs run this pair without the scales,
    clearcam_tpu/models/llm.py:1316-1318; the port's are held to the JAX
    engine's plain int8 route).

    spec_lookup keeps the reference's exclusions (llm.py:1280-1288): no
    constraints, no use_pallas_decode (a verify window has G+1 queries, the
    decode kernels take one) and no SSM stack (a rejected draft's
    recurrent-state update cannot be rolled back). use_pallas_decode is
    refused on SSM stacks, as the JAX package asserts (llm.py:1314).
    """
    if spec_lookup and cfg.ssm is not None:
        raise ValueError("spec_lookup needs attention or MLA blocks only: a rejected "
                         "draft's GatedDeltaNet state update cannot be rolled back")
    if use_pallas_decode and cfg.ssm is not None:
        raise ValueError("use_pallas_decode serves attention-only stacks (as "
                         "clearcam_tpu/models/llm.py:1314 asserts), not GatedDeltaNet ones")
    if spec_lookup:
        if use_pallas_decode:
            raise ValueError(
                "spec_lookup and use_pallas_decode are mutually exclusive (as in "
                "clearcam_tpu/models/llm.py:1284): a verify window has G+1 queries, "
                "the decode kernels take one")
        if constraints:
            raise ValueError("constrained decoding and spec_lookup are mutually exclusive "
                             "(a drafted window has no per-position grammar state)")
        return _make_spec_serving_fns(cfg, int(spec_lookup))
    _freqs = _freqs_per_device(cfg)

    def _con_mask(ctab, cst, extra_live=None):
        crow = ctab[torch.clamp_min(cst, 0).long()]
        con = cst >= 0
        if extra_live is not None:
            con = con & extra_live
        return con[:, None] & (crow < 0), con, crow

    def _con_advance(con, crow, tok, cst):
        nxt = crow.gather(-1, tok[:, None].long())[:, 0].to(torch.int32)
        return torch.where(con & (nxt >= 0), nxt, cst)

    attn_impl = None
    if use_pallas_decode:
        batch_impl = decode_attn_impl(True, kv_quant)

        def attn_impl(q, st, pos_vec, pads):              # [B,H,1,D] -> [B,H,1,D]
            if ("k_s" in st) != kv_quant:
                raise ValueError(f"serving graphs made with kv_quant={kv_quant} driven "
                                 f"with {'an int8' if 'k_s' in st else 'a float'} KV cache")
            return batch_impl(q, st, pos_vec, pads)

    def _prefill_many_ssm(params, state, toks, meta, freqs):
        """prefill_many's hidden states [B,CHUNK,D] on a GatedDeltaNet
        stack: fresh valid rows' recurrences zeroed, then the chunk one
        token at a time, row_live = write_mask = valid & (t < n_real);
        steps past the longest valid row are not run (zero rows)."""
        valid_np = meta[2] != 0
        fresh = np.nonzero(valid_np & (meta[0] == 0))[0]
        if len(fresh):
            rows = upload(fresh, toks.device)
            for i, s in enumerate(state):
                if cfg.block_kind(i) == "ssm":
                    for t in s.values():
                        t.index_fill_(0, rows, 0)
        b_n, width = toks.shape
        hidden = torch.zeros((b_n, width, cfg.dim), device=toks.device)
        for t in range(int(np.max(np.where(valid_np, meta[1], 0), initial=0))):
            # row_live goes to every SSM block: one upload a token, not one a block
            live_t = valid_np & (t < meta[1])
            pos_t = upload(np.minimum(meta[0] + t, cfg.max_context - 1), toks.device)
            hidden[:, t] = forward(params, cfg, state, toks[:, t:t + 1], pos_t, freqs,
                                   row_live=upload(live_t, toks.device),
                                   write_mask=live_t)[0][:, 0]
        return hidden

    @torch.inference_mode()
    def prefill_slot_c(params, state, first_tok, first_lp, tokens, slot, start_pos,
                       n_real, samp, seed, base_seed, cnt_p, cnt_o, bias, ctab,
                       cinit, cstate):
        dev = first_tok.device
        st_b = [{k: v[slot:slot + 1] for k, v in s.items()} for s in state]
        if int(start_pos) == 0:
            reset_recurrent(cfg, st_b)      # a new occupant's recurrence starts at 0
        h, _ = _prefill_hidden(params, cfg, st_b, upload(np.asarray(tokens, np.int64), dev),
                               int(start_pos), int(n_real), _freqs(dev))
        h = F.rms_norm(h, params["output_norm.weight"], cfg.norm_eps)
        # constraint context from the admission state: every chunk re-derives
        # "state after the first generated token", so the final chunk lands it
        ci = cinit[slot:slot + 1]
        cmask, con, crow = _con_mask(ctab, ci)
        samp_np = np.asarray(samp, np.float32).reshape(1, SAMP_W)
        tok, lp = sample_filtered_lp(
            F.linear(h, params["output.weight"]), upload(samp_np, dev),
            row_noise(base_seed, [seed], [0], cfg.vocab_size, dev),
            cnt_p[slot:slot + 1], cnt_o[slot:slot + 1], bias[slot:slot + 1],
            cmask=cmask, flags=samp_flags(samp_np))
        cstate = cstate.clone()
        cstate[slot:slot + 1] = _con_advance(con, crow, tok, ci)
        first_tok = first_tok.clone()
        first_tok[slot:slot + 1] = tok.to(first_tok.dtype)
        first_lp = first_lp.clone()
        first_lp[slot:slot + 1] = lp
        return first_tok, first_lp, state, cstate

    def decode_step(params, state, prev_tok, first_tok, m, samp_d, u, cnt_o, cnt_p,
                    bias, ctab, cstate, flags):
        """decode_all's device work, from device inputs alone (what its CUDA
        graph holds): m the [5,B] meta rows, samp_d the [B,8] specs, u the
        rows' uniforms for the Gumbel noise -> (token [B], lp, cstate')."""
        dev = first_tok.device
        pos, live = m[0], m[1] != 0
        token = torch.where(m[2] != 0, first_tok, prev_tok)[:, None]
        # the consumed token joins its row's output histogram before sampling
        b_n = token.shape[0]
        cnt_o.index_put_((torch.arange(b_n, device=dev), token[:, 0].long()),
                         live.to(cnt_o.dtype), accumulate=True)
        hidden, _ = forward(params, cfg, state, token, pos, _freqs(dev),
                            decode_attn=attn_impl,
                            row_live=live if cfg.ssm is not None else None)
        logits = logits_at(params, cfg, hidden, 0)
        cmask, con, crow = _con_mask(ctab, cstate, live)
        tok, lp = sample_filtered_lp(logits, samp_d, gumbel(u), cnt_p, cnt_o, bias,
                                     cmask=cmask, flags=flags)
        return tok.to(torch.int32), lp, _con_advance(con, crow, tok, cstate)

    graphs = _DecodeGraphs(decode_step, cfg.vocab_size)
    stack = _stack_refusal(cfg)

    @torch.inference_mode()
    def decode_all_c(params, state, prev_tok, first_tok, meta, samp, base_seed,
                     cnt_o, cnt_p, bias, ctab, cstate):
        dev = first_tok.device
        meta = np.asarray(meta, np.int32)
        samp_np = np.asarray(samp, np.float32).reshape(-1, SAMP_W)

        def draw(out=None):
            return _row_uniforms(base_seed, meta[3], meta[0] - meta[4] + 1,
                                 cfg.vocab_size, dev, out)
        tok, lp, cst = graphs(_graph_refusal(stack, params, dev), draw, params, state,
                              prev_tok, first_tok, meta, samp_np, samp_flags(samp_np),
                              cnt_o, cnt_p, bias, ctab, cstate)
        return tok, state, cnt_o, lp, cst

    @torch.inference_mode()
    def prefill_many_c(params, state, first_tok, first_lp, tokens, meta, samp,
                       base_seed, cnt_p, cnt_o, bias, ctab, cinit, cstate):
        dev = first_tok.device
        meta = np.asarray(meta, np.int32)
        valid_np = meta[2] != 0
        m = upload(meta, dev)
        starts, n_real, valid = m[0], m[1], m[2] != 0
        toks = upload(np.asarray(tokens, np.int64), dev)
        if cfg.ssm is None:
            hidden, _ = forward(params, cfg, state, toks, starts, _freqs(dev),
                                write_mask=valid_np)
        else:
            hidden = _prefill_many_ssm(params, state, toks, meta, _freqs(dev))
        h = hidden.gather(1, torch.clamp_min(n_real - 1, 0).long()[:, None, None]
                          .expand(-1, 1, hidden.shape[-1]))[:, 0]
        h = F.rms_norm(h, params["output_norm.weight"], cfg.norm_eps)
        cmask, con, crow = _con_mask(ctab, cinit, valid)
        samp_np = np.asarray(samp, np.float32).reshape(-1, SAMP_W)
        tok, lp = sample_filtered_lp(
            F.linear(h, params["output.weight"]), upload(samp_np, dev),
            row_noise(base_seed, meta[3], np.zeros_like(meta[3]), cfg.vocab_size, dev),
            cnt_p, cnt_o, bias, cmask=cmask, flags=samp_flags(samp_np))
        # a reused slot whose new occupant is unconstrained must not keep
        # the retired request's state; invalid rows keep theirs
        cstate = torch.where(valid, _con_advance(con, crow, tok, cinit), cstate)
        first_tok = torch.where(valid, tok.to(first_tok.dtype), first_tok)
        first_lp = torch.where(valid[:, None], lp, first_lp)
        return first_tok, first_lp, state, cstate

    if constraints:
        return prefill_slot_c, decode_all_c, prefill_many_c

    inert: dict = {}

    def _inert(first_tok):
        key = (first_tok.device, first_tok.shape[0])
        if key not in inert:
            inert[key] = (torch.zeros((1, cfg.vocab_size), dtype=torch.int16,
                                      device=first_tok.device),
                          torch.full((first_tok.shape[0],), -1, dtype=torch.int32,
                                     device=first_tok.device))
        return inert[key]

    def prefill_slot(params, state, first_tok, first_lp, tokens, slot, start_pos,
                     n_real, samp, seed, base_seed, cnt_p, cnt_o, bias):
        tab, u = _inert(first_tok)
        return prefill_slot_c(params, state, first_tok, first_lp, tokens, slot,
                              start_pos, n_real, samp, seed, base_seed, cnt_p, cnt_o,
                              bias, tab, u, u)[:3]

    def decode_all(params, state, prev_tok, first_tok, meta, samp, base_seed,
                   cnt_o, cnt_p, bias):
        tab, u = _inert(first_tok)
        return decode_all_c(params, state, prev_tok, first_tok, meta, samp,
                            base_seed, cnt_o, cnt_p, bias, tab, u)[:4]

    def prefill_many(params, state, first_tok, first_lp, tokens, meta, samp,
                     base_seed, cnt_p, cnt_o, bias):
        tab, u = _inert(first_tok)
        return prefill_many_c(params, state, first_tok, first_lp, tokens, meta, samp,
                              base_seed, cnt_p, cnt_o, bias, tab, u, u)[:3]

    return prefill_slot, decode_all, prefill_many


def init_serving_aux(cfg: TransformerConfig, batch: int, device="cpu") -> dict:
    """The speculative graphs' bookkeeping, on the card
    (clearcam_tpu.models.llm.init_serving_aux):

    - ``ids`` [B, S] int32: ids[b, p] is the token consumed at cache
      position p of slot b (prefill chunks and verified windows record
      here), so drafts come from the card's own history with no host round
      trip (the engine reads tokens ``sync_lag`` steps late);
    - ``pos`` [B] int32: each slot's next write position, set by prefill
      (start + n_real) and advanced by each window by its accepted length
      + 1, which the host cannot know when it dispatches;
    - ``last`` [B] int32: each slot's last emitted token, the next window's
      first input."""
    dev = resolve_device(device)
    return {"ids": torch.zeros((batch, cfg.max_context), dtype=torch.int32, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "last": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _device_lookup_draft(ids, pos, x0, gamma: int):
    """Prompt-lookup drafts on the card (llm.py:1568-1590): for each row,
    the ``gamma`` tokens that followed the most recent earlier occurrence of
    the tail bigram (ids[pos-1], x0) in the consumed history; rows with no
    match draft x0 repeated. Drafts only set the speed: every one is
    verified. ids [B,S], pos [B], x0 [B] -> [B, gamma] int32."""
    s = ids.shape[1]
    q0 = ids.gather(1, torch.clamp_min(pos - 1, 0).long()[:, None])[:, 0]
    hit = (ids[:, :-1] == q0[:, None]) & (ids[:, 1:] == x0[:, None])
    p_idx = torch.arange(s - 1, device=ids.device)[None]
    # p <= pos-3: strictly before the tail bigram, and its first
    # continuation token (p+2) is consumed history, not junk past pos
    m = torch.where(hit & (p_idx <= (pos - 3)[:, None]), p_idx, -1).amax(1)
    gidx = torch.clamp(m[:, None] + 2 + torch.arange(gamma, device=ids.device)[None], 0, s - 1)
    d = ids.gather(1, gidx)
    return torch.where((m >= 0)[:, None], d, x0[:, None]).to(torch.int32)


def _window_index(starts, width: int, s: int) -> np.ndarray:
    """[R, width] cache columns of windows at host ``starts``, each clamped
    to end inside the cache (as the JAX package's dynamic_update_slice)."""
    return np.minimum(np.asarray(starts, np.int64), s - width)[:, None] + np.arange(width)


def _make_spec_serving_fns(cfg: TransformerConfig, g: int):
    """Speculative continuous-batching graphs (make_serving_fns with
    spec_lookup=G; clearcam_tpu.models.llm._make_spec_serving_fns).

    Every decode dispatch verifies a (G+1)-token window per live slot, [the
    current token, G drafts from ``_device_lookup_draft``], at per-row
    positions, and advances each row by its accepted prefix + 1 (1..G+1
    tokens a dispatch). Rows with temperature > 0, a penalty or a logit
    bias accept nothing and emit their one sampled token. Exactness: in a
    window, position j holds x_j and attends in-window to x_0..x_j only,
    the true context of every accepted position; rejected positions' rows
    are junk that the next window, starting at the first of them and G+1
    wide, overwrites before any query reads them. Positions, histories and
    the last tokens live on the card (``init_serving_aux``) and advance
    there, so no call waits for the card. Non-live rows write nothing
    (write_mask on every cache, ids and pos update). State and aux are
    written in place.

    prefill_slot(params, state, aux, first_tok, tokens[1,CHUNK], slot,
                 start_pos, n_real, samp[8], seed, base_seed, cnt_p, cnt_o,
                 bias) -> (first_tok', state, aux)
        the non-speculative prefill chunk; also records the chunk's ids and
        sets pos[slot] = start_pos + n_real.
    decode_spec(params, state, aux, first_tok, meta[3,B] [live, inject,
                seed], samp[B,8], base_seed, step, cnt_o, cnt_p, bias)
        -> (out [B, G+2] int32, state, aux, cnt_o)
        out[b, :G+1] = the candidates y_0..y_G (y_j the greedy token after
        position pos+j; y_0 sampled on a stochastic row, its noise keyed by
        (base_seed, seed, step)); out[b, G+1] = n_emit, the leading
        candidates emitted (accepted + 1; 0 on a non-live row). The engine
        reads it late and cuts at eos or max_new.
    prefill_many(params, state, aux, first_tok, tokens[B,CHUNK],
                 meta[4,B] [start, n_real, valid, seed], samp[B,8],
                 base_seed, cnt_p, cnt_o, bias) -> (first_tok', state, aux)
    """
    s_len = cfg.max_context
    _freqs = _freqs_per_device(cfg)
    plain_slot, _, plain_many = make_serving_fns(cfg)
    lp_rows: dict = {}

    def _lp(first_tok):
        """A scratch logprob row buffer: the speculative graphs keep none."""
        key = (first_tok.device, first_tok.shape[0])
        if key not in lp_rows:
            lp_rows[key] = torch.zeros((first_tok.shape[0], 1 + 2 * LP_K),
                                       device=first_tok.device)
        return lp_rows[key]

    def _record(aux, rows, starts, toks, dev):
        """ids[rows, window at starts] = toks (host arrays)."""
        idx = upload(_window_index(starts, toks.shape[1], s_len), dev)
        aux["ids"][upload(np.asarray(rows, np.int64), dev)[:, None], idx] = \
            upload(np.asarray(toks, np.int32), dev)

    @torch.inference_mode()
    def prefill_slot(params, state, aux, first_tok, tokens, slot, start_pos, n_real,
                     samp, seed, base_seed, cnt_p, cnt_o, bias):
        first_tok, _, state = plain_slot(params, state, first_tok, _lp(first_tok), tokens,
                                         slot, start_pos, n_real, samp, seed, base_seed,
                                         cnt_p, cnt_o, bias)
        _record(aux, [int(slot)], [int(start_pos)], np.asarray(tokens), first_tok.device)
        aux["pos"][int(slot)] = int(start_pos) + int(n_real)
        return first_tok, state, aux

    @torch.inference_mode()
    def prefill_many(params, state, aux, first_tok, tokens, meta, samp, base_seed,
                     cnt_p, cnt_o, bias):
        first_tok, _, state = plain_many(params, state, first_tok, _lp(first_tok), tokens,
                                         meta, samp, base_seed, cnt_p, cnt_o, bias)
        meta = np.asarray(meta, np.int32)
        rows = np.nonzero(meta[2] != 0)[0]
        if len(rows):
            dev = first_tok.device
            _record(aux, rows, meta[0, rows], np.asarray(tokens)[rows], dev)
            aux["pos"][upload(rows, dev)] = upload(meta[0, rows] + meta[1, rows], dev)
        return first_tok, state, aux

    @torch.inference_mode()
    def decode_spec(params, state, aux, first_tok, meta, samp, base_seed, step, cnt_o,
                    cnt_p, bias):
        dev = first_tok.device
        meta = np.asarray(meta, np.int32)
        live_np = meta[0] != 0
        m = upload(meta, dev)
        live = m[0] != 0
        # junk rows clamp; live rows never reach the clamp (the engine's
        # capacity assert keeps a last window inside the cache)
        pos = torch.clamp_max(aux["pos"], s_len - 1 - g)
        x0 = torch.where(m[1] != 0, first_tok, aux["last"])
        xs = torch.cat([x0[:, None], _device_lookup_draft(aux["ids"], pos, x0, g)], 1)
        hidden, _ = forward(params, cfg, state, xs, pos, _freqs(dev), write_mask=live_np)
        h = F.rms_norm(hidden, params["output_norm.weight"], cfg.norm_eps)
        logits = F.linear(h, params["output.weight"])                  # [B, G+1, V]
        y = torch.argmax(logits.float(), -1).to(torch.int32)
        b_n = xs.shape[0]
        # the consumed token joins its row's output histogram before sampling
        cnt_o.index_put_((torch.arange(b_n, device=dev), x0.long()), live.to(cnt_o.dtype),
                         accumulate=True)
        samp_np = np.asarray(samp, np.float32).reshape(-1, SAMP_W)
        # penalties and a bias move the greedy argmax, so such rows cannot
        # ride the greedy verification: one sampled token a window
        stoch_np = ((samp_np[:, 0] > 0) | (samp_np[:, 4] != 0) | (samp_np[:, 5] != 0)
                    | (samp_np[:, 6] != 1) | (samp_np[:, 7] != 0))
        acc = torch.cumprod((xs[:, 1:] == y[:, :-1]).to(torch.int32), 1).sum(1)
        if (stoch_np & live_np).any():
            stoch = upload(stoch_np, dev)
            sampled = sample_filtered(
                logits[:, 0], upload(samp_np, dev),
                row_noise(base_seed, meta[2], [int(step)] * b_n, cfg.vocab_size, dev),
                cnt_p, cnt_o, bias, flags=samp_flags(samp_np))
            y[:, 0] = torch.where(stoch, sampled.to(torch.int32), y[:, 0])
            acc = torch.where(stoch, 0, acc)
        n_emit = torch.where(live, acc + 1, 0).to(torch.int32)
        rows = np.nonzero(live_np)[0]
        if len(rows):
            r = upload(rows, dev)
            idx = pos[r][:, None] + torch.arange(g + 1, device=dev)
            aux["ids"][r[:, None], idx] = xs[r]
        aux["pos"].copy_(torch.where(live, torch.clamp_max(pos + acc + 1, s_len - 1 - g),
                                     aux["pos"]))
        aux["last"].copy_(torch.where(live, y.gather(1, acc[:, None].long())[:, 0],
                                      aux["last"]))
        return torch.cat([y, n_emit[:, None]], 1), state, aux, cnt_o

    return prefill_slot, decode_spec, prefill_many


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0, dtype=torch.float32,
                device="cpu", quantize: str | None = None,
                generator: torch.Generator | None = None) -> dict:
    """Random GGUF-named params for every block family: the JAX package's
    init_params (llm.py:1900-1976), the same numpy draws in the same order,
    uploaded tensor by tensor so the host holds one tensor at a time
    (values pass through f32 on the way to ``dtype``).

    generator: a torch.Generator on ``device`` draws the values there
    instead (``torch.randn``, in the same order; not the JAX package's
    values): full-width stacks have billions of weights, minutes of numpy
    draws. quantize "int8" or "int4" quantizes each tensor as soon as it is
    drawn by the rules of quantize_params_int8 / int4, which are per
    tensor: the result equals init_params then quantize_params_*, with one
    float tensor alive at a time."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed) if generator is None else None
    bits = {None: 0, "int8": 8, "int4": 4}[quantize]
    p: dict = {}

    def put(key, w):
        p[key] = _quantize_one(key, w, bits) if bits else w

    def t(key, *shape, scale=0.05):
        if generator is None:
            a = torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to(dev)
        else:
            a = torch.randn(shape, generator=generator, device=dev) * scale
        put(key, a.to(dtype))

    def ones(key, *shape):
        p[key] = torch.ones(shape, dtype=dtype, device=dev)

    def full(key, n, value):
        p[key] = torch.full((n,), value, dtype=dtype, device=dev)

    t("token_embd.weight", cfg.vocab_size, cfg.dim)
    ones("output_norm.weight", cfg.dim)
    t("output.weight", cfg.vocab_size, cfg.dim)
    for i in range(cfg.num_blocks):
        bc = cfg.block_cfg(i)
        pre = f"blk.{i}"
        ones(pre + ".attn_norm.weight", cfg.dim)
        ones(pre + ".ffn_norm.weight", cfg.dim)
        kind = cfg.block_kind(i)
        if kind == "attn":
            qd = bc.head_dim * bc.n_heads * (2 if bc.attn_output_gate else 1)
            t(pre + ".attn_q.weight", qd, bc.dim)
            t(pre + ".attn_k.weight", bc.head_dim * bc.n_kv_heads, bc.dim)
            t(pre + ".attn_v.weight", bc.head_dim * bc.n_kv_heads, bc.dim)
            t(pre + ".attn_output.weight", bc.dim, bc.head_dim * bc.n_heads)
            if bc.qkv_bias:
                for n in ("q", "k", "v"):
                    full(f"{pre}.attn_{n}.bias",
                         qd if n == "q" else bc.head_dim * bc.n_kv_heads, 0.0)
            if bc.qk_norm:
                ones(pre + ".attn_q_norm.weight", bc.qk_norm)
                ones(pre + ".attn_k_norm.weight", bc.qk_norm)
        elif kind == "mla":
            nope = bc.head_dim - bc.rope_dim
            if bc.q_lora_rank > 0:
                t(pre + ".attn_q_a.weight", bc.q_lora_rank, bc.dim)
                ones(pre + ".attn_q_a_norm.weight", bc.q_lora_rank)
                t(pre + ".attn_q_b.weight", bc.n_heads * bc.head_dim, bc.q_lora_rank)
            else:
                t(pre + ".attn_q.weight", bc.n_heads * bc.head_dim, bc.dim)
            t(pre + ".attn_kv_a_mqa.weight", bc.kv_lora_rank + bc.rope_dim, bc.dim)
            ones(pre + ".attn_kv_a_norm.weight", bc.kv_lora_rank)
            t(pre + ".attn_k_b.weight", bc.n_heads, bc.kv_lora_rank, nope)
            t(pre + ".attn_v_b.weight", bc.n_heads, bc.v_head_dim, bc.kv_lora_rank)
            t(pre + ".attn_output.weight", bc.dim, bc.n_heads * bc.v_head_dim)
        else:
            ssm = bc.ssm
            conv_ch = ssm.inner_size + 2 * ssm.group_count * ssm.state_size
            t(pre + ".attn_qkv.weight", conv_ch, bc.dim)
            t(pre + ".attn_gate.weight", ssm.inner_size, bc.dim)
            t(pre + ".ssm_alpha.weight", ssm.time_step_rank, bc.dim)
            t(pre + ".ssm_beta.weight", ssm.time_step_rank, bc.dim)
            t(pre + ".ssm_conv1d.weight", conv_ch, ssm.conv_kernel)
            full(pre + ".ssm_dt.bias", ssm.time_step_rank, 0.0)
            full(pre + ".ssm_a", ssm.time_step_rank, -0.1)
            ones(pre + ".ssm_norm.weight", ssm.inner_size // ssm.time_step_rank)
            t(pre + ".ssm_out.weight", bc.dim, ssm.inner_size)
        if bc.num_experts > 0:
            t(pre + ".ffn_gate_inp.weight", bc.num_experts, bc.dim)
            t(pre + ".ffn_gate_exps.weight", bc.num_experts, bc.hidden_dim, bc.dim)
            t(pre + ".ffn_up_exps.weight", bc.num_experts, bc.hidden_dim, bc.dim)
            t(pre + ".ffn_down_exps.weight", bc.num_experts, bc.dim, bc.hidden_dim)
            if bc.expert_bias:
                full(pre + ".exp_probs_b.bias", bc.num_experts, 0.0)
            if bc.shared_expert_dim > 0:
                t(pre + ".ffn_gate_shexp.weight", bc.shared_expert_dim, bc.dim)
                t(pre + ".ffn_up_shexp.weight", bc.shared_expert_dim, bc.dim)
                t(pre + ".ffn_down_shexp.weight", bc.dim, bc.shared_expert_dim)
                if bc.shared_expert_gate:
                    t(pre + ".ffn_gate_inp_shexp.weight", bc.dim)
        else:
            t(pre + ".ffn_gate.weight", bc.hidden_dim, bc.dim)
            t(pre + ".ffn_up.weight", bc.hidden_dim, bc.dim)
            t(pre + ".ffn_down.weight", bc.dim, bc.hidden_dim)
    return p


def _quantize_one(key: str, w, bits: int, min_dim: int = 256):
    """One tensor by the JAX package's rules (llm.py:1983-2017): a 2-D
    ``*.weight`` with both dims >= min_dim (``token_embd.weight`` excepted,
    it is gathered) becomes a QuantLinear (bits 8) or QuantLinear4 (bits
    4); a 3-D ``*_exps.weight`` expert stack a QuantExpert, int8 under
    either; everything else (norms, biases, routers and SSM gates under
    min_dim, MLA's 3-D attn_k_b / attn_v_b, the SSM conv and decay
    vectors) stays as it is."""
    if not isinstance(w, torch.Tensor):
        return w
    if (key.endswith(".weight") and key != "token_embd.weight" and w.dim() == 2
            and min(w.shape) >= min_dim):
        return quantize_int8(w) if bits == 8 else quantize_int4(w)
    if key.endswith("_exps.weight") and w.dim() == 3:
        return quantize_experts_int8(w)
    return w


def quantize_params_int8(p: dict, min_dim: int = 256) -> dict:
    """Weight-only int8 of every large dense matmul weight and every MoE
    expert stack (``_quantize_one``), on each tensor's device."""
    return {k: _quantize_one(k, v, 8, min_dim) for k, v in p.items()}


def quantize_params_int4(p: dict, min_dim: int = 256) -> dict:
    """Packed int4 (group-128 scales) in place of each QuantLinear of
    quantize_params_int8; expert stacks stay int8."""
    return {k: _quantize_one(k, v, 4, min_dim) for k, v in p.items()}


def _to_torch(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor of the same dtype (bf16 too)."""
    a = np.array(a)                    # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(params: dict, device="cpu", dtype=None) -> dict:
    """The JAX package's params (arrays, QuantLinear, QuantLinear4,
    QuantExpert) as the port's: dense tensors on ``device`` (cast to
    ``dtype`` when given), quantized weights carried across byte for
    byte."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        kind = type(v).__name__
        if kind == "QuantLinear":
            out[k] = QuantLinear(_to_torch(v.q), _to_torch(v.s),
                                 v.out_features, v.in_features).to(dev)
        elif kind == "QuantLinear4":
            out[k] = QuantLinear4(_to_torch(v.packed), _to_torch(v.s),
                                  v.out_features, v.in_features).to(dev)
        elif kind == "QuantExpert":
            out[k] = QuantExpert(_to_torch(v.q), _to_torch(v.s)).to(dev)
        else:
            t = _to_torch(v).to(dev)
            out[k] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return out


# ---------------------------------------------------------------------------
# GGUF
# ---------------------------------------------------------------------------

def config_from_gguf(kv: dict, state_dict: dict,
                     max_context: int | None = None) -> TransformerConfig:
    """llama.cpp metadata conventions -> TransformerConfig (the JAX
    package's config_from_gguf, field for field)."""
    arch = kv["general.architecture"]
    mc = kv.get(f"{arch}.context_length", 4096)
    max_context = min(max_context, mc) if max_context else mc
    # chunk-aligned, rounded down (never past the trained context)
    max_context = max(CHUNK, max_context // CHUNK * CHUNK)
    n_heads = kv[f"{arch}.attention.head_count"]
    n_kv = kv[f"{arch}.attention.head_count_kv"]
    if isinstance(n_kv, list):
        n_kv = max(n_kv)
    kv_lora = kv.get(f"{arch}.attention.kv_lora_rank", 0)
    head_dim = kv.get(f"{arch}.attention.key_length_mla",
                      kv.get(f"{arch}.attention.key_length",
                             kv[f"{arch}.embedding_length"] // n_heads))
    rope_dim = kv.get(f"{arch}.rope.dimension_count", head_dim)
    ssm = None
    if arch in ("qwen35", "qwen35moe"):
        ssm = SSMConfig(**{k: kv[f"{arch}.ssm.{k}"] for k in
                           ("conv_kernel", "state_size", "group_count",
                            "time_step_rank", "inner_size")})
    lead = kv.get(f"{arch}.leading_dense_block_count", 0)
    return TransformerConfig(
        num_blocks=kv[f"{arch}.block_count"] - kv.get(f"{arch}.nextn_predict_layers", 0),
        dim=kv[f"{arch}.embedding_length"],
        hidden_dim=kv.get(f"{arch}.expert_feed_forward_length",
                          kv.get(f"{arch}.feed_forward_length", 0)),
        n_heads=n_heads, n_kv_heads=n_kv,
        norm_eps=kv[f"{arch}.attention.layer_norm_rms_epsilon"],
        vocab_size=len(kv["tokenizer.ggml.tokens"]),
        head_dim=head_dim, rope_theta=kv[f"{arch}.rope.freq_base"],
        rope_dim=rope_dim,
        v_head_dim=kv.get(f"{arch}.attention.value_length_mla",
                          kv.get(f"{arch}.attention.value_length", head_dim)),
        max_context=max_context,
        qk_norm=(head_dim if ssm else
                 (state_dict["blk.0.attn_q_norm.weight"].shape[0]
                  if "blk.0.attn_q_norm.weight" in state_dict else 0)),
        num_experts=kv.get(f"{arch}.expert_count", 0),
        num_experts_per_tok=kv.get(f"{arch}.expert_used_count", 0),
        norm_topk_prob=kv.get(f"{arch}.expert_weights_norm",
                              arch in ("qwen3moe", "qwen35moe")),
        kv_lora_rank=kv_lora, q_lora_rank=kv.get(f"{arch}.attention.q_lora_rank", 0),
        leading_dense_blocks=lead,
        shared_expert_dim=kv.get(
            f"{arch}.expert_shared_feed_forward_length",
            kv.get(f"{arch}.expert_shared_count", 0)
            * kv.get(f"{arch}.expert_feed_forward_length", 0)),
        shared_expert_gate=f"blk.{lead}.ffn_gate_inp_shexp.weight" in state_dict,
        dense_hidden_dim=kv.get(f"{arch}.feed_forward_length", 0) if lead else 0,
        routed_scaling_factor=kv.get(f"{arch}.expert_weights_scale", 1.0),
        attn_output_gate=arch in ("qwen35", "qwen35moe"),
        ssm=ssm, full_attention_interval=kv.get(f"{arch}.full_attention_interval", 0),
        qkv_bias="blk.0.attn_q.bias" in state_dict,
        expert_bias=f"blk.{lead}.exp_probs_b.bias" in state_dict)


def convert_state_dict(sd: dict, kv: dict, dtype=torch.bfloat16, device="cpu") -> dict:
    """GGUF tensors (numpy) -> params on ``device``: the llama/MLA RoPE
    repack (interleaved -> half-split) and the post_attention_norm ->
    ffn_norm rename of the JAX package's convert_state_dict."""
    dev = resolve_device(device)
    arch = kv["general.architecture"]
    n_heads = kv[f"{arch}.attention.head_count"]
    n_kv = kv[f"{arch}.attention.head_count_kv"]
    kv_lora = kv.get(f"{arch}.attention.kv_lora_rank", 0)
    head_dim = kv.get(f"{arch}.attention.key_length_mla",
                      kv.get(f"{arch}.attention.key_length",
                             kv[f"{arch}.embedding_length"] // n_heads))
    rope_dim = kv.get(f"{arch}.rope.dimension_count", head_dim)

    sd = dict(sd)
    if arch in ("qwen35", "qwen35moe", "glm4moe"):
        sd = {k.replace("post_attention_norm", "ffn_norm"): v for k, v in sd.items()}
    if "output.weight" not in sd and "token_embd.weight" in sd:
        sd["output.weight"] = sd["token_embd.weight"]

    def half_split(w, n):
        w = w.reshape(n, w.shape[0] // n, -1)
        prefix = head_dim - rope_dim
        head = w[:, :prefix]
        tail = w[:, prefix:].reshape(n, -1, 2, w.shape[-1]) \
            .transpose(0, 2, 1, 3).reshape(n, -1, w.shape[-1])
        return np.concatenate([head, tail], 1).reshape(-1, w.shape[-1])

    out = {}
    for name, arr in sd.items():
        arr = np.asarray(arr)
        if (("attn_q.weight" in name or "attn_q_b.weight" in name)
                and (arch == "llama" or kv_lora)):
            arr = half_split(arr, n_heads)
        elif arch == "llama" and "attn_k.weight" in name:
            w = arr.reshape(n_kv, arr.shape[0] // n_kv, -1)
            arr = w.reshape(n_kv, -1, 2, w.shape[-1]).transpose(0, 2, 1, 3) \
                .reshape(arr.shape)
        elif kv_lora and "attn_kv_a_mqa.weight" in name:
            head = arr[:kv_lora]
            tail = arr[kv_lora:].reshape(-1, 2, arr.shape[-1]) \
                .transpose(1, 0, 2).reshape(-1, arr.shape[-1])
            arr = np.concatenate([head, tail], 0)
        t = torch.from_numpy(np.array(arr))
        out[name] = t.to(dev) if arr.dtype == np.int32 else \
            t.to(dev, torch.float32).to(dtype)
    return out


def load_gguf(path, max_context: int | None = None, dtype=torch.bfloat16,
              device="cpu"):
    """(cfg, params, kv) from a GGUF file, through the port's GGUF reader
    (``io.gguf``)."""
    from ..io import gguf
    kv, sd = gguf.load(path)
    cfg = config_from_gguf(kv, sd, max_context)
    return cfg, convert_state_dict(sd, kv, dtype, device), kv


# ---------------------------------------------------------------------------
# single-stream and batched generation
# ---------------------------------------------------------------------------

def _gumbel_like(logits, gen) -> torch.Tensor:
    """Gumbel noise of logits' shape from the torch.Generator ``gen``."""
    return gumbel(torch.rand(logits.shape, generator=gen, device=logits.device))


def decode_attn_impl(batched: bool, kv_quant: bool):
    """The decode step's attention through the port's decode kernels (their
    plain versions on the CPU): one stream (``decode_attention``,
    ``decode_attention_q8``, q [1,H,1,D]) or a batch with per-row pads
    (``decode_attention_batch``, ``decode_attention_batch_q8``)."""
    from ..ops import decode_attention as dec

    def impl(q, st, start_pos, pads=None):           # [B,H,1,D] -> [B,H,1,D]
        qq = q[:, :, 0].contiguous()
        if batched:
            if kv_quant:
                out = dec.decode_attention_batch_q8(qq, st["k"], st["k_s"], st["v"],
                                                    st["v_s"], start_pos, pads)
            else:
                out = dec.decode_attention_batch(qq, st["k"], st["v"], start_pos, pads)
            return out[:, :, None]
        if kv_quant:
            out = dec.decode_attention_q8(qq[0], st["k"][0], st["k_s"][0], st["v"][0],
                                          st["v_s"][0], start_pos)
        else:
            out = dec.decode_attention(qq[0], st["k"][0], st["v"][0], start_pos)
        return out[None, :, None]
    return impl


def _prefill_hidden(params, cfg: TransformerConfig, state, tokens, start_pos,
                    n_real: int, freqs, pad_start=None):
    """One chunk of prefill -> (pre-norm hidden [B,D] at token n_real - 1,
    state) (clearcam_tpu/models/llm.py:871-902). Attention and MLA stacks
    run the chunk in one forward; SSM stacks step it a token at a time,
    and the padded steps t >= n_real are not run; with pad_start, a row's
    recurrence advances only once the position clears its left pad. A
    Python loop of T = 1 forwards, where the JAX package scans them inside
    one compiled program."""
    if cfg.ssm is None:
        hidden, state = forward(params, cfg, state, tokens, start_pos, freqs,
                                pad_start=pad_start)
        return hidden[:, n_real - 1], state
    for t in range(n_real):
        live = None if pad_start is None else (start_pos + t) >= pad_start
        hidden, state = forward(params, cfg, state, tokens[:, t:t + 1], start_pos + t,
                                freqs, pad_start=pad_start, row_live=live)
    return hidden[:, 0], state


def make_step_fns(cfg: TransformerConfig, use_pallas_decode: bool = False,
                  kv_quant: bool = False):
    """-> (prefill, decode), the single-stream steps of ``Transformer``
    (the JAX package's make_step_fns, llm.py:905-961), taking params
    explicitly and writing ``state`` in place.

    prefill(params, state, tokens[B,CHUNK], start_pos, n_real, samp, gen)
        -> (token [B], state)   (logits taken at n_real-1)
    decode(params, state, token[B,1], start_pos, samp, gen) -> (token, state)

    ``samp`` is a packed pack_samp() row; ``gen`` the torch.Generator the
    Gumbel noise is drawn from. use_pallas_decode runs the decode step's
    attention through the single-stream decode kernel (``decode_attention``,
    or ``decode_attention_q8`` on an int8 cache with kv_quant), whose reads
    scale with the live context; B = 1. On a hybrid stack it serves the
    attention blocks (the JAX package's make_step_fns asserts nothing of
    the stack)."""
    _freqs = _freqs_per_device(cfg)
    attn_impl = decode_attn_impl(False, kv_quant) if use_pallas_decode else None

    @torch.inference_mode()
    def prefill(params, state, tokens, start_pos, n_real, samp, gen):
        tokens = torch.as_tensor(tokens).to(params["output_norm.weight"].device)
        h, state = _prefill_hidden(params, cfg, state, tokens, int(start_pos),
                                   int(n_real), _freqs(tokens.device))
        logits = F.linear(F.rms_norm(h, params["output_norm.weight"], cfg.norm_eps),
                          params["output.weight"])
        return sample_filtered(logits, samp, _gumbel_like(logits, gen)), state

    @torch.inference_mode()
    def decode(params, state, token, start_pos, samp, gen):
        token = torch.as_tensor(token).to(params["output_norm.weight"].device)
        hidden, state = forward(params, cfg, state, token, int(start_pos),
                                _freqs(token.device), decode_attn=attn_impl)
        logits = logits_at(params, cfg, hidden, 0)
        return sample_filtered(logits, samp, _gumbel_like(logits, gen)), state

    return prefill, decode


def make_verify_fn(cfg: TransformerConfig):
    """Speculative-decoding verifier (llm.py:1767-1783): feed G candidate
    tokens in one pass and return the greedy token after each position
    ([B,G] int32). The cache is written for all G positions; entries past
    the accepted prefix are junk the caller's position bookkeeping never
    attends to (the causal mask is position-based) and later steps
    overwrite."""
    _freqs = _freqs_per_device(cfg)

    @torch.inference_mode()
    def verify(params, state, tokens, start_pos):
        tokens = torch.as_tensor(tokens).to(params["output_norm.weight"].device)
        hidden, state = forward(params, cfg, state, tokens, int(start_pos),
                                _freqs(tokens.device))
        h = F.rms_norm(hidden, params["output_norm.weight"], cfg.norm_eps)
        logits = F.linear(h, params["output.weight"])              # [B,G,V]
        return torch.argmax(logits.float(), -1).to(torch.int32), state

    return verify


def make_slot_transform(fn):
    """Lift a B=1 state transform ``fn(state_b, *args) -> state_b`` onto one
    slot of a batched serving state (the serving engine's custom prefill,
    llm.py:1747-1764). The port's state is written in place, so the slot is
    a ``[slot:slot+1]`` view of each cache: ``fn``'s writes land in the
    batched state and nothing is scattered back. Other slots' bytes stay
    untouched."""
    def wrapped(state, slot, *args):
        slot = int(slot)
        fn([{k: v[slot:slot + 1] for k, v in s.items()} for s in state], *args)
        return state
    return wrapped


@torch.inference_mode()
def generate_batch(params, cfg: TransformerConfig, prompts: list, max_new: int,
                   temperature: float = 0.0, seed: int = 0,
                   eos_id: int | None = None, state_dtype=torch.float32,
                   kv_quant: bool = False, use_pallas_decode: bool = False,
                   top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0,
                   presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
                   repetition_penalty: float = 1.0, logit_bias: dict | None = None,
                   seeds: list | None = None) -> list:
    """Batched generation, B prompts in one cache (llm.py:964-1150).

    Prompts are right-aligned (left-padded to the longest) and each row's
    pad region is masked out of attention; RoPE scores depend only on
    relative position, so every output equals that prompt's solo
    generation. use_pallas_decode runs the decode step's attention through
    the batched decode kernel with per-row pads (``decode_attention_batch``,
    or ``decode_attention_batch_q8`` on the int8 cache of kv_quant).

    Noise: with ``seeds`` ([B] ints), row b's noise at generated-token
    index i is ``row_noise(seed, seeds[b], i)``, the serving engine's draw
    for a request submitted with seed=seeds[b] to an engine of seed
    ``seed``, so a seeded row equals that engine request at equal batch
    width. Without, a torch.Generator seeded with ``seed`` draws it.

    SSM stacks step the prompt a token at a time, each row's recurrence
    held still over its left pads, and refuse use_pallas_decode (as the
    JAX package asserts, llm.py:1019).

    Returns [B] lists of up to max_new token ids (truncated at eos_id)."""
    b_n = len(prompts)
    if min(len(p) for p in prompts) < 1:
        raise ValueError("empty prompt row: its first sample would come from a "
                         "pad position")
    if cfg.max_context % CHUNK:
        raise ValueError("max_context must be CHUNK-aligned")
    longest = max(len(p) for p in prompts)
    if longest + max_new > cfg.max_context:
        raise ValueError("prompts + max_new overflow max_context")
    if seeds is not None and len(seeds) != b_n:
        raise ValueError("seeds must give one seed per prompt")
    if use_pallas_decode and cfg.ssm is not None:
        raise ValueError("use_pallas_decode serves attention-only stacks (as "
                         "clearcam_tpu/models/llm.py:1019 asserts), not GatedDeltaNet ones")
    dev = params["output_norm.weight"].device
    pad = [longest - len(p) for p in prompts]
    rows = [[0] * d + list(p) for d, p in zip(pad, prompts)]
    pads = torch.tensor(pad, dtype=torch.int32, device=dev)
    freqs = freqs_for(cfg, dev)
    attn_impl = decode_attn_impl(True, kv_quant) if use_pallas_decode else None
    samp_np = np.asarray(pack_samp(temperature, top_p, top_k, min_p, presence_penalty,
                                   frequency_penalty, repetition_penalty,
                                   1.0 if logit_bias else 0.0))
    samp = torch.from_numpy(samp_np).to(dev)
    flags = samp_flags(samp_np)
    cnt_p = cnt_o = bias = None
    if flags[0] or flags[1]:
        cnt_p = torch.from_numpy(np.stack([np.bincount(
            np.asarray(p, np.int64), minlength=cfg.vocab_size) for p in prompts])
            .astype(np.int32)).to(dev)
        cnt_o = torch.zeros((b_n, cfg.vocab_size), dtype=torch.int32, device=dev)
        brow = np.zeros(cfg.vocab_size, np.float32)
        for t, v in (logit_bias or {}).items():
            brow[int(t)] = float(v)
        bias = torch.from_numpy(brow).to(dev).expand(b_n, -1)
    gen = None
    if seeds is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    def sample(logits, gi):
        noise = _gumbel_like(logits, gen) if seeds is None else \
            row_noise(seed, seeds, [gi] * b_n, cfg.vocab_size, dev)
        return sample_filtered(logits, samp, noise, cnt_p, cnt_o, bias, flags=flags)

    state = init_state(cfg, b_n, dtype=state_dtype, kv_quant=kv_quant, device=dev)
    all_live = None if cfg.ssm is None else torch.ones(b_n, dtype=torch.bool, device=dev)
    pos = 0
    tok = None
    while pos < longest:
        n = min(CHUNK, longest - pos)
        chunk = [r[pos:pos + n] + [0] * (CHUNK - n) for r in rows]
        h, _ = _prefill_hidden(params, cfg, state, torch.tensor(chunk, device=dev), pos, n,
                               freqs, pad_start=pads)
        tok = sample(F.linear(F.rms_norm(h, params["output_norm.weight"], cfg.norm_eps),
                              params["output.weight"]), 0)
        pos += n
    out: list = [[] for _ in range(b_n)]
    done = [False] * b_n
    cur = tok.cpu().numpy()
    gi = 1                              # the next decode gives token index 1
    for _ in range(max_new):
        for b in range(b_n):
            if not done[b]:
                out[b].append(int(cur[b]))
                if eos_id is not None and int(cur[b]) == eos_id:
                    done[b] = True
        if all(done) or pos >= cfg.max_context - 1:
            break
        token = torch.from_numpy(cur[:, None].astype(np.int64)).to(dev)
        if cnt_o is not None:           # the consumed token joins the histogram
            cnt_o[torch.arange(b_n, device=dev), token[:, 0]] += 1
        hidden, _ = forward(params, cfg, state, token, pos, freqs,
                            decode_attn=attn_impl, pad_start=pads, row_live=all_live)
        tok = sample(logits_at(params, cfg, hidden, 0), gi)
        pos += 1
        gi += 1
        cur = tok.cpu().numpy()
    return out


class Transformer:
    """Stateful single-stream generator (llm.py:2020-2179): chunked prefill,
    a decode loop, prefix-cache reuse and prompt-lookup speculative decoding
    (``spec_lookup``), over ``make_step_fns``.

    The state keeps the format the instance was built with: ``state_dtype``
    (f32 or bf16 caches) or ``kv_quant`` (int8 caches with per-token
    scales); ``reset_state()`` rebuilds it in that format. Sampling noise
    comes from a torch.Generator seeded with ``seed`` on the params'
    device."""

    def __init__(self, params: dict, cfg: TransformerConfig, seed: int = 0,
                 state_dtype=torch.float32, kv_quant: bool = False,
                 use_pallas_decode: bool = False, spec_lookup: int = 0):
        if cfg.max_context % CHUNK:
            raise ValueError("max_context must be CHUNK-aligned")
        if spec_lookup and cfg.ssm is not None:
            # the JAX package's Transformer turns spec off here silently
            raise ValueError("spec_lookup needs attention or MLA blocks only: a rejected "
                             "draft's GatedDeltaNet state update cannot be rolled back")
        self.params = params
        self.cfg = cfg
        self.state_dtype, self.kv_quant = state_dtype, kv_quant
        self.use_pallas_decode = use_pallas_decode
        self.device = params["output_norm.weight"].device
        self.prefill_fn, self.decode_fn = make_step_fns(
            cfg, use_pallas_decode=use_pallas_decode, kv_quant=kv_quant)
        self.spec_lookup = int(spec_lookup)
        self.verify_fn = make_verify_fn(cfg) if self.spec_lookup else None
        self.chunk = CHUNK
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.reset_state()

    def reset_state(self) -> None:
        """A zeroed cache in this instance's format, and no reusable prefix."""
        self.state = init_state(self.cfg, 1, dtype=self.state_dtype,
                                kv_quant=self.kv_quant, device=self.device)
        self._cached_tokens: list[int] = []

    @classmethod
    def from_gguf(cls, path, max_context: int | None = None, dtype=torch.bfloat16,
                  seed: int = 0, quantize: bool = False, kv_quant: bool = False,
                  spec_lookup: int = 0, use_pallas_decode: bool = False,
                  device="cuda"):
        """(Transformer, GGUF metadata) from a checkpoint: quantize=True
        re-quantizes the dense matmul weights to int8 (quantize_params_int8)
        after the GGUF dequant."""
        cfg, params, kv = load_gguf(path, max_context, dtype, device)
        if quantize:
            params = quantize_params_int8(params)
        return cls(params, cfg, seed, kv_quant=kv_quant,
                   use_pallas_decode=use_pallas_decode, spec_lookup=spec_lookup), kv

    def quantize_int8(self):
        """Switch this instance to the int8 weight-only path."""
        self.params = quantize_params_int8(self.params)
        return self

    @staticmethod
    def _lookup_draft(tokens: list[int], gamma: int, max_ngram: int = 3) -> list | None:
        """Prompt-lookup draft: the gamma tokens that followed the most
        recent earlier occurrence of the current tail n-gram (longest n
        first)."""
        for n in range(max_ngram, 1, -1):
            if len(tokens) <= n:
                continue
            tail = tokens[-n:]
            for i in range(len(tokens) - n - 1, -1, -1):
                if tokens[i:i + n] == tail:
                    cont = tokens[i + n:i + n + gamma]
                    if cont:
                        return cont + [cont[-1]] * (gamma - len(cont))
        return None

    def reusable_prefix(self, tokens: list[int]) -> int:
        n = 0
        for a, b in zip(tokens[:-1], self._cached_tokens):
            if a != b:
                break
            n += 1
        if self.cfg.ssm is not None and n != len(self._cached_tokens):
            return 0            # a recurrent state cannot be partly reused
        return n

    def generate(self, tokens: list[int], temperature: float = 0.0,
                 cache_offset: int = 0, max_new: int | None = None,
                 top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0):
        """Yields sampled token ids until max_context (the caller checks eos).

        cache_offset: the absolute cache position where the prompt begins,
        nonzero when earlier context (e.g. VLM image embeddings) already
        occupies the cache; prefix-cache reuse applies only at offset 0.
        top_p/top_k/min_p filter the temperature-scaled distribution."""
        cfg = self.cfg
        pos = 0                       # tokens of the prompt already consumed
        if cache_offset == 0:
            pos = self.reusable_prefix(tokens)
            if pos < len(self._cached_tokens):
                self.state = reset_recurrent(cfg, self.state)
        tokens = list(tokens)
        prompt_len = len(tokens)
        samp = pack_samp(temperature, top_p, top_k, min_p).to(self.device)
        dev = self.device
        out_tok = None
        produced = 0
        while cache_offset + len(tokens) < cfg.max_context:
            if pos < prompt_len:      # (chunked) prefill
                n = min(self.chunk, prompt_len - pos)
                chunk = tokens[pos:pos + n] + [0] * (self.chunk - n)
                out_tok, self.state = self.prefill_fn(
                    self.params, self.state, torch.tensor([chunk], device=dev),
                    cache_offset + pos, n, samp, self._gen)
                pos += n
                if pos < prompt_len:
                    continue
            else:
                g = self.spec_lookup
                draft = None
                if (g and temperature == 0.0
                        and cache_offset + pos + g + 1 < cfg.max_context):
                    draft = self._lookup_draft(tokens, g)
                if draft is not None:
                    # one verify pass over [current, d1..dG]: greedy_out[i] is
                    # the model's token after consuming position pos+i
                    feed = torch.tensor([[tokens[-1]] + draft], device=dev)
                    toks, self.state = self.verify_fn(self.params, self.state, feed,
                                                      cache_offset + pos)
                    greedy_out = toks[0].cpu().numpy()
                    a = 0
                    while a < g and int(greedy_out[a]) == draft[a]:
                        a += 1
                    new_toks = draft[:a] + [int(greedy_out[a])]
                    pos += a + 1
                else:
                    out_tok, self.state = self.decode_fn(
                        self.params, self.state, torch.tensor([[tokens[-1]]], device=dev),
                        cache_offset + pos, samp, self._gen)
                    pos += 1
                    new_toks = [int(out_tok[0])]
                for nxt in new_toks:
                    tokens.append(nxt)
                    if cache_offset == 0:
                        self._cached_tokens = tokens[:-1]
                    produced += 1
                    yield nxt
                    if max_new is not None and produced >= max_new:
                        return
                continue
            nxt = int(out_tok[0])
            tokens.append(nxt)
            if cache_offset == 0:
                self._cached_tokens = tokens[:-1]
            produced += 1
            yield nxt
            if max_new is not None and produced >= max_new:
                return
