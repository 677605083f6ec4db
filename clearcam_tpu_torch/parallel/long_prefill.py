"""Sequence-parallel LLM prefill: the whole transformer forward with the
prompt sharded across ranks, the counterpart of
``clearcam_tpu.parallel.long_prefill``.

Builds on ``parallel.ringattn``: each rank embeds its T/n tokens and runs
the norms and FFNs on them (weights replicated), and attention runs as a
ring, so a prompt n times longer than one device's attention memory fits.
RoPE takes global positions (rank s starts at s * T/n).

Scope: standard GQA attention stacks (every ``cfg.block_kind`` "attn");
recurrent GatedDeltaNet blocks run sequentially over T and MLA's latent
cache is another layout, so those stacks are refused.

Returns this rank's slice of the final hidden states and every layer's
K/V slice; ``materialize_state`` gathers the K/V into the decode cache
(``llm.init_state`` layout), and the ordinary one-device decode continues
from ``start_pos = T``.
"""
from __future__ import annotations

import torch

from ..models import llm
from ..nn import functional as F
from .ringattn import gather_seq, ring_attention_shard


def _attn_block_shard(p, pre, bc, x, pos0, freqs, group):
    """GQA attention for one rank's tokens; global positions from pos0."""
    b, t, _ = x.shape
    hd, nh, nkv = bc.head_dim, bc.n_heads, bc.n_kv_heads
    q = F.linear(x, p[f"{pre}.attn_q.weight"], p.get(f"{pre}.attn_q.bias"))
    k = F.linear(x, p[f"{pre}.attn_k.weight"], p.get(f"{pre}.attn_k.bias"))
    v = F.linear(x, p[f"{pre}.attn_v.weight"], p.get(f"{pre}.attn_v.bias"))
    if bc.qk_norm and bc.qk_norm != hd:
        q = F.rms_norm(q, p[f"{pre}.attn_q_norm.weight"], bc.norm_eps)
        k = F.rms_norm(k, p[f"{pre}.attn_k_norm.weight"], bc.norm_eps)
    q = q.reshape(b, t, nh, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, hd)
    if bc.qk_norm == hd:
        q = F.rms_norm(q, p[f"{pre}.attn_q_norm.weight"], bc.norm_eps)
        k = F.rms_norm(k, p[f"{pre}.attn_k_norm.weight"], bc.norm_eps)
    fr = freqs[pos0:pos0 + t]

    def rope(z):                                   # apply_rope takes [B, H, T, D]
        zt = z.transpose(1, 2)
        zt = torch.cat([llm.apply_rope(zt[..., :bc.rope_dim], fr),
                        zt[..., bc.rope_dim:]], -1)
        return zt.transpose(1, 2)
    q, k = rope(q), rope(k)
    out = ring_attention_shard(q.float(), k.float(), v.float(), group)
    out = out.reshape(b, t, nh * hd).to(x.dtype)
    return F.linear(out, p[f"{pre}.attn_output.weight"]), k, v


def make_sharded_prefill(mesh, cfg, axis: str = "data"):
    """-> fn(params, tokens [B, T]) -> (this rank's hidden [B, T/n, D],
    [(k, v)] per layer, each [B, T/n, KvH, D]). ``tokens`` is the whole
    prompt on every rank; T must divide by the axis size. Attention-only
    stacks."""
    assert all(cfg.block_kind(i) == "attn" for i in range(cfg.num_blocks)), \
        "sequence-parallel prefill supports standard attention stacks only"
    group = mesh.group(axis)
    n, i = mesh.shape[axis], mesh.coord(axis)
    freqs = llm.freqs_for(cfg, mesh.device)

    @torch.no_grad()
    def run(params, tokens):
        tokens = torch.as_tensor(tokens).to(mesh.device)
        t = tokens.shape[1]
        if t % n:
            raise ValueError(f"T = {t} does not split over {axis}={n}")
        tl = t // n
        x = F.embedding(params["token_embd.weight"], tokens[:, i * tl:(i + 1) * tl]).float()
        kvs = []
        for j in range(cfg.num_blocks):
            bc, pre = cfg.block_cfg(j), f"blk.{j}"
            h = F.rms_norm(x, params[f"{pre}.attn_norm.weight"], cfg.norm_eps)
            attn_out, k, v = _attn_block_shard(params, pre, bc, h, i * tl, freqs, group)
            x = x + attn_out
            x = x + llm._ffn(params, pre, bc, F.rms_norm(
                x, params[f"{pre}.ffn_norm.weight"], cfg.norm_eps))
            kvs.append((k, v))
        return x, kvs

    return run


def materialize_state(cfg, kvs, batch: int = 1, dtype=torch.float32, group=None,
                      device=None) -> list:
    """Sequence-sharded prefill K/V -> the decode cache (``llm.init_state``
    layout, [B, KvH, max_context, D]): each layer's K/V slices gathered
    over ``group`` (one ``all_gather`` each) and written at positions
    [0, T)."""
    dev = device if device is not None else kvs[0][0].device
    state = llm.init_state(cfg, batch, dtype, device=dev)
    for i, (k, v) in enumerate(kvs):
        k, v = gather_seq(k, group), gather_seq(v, group)
        t = k.shape[1]
        state[i]["k"][:, :, :t] = k.to(dtype).transpose(1, 2)
        state[i]["v"][:, :, :t] = v.to(dtype).transpose(1, 2)
    return state

