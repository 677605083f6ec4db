"""Ring attention: prefill attention with the sequence sharded across
ranks, the counterpart of ``clearcam_tpu.parallel.ringattn``.

Each rank holds T/n query, key and value tokens; the K/V blocks rotate one
hop a step around the ring (``dist.batch_isend_irecv``: send to the next
rank, receive from the previous one) while a streaming softmax accumulates
in f32, so no rank holds the [T, T] scores. The next hop's send and
receive are posted before the current block's arithmetic, so the copy and
the compute overlap; the last rotation is left out. The body is plain
torch, as the JAX body is plain einsums (no Pallas kernel).

Exact, not approximate: it equals one-device attention to float
tolerance.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import comm


def ring_attention_shard(q, k, v, group=None, causal: bool = True,
                         scale: float | None = None):
    """q [B, Tl, H, D], k and v [B, Tl, KvH, D]: this rank's slice of the
    sequence (rank s of ``group`` holds global tokens s*Tl .. s*Tl + Tl - 1)
    -> [B, Tl, H, D] attention output for the local queries. GQA: each K/V
    head serves H / KvH query heads; the unrepeated K/V ride the ring."""
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    b, tl, h, d = q.shape
    rep = h // k.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float() * scale
    q_pos = my * tl + torch.arange(tl, device=q.device)
    acc = torch.zeros((b, tl, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tl, 1), float("-inf"), device=q.device)
    l_sum = torch.zeros((b, h, tl, 1), device=q.device)
    kb, vb = k.contiguous(), v.contiguous()
    for i in range(n):
        pending = None
        if i < n - 1:
            k_next, v_next = torch.empty_like(kb), torch.empty_like(vb)
            pending = comm.exchange_start([(kb, (my + 1) % n), (vb, (my + 1) % n)],
                                          [(k_next, (my - 1) % n), (v_next, (my - 1) % n)],
                                          group)
        src = (my - i) % n                       # owner of the held K/V block
        kf, vf = kb.float(), vb.float()
        if rep > 1:
            kf, vf = kf.repeat_interleave(rep, 2), vf.repeat_interleave(rep, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        if causal:
            k_pos = src * tl + torch.arange(tl, device=q.device)
            s = s.masked_fill(~(k_pos[None, :] <= q_pos[:, None])[None, None],
                              float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        # rows with nothing visible yet keep m = -inf; exp(-inf - -inf) guards
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe)
        alpha = torch.exp(m - m_safe)
        l_sum = l_sum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha.transpose(1, 2) + torch.einsum("bhqk,bkhd->bqhd", p, vf)
        m = m_new
        if pending is not None:
            pending()
            kb, vb = k_next, v_next
    out = acc / torch.clamp_min(l_sum.transpose(1, 2), 1e-20)
    return out.to(q.dtype)


def gather_seq(x, group=None, dim: int = 1):
    """Each rank's slice of the sequence -> the whole sequence on every
    rank (one ``all_gather`` along ``dim``)."""
    return comm.all_gather(x.contiguous(), group, dim)


def ring_prefill(mesh, axis: str = "data", causal: bool = True):
    """-> fn(q, k, v): global [B, T, H, D] inputs (the same on every rank),
    T split over ``axis``; each rank runs ``ring_attention_shard`` on its
    slice and the slices are gathered, so the [B, T, H, D] output is on
    every rank."""
    group = mesh.group(axis)
    n, i = mesh.shape[axis], mesh.coord(axis)

    def run(q, k, v):
        t = q.shape[1]
        if t % n:
            raise ValueError(f"T = {t} does not split over {axis}={n}")
        tl = t // n
        sl = slice(i * tl, (i + 1) * tl)
        q, k, v = (torch.as_tensor(z)[:, sl].to(mesh.device) for z in (q, k, v))
        with torch.no_grad():
            return gather_seq(ring_attention_shard(q, k, v, group, causal), group)

    return run
