"""Pipeline parallelism over a mesh axis, the counterpart of
``clearcam_tpu.parallel.pipeline``: a GPipe forward, and two training
schedules (GPipe and 1F1B) written by hand.

Rank s of the ``stage`` axis holds stage s's parameters and nothing of the
others. The JAX package writes each schedule by hand on ``ppermute``
inside one ``lax.scan``; here each is a tick loop whose activations hop
stage to stage with ``dist.batch_isend_irecv`` (``comm.exchange``), one
exchange a tick. ``send``/``recv`` are not differentiable, and neither
``torch.distributed.pipelining`` nor autograd through communication is
used: the backward of each schedule is scheduled by hand, with
``torch.autograd.backward(y, grad_from_next_stage)`` on the stage's own
graph and the input gradient sent back.

  * ``pipeline_apply``: M microbatches over S stages in M + S - 1 ticks,
    the outputs replicated from the last stage (one ``broadcast``).
  * ``pipeline_train_step_gpipe``: the same forward ticks keeping every
    microbatch's graph, then the backward ticks in reverse: memory grows
    with M.
  * ``pipeline_train_step_1f1b``: the JAX tick plan. Each tick runs one
    forward phase and one backward phase a stage; the backward of
    microbatch m on stage s runs 2(S-1) - s phases after its forward; the
    stage keeps only its inputs, in a ring of 2S - 1 slots, and the
    backward recomputes the stage forward under autograd, so the live
    activations are O(S) whatever M is.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import comm


def _stage(mesh, axis):
    return mesh.group(axis), mesh.shape[axis], mesh.coord(axis)


def pipeline_apply(mesh, axis: str, stage_fn, stage_params, x):
    """S stages over M microbatches. stage_fn(stage_params, mb) -> mb'
    (shape-preserving); ``stage_params`` are this rank's stage's; x [M, ...]
    the same on every rank. -> [M, ...] = stage_{S-1}(...stage_0(x)...),
    on every rank."""
    group, s_n, stage = _stage(mesh, axis)
    m_n = x.shape[0]
    x = x.to(mesh.device)
    outs = torch.zeros_like(x)
    buf = torch.empty_like(x[0])
    with torch.no_grad():
        for t in range(m_n + s_n - 1):
            mb = t - stage
            y = None
            if 0 <= mb < m_n:
                y = stage_fn(stage_params, x[mb] if stage == 0 else buf)
                if stage == s_n - 1:
                    outs[mb] = y
            sends = [(y, stage + 1)] if y is not None and stage < s_n - 1 else []
            recvs = []
            if stage > 0 and 0 <= t - (stage - 1) < m_n:
                buf = torch.empty_like(buf)
                recvs = [(buf, stage - 1)]
            comm.exchange(sends, recvs, group)
    return comm.broadcast(outs, dist.get_global_rank(group, s_n - 1), group)


def _grads_like(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _leaf(params):
    return {k: v.detach().requires_grad_() for k, v in params.items()}


def pipeline_train_step_gpipe(mesh, axis: str, stage_fn, loss_fn, stage_params, x, y):
    """GPipe training step: loss (the mean of loss_fn(out[m], y[m]) over
    the M microbatches) and this stage's grads (a dict like
    ``stage_params``). Every microbatch's forward graph is kept until the
    backward ticks, which run the microbatches in reverse."""
    group, s_n, stage = _stage(mesh, axis)
    m_n = x.shape[0]
    x, y = x.to(mesh.device), y.to(mesh.device)
    p = _leaf(stage_params)
    inputs, outputs = [None] * m_n, [None] * m_n
    buf = torch.empty_like(x[0])
    for t in range(m_n + s_n - 1):
        mb = t - stage
        out = None
        if 0 <= mb < m_n:
            inp = x[mb] if stage == 0 else buf.requires_grad_()
            inputs[mb] = inp
            out = outputs[mb] = stage_fn(p, inp)
        sends = [(out.detach(), stage + 1)] if out is not None and stage < s_n - 1 else []
        recvs = []
        if stage > 0 and 0 <= t - (stage - 1) < m_n:
            buf = torch.empty_like(buf)
            recvs = [(buf, stage - 1)]
        comm.exchange(sends, recvs, group)
    loss_sum = torch.zeros((), device=mesh.device)
    gbuf = torch.empty_like(x[0])
    for t in range(m_n + s_n - 1):
        mb = m_n - 1 - (t - (s_n - 1 - stage))
        gx = None
        if 0 <= mb < m_n:
            if stage == s_n - 1:
                lval = loss_fn(outputs[mb], y[mb]) / m_n
                loss_sum = loss_sum + lval.detach()
                torch.autograd.backward(lval)
            else:
                torch.autograd.backward(outputs[mb], gbuf)
            if stage > 0:
                gx = inputs[mb].grad
            inputs[mb] = outputs[mb] = None
        sends = [(gx, stage - 1)] if gx is not None else []
        recvs = []
        nxt = m_n - 1 - (t - (s_n - 2 - stage))
        if stage < s_n - 1 and 0 <= nxt < m_n:
            gbuf = torch.empty_like(gbuf)
            recvs = [(gbuf, stage + 1)]
        comm.exchange(sends, recvs, group)
    loss = comm.all_reduce(loss_sum, group)
    return loss, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                  for k, v in p.items()}


def pipeline_train_step_1f1b(mesh, axis: str, stage_fn, loss_fn, stage_params, x, y,
                             stats: dict | None = None):
    """1F1B training step: loss (mean over microbatches) and this stage's
    grads, equal to the sequential computation (the schedule reorders the
    microbatch backwards; gradient accumulation is a sum). ``stats``, when
    given, gets ``ring_slots`` (2S - 1), ``peak_live`` (the most stored
    inputs alive at once on this stage) and ``ticks``."""
    group, s_n, stage = _stage(mesh, axis)
    m_n = x.shape[0]
    w_n = 2 * s_n - 1                     # ring depth >= the 2(S-1) + 1 in flight
    n_ticks = m_n + 2 * (s_n - 1)
    last = s_n - 1
    x, y = x.to(mesh.device), y.to(mesh.device)
    p = _leaf(stage_params)
    grads = _grads_like(stage_params)
    ring = [None] * w_n
    peak = 0
    loss_sum = torch.zeros((), device=mesh.device)
    fwd_buf, bwd_buf = torch.empty_like(x[0]), torch.empty_like(x[0])
    for t in range(n_ticks):
        # forward phase: stage s runs microbatch t - s
        mb_f = t - stage
        y_out = None
        if 0 <= mb_f < m_n:
            inp = x[mb_f] if stage == 0 else fwd_buf
            ring[t % w_n] = inp
            peak = max(peak, sum(r is not None for r in ring))
            with torch.no_grad():
                y_out = stage_fn(p, inp)
        # backward phase: stage s runs microbatch t - 2(S-1) + s, recomputing
        # its forward from the stored input (forward phase mb_b + s)
        mb_b = t - 2 * (s_n - 1) + stage
        g_x = None
        if 0 <= mb_b < m_n:
            slot = (mb_b + stage) % w_n
            inp_b = ring[slot].detach().requires_grad_()
            ring[slot] = None
            out_b = stage_fn(p, inp_b)
            if stage == last:
                lval = loss_fn(out_b, y[mb_b])
                loss_sum = loss_sum + lval.detach()
                torch.autograd.backward(lval)
            else:
                torch.autograd.backward(out_b, bwd_buf)
            for k, v in p.items():
                if v.grad is not None:
                    grads[k] += v.grad
                    v.grad = None
            g_x = inp_b.grad
        sends, recvs = [], []
        if y_out is not None and stage < last:
            sends.append((y_out, stage + 1))
        if g_x is not None and stage > 0:
            sends.append((g_x, stage - 1))
        if stage > 0 and 0 <= t - (stage - 1) < m_n:
            fwd_buf = torch.empty_like(fwd_buf)
            recvs.append((fwd_buf, stage - 1))
        if stage < last and 0 <= t - 2 * (s_n - 1) + stage + 1 < m_n:
            bwd_buf = torch.empty_like(bwd_buf)
            recvs.append((bwd_buf, stage + 1))
        comm.exchange(sends, recvs, group)
    if stats is not None:
        stats.update(ring_slots=w_n, peak_live=peak, ticks=n_ticks)
    loss = comm.all_reduce(loss_sum, group) / m_n
    return loss, {k: g / m_n for k, g in grads.items()}


# ---------------------------------------------------------------------------
# LLM instantiation: the layer stack split across stages
# ---------------------------------------------------------------------------

def stack_llm_stage_params(params: dict, cfg, n_stages: int, stage: int) -> dict:
    """Stage ``stage``'s blocks of an n_stages split (contiguous ranges),
    keyed relative to the stage: {"blk.{j}.{suffix}": tensor}. Where the JAX
    function stacks every stage on a leading axis, a rank here keeps only
    its own. Homogeneous (attention) stacks only."""
    assert cfg.ssm is None, "pipeline stages need homogeneous (attn) blocks"
    assert cfg.num_blocks % n_stages == 0, \
        f"{cfg.num_blocks} blocks not divisible into {n_stages} stages"
    per = cfg.num_blocks // n_stages
    out = {}
    for j in range(per):
        pre = f"blk.{stage * per + j}."
        for k, v in params.items():
            if k.startswith(pre):
                out[f"blk.{j}." + k[len(pre):]] = v
    return out


def make_llm_stage_fn(cfg, n_stages: int, seq_len: int, device="cpu"):
    """Stage function running cfg.num_blocks / n_stages attention blocks on
    hidden states [mb, T, D] (prefill: causal within the chunk, a fresh
    cache each call)."""
    from ..models import llm

    per = cfg.num_blocks // n_stages
    sub = dataclasses.replace(cfg, num_blocks=per, max_context=seq_len)
    freqs = llm.freqs_for(sub, device)

    def stage_fn(p_stage, x):
        state = llm.init_state(sub, batch=x.shape[0], device=x.device)
        h, _ = llm.forward(p_stage, sub, state, None, 0, freqs, hidden_override=x)
        return h

    return stage_fn


def _embed(params, cfg, tokens, n_micro, device):
    from ..nn import functional as F
    b, t = tokens.shape
    assert b % n_micro == 0
    tokens = torch.as_tensor(tokens).to(device)
    x = F.embedding(params["token_embd.weight"], tokens).float()
    return x.reshape(n_micro, b // n_micro, t, -1)


def pp_llm_prefill(mesh, axis: str, params: dict, cfg, tokens, n_micro: int):
    """Pipelined long-prompt prefill: tokens [B, T] (B % n_micro == 0) ->
    final hidden states [B, T, D] on every rank; the block stack is split
    over the stages, the embedding replicated."""
    s_n = mesh.shape[axis]
    stage_p = stack_llm_stage_params(params, cfg, s_n, mesh.coord(axis))
    stage_fn = make_llm_stage_fn(cfg, s_n, tokens.shape[-1], mesh.device)
    b, t = tokens.shape
    x = _embed(params, cfg, tokens, n_micro, mesh.device)
    return pipeline_apply(mesh, axis, stage_fn, stage_p, x).reshape(b, t, -1)


def pp_llm_train_step(mesh, axis: str, params: dict, cfg, tokens, targets,
                      n_micro: int, schedule: str = "1f1b"):
    """Pipelined LLM block-stack training step: next-token cross-entropy over
    [B, T] tokens with the layer stack split over the stages. Trains the
    blk.* parameters (the grads are this rank's stage's, keyed as
    ``stack_llm_stage_params``); the embedding and output head run
    replicated and stay frozen. schedule "1f1b" (the default) or "gpipe".
    -> (loss, grads)."""
    from ..nn import functional as F

    s_n = mesh.shape[axis]
    stage_p = stack_llm_stage_params(params, cfg, s_n, mesh.coord(axis))
    stage_fn = make_llm_stage_fn(cfg, s_n, tokens.shape[-1], mesh.device)
    b, t = tokens.shape
    x = _embed(params, cfg, tokens, n_micro, mesh.device)
    tgt = torch.as_tensor(targets).to(mesh.device).reshape(n_micro, b // n_micro, t)
    w_norm, w_out, eps = params["output_norm.weight"], params["output.weight"], cfg.norm_eps

    def loss_fn(hidden, tgt_mb):
        logits = F.linear(F.rms_norm(hidden, w_norm, eps), w_out)
        logp = torch.log_softmax(logits, -1)
        return -torch.mean(torch.gather(logp, -1, tgt_mb[..., None].long())[..., 0])

    step = pipeline_train_step_1f1b if schedule == "1f1b" else pipeline_train_step_gpipe
    return step(mesh, axis, stage_fn, loss_fn, stage_p, x, tgt)


def make_pp_mesh(n_devices: int | None = None, device=None):
    """A one-axis ("stage",) mesh over the process group's ranks."""
    from .mesh import Mesh, _current_device
    n = n_devices or dist.get_world_size()
    return Mesh({"stage": n}, _current_device(device))
