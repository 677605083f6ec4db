"""Rank bodies of the port's multi-device tests, run in spawned gloo ranks
by ``torch_ranks.run_ranks``. Each returns numpy or plain Python; nothing
here imports jax or clearcam_tpu."""
from __future__ import annotations

import time

import numpy as np
import torch


def tiny_cfg(**kw):
    from clearcam_tpu_torch.models import llm
    base = dict(num_blocks=2, dim=32, hidden_dim=64, n_heads=4, n_kv_heads=2,
                norm_eps=1e-5, vocab_size=64, head_dim=8, rope_theta=1e4,
                rope_dim=8, v_head_dim=8, max_context=96)
    base.update(kw)
    return llm.TransformerConfig(**base)


# ---------------------------------------------------------------------------
# tensor-parallel serving
# ---------------------------------------------------------------------------

def _drive(eng, script):
    reqs = []
    for cmd in script:
        if cmd[0] == "submit":
            reqs.append(eng.submit(list(cmd[1]), max_new=cmd[2]))
        elif cmd[0] == "step":
            for _ in range(cmd[1]):
                eng.step()
        else:
            eng.run_until_idle()
    return [r.wait(5) for r in reqs]


def engine_tp(rank, cases, script):
    """A tp engine over every rank for each (cfg, params, engine_kw) case:
    rank 0 runs ``script`` (("submit", prompt, max_new) / ("step", n) /
    ("idle",)), the others follow. -> per case: rank 0's tokens, every
    rank's block-0 shard shapes and split keys."""
    from clearcam_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(data=1)
    out = []
    for cfg, params, engine_kw in cases:
        eng = pmesh.serving_engine_tp(params, cfg, mesh, **engine_kw)
        shapes = {k: tuple(getattr(v, "shape", ())) for k, v in eng.params.items()
                  if k.startswith("blk.0.")}
        st = eng.state[0]
        shapes["state"] = {k: tuple(v.shape) for k, v in st.items()}
        row = {"shapes": shapes, "split": sorted(eng.params.tp.split)}
        if mesh.is_leader:
            row["tokens"] = _drive(eng, script)
            row["steps"] = eng.ranks.steps
            eng.close()
            mesh.stop_followers()
        else:
            mesh.follow()
        out.append(row)
    return out


def _aux_row(aux, first_tok):
    return {"ids": aux["ids"].numpy().copy(), "pos": aux["pos"].numpy().copy(),
            "last": aux["last"].numpy().copy(), "first": first_tok.numpy().copy()}


def _record_aux(eng, mesh, log):
    """Append every rank's ``aux`` and first tokens to ``log`` after each
    prefill and decode graph it runs (rank 0: the engine's wrapped calls;
    a follower: the commands it runs)."""
    if mesh.is_leader:
        for name in ("prefill_slot", "decode_all", "prefill_many"):
            fn = getattr(eng, name)

            def lead(*a, _fn=fn, **k):
                out = _fn(*a, **k)
                log.append(_aux_row(eng.aux, eng._first_tok if len(out) == 4 else out[0]))
                return out
            setattr(eng, name, lead)
        return
    ranks = eng.ranks
    for name in ("prefill_slot", "decode_all", "prefill_many"):
        fn = getattr(ranks, name)

        def follow(*a, _fn=fn):
            _fn(*a)
            log.append(_aux_row(eng.aux, ranks._tok))
        setattr(ranks, name, follow)


def _fault(eng, at, after):
    """Raise on rank 0's ``at``-th decode call: before it (no command sent)
    or after the mirrored call returned."""
    orig, calls = eng.decode_all, {"n": 0}

    def wrapper(*a, **k):
        calls["n"] += 1
        if calls["n"] == at and not after:
            raise RuntimeError("injected decode failure")
        out = orig(*a, **k)
        if calls["n"] == at:
            raise RuntimeError("injected decode failure")
        return out
    eng.decode_all = wrapper


def _graph_end_fault(eng, at, times):
    """Raise inside rank 0's ``at``-th mirrored decode call, after its graph
    returned: the followers' graphs have ended too."""
    raw, calls = eng.ranks._decode, {"n": 0}

    def inside(*a):
        r = raw(*a)
        calls["n"] += 1
        if calls["n"] == at:
            times.append(time.monotonic())
            raise RuntimeError("injected fault inside a mirrored call")
        return r
    eng.ranks._decode = inside


# how long rank 0 waits before it raises inside a step, so that the
# followers, a block's work behind it, are waiting in the collective the
# test names (s)
SETTLE_S = 0.3


def reduce_fault(eng, method, calls, k, times):
    """Raise on rank 0 at its ``k``-th block reduction inside each of its
    ``method`` calls numbered in ``calls`` (the engine's mirrored wrapper:
    its command went out), before the reduction is posted: the followers
    then wait inside reduction ``k``. Appends the fault's time to
    ``times``."""
    tp, orig = eng.params.tp, getattr(eng, method)
    at = {"n": 0, "k": 0}

    def call(*a, **kw):
        at["n"] += 1
        at["k"] = 0
        return orig(*a, **kw)

    def reduce(t):
        if at["n"] in calls:
            at["k"] += 1
            if at["k"] == k:
                time.sleep(SETTLE_S)
                times.append(time.monotonic())
                raise RuntimeError("injected fault between two block reductions")
        return type(tp).reduce(tp, t)
    setattr(eng, method, call)
    object.__setattr__(tp, "reduce", reduce)


def _serve(eng, reqs, fresh):
    """Rank 0: ``reqs`` [(prompt, max_new)] submitted, then the scheduler on
    its thread, then ``fresh`` after them -> tokens, failed flags, restarts
    (a further submit refused: ``refused``)."""
    rs = [eng.submit(list(p), max_new=n) for p, n in reqs]
    eng.start()
    toks = [r.wait(60) for r in rs]
    try:
        r = eng.submit(list(fresh[0]), max_new=fresh[1])
        toks.append(r.wait(60))
        rs.append(r)
        refused = False
    except RuntimeError:
        refused = True
    out = {"tokens": toks, "failed": [x.failed for x in rs], "refused": refused,
           "restarts": eng.stats["scheduler_restarts"]}
    eng.close()
    return out


def engine_tp_spec(rank, cases, script, stoch, recoveries):
    """2 ranks, every speculative and recovery case in one spawn:
    - ``cases`` [(cfg, params, engine_kw)]: rank 0 runs ``script`` as in
      ``engine_tp``;
    - ``stoch`` (cfg, params, engine_kw, [(prompt, max_new, sampling kw)]):
      every rank's aux and first tokens after each graph call;
    - ``recoveries`` (cfg, params, [(engine_kw, fault), ...], reqs, fresh),
      the scheduler on its thread, fault on rank 0: ("before"|"after", at)
      around its decode call ``at`` (``_fault``); ("graph_end", at) inside
      that mirrored call, after its graph returned; ("reduce", method,
      calls, k) inside the graph, at its k-th block reduction
      (``reduce_fault``). -> rank 0: tokens, failed, restarts, the faults'
      times; a follower: its releases (``Channel.releases``)."""
    from clearcam_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(data=1)
    out = {"cases": [], "recoveries": []}
    for cfg, params, engine_kw in cases:
        eng = pmesh.serving_engine_tp(params, cfg, mesh, **engine_kw)
        row = {"spec": eng.spec}
        if mesh.is_leader:
            row["tokens"] = _drive(eng, script)
            row["steps"] = eng.ranks.steps
            row["spec_emitted"] = eng.stats["spec_emitted"]
            eng.close()
            mesh.stop_followers()
        else:
            mesh.follow()
        out["cases"].append(row)
    cfg, params, engine_kw, reqs = stoch
    eng = pmesh.serving_engine_tp(params, cfg, mesh, **engine_kw)
    log = []
    _record_aux(eng, mesh, log)
    if mesh.is_leader:
        rs = [eng.submit(list(p), max_new=n, **kw) for p, n, kw in reqs]
        eng.run_until_idle()
        out["stoch_tokens"] = [r.wait(5) for r in rs]
        eng.close()
        mesh.stop_followers()
    else:
        mesh.follow()
    out["aux_log"] = log
    cfg, params, runs, reqs, fresh = recoveries
    for engine_kw, fault in runs:
        eng = pmesh.serving_engine_tp(params, cfg, mesh, **engine_kw)
        row, n_rel = {}, len(mesh.channel.releases)
        if mesh.is_leader:
            times = []
            if fault[0] in ("before", "after"):
                _fault(eng, fault[1], fault[0] == "after")
            elif fault[0] == "graph_end":
                _graph_end_fault(eng, fault[1], times)
            else:
                reduce_fault(eng, *fault[1:], times)
            row.update(_serve(eng, reqs, fresh))
            row["faults"] = times
            row["broken"] = eng.ranks.broken
            mesh.stop_followers()
        else:
            mesh.follow()
            row["releases"] = mesh.channel.releases[n_rel:]
        out["recoveries"].append(row)
    return out


def broken_repair_ranks(rank, cfg, params, reqs, fresh):
    """2 ranks: rank 0's own block reduction fails in the backend (nothing
    posted) inside decode call 2, so it cannot release the follower. Rank 0
    prints ``_serve``'s row and ``broken`` to stderr (the follower leaves
    its process, so no result comes back through the queue)."""
    import json
    import sys
    import torch.distributed as dist
    from clearcam_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(data=1)
    eng = pmesh.serving_engine_tp(params, cfg, mesh, n_slots=2, max_restarts=3,
                                  sync_lag=4)
    if not mesh.is_leader:
        mesh.follow()
        return {}
    orig_decode, orig_reduce, at = eng.decode_all, dist.all_reduce, {"n": 0}

    def decode(*a):
        at["n"] += 1
        return orig_decode(*a)

    def all_reduce(*a, **k):
        if at["n"] == 2:
            raise RuntimeError("injected backend failure of a block reduction")
        return orig_reduce(*a, **k)
    eng.decode_all, dist.all_reduce = decode, all_reduce
    row = _serve(eng, reqs, fresh)
    row["broken"] = eng.ranks.broken
    print("rank 0 row " + json.dumps(row), file=sys.stderr, flush=True)
    time.sleep(60)        # the follower's exit ends the spawn
    return row


def vlm_spec_ranks(rank, tc, tp, vkv, vp, frame, spec, max_new, k):
    """2 ranks: VLMServingEngine(mesh=) under CLEARCAM_SPEC_LOOKUP=spec on
    rank 0's request -> its text and decode steps, the engine's spec
    width; then one without spec (max_restarts 1, its scheduler on a
    thread) where rank 0 raises at its k-th block reduction inside the
    mirrored image prefill (``custom_prefill``) -> the retried request's
    text, failed flag and restarts, the fault's time; the follower's
    releases."""
    import os
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    os.environ["CLEARCAM_SPEC_LOOKUP"] = str(spec)
    mesh = pmesh.make_mesh(2, data=1)
    qwen = port_vlm(tc, tp, vkv, vp)
    eng = VLMServingEngine(qwen, n_slots=2, mesh=mesh)
    out = {"spec": eng.engine.spec}
    if mesh.is_leader:
        r = eng.submit([frame], "what is this", max_new=max_new, temperature=0.0)
        eng.run_until_idle()
        out["text"] = eng.text(r)
        out["decode_steps"] = eng.engine.stats["decode_steps"]
        eng.close()
        mesh.stop_followers()
    else:
        mesh.follow()
    os.environ["CLEARCAM_SPEC_LOOKUP"] = "0"
    eng = VLMServingEngine(qwen, n_slots=2, mesh=mesh, max_restarts=1)
    if mesh.is_leader:
        times = []
        reduce_fault(eng.engine, "custom_prefill", {1}, k, times)
        r = eng.submit([frame], "what is this", max_new=max_new, temperature=0.0)
        eng.start()
        r.wait(60)
        out["fault"] = {"text": eng.text(r), "failed": r.failed, "faults": times,
                        "restarts": eng.engine.stats["scheduler_restarts"]}
        eng.close()
        mesh.stop_followers()
    else:
        mesh.follow()
        out["releases"] = mesh.channel.releases
    return out


def solo_engine(cfg, params, engine_kw, script):
    """The same script on the port's one-device engine."""
    from clearcam_tpu_torch.serving.engine import ServingEngine
    eng = ServingEngine(params, cfg, device="cpu", **engine_kw)
    toks = _drive(eng, script)
    eng.close()
    return toks


# ---------------------------------------------------------------------------
# detection: sharded_detect_fn, BatchDetector(mesh=), federation
# ---------------------------------------------------------------------------

def detect_ranks(rank, params_np, frames8, frames5):
    """4 ranks: the default axes, then dp 4 detect (every rank's gathered
    rows) and a leading BatchDetector (rank 0's rows)."""
    from clearcam_tpu_torch.models import yolov9
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    default = pmesh.make_mesh().shape
    mesh = pmesh.make_mesh(4, data=4)
    det, in_spec = pmesh.sharded_detect_fn(mesh, "t", res=64,
                                           compute_dtype=torch.float32)
    params = yolov9.params_from_jax(pmesh.replicate(mesh, params_np), "cpu")
    rows = in_spec(frames8)
    sharded = det(params, rows).numpy()
    bd = BatchDetector("t", res=64, params=params_np, dtype=torch.float32,
                       device="cpu", mesh=mesh)
    out = {"default": default, "local_rows": tuple(rows.shape), "sharded": sharded,
           "buckets": [bd._bucket(5), bd._bucket(9)]}
    if mesh.is_leader:
        out["batch"] = np.stack(bd.detect_many(list(frames5)))
        mesh.stop_followers()
    else:
        mesh.follow()
    return out


def detect_fault_ranks(rank, params_np, frames, path=None, world=2, backend="gloo"):
    """``world`` data ranks (on the CPU; with ``path``, one NCCL rank a card,
    joining the group here): BatchDetector(mesh=) where rank 0, after a
    first step, raises inside one, between the frames' scatter and the
    rows' gather, then runs the next step. -> rank 0: the raise, its time and the next step's
    rows (on a card also one device's, each data rank's rows at its batch);
    the other ranks: their releases; every rank: its stem launches."""
    from clearcam_tpu_torch.ops.stem import stem
    from clearcam_tpu_torch.parallel import comm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.runtime.nvr import BatchDetector
    dev = "cpu" if path is None else comm.init_group(rank, world, f"file://{path}", "cuda",
                                                     backend)
    mesh = pmesh.make_mesh(world, data=world)
    bd = BatchDetector("t", res=64, params=params_np, dtype=torch.float32, device=dev,
                       mesh=mesh)
    out = {}
    s0 = stem.launches
    if not mesh.is_leader:
        mesh.follow()
        out["releases"] = mesh.channel.releases
        out["stem"] = stem.launches - s0
        return out
    bd.detect_many(list(frames))
    step = bd._step

    def fail(*a):
        time.sleep(SETTLE_S)
        out["fault"] = time.monotonic()
        raise RuntimeError("injected fault between scatter and gather")
    bd._step = fail
    try:
        bd.detect_many(list(frames))
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    bd._step = step
    out["rows"] = np.stack(bd.detect_many(list(frames)))
    mesh.stop_followers()
    out["stem"] = stem.launches - s0
    if path is not None:
        one, n = BatchDetector("t", res=64, params=params_np, dtype=torch.float32,
                               device=dev), len(frames) // world
        out["solo"] = np.stack([r for i in range(world)
                                for r in one.detect_many(list(frames[i * n:(i + 1) * n]))])
    return out


def federation_rank(rank, port, frames):
    """2 processes joining over tcp://, 2 cameras each."""
    from clearcam_tpu_torch.models import yolov9
    from clearcam_tpu_torch.parallel import federation as fed
    fed.init_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                         device="cpu")
    mesh = fed.make_global_mesh(model=1)
    try:
        fed.make_global_mesh(model=4)
        refused = False
    except ValueError:
        refused = True
    params = yolov9.params_from_jax(yolov9.init_params("t", seed=0), "cpu")
    local = frames[rank]
    gbatch = fed.host_batch_to_global(mesh, local)
    step, _ = fed.global_detect_step(mesh, "t", res=64, compute_dtype=torch.float32)
    mine = fed.fetch_local(step(params, gbatch))
    solo = yolov9.detect(params, torch.from_numpy(local), size="t", res=64).numpy()
    return {"shape": mesh.shape, "start": gbatch.start, "total": gbatch.total,
            "mine": mine, "solo": solo, "refused": refused}


# ---------------------------------------------------------------------------
# sequence parallel: ring attention, sharded prefill
# ---------------------------------------------------------------------------

def seq_ranks(rank, ring_cases, cfg, params, prompt, hybrid_cfg):
    """4 ranks: ring_prefill on each case, then the sequence-parallel
    prefill, the materialized cache and 3 greedy decode steps."""
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.parallel.long_prefill import (gather_seq, make_sharded_prefill,
                                                         materialize_state)
    from clearcam_tpu_torch.parallel.ringattn import ring_prefill
    mesh = pmesh.make_mesh(4, data=4)
    out = {"ring": []}
    for q, k, v, causal in ring_cases:
        fn = ring_prefill(mesh, "data", causal=causal)
        out["ring"].append(fn(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v)).numpy())
    group = mesh.group("data")
    hidden, kvs = make_sharded_prefill(mesh, cfg)(params, torch.from_numpy(prompt))
    out["hidden"] = gather_seq(hidden, group).numpy()
    out["kv"] = [(gather_seq(k, group).numpy(), gather_seq(v, group).numpy())
                 for k, v in kvs]
    state = materialize_state(cfg, kvs, batch=prompt.shape[0], group=group)
    freqs = llm.freqs_for(cfg, "cpu")
    t = prompt.shape[1]
    full = gather_seq(hidden, group)
    toks = [int(torch.argmax(llm.logits_at(params, cfg, full, t - 1), -1)[0])]
    with torch.no_grad():
        for j in range(3):
            h, state = llm.forward(params, cfg, state, torch.tensor([[toks[-1]]]),
                                   t + j, freqs)
            toks.append(int(torch.argmax(llm.logits_at(params, cfg, h, 0), -1)[0]))
    out["decode"] = toks
    try:
        make_sharded_prefill(mesh, hybrid_cfg)
        out["refused"] = False
    except AssertionError as e:
        out["refused"] = "attention" in str(e)
    return out


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------

def mlp_stage(p, x):
    return torch.nn.functional.silu(x @ p["w1"]) @ p["w2"]


def mse(pred, tgt):
    return torch.mean((pred - tgt) ** 2)


def pipe_ranks(rank, stages, apply_cases, train_cases, llm_case):
    """4 stages: pipeline_apply, both training schedules (loss, this
    stage's grads), the 1F1B ring's occupancy at two M, and the LLM
    instantiation."""
    from clearcam_tpu_torch.parallel import pipeline as pp
    mesh = pp.make_pp_mesh(4)
    s = mesh.coord("stage")
    out = {"apply": [], "train": [], "peak": {}}
    for x in apply_cases:
        out["apply"].append(pp.pipeline_apply(mesh, "stage", mlp_stage, stages[s],
                                              torch.from_numpy(x)).numpy())
    for x, y in train_cases:
        row = {}
        for name, fn in (("1f1b", pp.pipeline_train_step_1f1b),
                         ("gpipe", pp.pipeline_train_step_gpipe)):
            loss, g = fn(mesh, "stage", mlp_stage, mse, stages[s], torch.from_numpy(x),
                         torch.from_numpy(y))
            row[name] = (float(loss), {k: v.numpy() for k, v in g.items()})
        out["train"].append(row)
    for m_n in (16, 32):
        stats = {}
        z = torch.zeros((m_n, 2, 16))
        pp.pipeline_train_step_1f1b(mesh, "stage", mlp_stage, mse, stages[s], z, z,
                                    stats=stats)
        out["peak"][m_n] = (stats["ring_slots"], stats["peak_live"])
    cfg, params, tokens, targets, cfg_pre, params_pre, tokens_pre = llm_case
    out["pre"] = pp.pp_llm_prefill(mesh, "stage", params_pre, cfg_pre,
                                   torch.from_numpy(tokens_pre), n_micro=2).numpy()
    for sched in ("1f1b", "gpipe"):
        loss, g = pp.pp_llm_train_step(mesh, "stage", params, cfg,
                                       torch.from_numpy(tokens), torch.from_numpy(targets),
                                       n_micro=2, schedule=sched)
        out[sched] = (float(loss), {k: v.numpy() for k, v in g.items()})
    out["layout"] = sorted(pp.stack_llm_stage_params(params, cfg, 4, s))
    return out


# ---------------------------------------------------------------------------
# MoE expert parallelism, the VLM engine, the NVR summary engine
# ---------------------------------------------------------------------------

def moe_prefill_ranks(rank, cfg, params, tokens):
    """2 ranks: the ep-sharded prefill's first token."""
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(2, data=1)
    sharded = pmesh.shard_llm_params(mesh, params, cfg)
    pre = pmesh.sharded_llm_prefill(mesh, sharded, cfg)
    state = pmesh.shard_llm_state(mesh, cfg, llm.init_state(cfg))
    tok, _ = pre(state, torch.from_numpy(tokens), 0, 4, 0.0)
    return {"tok": int(tok[0]), "exps": tuple(sharded["blk.0.ffn_gate_exps.weight"].shape),
            "split": sorted(sharded.tp.split)}


def port_vlm(tc, tp, vkv, vp):
    """The port's tiny Qwen3-VL (test_torch_port_qwen3vl's widths)."""
    from clearcam_tpu_torch.models import llm
    from clearcam_tpu_torch.models import qwen3vl as tvl
    from clearcam_tpu_torch.utils.llm_tokenizer import LLMTokenizer
    from clearcam_tpu_torch.utils.tokenizer import byte_encoder
    be = byte_encoder()
    normal = {be[b]: b for b in range(256)}
    specials = {"<|im_start|>": 256, "<|im_end|>": 257,
                "<|vision_start|>": 258, "<|vision_end|>": 259}
    tok = LLMTokenizer(normal, specials, preset="qwen2", bos_id=None, eos_id=257)
    return tvl.Qwen3VL(res=(64, 96), lang=llm.Transformer(tp, tc, seed=0), tok=tok,
                       vision=tvl.VisionTower(vkv, vp, device="cpu"))


def vlm_ranks(rank, tc, tp, vkv, vp, frame, tmp):
    """2 ranks: VLMServingEngine(mesh=) on rank 0's request, then the NVR's
    tensor-parallel summary engine (NVR(llm_mesh=)), the followers building
    theirs on rank 0's command; then a request whose image prefill rank 0
    fails inside (its first block reduction), driven by the NVR's own
    summary ticks until done -> its text and the fault's time; the
    follower's releases."""
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    from clearcam_tpu_torch.ops.vit_attention import mha_flash
    mesh = pmesh.make_mesh(2, data=1)
    qwen = port_vlm(tc, tp, vkv, vp)
    eng = VLMServingEngine(qwen, n_slots=2, mesh=mesh)
    kshape = tuple(eng.engine.state[0]["k"].shape)
    out = {"kshape": kshape}
    if not mesh.is_leader:

        class Follower:
            def summary_engine(self, n_slots):
                VLMServingEngine(qwen, n_slots=n_slots, state_dtype=torch.bfloat16,
                                 mesh=mesh)
        mesh.channel.register_as("nvr", Follower())
        mesh.follow()
        out["releases"] = mesh.channel.releases
        return out
    r = eng.submit([frame], "what is this", max_new=4, temperature=0.0)
    eng.run_until_idle()
    out["text"] = eng.text(r)
    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.utils.db import KVStore
    nvr = NVR(KVStore(f"{tmp}/kv.db"), f"{tmp}/data", qwen=qwen, summary_slots=2,
              use_native_ingest=False, llm_mesh=mesh)
    try:
        se = nvr.summary_engine()
        r2 = se.submit([frame], "what is this", max_new=4, temperature=0.0)
        se.run_until_idle()
        out["nvr_text"] = se.text(r2)
        out["nvr_kshape"] = tuple(se.engine.state[0]["k"].shape)
        out["nvr_dtype"] = str(se.engine.state[0]["k"].dtype)
        times = []
        reduce_fault(se.engine, "custom_prefill", {1}, 1, times)
        r3 = se.submit([frame], "what is this", max_new=4, temperature=0.0)
        for _ in range(100):
            if r3.done:
                break
            nvr._advance_summary_engine()
        out["nvr_fault"] = {"text": se.text(r3), "faults": times}
    finally:
        nvr.stop()
    out["vit"] = mha_flash.launches
    mesh.stop_followers()
    return out


# ---------------------------------------------------------------------------
# YOLOv9 training under dp x tp
# ---------------------------------------------------------------------------

def train_ranks(rank, params_np, frames, boxes, cls, targets, steps):
    """4 ranks on a (2, 2) mesh: make_train_step under shard_params_tp, both
    kinds; -> the losses and the whole params after ``steps``."""
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.tools.finetune import train_params
    mesh = pmesh.make_mesh(4, data=2)
    out = {"shape": mesh.shape}
    for kind in ("detect", "distill"):
        params = pmesh.shard_params_tp(mesh, train_params(params_np, "cpu"))
        marked = sorted(k for k, v in params.items() if hasattr(v, "tp_group"))
        step, opt = pmesh.make_train_step("t", lr=1e-3, kind=kind, mesh=mesh)
        opt_state = opt.init(params)
        losses = []
        for i in range(steps):
            if kind == "detect":
                params, opt_state, loss = step(
                    params, opt_state, pmesh.shard_batch(mesh, frames[i]),
                    pmesh.shard_batch(mesh, boxes[i]), pmesh.shard_batch(mesh, cls[i]))
            else:
                params, opt_state, loss = step(params, opt_state,
                                               pmesh.shard_batch(mesh, frames[i]),
                                               pmesh.shard_batch(mesh, targets[i]))
            losses.append(float(loss))
        out[kind] = (losses, {k: v.numpy() for k, v in
                              pmesh.gather_params_tp(params).items()})
        out[kind + "_marked"] = marked
    return out


def solo_train(params_np, frames, boxes, cls, targets, steps):
    """The same steps on one device."""
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.tools.finetune import train_params
    out = {}
    for kind in ("detect", "distill"):
        params = train_params(params_np, "cpu")
        step, opt = pmesh.make_train_step("t", lr=1e-3, kind=kind)
        opt_state = opt.init(params)
        losses = []
        for i in range(steps):
            extra = (torch.from_numpy(boxes[i]), torch.from_numpy(cls[i])) \
                if kind == "detect" else (torch.from_numpy(targets[i]),)
            params, opt_state, loss = step(params, opt_state, torch.from_numpy(frames[i]),
                                           *extra)
            losses.append(float(loss))
        out[kind] = (losses, {k: v.detach().numpy() for k, v in params.items()})
    return out


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_port_cuda.py)
# ---------------------------------------------------------------------------

def tp_decode_on_card(rank, path, cfg, params, script):
    """2 gloo ranks sharing card 0: the int8-weight tp engine through the
    batched decode kernel on a bf16 cache. -> rank 0's tokens, and every
    rank's kernel launches and cache shape."""
    from clearcam_tpu_torch.ops.decode_attention import decode_attention_batch
    from clearcam_tpu_torch.ops.quant_matmul import quant_linear
    from clearcam_tpu_torch.parallel import comm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.models import llm
    dev = comm.init_group(rank, 2, f"file://{path}", "cuda", "gloo")
    mesh = pmesh.make_mesh(data=1)
    p = {k: (v.to(dev) if hasattr(v, "to") else v) for k, v in params.items()}
    p = llm.quantize_params_int8(p)
    eng = pmesh.serving_engine_tp(p, cfg, mesh, n_slots=2, state_dtype=torch.bfloat16,
                                  use_pallas_decode=True)
    q0, d0 = quant_linear.launches, decode_attention_batch.launches
    out = {"kshape": tuple(eng.state[0]["k"].shape), "device": str(eng.device)}
    if mesh.is_leader:
        out["tokens"] = _drive(eng, script)
        eng.close()
        mesh.stop_followers()
    else:
        mesh.follow()
    out["quant_linear"] = quant_linear.launches - q0
    out["decode_attention_batch"] = decode_attention_batch.launches - d0
    return out


def tp_fault_on_card(rank, path, cfg, params, reqs, fresh, fault, world=2, backend="gloo",
                     device="cuda"):
    """``world`` ranks (gloo ranks share card 0; NCCL ranks a card each),
    the int8-weight tp engine through the batched decode kernel on a bf16
    cache (max_restarts 1): rank 0 raises inside a mirrored call, ``fault``
    = (method, calls, k) as ``reduce_fault`` takes them, and recovers. ->
    rank 0: tokens, failed, restarts, the fault's time; every rank: its
    kernel launches after its reset, its releases."""
    from clearcam_tpu_torch.ops.decode_attention import decode_attention_batch
    from clearcam_tpu_torch.ops.quant_matmul import quant_linear
    from clearcam_tpu_torch.parallel import comm
    from clearcam_tpu_torch.parallel import mesh as pmesh
    from clearcam_tpu_torch.models import llm
    dev = comm.init_group(rank, world, f"file://{path}", device, backend)
    mesh = pmesh.make_mesh(data=1)
    p = llm.quantize_params_int8({k_: (v.to(dev) if hasattr(v, "to") else v)
                                  for k_, v in params.items()})
    eng = pmesh.serving_engine_tp(p, cfg, mesh, n_slots=2, state_dtype=torch.bfloat16,
                                  use_pallas_decode=True, max_restarts=1, sync_lag=4)
    at_reset = {}

    def counted(fn):
        def run(*a):
            at_reset.update(q=quant_linear.launches, d=decode_attention_batch.launches)
            return fn(*a)
        return run
    out = {}
    if mesh.is_leader:
        times = []
        eng.ranks.reset_all = counted(eng.ranks.reset_all)
        reduce_fault(eng, *fault, times)
        out.update(_serve(eng, reqs, fresh))
        out["faults"] = times
        mesh.stop_followers()
    else:
        eng.ranks.reset = counted(eng.ranks.reset)
        mesh.follow()
        out["releases"] = mesh.channel.releases
    out["quant_linear"] = quant_linear.launches - at_reset["q"]
    out["decode_attention_batch"] = decode_attention_batch.launches - at_reset["d"]
    return out


def ring_on_card(rank, path, q, k, v):
    """World size 1 over NCCL: ring_attention_shard on CUDA tensors."""
    from clearcam_tpu_torch.parallel import comm
    from clearcam_tpu_torch.parallel.ringattn import ring_attention_shard
    dev = comm.init_group(rank, 1, f"file://{path}", "cuda", "nccl")
    out = ring_attention_shard(*(torch.from_numpy(z).to(dev) for z in (q, k, v)))
    return {"out": out.cpu().numpy(), "backend": comm.backend_of()}
