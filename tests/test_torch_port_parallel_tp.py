"""The port's tensor and expert parallelism against the JAX package's and
against its own one-device paths, on the CPU with 2 or 4 gloo ranks
(``torch_ranks.run_ranks``): the tp serving engine (f32 against JAX
``serving_engine_tp`` and solo ``Transformer.generate``; int8 and int4
weights with bf16 and int8 caches through the batched decode kernels'
plain versions, MoE expert parallelism, MLA and GatedDeltaNet-hybrid
stacks against the port's one-device engine), every split weight and the
cache at 1/m, the ep-sharded prefill's first token against JAX
``sharded_llm_prefill``, ``VLMServingEngine(mesh=)`` and the NVR's
tensor-parallel summary engine against solo ``Qwen3VL.generate``, and the
YOLOv9 training step under ``shard_params_tp`` against the one-device
step. Speculative windows under the mesh (``spec_lookup``): rank 0's tokens
against JAX ``serving_engine_tp(spec_lookup=3)``, solo generation and the
port's one-device spec engine, every rank's ``aux`` against rank 0's beside
a stochastic row, and ``VLMServingEngine(mesh=)`` under
``CLEARCAM_SPEC_LOOKUP``; crash recovery on 2 ranks: faults before a
mirrored call's command, after it returned, and inside it (between two
block reductions of a decode, a spec window or a batched prefill, with the
follower waiting in the next one, or after the graph) recover, the last
within a restart budget. Tokens are compared exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.models import qwen3vl as jvl
from clearcam_tpu.models import yolov9 as jyolo
from clearcam_tpu.parallel import mesh as jmesh
from clearcam_tpu.utils.llm_tokenizer import LLMTokenizer as JTok
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.models import qwen3vl as tvl

import torch_parallel_workers as W
from test_llm import tiny_cfg
from test_torch_port_llm import port_cfg
from test_torch_port_llm_families import FAMILIES
from test_torch_port_qwen3vl import _cfgs, _jax_lm, _params, _tok
from torch_ranks import run_ranks

SCRIPT = [("submit", [1, 2, 3, 4, 5], 6), ("step", 2), ("submit", [9, 8, 7], 5),
          ("idle",)]


def _quant_cfg():
    """Widths the quantizers take (every product >= 256 wide), head_dim 128
    for the decode kernels, 2 KV heads to split over 2 ranks."""
    return tiny_cfg(dim=256, hidden_dim=512, n_heads=4, n_kv_heads=2, head_dim=128,
                    rope_dim=128, v_head_dim=128, vocab_size=512, max_context=128,
                    qk_norm=128)


def _cases():
    """(name, JAX cfg, port params, engine kwargs)."""
    out = []
    cfg = tiny_cfg(max_context=96)
    out.append(("f32", cfg, tllm.params_from_jax(jllm.init_params(cfg, seed=4)),
                dict(n_slots=2)))
    for fam in ("qwen_moe", "mla", "ssm_hybrid"):
        c = tiny_cfg(max_context=96, **FAMILIES[fam])
        out.append((fam, c, tllm.params_from_jax(jllm.init_params(c, seed=7)),
                    dict(n_slots=2)))
    qc = _quant_cfg()
    qp = tllm.params_from_jax(jllm.init_params(qc, seed=3))
    out.append(("int8_bf16kv", qc, tllm.quantize_params_int8(qp),
                dict(n_slots=2, state_dtype=torch.bfloat16, use_pallas_decode=True)))
    out.append(("int4_int8kv", qc, tllm.quantize_params_int4(qp),
                dict(n_slots=2, kv_quant=True, use_pallas_decode=True)))
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    cases = _cases()
    runs = run_ranks(W.engine_tp, 2, tmp_path_factory.mktemp("tp"),
                     [(port_cfg(c), p, kw) for _, c, p, kw in cases], SCRIPT)
    return {name: (cfg, p, kw, [r[i] for r in runs])
            for i, (name, cfg, p, kw) in enumerate(cases)}


def test_tp_engine_f32_matches_jax_tp_and_solo(engines):
    """Staggered requests, one joining mid-flight: rank 0's greedy tokens
    equal JAX serving_engine_tp's (2-device mesh, (1, 2)) and JAX's solo
    Transformer.generate; both ranks hold half of q/k/v/gate/up rows, half
    of attn_output/ffn_down columns, and one of the two KV heads."""
    cfg, _, _, (r0, r1) = engines["f32"]
    jp = jllm.init_params(cfg, seed=4)
    eng = jmesh.serving_engine_tp(jp, cfg, jmesh.make_mesh(2, data=1), n_slots=2)
    j1 = eng.submit([1, 2, 3, 4, 5], max_new=6)
    for _ in range(2):
        eng.step()
    j2 = eng.submit([9, 8, 7], max_new=5)
    eng.run_until_idle()

    def solo(prompt, n):
        return list(jllm.Transformer(jp, cfg, seed=0).generate(list(prompt), temperature=0.0,
                                                               max_new=n))
    assert r0["tokens"] == [j1.wait(1), j2.wait(1)]
    assert r0["tokens"] == [solo([1, 2, 3, 4, 5], 6), solo([9, 8, 7], 5)]
    assert r0["steps"] > 0
    for r in (r0, r1):
        sh = r["shapes"]
        assert sh["blk.0.attn_q.weight"] == (16, 32)
        assert sh["blk.0.attn_k.weight"] == sh["blk.0.attn_v.weight"] == (8, 32)
        assert sh["blk.0.attn_output.weight"] == (32, 16)
        assert sh["blk.0.ffn_gate.weight"] == sh["blk.0.ffn_up.weight"] == (32, 32)
        assert sh["blk.0.ffn_down.weight"] == (32, 32)
        assert sh["state"] == {"k": (2, 1, 96, 8), "v": (2, 1, 96, 8)}
        assert r["split"] == ["blk.0.attn_output.weight", "blk.0.ffn_down.weight",
                              "blk.1.attn_output.weight", "blk.1.ffn_down.weight"]


@pytest.mark.parametrize("name", ["qwen_moe", "mla", "ssm_hybrid", "int8_bf16kv",
                                  "int4_int8kv"])
def test_tp_engine_matches_one_device_engine(engines, name):
    """The same staggered requests through the port's one-device engine
    give the same tokens; the split layout of each stack (experts E/2 a
    rank; MLA and GatedDeltaNet blocks replicated; int8 rows and int4
    columns sliced; the int8 cache's scales split with its heads)."""
    cfg, params, kw, (r0, r1) = engines[name]
    assert r0["tokens"] == W.solo_engine(port_cfg(cfg), params, kw, SCRIPT)
    sh, split = r0["shapes"], set(r0["split"])
    assert r1["shapes"] == sh
    if name == "qwen_moe":
        assert sh["blk.0.ffn_gate_exps.weight"][0] == 2
        assert "blk.0.ffn_down_exps.weight" in split
        assert sh["blk.0.ffn_gate_shexp.weight"] == (16, 32)
        assert sh["state"]["k"] == (2, 1, 96, 8)
    elif name == "mla":
        assert not any("attn" in k for k in split)
        assert sh["state"]["kv"][1] == 1
    elif name == "ssm_hybrid":
        assert "blk.0.attn_output.weight" not in split       # block 0 is GatedDeltaNet
        assert "blk.1.attn_output.weight" in split
        assert sh["state"]["conv"][0] == 2
    else:
        assert sh["state"]["k"] == (2, 1, 128, 128)
        assert sh["blk.0.attn_q.weight"] == (256, 256)
        assert sh["blk.0.attn_output.weight"] == (256, 256)
        assert sh["blk.0.ffn_down.weight"] == (256, 256)
        if name == "int4_int8kv":
            assert sh["state"]["k_s"] == (2, 1, 128)


SPEC = 3
STOCH = [([1, 2, 3, 4, 5], 8, {}),
         ([9, 8, 7], 8, {"temperature": 0.7, "repetition_penalty": 1.3,
                         "presence_penalty": 1.0, "logit_bias": {5: 3.0}}),
         ([4, 4, 4, 4], 8, {})]
RECOVERY_REQS, RECOVERY_FRESH = [([1, 2, 3, 4, 5], 6), ([9, 8, 7], 5)], ([5, 5], 4)
# the block reduction rank 0 fails at inside a decode call: the first of
# block 1's (2 a block: attn_output, ffn_down)
K = 3
# (spec_lookup, fault, max_restarts), fault on rank 0 (torch_parallel_workers
# .engine_tp_spec): at decode call 2, before the command / after the
# mirrored call returned; inside a mirrored call: at its k-th block
# reduction (a follower waits inside it), or after its graph returned; two
# inside faults on a budget of one restart
RECOVERY_RUNS = [(0, ("before", 2), 3), (0, ("after", 2), 3), (SPEC, ("before", 2), 3),
                 (SPEC, ("after", 2), 3),
                 (0, ("reduce", "decode_all", {2}, K), 3),
                 (SPEC, ("reduce", "decode_all", {2}, K), 3),
                 (0, ("reduce", "prefill_many", {1}, 2), 3),
                 (0, ("graph_end", 2), 3),
                 (0, ("reduce", "decode_all", {2, 4}, K), 1)]
# the cases inside a mirrored call: index in RECOVERY_RUNS, the reduction
# the follower waits in (None: its graph had ended)
INSIDE = {"decode": (4, K), "spec_window": (5, K), "prefill_many": (6, 2),
          "after_the_graph": (7, None)}


def _spec_cases():
    """(name, JAX cfg, port params, engine kwargs): spec_lookup=3 on the
    f32 model, MoE and MLA stacks, int8 weights with a bf16 cache and int4
    weights with an int8 cache (plain attention: a window has G+1
    queries)."""
    out = []
    for name, cfg, p, kw in _cases():
        if name == "ssm_hybrid":
            continue                     # spec refuses GatedDeltaNet stacks
        kw = {k: v for k, v in kw.items() if k != "use_pallas_decode"}
        out.append((name, cfg, p, dict(kw, spec_lookup=SPEC)))
    return out


@pytest.fixture(scope="module")
def spec_engines(tmp_path_factory):
    """One spawn of 2 ranks: the staggered script on every spec case, the
    stochastic row's aux log and the recovery runs."""
    cases = _spec_cases()
    cfg = tiny_cfg(max_context=96)
    jp = jllm.init_params(cfg, seed=4)
    tp = tllm.params_from_jax(jp)
    stoch = (port_cfg(cfg), tp, dict(n_slots=3, spec_lookup=SPEC), STOCH)
    runs = [(dict(n_slots=2, max_restarts=n, sync_lag=4, spec_lookup=g), fault)
            for g, fault, n in RECOVERY_RUNS]
    r0, r1 = run_ranks(W.engine_tp_spec, 2, tmp_path_factory.mktemp("tp_spec"),
                       [(port_cfg(c), p, kw) for _, c, p, kw in cases], SCRIPT, stoch,
                       (port_cfg(cfg), tp, runs, RECOVERY_REQS, RECOVERY_FRESH))
    return {"cases": {name: (c, p, kw, r0["cases"][i])
                      for i, (name, c, p, kw) in enumerate(cases)},
            "model": (cfg, jp), "r0": r0, "r1": r1}


def _jax_solo(jp, cfg, prompt, n):
    return list(jllm.Transformer(jp, cfg, seed=0).generate(list(prompt), temperature=0.0,
                                                           max_new=n))


def test_tp_spec_engine_f32_matches_jax_tp_and_solo(spec_engines):
    """serving_engine_tp(spec_lookup=3) on 2 ranks, staggered requests:
    rank 0's tokens equal JAX serving_engine_tp(spec_lookup=3)'s on a
    (1, 2) mesh and JAX's solo greedy generation, exactly."""
    cfg, jp = spec_engines["model"]
    row = spec_engines["cases"]["f32"][3]
    eng = jmesh.serving_engine_tp(jp, cfg, jmesh.make_mesh(2, data=1), n_slots=2,
                                  spec_lookup=SPEC)
    j1 = eng.submit([1, 2, 3, 4, 5], max_new=6)
    for _ in range(2):
        eng.step()
    j2 = eng.submit([9, 8, 7], max_new=5)
    eng.run_until_idle()
    assert row["spec"] == SPEC
    assert row["tokens"] == [j1.wait(1), j2.wait(1)]
    assert row["tokens"] == [_jax_solo(jp, cfg, [1, 2, 3, 4, 5], 6),
                             _jax_solo(jp, cfg, [9, 8, 7], 5)]
    assert row["spec_emitted"] == eng.stats["spec_emitted"] > 0
    assert row["steps"] == eng.stats["decode_steps"] > 0


@pytest.mark.parametrize("name", ["qwen_moe", "mla", "int8_bf16kv", "int4_int8kv"])
def test_tp_spec_engine_matches_one_device_engine(spec_engines, name):
    """The same staggered spec requests through the port's one-device spec
    engine give the same tokens, exactly."""
    cfg, params, kw, row = spec_engines["cases"][name]
    assert row["spec"] == SPEC
    assert row["tokens"] == W.solo_engine(port_cfg(cfg), params, kw, SCRIPT)


def test_tp_spec_aux_is_rank0s_beside_a_stochastic_row(spec_engines):
    """A temperature-0.7 row with penalties and a logit bias (which the
    followers sample with inert counts and bias) beside two greedy rows: after
    every prefill and decode graph, each rank's aux (ids, pos, last) and
    first tokens equal rank 0's; the greedy rows' tokens are JAX solo's."""
    cfg, jp = spec_engines["model"]
    r0, r1 = spec_engines["r0"], spec_engines["r1"]
    log0, log1 = r0["aux_log"], r1["aux_log"]
    assert len(log0) == len(log1) > 8
    for i, (a, b) in enumerate(zip(log0, log1)):
        for k in ("ids", "pos", "last", "first"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"graph call {i}: {k}")
    toks = r0["stoch_tokens"]
    assert toks[0] == _jax_solo(jp, cfg, [1, 2, 3, 4, 5], 8)
    assert toks[2] == _jax_solo(jp, cfg, [4, 4, 4, 4], 8)
    assert len(toks[1]) == 8


@pytest.mark.parametrize("i", range(4), ids=[f"spec{g}-{f[0]}"
                                             for g, f, _ in RECOVERY_RUNS[:4]])
def test_tp_engine_recovers_on_two_ranks(spec_engines, i):
    """max_restarts under a mesh: a fault at rank 0's second decode call,
    before its command or after the mirrored call returned, resets every
    rank (the reset command); both in-flight requests requeue and give
    their solo tokens, and so does a fresh request after the reset."""
    cfg, jp = spec_engines["model"]
    row = spec_engines["r0"]["recoveries"][i]
    want = [_jax_solo(jp, cfg, p, n) for p, n in RECOVERY_REQS + [RECOVERY_FRESH]]
    assert row["tokens"] == want
    assert row["failed"] == [False] * 3
    assert row["restarts"] == 1


@pytest.mark.parametrize("case", list(INSIDE))
def test_tp_engine_recovers_from_a_fault_inside_a_mirrored_call(spec_engines, case):
    """A fault raised on rank 0 inside a mirrored call, after its command
    went out: between two block reductions of decode call 2 (plain, and a
    spec_lookup=3 window), of the first prefill_many, or after decode call
    2's graph returned. The follower, waiting inside reduction k (or idle),
    is released within 10 s (Channel.repair), every rank resets, both
    requeued requests and a fresh one give JAX's solo tokens, one restart,
    and both rank processes exit 0 (run_ranks)."""
    cfg, jp = spec_engines["model"]
    i, k = INSIDE[case]
    row, rel = spec_engines["r0"]["recoveries"][i], spec_engines["r1"]["recoveries"][i]
    want = [_jax_solo(jp, cfg, p, n) for p, n in RECOVERY_REQS + [RECOVERY_FRESH]]
    assert row["tokens"] == want
    assert row["failed"] == [False] * 3
    assert row["restarts"] == 1 and not row["broken"]
    (release,) = rel["releases"]
    assert 0 <= release["t"] - row["faults"][0] < 10
    if k is None:
        assert not release["waiting"]
    else:
        assert release["waiting"]
        assert release["ops"][-1] == "all_reduce"
        assert release["ops"].count("all_reduce") == k


def test_tp_engine_fault_inside_a_mirrored_call_past_its_budget(spec_engines):
    """max_restarts=1 and two faults inside decode calls (2 and 4, between
    two block reductions): the first recovers, the second fails both
    waiters, a further submit raises; the follower was released both times
    and nothing hangs (both ranks stop and exit 0)."""
    row = spec_engines["r0"]["recoveries"][8]
    rel = spec_engines["r1"]["recoveries"][8]["releases"]
    assert row["failed"] == [True, True] and row["refused"]
    assert row["restarts"] == 1 and not row["broken"]
    assert len(row["faults"]) == 2
    assert [r["waiting"] for r in rel] == [True, True]
    assert all(r["ops"].count("all_reduce") == K for r in rel)


def test_tp_engine_fails_loudly_when_the_release_fails(tmp_path):
    """Rank 0's own block reduction fails in the backend inside decode call
    2 (nothing posted), so it cannot release the follower: the mesh is
    broken, every waiter fails and a further submit raises, with restarts
    left in the budget; the follower, told so, says why and leaves its
    process (which ends a real job: comm.Ranks) instead of waiting."""
    import json
    import re
    cfg = tiny_cfg(max_context=96)
    with pytest.raises(AssertionError) as err:
        run_ranks(W.broken_repair_ranks, 2, tmp_path, port_cfg(cfg),
                  tllm.params_from_jax(jllm.init_params(cfg, seed=4)),
                  RECOVERY_REQS, RECOVERY_FRESH)
    text = str(err.value)
    assert text.startswith("a rank died")
    assert "rank 0 could not release this rank from a failed step" in text
    row = json.loads(re.search(r"rank 0 row (\{.*\})", text).group(1))
    assert row["broken"] and row["refused"] and row["restarts"] == 0
    assert row["failed"] == [True, True]


def test_moe_ep_prefill_matches_jax(tmp_path):
    """Expert parallelism: each rank holds 4 of 8 experts; the sharded
    prefill's first token equals JAX sharded_llm_prefill's and its
    single-device prefill's."""
    cfg = jllm.TransformerConfig(
        num_blocks=2, dim=32, hidden_dim=64, n_heads=4, n_kv_heads=2, norm_eps=1e-5,
        vocab_size=64, head_dim=8, rope_theta=1e4, rope_dim=8, v_head_dim=8,
        max_context=64, num_experts=8, num_experts_per_tok=2, norm_topk_prob=True)
    jp = jllm.init_params(cfg, seed=0)
    tokens = np.asarray([[1, 2, 3, 4] + [0] * 28], np.int64)
    key = jax.random.PRNGKey(0)
    pre_ref, _ = jllm.make_step_fns(cfg)
    tok_ref, _ = pre_ref(jp, jllm.init_state(cfg), jnp.asarray(tokens, jnp.int32), 0,
                         jnp.int32(4), jnp.float32(0.0), key)
    mesh = jmesh.make_mesh(8)
    pre = jmesh.sharded_llm_prefill(mesh, jmesh.shard_llm_params(mesh, jp), cfg)
    with mesh:
        tok_j, _ = pre(jllm.init_state(cfg), jnp.asarray(tokens, jnp.int32), 0, jnp.int32(4),
                       jnp.float32(0.0), key)
    outs = run_ranks(W.moe_prefill_ranks, 2, tmp_path, port_cfg(cfg),
                     tllm.params_from_jax(jp), tokens)
    for o in outs:
        assert o["tok"] == int(tok_j[0]) == int(tok_ref[0])
        assert o["exps"][0] == 4
        assert "blk.0.ffn_down_exps.weight" in o["split"]


@pytest.fixture(scope="module")
def vlm_nvr(tmp_path_factory):
    """One spawn of 2 ranks (``torch_parallel_workers.vlm_ranks``) and
    JAX's solo text."""
    jc, tc = _cfgs(max_context=1024)
    jp, tp = _params(jc, seed=0)
    vkv, vp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(0,))
    j = jvl.Qwen3VL(res=(64, 96), lang=_jax_lm(jp, jc, "f32", False), tok=_tok(JTok),
                    vision=jvl.VisionTower(vkv, vp))
    frame = np.random.default_rng(3).integers(0, 255, (48, 80, 3), np.uint8)
    solo = j.generate(prompt="what is this", image=frame, reset=True, temperature=0.0,
                      max_new=4)
    tmp = tmp_path_factory.mktemp("vlm_nvr")
    return solo, run_ranks(W.vlm_ranks, 2, tmp, tc, tp, vkv, vp, frame, str(tmp))


def test_vlm_engine_and_nvr_summaries_tp_match_solo(vlm_nvr):
    """VLMServingEngine(mesh=) on 2 ranks, and the NVR's summary engine
    built with llm_mesh (rank 1 building its own on rank 0's command):
    the same text as JAX's solo Qwen3VL.generate; each rank's cache holds
    one of the two KV heads (bf16 in the NVR's); the replicated vision
    tower ran on rank 0's image."""
    solo, outs = vlm_nvr
    assert outs[0]["text"] == solo
    assert outs[0]["nvr_text"] == solo
    assert outs[0]["kshape"] == outs[1]["kshape"] == (2, 1, 1024, 128)
    assert outs[0]["nvr_kshape"] == (2, 1, 1024, 128)
    assert outs[0]["nvr_dtype"] == "torch.bfloat16"


def test_nvr_summary_engine_tp_carries_on_after_a_fault_inside_a_step(vlm_nvr):
    """The NVR's tensor-parallel summary engine, driven by the NVR's own
    summary ticks: rank 0 raises at the first block reduction inside a
    request's mirrored image prefill. The NVR logs the failed tick and
    carries on, as on one device; the follower, waiting in that
    reduction, is released within 10 s; the next ticks re-run the prefill
    and the summary's text equals JAX's solo generation."""
    solo, outs = vlm_nvr
    got = outs[0]["nvr_fault"]
    assert got["text"] == solo and len(got["faults"]) == 1
    (release,) = outs[1]["releases"]
    assert release["waiting"] and release["ops"] == ["all_reduce"]
    assert 0 <= release["t"] - got["faults"][0] < 10


@pytest.fixture(scope="module")
def vlm_spec(tmp_path_factory):
    """One spawn of 2 ranks: VLMServingEngine(mesh=) under
    CLEARCAM_SPEC_LOOKUP=2, then without it through a fault inside its
    image prefill (the first language block's second reduction); and
    JAX's solo text."""
    jc, tc = _cfgs(max_context=1024)
    jp, tp = _params(jc, seed=0)
    vkv, vp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(0,))
    j = jvl.Qwen3VL(res=(64, 96), lang=_jax_lm(jp, jc, "f32", False), tok=_tok(JTok),
                    vision=jvl.VisionTower(vkv, vp))
    frame = np.random.default_rng(3).integers(0, 255, (48, 80, 3), np.uint8)
    solo = j.generate(prompt="what is this", image=frame, reset=True, temperature=0.0,
                      max_new=8)
    outs = run_ranks(W.vlm_spec_ranks, 2, tmp_path_factory.mktemp("vlm_spec"), tc, tp,
                     vkv, vp, frame, 2, 8, 2)
    return solo, outs


def test_vlm_engine_tp_spec_matches_solo(vlm_spec):
    """VLMServingEngine(mesh=) under CLEARCAM_SPEC_LOOKUP=2 on 2 ranks:
    speculative windows over the image prefill's cache give JAX's solo
    Qwen3VL.generate text exactly."""
    solo, outs = vlm_spec
    assert outs[0]["text"] == solo
    assert outs[0]["spec"] == outs[1]["spec"] == 2
    assert outs[0]["decode_steps"] > 0


def test_vlm_engine_tp_recovers_from_a_fault_inside_custom_prefill(vlm_spec):
    """VLMServingEngine(mesh=, max_restarts=1) on 2 ranks: rank 0 raises at
    its second block reduction inside the mirrored image prefill; the
    follower, waiting in that reduction, is released within 10 s, the
    request requeues and its retried summary's text equals JAX's solo
    Qwen3VL.generate, with one restart."""
    solo, outs = vlm_spec
    got, rel = outs[0]["fault"], outs[1]["releases"]
    assert got["text"] == solo and not got["failed"]
    assert got["restarts"] == 1
    (release,) = rel
    assert release["waiting"] and release["ops"] == ["all_reduce"] * 2
    assert 0 <= release["t"] - got["faults"][0] < 10


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def test_train_step_tp_matches_one_device(tmp_path):
    """make_train_step (detect and distill) on a (2, 2) mesh: the batch
    split over data, conv output channels over model (shard_params_tp, the
    stem's filters gathered for its kernel). The losses, and the parameters
    after 2 steps (all of them as one vector), are within 1e-5 relative of
    the one-device step's."""
    params = jyolo.init_params("t", seed=0)
    rng = np.random.default_rng(0)
    steps = 2
    frames = rng.uniform(0, 1, (steps, 4, 64, 64, 3)).astype(np.float32)
    boxes = np.tile(np.asarray([[[12.0, 12.0, 44.0, 44.0], [4.0, 8.0, 30.0, 40.0]]],
                               np.float32), (steps, 4, 1, 1))
    cls = np.tile(np.asarray([[0, 2]], np.int32), (steps, 4, 1))
    targets = rng.normal(0, 1, (steps, 4, 84, 84)).astype(np.float32)
    outs = run_ranks(W.train_ranks, 4, tmp_path, params, frames, boxes, cls, targets,
                     steps)
    solo = W.solo_train(params, frames, boxes, cls, targets, steps)
    for o in outs:
        assert o["shape"] == {"data": 2, "model": 2}
        assert "model.0.conv.weight" in o["detect_marked"]
        for kind in ("detect", "distill"):
            losses, got = o[kind]
            np.testing.assert_allclose(losses, solo[kind][0], rtol=1e-5)
            keys = sorted(got)
            rel = _rel(np.concatenate([got[k].ravel() for k in keys]),
                       np.concatenate([solo[kind][1][k].ravel() for k in keys]))
            worst = max((_rel(got[k], solo[kind][1][k]), k) for k in keys)
            assert rel <= 1e-5, (kind, rel, worst)
