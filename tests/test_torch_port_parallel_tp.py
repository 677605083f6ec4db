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
step."""
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


def test_vlm_engine_and_nvr_summaries_tp_match_solo(tmp_path):
    """VLMServingEngine(mesh=) on 2 ranks, and the NVR's summary engine
    built with llm_mesh (rank 1 building its own on rank 0's command):
    the same text as JAX's solo Qwen3VL.generate; each rank's cache holds
    one of the two KV heads (bf16 in the NVR's); the replicated vision
    tower ran on rank 0's image."""
    jc, tc = _cfgs(max_context=1024)
    jp, tp = _params(jc, seed=0)
    vkv, vp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(0,))
    j = jvl.Qwen3VL(res=(64, 96), lang=_jax_lm(jp, jc, "f32", False), tok=_tok(JTok),
                    vision=jvl.VisionTower(vkv, vp))
    frame = np.random.default_rng(3).integers(0, 255, (48, 80, 3), np.uint8)
    solo = j.generate(prompt="what is this", image=frame, reset=True, temperature=0.0,
                      max_new=4)
    outs = run_ranks(W.vlm_ranks, 2, tmp_path, tc, tp, vkv, vp, frame, str(tmp_path))
    assert outs[0]["text"] == solo
    assert outs[0]["nvr_text"] == solo
    assert outs[0]["kshape"] == outs[1]["kshape"] == (2, 1, 1024, 128)
    assert outs[0]["nvr_kshape"] == (2, 1, 1024, 128)
    assert outs[0]["nvr_dtype"] == "torch.bfloat16"


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
