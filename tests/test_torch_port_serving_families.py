"""The port's continuous-batching engine (clearcam_tpu_torch.serving) on the
MoE, MLA and GatedDeltaNet-hybrid stacks against the JAX package's engine,
on the CPU at tiny widths, greedy and f32: staggered admission, slot reuse
that zeroes a recurrent state, the batched prefill's write mask over the
MLA latent cache (float and int8), no prefix reuse on SSM stacks, the
decode-attention route on an MoE stack, speculative serving on MLA, the
refusals the JAX package asserts, and ``llm_bench --ssm``.
"""
import json

import jax.numpy as jnp
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.serving import ServingEngine as JaxEngine
from clearcam_tpu.tools import llm_bench as jbench
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.serving import ServingEngine
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.tools import llm_bench as tbench

from test_llm import tiny_cfg
from test_torch_port_llm import port_cfg
from test_torch_port_llm_families import FAMILIES as BLOCK_FAMILIES
from test_torch_port_llm_families import NEXT


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


FAMILIES = {"moe": BLOCK_FAMILIES["qwen_moe"], "mla": BLOCK_FAMILIES["mla"],
            "ssm": BLOCK_FAMILIES["ssm_hybrid"]}


def _pair(name, max_context=96, seed=7, **kw):
    cfg = tiny_cfg(max_context=max_context, **FAMILIES[name], **kw)
    jp = jllm.init_params(cfg, seed=seed)
    return cfg, jp, tllm.params_from_jax(jp)


def _both(cfg, jp, tp, drive, **kw):
    """drive(engine) -> result, for the port's engine and the JAX one."""
    return (drive(ServingEngine(tp, port_cfg(cfg), **kw)),
            drive(JaxEngine(jp, cfg, **kw)))


def _staggered(eng):
    """A request, then a 2-chunk one two ticks later, then two more that
    queue behind the busy slots and reuse whichever frees first."""
    r1 = eng.submit([1, 2, 3, 4, 5], max_new=6)
    for _ in range(2):
        eng.step()
    r2 = eng.submit(list(range(1, 41)), max_new=5)
    eng.step()
    r3 = eng.submit([9, 8, 7], max_new=4)
    r4 = eng.submit([2, 7], max_new=4)
    eng.run_until_idle()
    return [r.wait(1) for r in (r1, r2, r3, r4)], eng.stats["prefill_batched_steps"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_staggered_requests_and_slot_reuse_match_jax(name):
    """tests/test_serving.py:69-115: every request's tokens equal the JAX
    engine's; on the hybrid, the reused slots' recurrences start from zero."""
    cfg, jp, tp = _pair(name)
    (got, _), (want, _) = _both(cfg, jp, tp, _staggered, n_slots=2)
    assert got == want


@pytest.mark.parametrize("name", ["moe", "ssm"])
def test_burst_through_the_batched_prefill_matches_jax(name):
    """Three admissions at once take prefill_many (the hybrid's steps the
    chunk a token at a time with per-row gating), then a second wave
    through the same slots; tokens equal the JAX engine's, which takes the
    same path."""
    cfg, jp, tp = _pair(name)
    prompts = [[1, 2, 3, 4, 5], list(range(9, 44)), [2, 7, 6, 5]]

    def drive(eng):
        rs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run_until_idle()
        rs += [eng.submit(list(reversed(p)), max_new=4) for p in prompts]
        eng.run_until_idle()
        return [r.wait(1) for r in rs], eng.stats["prefill_batched_steps"]

    (got, n_got), (want, n_want) = _both(cfg, jp, tp, drive, n_slots=3)
    assert got == want and n_got == n_want > 0


def test_ssm_slot_reuse_zeroes_the_recurrence():
    """A slot's next occupant starts from a zero conv window and recurrent
    state, whatever the last one left there."""
    cfg, jp, tp = _pair("ssm")
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=1)
    eng.submit([5, 4, 3, 2, 1, 9, 9], max_new=6)
    eng.run_until_idle()
    ssm_i = [i for i in range(cfg.num_blocks) if cfg.block_kind(i) == "ssm"]
    assert all(eng.state[i]["rec"].abs().sum() > 0 for i in ssm_i)
    r = eng.submit([2, 7], max_new=4)
    eng.run_until_idle()
    fresh = ServingEngine(tp, port_cfg(cfg), n_slots=1)
    q = fresh.submit([2, 7], max_new=4)
    fresh.run_until_idle()
    assert r.wait(1) == q.wait(1)


def test_no_prefix_reuse_on_ssm_stacks():
    """tests/test_serving.py:265: the recurrent state at a reuse boundary is
    not position-addressed, so the hybrid serves without prefix reuse."""
    cfg, jp, tp = _pair("ssm", max_context=160)
    pre = [(i * 7) % 60 + 1 for i in range(40)]

    def drive(eng):
        assert not eng.prefix_cache
        rs = [eng.submit(pre + [1], max_new=3), eng.submit(pre + [2], max_new=3)]
        eng.run_until_idle()
        return [r.wait(1) for r in rs], eng.stats["reused_tokens"]

    (got, reused), (want, _) = _both(cfg, jp, tp, drive, n_slots=1)
    assert got == want and reused == 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_mla_latent_cache_through_the_batched_prefill(kv_quant):
    """tests/test_serving.py:389-400: the batched prefill's write mask over
    the MLA latent cache (and its int8 form with one scale a position):
    the batched engine's tokens equal the one-slot serial engine's and the
    JAX engine's."""
    cfg, jp, tp = _pair("mla", seed=6)
    prompts = [[1, 2, 3, 4], list(range(2, 36)), [7, 7, 7]]

    def drive(eng):
        rs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run_until_idle()
        return [r.wait(1) for r in rs], eng.stats["prefill_batched_steps"]

    (got, n), (want, _) = _both(cfg, jp, tp, drive, n_slots=3, kv_quant=kv_quant)
    assert got == want and n >= 1
    serial = ServingEngine(tp, port_cfg(cfg), n_slots=1, kv_quant=kv_quant,
                           prefill_batch=False)
    for p, toks in zip(prompts, got):
        q = serial.submit(p, max_new=5)
        serial.run_until_idle()
        assert q.wait(1) == toks


def _decode_kernel_calls(monkeypatch, name):
    """Count a decode kernel's plain version (what its wrapper runs on CPU
    tensors) -> the list of calls."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    calls = []
    plain = getattr(dec, name)

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)
    monkeypatch.setattr(dec, name, counted)
    return calls


@pytest.mark.parametrize("kv_quant", [False, True])
def test_moe_decode_kernel_route_matches_jax(kv_quant, monkeypatch):
    """use_pallas_decode on an MoE stack (the attention blocks take the
    batched decode kernel; on the CPU its plain version), bf16 and int8
    caches, against the JAX engine's plain route."""
    cfg, jp, tp = _pair("moe", max_context=256, head_dim=128, rope_dim=128,
                        v_head_dim=128, n_heads=4, n_kv_heads=2)
    calls = _decode_kernel_calls(monkeypatch, "decode_attention_batch_q8_reference"
                                 if kv_quant else "decode_attention_batch_reference")
    got = _staggered(ServingEngine(tp, port_cfg(cfg), n_slots=2, kv_quant=kv_quant,
                                   use_pallas_decode=True))[0]
    assert calls
    assert got == _staggered(JaxEngine(jp, cfg, n_slots=2, kv_quant=kv_quant))[0]


def test_spec_mla_matches_jax():
    """tests/test_serving_spec.py:150: MLA latent-cache stacks through the
    speculative verify windows."""
    cfg = tiny_cfg(kv_lora_rank=16, q_lora_rank=0, rope_dim=4, head_dim=12, v_head_dim=8,
                   n_kv_heads=4, max_context=96)
    jp = jllm.init_params(cfg, seed=6)
    tp = tllm.params_from_jax(jp)

    def drive(eng):
        r1 = eng.submit([1, 2, 3, 4], max_new=6)
        eng.step()
        r2 = eng.submit([6, 5], max_new=5)
        r3 = eng.submit([1, 2, 1, 2, 1, 2, 1], max_new=8)
        eng.run_until_idle()
        return [r.wait(1) for r in (r1, r2, r3)], eng.stats["spec_emitted"]

    (got, emitted), (want, jax_emitted) = _both(cfg, jp, tp, drive, n_slots=2,
                                                spec_lookup=3)
    assert got == want and emitted == jax_emitted > 0
    assert got == drive(ServingEngine(tp, port_cfg(cfg), n_slots=2))[0]


def test_ssm_refusals():
    """Speculative serving on a hybrid raises (the JAX engine turns it off:
    a rejected draft's recurrent update cannot be rolled back), and so does
    the decode kernel (the JAX package asserts attention-only stacks)."""
    cfg, _, tp = _pair("ssm")
    with pytest.raises(ValueError, match="rolled back"):
        ServingEngine(tp, port_cfg(cfg), spec_lookup=3)
    with pytest.raises(ValueError, match="rolled back"):
        tllm.make_serving_fns(port_cfg(cfg), spec_lookup=3)
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(tp, port_cfg(cfg), use_pallas_decode=True)


def test_llm_bench_ssm_runs_on_cpu(monkeypatch, capsys):
    """``llm_bench --ssm --device cpu`` builds the hybrid from
    qwen3_next_cfg (here a 2-block tiny one) and runs the modes, the
    batched ladder and the engine; each JSON line has the JAX tool's keys."""
    monkeypatch.setattr(tllm, "qwen3_next_cfg", lambda blocks, ctx: port_cfg(NEXT))
    out = tbench.main(["--device", "cpu", "--ssm", "--blocks", "2", "--ctx", "256",
                       "--steps", "2", "--modes", "bf16,int8+kv16", "--decode-batch", "1,2"])
    assert [r.get("batch", r.get("mode")) for r in out] == [1, 2, "bf16", "int8+kv16"]
    assert all(r["decode_tok_s"] > 0 for r in out)
    head = capsys.readouterr().out.splitlines()[0]
    assert head.startswith("# 2 blocks") and "device cpu" in head
    jp = jllm.init_params(NEXT, seed=0, dtype=jnp.bfloat16)
    keys = set(json.loads(json.dumps(jbench.bench_mode(NEXT, jp, "bf16", 128, 1))))
    assert set(out[2]) == keys
    got = tbench.main(["--device", "cpu", "--ssm", "--blocks", "2", "--ctx", "256",
                       "--serving", "--slots", "2", "--requests", "3", "--prompt-len", "12",
                       "--max-new", "4"])
    assert got["generated"] == 12 and got["agg_tok_s"] > 0
