"""The port's continuous-batching engine (clearcam_tpu_torch.serving) against
the JAX package's ServingEngine and solo ``Transformer`` generation, on the
CPU at tiny widths, greedy and f32: every request's tokens are exactly the
JAX package's, under staggered admission, slot reuse, batched prefill,
prefix reuse, lagged reads, quantized weights, the int8 KV cache and the
decode-attention route; plus cancel, deadlines, backpressure, constrained
decoding, logprobs and seeded sampling.
"""
import json
import time
from dataclasses import asdict

import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.serving import ServingEngine as JaxEngine
from clearcam_tpu.serving import constrain as jcon
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.serving import QueueFull, ServingEngine, constrain
from clearcam_tpu_torch.testing import torch_threads

from test_llm import tiny_cfg


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def port_cfg(cfg):
    d = asdict(cfg)
    d.pop("ssm")
    return tllm.TransformerConfig(**d)


def _solo(params, cfg, prompt, n, eos_id=None):
    out = []
    for tok in jllm.Transformer(params, cfg, seed=0).generate(
            list(prompt), temperature=0.0, max_new=n):
        out.append(tok)
        if eos_id is not None and tok == eos_id:
            break
    return out


def _staggered(engine):
    """Requests joining while others are mid-flight, one with a 2-chunk
    prompt that interleaves prefill chunks between decode steps."""
    r1 = engine.submit([1, 2, 3, 4, 5], max_new=8)
    for _ in range(3):
        engine.step()
    r2 = engine.submit(list(range(1, 41)), max_new=6)
    engine.step()
    r3 = engine.submit([9, 8, 7], max_new=5)
    engine.run_until_idle()
    return [r.wait(1) for r in (r1, r2, r3)]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_cfg(max_context=96)
    jp = jllm.init_params(cfg, seed=4)
    return cfg, jp, tllm.params_from_jax(jp)


def test_staggered_requests_match_jax_engine_and_solo(tiny):
    cfg, jp, tp = tiny
    got = _staggered(ServingEngine(tp, port_cfg(cfg), n_slots=2))
    assert got == _staggered(JaxEngine(jp, cfg, n_slots=2))
    assert got == [_solo(jp, cfg, [1, 2, 3, 4, 5], 8), _solo(jp, cfg, list(range(1, 41)), 6),
                   _solo(jp, cfg, [9, 8, 7], 5)]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_match_jax_engine(tiny, bits):
    cfg, jp, _ = tiny
    jq = getattr(jllm, f"quantize_params_int{bits}")(jp, min_dim=32)
    tq = tllm.params_from_jax(jq)
    assert any(isinstance(v, (tllm.QuantLinear, tllm.QuantLinear4)) for v in tq.values())
    assert _staggered(ServingEngine(tq, port_cfg(cfg), n_slots=2)) == \
        _staggered(JaxEngine(jq, cfg, n_slots=2))


def test_kv_quant_matches_jax_engine(tiny):
    cfg, jp, tp = tiny
    assert _staggered(ServingEngine(tp, port_cfg(cfg), n_slots=2, kv_quant=True)) == \
        _staggered(JaxEngine(jp, cfg, n_slots=2, kv_quant=True))


def test_decode_attention_route_matches_jax():
    """use_pallas_decode: on CPU tensors the decode step runs the kernel's
    plain version; rows at different positions, one joining lower."""
    cfg = tiny_cfg(head_dim=128, rope_dim=128, v_head_dim=128, n_heads=4,
                   n_kv_heads=2, max_context=256)
    jp = jllm.init_params(cfg, seed=6)
    tp = tllm.params_from_jax(jp)

    def run(engine):
        r1 = engine.submit([1, 2, 3, 4, 5], max_new=5)
        for _ in range(2):
            engine.step()
        r2 = engine.submit([9, 8, 7], max_new=4)
        engine.run_until_idle()
        return r1.wait(1), r2.wait(1)

    want = run(JaxEngine(jp, cfg, n_slots=2))
    assert run(ServingEngine(tp, port_cfg(cfg), n_slots=2, use_pallas_decode=True)) == want
    assert run(ServingEngine(tp, port_cfg(cfg), n_slots=2)) == want


def _q8_route(monkeypatch):
    """Count the int8 decode kernel's plain version (what the wrapper runs
    on CPU tensors) and refuse the float one: -> the call counter."""
    from clearcam_tpu_torch.ops import decode_attention as dec
    calls = []
    plain = dec.decode_attention_batch_q8_reference

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    def refused(*a, **kw):
        raise AssertionError("the float decode kernel ran on an int8 cache")
    monkeypatch.setattr(dec, "decode_attention_batch_q8_reference", counted)
    monkeypatch.setattr(dec, "decode_attention_batch_reference", refused)
    return calls


def test_kv_quant_with_decode_kernel_is_refused(tiny, monkeypatch):
    """(Refused until the int8 route was repaired; the name is kept.) The
    engine's kv_quant + use_pallas_decode route runs decode_attention_batch_q8
    with the cache's scales and its tokens equal the JAX engine's kv_quant
    plain route (the JAX engine's own pair runs its decode attention on raw
    int8 values without the scales, llm.py:1316-1318), with staggered
    prompts at different positions and slot reuse."""
    cfg, jp, tp = tiny
    calls = _q8_route(monkeypatch)

    def run(engine):
        out = _staggered(engine)
        r = engine.submit([3, 3, 1, 2], max_new=4)      # reuses a slot
        engine.run_until_idle()
        return out + [r.wait(1)]

    got = run(ServingEngine(tp, port_cfg(cfg), n_slots=2, kv_quant=True,
                            use_pallas_decode=True))
    assert calls and all(c[0] == 2 for c in calls)
    assert got == run(JaxEngine(jp, cfg, n_slots=2, kv_quant=True))


def test_kv_quant_decode_route_matches_jax_plain_route(monkeypatch):
    """The kernel route at head_dim 128, four slots joining at different
    times with prompts of 3 to 45 tokens, against the JAX engine's plain
    int8 route."""
    cfg = tiny_cfg(head_dim=128, rope_dim=128, v_head_dim=128, n_heads=4,
                   n_kv_heads=2, max_context=256)
    jp = jllm.init_params(cfg, seed=6)
    tp = tllm.params_from_jax(jp)
    calls = _q8_route(monkeypatch)
    prompts = [[1, 2, 3], list(range(5, 50)), [9, 8, 7, 6, 5, 4, 3, 2], list(range(40, 60))]

    def run(engine):
        rs = [engine.submit(prompts[0], max_new=7)]
        for p in prompts[1:]:
            engine.step()
            engine.step()
            rs.append(engine.submit(p, max_new=5))
        engine.run_until_idle()
        return [r.wait(1) for r in rs]

    got = run(ServingEngine(tp, port_cfg(cfg), n_slots=4, kv_quant=True,
                            use_pallas_decode=True))
    assert len(calls) > 0
    assert got == run(JaxEngine(jp, cfg, n_slots=4, kv_quant=True))


@pytest.mark.parametrize("argv,raises,match", [
    (["--spec", "4", "--pallas"], SystemExit, None),
    (["--mesh", "4", "--spec", "4"], SystemExit, "--spec is not served over --mesh"),
])
def test_serve_llm_refuses_what_is_not_ported(argv, raises, match, capsys):
    """--spec with --pallas is refused at parsing (argparse's error, exit
    2), as the reference excludes the pair; --mesh parses (tensor-parallel
    serving, tests/test_torch_port_parallel_tp.py) but not with --spec,
    whose drafts live in per-rank bookkeeping."""
    from clearcam_tpu_torch.tools import serve_llm
    assert serve_llm.parse_args(["--synthetic", "--mesh", "4"]).mesh == 4
    with pytest.raises(raises):
        serve_llm.parse_args(["--synthetic", *argv])
    assert (match or "--spec excludes --pallas") in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--kv-quant", "--pallas"], ["--spec", "4"],
                                  ["--int8", "--kv-quant", "--spec", "2"]])
def test_serve_llm_parses_what_it_serves(argv):
    from clearcam_tpu_torch.tools import serve_llm
    args = serve_llm.parse_args(["--synthetic", *argv])
    assert args.kv_quant == ("--kv-quant" in argv) and args.pallas == ("--pallas" in argv)
    assert args.spec == (int(argv[argv.index("--spec") + 1]) if "--spec" in argv else 0)


@pytest.mark.parametrize("argv,spec,pallas,q8", [
    (["--kv-quant", "--pallas"], 0, True, True),
    (["--spec", "3"], 3, False, False),
])
def test_serve_llm_builds_the_engine(argv, spec, pallas, q8, monkeypatch):
    """build_engine at a tiny width on the CPU: the int8-cache kernel route
    and the speculative engine serve a request; --spec drops the JSON
    grammar and its reserved rows, as the reference does."""
    from clearcam_tpu_torch.tools import serve_llm
    small = port_cfg(tiny_cfg(head_dim=128, rope_dim=128, v_head_dim=128, n_heads=4,
                              n_kv_heads=2, max_context=128))
    monkeypatch.setattr(tllm, "qwen3_2b_cfg", lambda blocks, ctx: small)
    args = serve_llm.parse_args(["--synthetic", "--device", "cpu", "--slots", "2",
                                 "--json-depth", "0" if not spec else "4", *argv])
    gen = serve_llm.build_engine(args)
    eng = gen.engine
    assert eng.spec == spec and eng._kv_quant == q8 and eng._cap == (0 if spec else 512)
    r = eng.submit([5, 6, 5, 6, 5], max_new=6)
    eng.run_until_idle()
    assert len(r.wait(1)) == 6


def test_slot_reuse_and_eos(tiny):
    cfg, jp, tp = tiny
    eos = _solo(jp, cfg, [1, 2, 3], 4)[1]
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=1)
    reqs = [eng.submit([1, 2, 3], max_new=6, eos_id=eos), eng.submit([5, 5], max_new=4),
            eng.submit([7, 1, 7, 1], max_new=3)]
    eng.run_until_idle()
    assert reqs[0].wait(1) == _solo(jp, cfg, [1, 2, 3], 6, eos_id=eos)
    assert reqs[0].tokens[-1] == eos
    assert reqs[1].wait(1) == _solo(jp, cfg, [5, 5], 4)
    assert reqs[2].wait(1) == _solo(jp, cfg, [7, 1, 7, 1], 3)


def test_batched_prefill_exact_and_used(tiny):
    cfg, jp, tp = tiny
    prompts = [list(range(1, 35)), [4, 4, 2], list(range(20, 60))]

    def run(**kw):
        eng = ServingEngine(tp, port_cfg(cfg), n_slots=3, **kw)
        rs = [eng.submit(p, max_new=4) for p in prompts]
        eng.run_until_idle()
        return [r.wait(1) for r in rs], eng.stats["prefill_batched_steps"]

    batched, n_batched = run()
    serial, n_serial = run(prefill_batch=False)
    assert n_batched > 0 and n_serial == 0
    assert batched == serial == [_solo(jp, cfg, p, 4) for p in prompts]


def test_prefix_reuse_token_exact():
    cfg = tiny_cfg(max_context=160)
    jp = jllm.init_params(cfg, seed=4)
    pre = [(i * 7) % 60 + 1 for i in range(70)]
    p1, p2 = pre + [9, 9], pre + [3, 5, 3]
    eng = ServingEngine(tllm.params_from_jax(jp), port_cfg(cfg), n_slots=1)
    r1 = eng.submit(p1, max_new=4)
    eng.run_until_idle()
    chunks = eng.stats["prefill_chunks"]
    r2 = eng.submit(p2, max_new=4)
    eng.run_until_idle()
    assert eng.stats["reused_tokens"] == 64
    assert eng.stats["prefill_chunks"] - chunks == 1
    assert r1.wait(1) == _solo(jp, cfg, p1, 4)
    assert r2.wait(1) == _solo(jp, cfg, p2, 4)


def test_sync_lag_invariance(tiny):
    cfg, jp, tp = tiny
    eos = _solo(jp, cfg, [1, 2, 3], 4)[1]

    def run(lag, fetch=4):
        eng = ServingEngine(tp, port_cfg(cfg), n_slots=2, sync_lag=lag, fetch_every=fetch)
        rs = [eng.submit([1, 2, 3], max_new=6, eos_id=eos), eng.submit([5, 5], max_new=5),
              eng.submit([7, 1, 7, 1], max_new=4)]
        eng.run_until_idle()
        return [r.wait(1) for r in rs]

    assert run(0) == run(4) == run(9) == run(0, fetch=1) == run(4, fetch=7)


def test_cancel_and_deadlines(tiny):
    cfg, _, tp = tiny
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=1)
    running = eng.submit([1, 2, 3], max_new=40)
    waiting = eng.submit([4, 5], max_new=4)
    eng.step()
    eng.cancel(waiting)
    assert waiting.done and waiting.tokens == []
    eng.cancel(running)
    eng.run_until_idle()
    assert running.done and len(running.tokens) < 40
    late = eng.submit([1, 2], max_new=50, timeout_s=0.0)
    queued = eng.submit([3, 4], max_new=5, timeout_s=0.0)
    time.sleep(0.01)
    eng.run_until_idle()
    assert late.timed_out and queued.timed_out and queued.tokens == []
    after = eng.submit([6], max_new=2)
    eng.run_until_idle()
    assert len(after.wait(1)) == 2


def test_queue_full_and_close(tiny):
    cfg, _, tp = tiny
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=1, max_waiting=2)
    rs = [eng.submit([1, 2], max_new=3) for _ in range(2)]
    with pytest.raises(QueueFull):
        eng.submit([3], max_new=3)
    eng.start()
    assert [len(r.wait(10)) for r in rs] == [3, 3]
    hang = eng.submit([1, 2, 3], max_new=80)
    eng.close()
    assert hang.done
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1], max_new=1)


def test_logprobs_and_penalties_match_jax_engine(tiny):
    cfg, jp, tp = tiny
    kw = dict(max_new=6, logprobs=3, presence_penalty=0.4, repetition_penalty=1.2,
              logit_bias={5: 2.0, 7: -1.0})

    def run(engine):
        rs = [engine.submit([1, 2, 3, 4], **kw), engine.submit([9, 9, 8], max_new=4,
                                                               logprobs=2)]
        engine.run_until_idle()
        return rs

    got, want = run(ServingEngine(tp, port_cfg(cfg), n_slots=2)), \
        run(JaxEngine(jp, cfg, n_slots=2))
    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert len(g.lp) == len(w.lp) == len(g.tokens)
        for (gc, galt), (wc, walt) in zip(g.lp, w.lp):
            assert abs(gc - wc) < 1e-5
            assert [i for i, _ in galt] == [i for i, _ in walt]
            np.testing.assert_allclose([x for _, x in galt], [x for _, x in walt], atol=1e-5)


def _vocab128():
    """A byte-per-token vocab that holds the JSON alphabet ({ is id 90)."""
    cfg = tiny_cfg(max_context=96, vocab_size=128)
    jp = jllm.init_params(cfg, seed=8)
    return cfg, jp, tllm.params_from_jax(jp)


def test_json_constraint_matches_jax_engine():
    """A json_object grammar over a byte-per-token vocab: the constrained
    greedy request's text parses as a JSON prefix, and equals the JAX
    engine's tokens; the unconstrained neighbour is unaffected."""
    from clearcam_tpu.tools.serve_llm import _AsciiTok
    cfg, jp, tp = _vocab128()
    tok = _AsciiTok(cfg.vocab_size)
    tc = constrain.token_table(constrain.json_char_dfa(2), tok.vocab_bytes(), [0],
                               n_vocab=cfg.vocab_size)
    jtc = jcon.token_table(jcon.json_char_dfa(2), tok.vocab_bytes(), [0],
                           n_vocab=cfg.vocab_size)
    np.testing.assert_array_equal(tc.trans, jtc.trans)

    def run(engine):
        a = engine.submit([1, 2, 3], max_new=12, constraint="json", eos_id=0)
        b = engine.submit([1, 2, 3], max_new=5)
        engine.run_until_idle()
        return a.wait(1), b.wait(1)

    got = run(ServingEngine(tp, port_cfg(cfg), n_slots=2, constraints={"json": tc}))
    assert got == run(JaxEngine(jp, cfg, n_slots=2, constraints={"json": jtc}))
    assert got[1] == _solo(jp, cfg, [1, 2, 3], 5)
    text = tok.decode([t for t in got[0] if t != 0])
    assert text.startswith("{")
    for end in ("", "}", "\"}", "0}", "]}", "\"]}"):
        try:
            json.loads(text + end)
            break
        except ValueError:
            pass
    else:
        assert constrain.run_char_dfa(constrain.json_char_dfa(2), text.encode()) >= 0, text


def test_runtime_constraint_registration():
    cfg, _, tp = _vocab128()
    from clearcam_tpu.tools.serve_llm import _AsciiTok
    tok = _AsciiTok(cfg.vocab_size)
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=2, constraint_rows=128)
    eng.register_constraint("choice", constrain.choice_token_constraint(
        tok, cfg.vocab_size, ["yes", "no"]))
    r = eng.submit([1, 2, 3], max_new=8, constraint="choice", eos_id=0)
    eng.run_until_idle()
    assert tok.decode([t for t in r.wait(1) if t != 0]) in ("yes", "no")


def test_seeded_sampling_is_slot_and_companion_independent(tiny):
    cfg, _, tp = tiny
    kw = dict(max_new=8, temperature=1.0, top_k=20, seed=1234)

    eng = ServingEngine(tp, port_cfg(cfg), n_slots=3, seed=7)
    alone = eng.submit([1, 2, 3], **kw)
    eng.run_until_idle()
    busy = [eng.submit([5, 6, 7, 8], max_new=6, temperature=1.0),
            eng.submit(list(range(1, 30)), max_new=3)]
    again = eng.submit([1, 2, 3], **kw)           # lands on another slot
    eng.run_until_idle()
    assert again.wait(1) == alone.wait(1)
    assert all(r.done for r in busy)
    other = ServingEngine(tp, port_cfg(cfg), n_slots=3, seed=7)
    third = other.submit([1, 2, 3], **dict(kw, seed=99))
    other.run_until_idle()
    assert third.wait(1) != alone.tokens


def test_engine_metrics_published(tiny):
    # the port's own registry, the one its NVR and server read
    from clearcam_tpu_torch.runtime import metrics
    cfg, _, tp = tiny
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=2)
    eng.submit([1, 2, 3], max_new=4)
    eng.run_until_idle()
    g = metrics.snapshot()["gauges"]
    assert g["serving.slots_free"] == 2 and g["serving.slots_live"] == 0
    assert g["serving.waiting"] == 0
    assert g["serving.decode_steps"] >= 3 and g["serving.prefill_tokens"] >= 3


def test_state_is_written_in_place(tiny):
    """Serving writes the preallocated caches in place (no copies of the
    state); sampled tokens are fresh tensors."""
    cfg, _, tp = tiny
    eng = ServingEngine(tp, port_cfg(cfg), n_slots=2)
    ptrs = [s["k"].data_ptr() for s in eng.state]
    first = eng._first_tok
    eng.submit([1, 2, 3], max_new=4)
    eng.run_until_idle()
    assert [s["k"].data_ptr() for s in eng.state] == ptrs
    assert eng._first_tok is not first and torch.equal(first, torch.zeros_like(first))


def test_decode_profile_tool_measures_every_route():
    """tools/llm_decode_profile's measurements at a tiny width on the CPU:
    every weight format, route and position gets a step time, a profile
    and time-to-first-token readings."""
    from clearcam_tpu_torch.tools import llm_decode_profile
    cfg = port_cfg(tiny_cfg(head_dim=128, rope_dim=128, v_head_dim=128, n_heads=4,
                            n_kv_heads=2, max_context=128))
    params = {k: v.bfloat16() for k, v in tllm.init_params(cfg, seed=2).items()}
    res = llm_decode_profile.measure(cfg, params, "cpu", positions=(5, 40), slots=2,
                                     steps=2, profile_steps=1, ttft_prompt=40,
                                     ttft_reps=2, log=lambda m: None)
    keys = {f"{w} {r} pos{p}" for w in ("bf16", "int8", "int4")
            for r in ("kernel", "plain") for p in (5, 40)}
    assert set(res["step_ms"]) == keys and set(res["tokens_per_s"]) == keys
    assert all(np.isfinite(v) and v > 0 for v in res["step_ms"].values())
    assert set(res["profile"]) == {k for k in keys if k.endswith("pos40")}
    assert all(len(v) == 2 and min(v) > 0 for v in res["ttft_ms"].values())
    json.dumps(res)
