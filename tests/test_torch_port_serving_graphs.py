"""decode_all as a CUDA graph on the card (``models/llm._DecodeGraphs``): on
a 2-block stack at Qwen3-1.7B's widths with int8 weights, a bf16 cache and
the decode-attention kernel, the replayed step gives the eager step's
tokens and logprob rows bit for bit, for greedy, seeded-temperature,
penalised and constrained rows, slots refilled between steps and outputs
held across the lagged fetch, and captures again where its buffers change;
the hand kernels' launch counters count the replayed kernels; stacks at
head dims 64, 80 and 96 (the decode kernel's padded instances) replay too.
The eager step is reached through ``llm._graph_refusal``, patched. Every
test needs the card and skips without one. The file imports no jax, so on
a GPU machine it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_serving_graphs.py
"""
import time

import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import llm
from clearcam_tpu_torch.runtime import metrics
from clearcam_tpu_torch.serving import ServingEngine, constrain

pytestmark = pytest.mark.cuda

CFG = llm.qwen3_2b_cfg(blocks=2, ctx=512)
ALLOWED = ([100, 200, 300], [400, 500])      # the test grammar's two states


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params(card):
    return llm.init_params(CFG, device=card, quantize="int8",
                           generator=torch.Generator(device=card).manual_seed(3))


@pytest.fixture
def eager(monkeypatch):
    """Run every decode_all call as the eager step (the reason ``test``)."""
    def force():
        monkeypatch.setattr(llm, "_graph_refusal", lambda *a: "test")
    return force


def _grammar():
    """Two states: a token of ``ALLOWED[0]`` leads to state 1, one of
    ``ALLOWED[1]`` back to state 0."""
    trans = np.full((2, CFG.vocab_size), -1, np.int16)
    trans[0, ALLOWED[0]] = 1
    trans[1, ALLOWED[1]] = 0
    return constrain.TokenConstraint(trans, 0, np.ones(2, bool), name="test")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, n).tolist()


def _modes(t0):
    return [s.attr for s in metrics.spans("serving.decode_graph", t0)]


def _launches():
    return [f.launches for f in llm._launch_counters()]


def _counts():
    c = metrics.snapshot()["counters"]
    return {k: c.get(f"serving.graph.{k}", 0) for k in ("replays", "captures", "eager")}


def _engine(params, kv_quant=False, **kw):
    return ServingEngine(params, CFG, n_slots=3, state_dtype=torch.bfloat16,
                         kv_quant=kv_quant, use_pallas_decode=True, seed=11, **kw)


def _serve(eng):
    """Five requests on three slots, each with its 8-wide logprob rows and a
    seed (greedy rows draw noise too): greedy, temperature with top-p and
    top-k, penalties, a grammar, and a late one that takes a slot freed
    between decode steps."""
    kw = dict(logprobs=8)
    rs = [eng.submit(_prompt(0, 40), max_new=12, seed=1, **kw),
          eng.submit(_prompt(1, 70), max_new=10, temperature=0.9, top_p=0.9, top_k=50,
                     seed=5, **kw),
          eng.submit(_prompt(2, 20), max_new=9, repetition_penalty=1.3,
                     presence_penalty=0.5, frequency_penalty=0.2, seed=2, **kw),
          eng.submit(_prompt(3, 33), max_new=8, constraint="abc", seed=3, **kw),
          eng.submit(_prompt(4, 50), max_new=6, temperature=0.7, seed=9, **kw)]
    eng.run_until_idle()
    assert all(r.done and not r.failed for r in rs)
    return [(r.tokens, r.lp) for r in rs]


def _obeys(tokens):
    return all(t in ALLOWED[i % 2] for i, t in enumerate(tokens))


@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_engine_replays_give_the_eager_tokens_and_logprob_rows(card, params, eager, cache):
    """``_serve`` through the engine, graphs against the eager step, bit for
    bit, with the bf16 cache and with the int8 one (its quantize-on-write
    inside the graph, the decode kernel reading the int8 bytes and scales);
    the spans' attributes and the counters agree."""
    kv_quant = cache == "int8"
    before, t0, n0 = _counts(), time.perf_counter(), _launches()
    got = _serve(_engine(params, kv_quant, constraints={"abc": _grammar()}))
    modes, after = _modes(t0), _counts()
    n_graph = [a - b for a, b in zip(_launches(), n0)]
    assert {"eager:warmup", "capture", "replay"} <= set(modes)
    assert set(modes) <= {"eager:warmup", "capture", "replay"}
    assert after["replays"] - before["replays"] == modes.count("replay") > 0
    assert after["captures"] - before["captures"] == modes.count("capture")
    assert after["eager"] - before["eager"] == modes.count("eager:warmup")
    # graphs only for keys seen again: each warm key is captured at most once
    assert modes.count("capture") <= modes.count("eager:warmup")
    assert _obeys(got[3][0])

    eager()
    t1, n1 = time.perf_counter(), _launches()
    want = _serve(_engine(params, kv_quant, constraints={"abc": _grammar()}))
    assert set(_modes(t1)) == {"eager:test"}
    for (tg, lg), (tw, lw) in zip(got, want):
        assert tg == tw
        assert lg == lw            # floats compared exactly: bit for bit
    # the same steps launch the same kernels, replayed or not: quant_linear
    # and the cache's decode kernel, counted a launch a replayed call
    assert n_graph == [a - b for a, b in zip(_launches(), n1)]
    assert n_graph[0] > 0 and n_graph[2 if kv_quant else 1] > 0


def _head_dim_cfg(head_dim):
    """Two blocks of a Llama-style stack at ``head_dim``, below the decode
    kernel's 128 width (its padded instances): 8 heads on 2 KV heads, no
    qk-norm, hidden = heads x head dim, vocab 32000."""
    return llm.TransformerConfig(
        num_blocks=2, dim=8 * head_dim, hidden_dim=24 * head_dim, n_heads=8, n_kv_heads=2,
        norm_eps=1e-5, vocab_size=32000, head_dim=head_dim, rope_theta=1e4,
        rope_dim=head_dim, v_head_dim=head_dim, max_context=512)


@pytest.mark.parametrize("head_dim,cache", [(64, "int8"), (80, "bf16"), (96, "int8")])
def test_head_dims_below_the_kernel_width_replay_the_eager_step(card, eager, head_dim, cache):
    """The engine over stacks at the head dims of the Llama-3.2-1B, H2O-Danube2
    and Danube3 GGUFs, int8 weights: decode steps replayed after a capture
    give the eager step's tokens and logprob rows bit for bit."""
    cfg = _head_dim_cfg(head_dim)
    p = llm.init_params(cfg, device=card, quantize="int8",
                        generator=torch.Generator(device=card).manual_seed(head_dim))

    def serve():
        eng = ServingEngine(p, cfg, n_slots=3, state_dtype=torch.bfloat16,
                            kv_quant=cache == "int8", use_pallas_decode=True, seed=11)
        rng = np.random.default_rng(head_dim)
        rs = [eng.submit(rng.integers(1, cfg.vocab_size, n).tolist(), max_new=10, logprobs=8,
                         seed=i, **kw)
              for i, (n, kw) in enumerate([(40, {}), (25, dict(temperature=0.8, top_k=30)),
                                           (60, dict(repetition_penalty=1.2)), (30, {})])]
        eng.run_until_idle()
        assert all(r.done and not r.failed for r in rs)
        return [(r.tokens, r.lp) for r in rs]

    t0 = time.perf_counter()
    got = serve()
    assert "replay" in _modes(t0)
    eager()
    assert got == serve()


def _buffers(card, b, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    return dict(state=llm.init_state(CFG, b, dtype=torch.bfloat16, device=card),
                cnt_o=torch.zeros((b, CFG.vocab_size), dtype=torch.int32, device=card),
                cnt_p=torch.randint(0, 3, (b, CFG.vocab_size), generator=g, device=card,
                                    dtype=torch.int32),
                bias=torch.randn((b, CFG.vocab_size), generator=g, device=card),
                ctab=torch.from_numpy(_grammar().trans).to(card),
                first=torch.randint(1, CFG.vocab_size, (b,), generator=g, device=card,
                                    dtype=torch.int32))


def _steps(decode_all, params, buf, n, samp):
    """n decode steps over every row; the outputs of every step are kept
    and read only at the end, as the engine reads them sync_lag steps late."""
    b, dev = samp.shape[0], buf["first"].device
    prev = torch.zeros(b, dtype=torch.int32, device=dev)
    cstate = torch.tensor([-1, -1, -1, 0], dtype=torch.int32, device=dev)
    held = []
    for j in range(n):
        meta = np.zeros((5, b), np.int32)
        meta[0] = 40 + j
        meta[1] = 1
        meta[2] = j == 0
        meta[3] = np.arange(b) + 7
        meta[4] = 40
        prev, _, _, lp, cstate = decode_all(params, buf["state"], prev, buf["first"], meta,
                                            samp, 123, buf["cnt_o"], buf["cnt_p"],
                                            buf["bias"], buf["ctab"], cstate)
        held.append((prev, lp, cstate))
    return [tuple(t.cpu() for t in h) for h in held]


def test_held_outputs_and_recapture_match_the_eager_step(card, params, eager):
    """Direct decode_all calls on 4 rows (greedy; seeded temperature with
    top-k; penalties and a logit bias; a grammar row): 6 steps, every
    output held to the end; then fresh buffers (new data pointers, as after
    reset_device), on which the step is captured again. Every step is the
    eager step's bit for bit, and so are the caches and histograms."""
    samp = np.stack([llm.pack_samp().numpy(), llm.pack_samp(0.8, top_k=40).numpy(),
                     llm.pack_samp(presence=0.4, frequency=0.3, repetition=1.2,
                                   bias_active=1.0).numpy(), llm.pack_samp().numpy()])

    def run():
        _, decode_all, _ = llm.make_serving_fns(CFG, use_pallas_decode=True, constraints=True)
        bufs = [_buffers(card, samp.shape[0], seed) for seed in (1, 2)]
        return [_steps(decode_all, params, buf, 6, samp) for buf in bufs], bufs

    t0 = time.perf_counter()
    got, got_bufs = run()
    assert _modes(t0) == 2 * (["eager:warmup", "capture"] + ["replay"] * 4)
    eager()
    want, want_bufs = run()
    for g_run, w_run in zip(got, want):
        for g_step, w_step in zip(g_run, w_run):
            assert all(torch.equal(g, w) for g, w in zip(g_step, w_step))
    for gb, wb in zip(got_bufs, want_bufs):
        assert torch.equal(gb["cnt_o"], wb["cnt_o"])
        for gs, ws in zip(gb["state"], wb["state"]):
            assert all(torch.equal(gs[k], ws[k]) for k in gs)
    # the grammar row keeps to its automaton: states 1, 0, 1, ...
    assert [int(c[3]) for _, _, c in got[0]] == [1, 0, 1, 0, 1, 0]


def test_reset_and_a_registered_grammar(card, params, eager):
    """After reset_device the next decode steps warm up and capture again on
    the new cache. A grammar registered at run time is written into the
    table in place (its data pointer stays), so the graphs kept serve it.
    The graph engine and the eager one give the same tokens and rows."""
    def scenario():
        eng = _engine(params, constraint_rows=64)
        r0 = eng.submit(_prompt(5, 30), max_new=8, logprobs=8, seed=5)
        eng.run_until_idle()
        t0, ptr = time.perf_counter(), eng._ctab.data_ptr()
        eng.reset_device()
        r1 = eng.submit(_prompt(6, 30), max_new=8, logprobs=8, seed=6)
        eng.run_until_idle()
        t1 = time.perf_counter()
        eng.register_constraint("late", _grammar())
        assert eng._ctab.data_ptr() == ptr
        r2 = eng.submit(_prompt(7, 30), max_new=8, logprobs=8, seed=7, constraint="late")
        r3 = eng.submit(_prompt(8, 30), max_new=8, logprobs=8, seed=8)
        eng.run_until_idle()
        assert _obeys(r2.tokens)
        return [(r.tokens, r.lp) for r in (r0, r1, r2, r3)], _modes(t0), _modes(t1)

    got, after_reset, after_grammar = scenario()
    assert after_reset[:2] == ["eager:warmup", "capture"]
    assert "replay" in after_grammar
    eager()
    want, _, _ = scenario()
    assert got == want
