"""The port's sequence and pipeline parallelism against the JAX package's,
on the CPU: 4 gloo ranks (``torch_ranks.run_ranks``, one spawn for ring
attention and the sequence-parallel prefill, one for the pipelines) on the
same numpy inputs as the JAX functions on conftest's 8 virtual devices.
Tolerances are the JAX tests': ring attention 2e-5, the sharded prefill
3e-5, pipeline_apply 1e-5 / 1e-6, the training steps 1e-5 on the loss and
1e-4 / 5e-4 on the grads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.parallel import pipeline as jpp
from clearcam_tpu.parallel.long_prefill import make_sharded_prefill
from clearcam_tpu.parallel.ringattn import ring_prefill
from clearcam_tpu_torch.models import llm as tllm

import torch_parallel_workers as W
from test_torch_port_llm import port_cfg
from torch_ranks import run_ranks


def _ring_cases():
    """(q, k, v, causal): the JAX tests' shapes, 16 tokens a rank at 4."""
    rng = np.random.default_rng(0)
    cases = []
    for b, t, h, kvh, d, causal in ((2, 64, 4, 4, 16, True), (2, 64, 4, 4, 16, False),
                                    (1, 1024, 2, 2, 32, True), (1, 64, 4, 2, 16, True),
                                    (1, 32, 1, 1, 8, True)):
        cases.append((rng.normal(size=(b, t, h, d)).astype(np.float32),
                      rng.normal(size=(b, t, kvh, d)).astype(np.float32),
                      rng.normal(size=(b, t, kvh, d)).astype(np.float32), causal))
    return cases


def _tiny(**kw):
    base = dict(num_blocks=2, dim=32, hidden_dim=64, n_heads=4, n_kv_heads=2,
                norm_eps=1e-5, vocab_size=128, head_dim=8, rope_theta=1e4,
                rope_dim=8, v_head_dim=8, max_context=256)
    base.update(kw)
    return jllm.TransformerConfig(**base)


@pytest.fixture(scope="module")
def seq_run(tmp_path_factory):
    cases = _ring_cases()
    cfg = _tiny()
    jp = jllm.init_params(cfg, seed=7)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 32)).astype(np.int64)
    hybrid = port_cfg(_tiny(ssm=jllm.SSMConfig(conv_kernel=4, state_size=8, group_count=2,
                                                time_step_rank=4, inner_size=32),
                            full_attention_interval=2))
    outs = run_ranks(W.seq_ranks, 4, tmp_path_factory.mktemp("seq"), cases,
                     port_cfg(cfg), tllm.params_from_jax(jp), prompt, hybrid)
    return cases, cfg, jp, prompt, outs


def test_ring_prefill_matches_jax(seq_run):
    """Causal and not, a 1024-token sequence, GQA heads, and the first token
    and the shard boundaries: every rank's gathered output equals JAX
    ring_prefill on its 8-device ring within 2e-5."""
    cases, _, _, _, outs = seq_run
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    for i, (q, k, v, causal) in enumerate(cases):
        with mesh:
            ref = np.asarray(ring_prefill(mesh, "data", causal=causal)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
        for r, o in enumerate(outs):
            np.testing.assert_allclose(o["ring"][i], ref, rtol=2e-5, atol=2e-5,
                                       err_msg=f"case {i} rank {r}")
    q, k, v, _ = cases[4]                     # 8 tokens a rank: edges 0, 7, 8, 15, 16
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    s = np.where(np.tril(np.ones((32, 32), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    for pos in (0, 7, 8, 15, 16, 31):
        np.testing.assert_allclose(outs[0]["ring"][4][0, pos], ref[0, pos],
                                   rtol=2e-5, atol=2e-5, err_msg=f"pos {pos}")


def test_sharded_prefill_then_decode_matches_jax(seq_run):
    """make_sharded_prefill's hidden states and per-layer K/V equal JAX's
    within 3e-5; materialize_state's cache continues with the ordinary
    decode to the same greedy tokens as JAX's prefill + decode; a
    recurrent stack is refused."""
    _, cfg, jp, prompt, outs = seq_run
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    with mesh:
        hidden, kvs = make_sharded_prefill(mesh, cfg)(jp, jnp.asarray(prompt, jnp.int32))
    for o in outs:
        np.testing.assert_allclose(o["hidden"], np.asarray(hidden), rtol=3e-5, atol=3e-5)
        for (k, v), (jk, jv) in zip(o["kv"], kvs):
            np.testing.assert_allclose(k, np.asarray(jk), rtol=3e-5, atol=3e-5)
            np.testing.assert_allclose(v, np.asarray(jv), rtol=3e-5, atol=3e-5)
        assert o["refused"]
    freqs = jnp.asarray(jllm.precompute_freqs(cfg.rope_dim, cfg.max_context, cfg.rope_theta))
    st = jllm.init_state(cfg, 1)
    h, st = jllm.forward(jp, cfg, st, jnp.asarray(prompt, jnp.int32), 0, freqs)
    toks = [int(jnp.argmax(jllm.logits_at(jp, cfg, h, 31), -1)[0])]
    for j in range(3):
        h, st = jllm.forward(jp, cfg, st, jnp.asarray([[toks[-1]]], jnp.int32), 32 + j, freqs)
        toks.append(int(jnp.argmax(jllm.logits_at(jp, cfg, h, 0), -1)[0]))
    for o in outs:
        assert o["decode"] == toks


def _mlp(seed, n_stages=4, d=16, h=32):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.normal(size=(d, h)) * 0.3).astype(np.float32),
             "w2": (rng.normal(size=(h, d)) * 0.3).astype(np.float32)}
            for _ in range(n_stages)]


def _jmlp(p, x):
    return jax.nn.silu(x @ p["w1"]) @ p["w2"]


def _jmse(pred, tgt):
    return jnp.mean((pred - tgt) ** 2)


@pytest.fixture(scope="module")
def pipe_run(tmp_path_factory):
    import torch
    stages = _mlp(0)
    rng = np.random.default_rng(1)
    applies = [rng.normal(size=(m, 2, 16)).astype(np.float32) for m in (4, 1, 3)]
    trains = [(rng.normal(size=(m, 2, 16)).astype(np.float32),
               rng.normal(size=(m, 2, 16)).astype(np.float32)) for m in (6, 1, 5)]
    cfg = _tiny(num_blocks=4, vocab_size=64, max_context=8)
    cfg_pre = _tiny(num_blocks=4, vocab_size=64, max_context=16)
    params, params_pre = jllm.init_params(cfg, seed=1), jllm.init_params(cfg_pre, seed=0)
    tokens = rng.integers(0, 64, (4, 8)).astype(np.int64)
    targets = rng.integers(0, 64, (4, 8)).astype(np.int64)
    tokens_pre = rng.integers(0, 64, (4, 16)).astype(np.int64)
    t_stages = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]
    llm_case = (port_cfg(cfg), tllm.params_from_jax(params), tokens, targets,
                port_cfg(cfg_pre), tllm.params_from_jax(params_pre), tokens_pre)
    outs = run_ranks(W.pipe_ranks, 4, tmp_path_factory.mktemp("pipe"), t_stages, applies,
                     trains, llm_case)
    return stages, applies, trains, (cfg, params, tokens, targets, cfg_pre, params_pre,
                                      tokens_pre), outs


def _stack(stages):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *stages)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["4x4", "4x1", "4x3"])
def test_pipeline_apply_matches_jax(pipe_run, case):
    """(stages, microbatches) = (4, 4), (4, 1), (4, 3): every rank holds
    the stages applied in sequence (the same torch stage function) within
    1e-5 / 1e-6, the JAX test's bound on its schedule, and JAX
    pipeline_apply's output within 1e-5 / 1e-5 (two libraries' f32
    products over four stages)."""
    import torch
    stages, applies, _, _, outs = pipe_run
    ref = np.asarray(jpp.pipeline_apply(jpp.make_pp_mesh(4), "stage", _jmlp,
                                        _stack(stages), jnp.asarray(applies[case])))
    seq = torch.from_numpy(applies[case])
    for sp in stages:
        seq = W.mlp_stage({k: torch.from_numpy(v) for k, v in sp.items()}, seq)
    for o in outs:
        np.testing.assert_allclose(o["apply"][case], seq.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["apply"][case], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", [0, 1, 2], ids=["m6", "m1", "m5"])
def test_train_schedules_match_jax(pipe_run, case):
    """1F1B and GPipe: the loss equals JAX 1F1B's within 1e-5 and each
    rank's stage grads its stage's slice of JAX's within 1e-4 / 5e-4."""
    stages, _, trains, _, outs = pipe_run
    x, y = trains[case]
    loss, grads = jpp.pipeline_train_step_1f1b(jpp.make_pp_mesh(4), "stage", _jmlp, _jmse,
                                               _stack(stages), jnp.asarray(x), jnp.asarray(y))
    for s, o in enumerate(outs):
        for sched in ("1f1b", "gpipe"):
            got_loss, got = o["train"][case][sched]
            np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
            for k in got:
                np.testing.assert_allclose(got[k], np.asarray(grads[k][s]), rtol=1e-4,
                                           atol=5e-4, err_msg=f"{sched} stage {s} {k}")


def test_1f1b_ring_holds_2s_minus_1_inputs(pipe_run):
    """The 1F1B stage stores its inputs in a ring of 2S - 1 slots: stage 0
    has all 2S - 1 alive at its peak, the last stage one, at M = 16 and at
    M = 32 alike."""
    outs = pipe_run[-1]
    for s, o in enumerate(outs):
        assert o["peak"][16] == o["peak"][32] == (7, 7 - 2 * s)


def test_pp_llm_prefill_and_train_step_match_jax(pipe_run):
    """The stage-split LLM prefill equals JAX pp_llm_prefill; both training
    schedules' loss and stage grads equal JAX pp_llm_train_step's; each
    rank keeps its own stage's blocks, keyed relative to the stage."""
    _, _, _, (cfg, params, tokens, targets, cfg_pre, params_pre, tokens_pre), outs = pipe_run
    mesh = jpp.make_pp_mesh(4)
    h = np.asarray(jpp.pp_llm_prefill(mesh, "stage", params_pre, cfg_pre,
                                      jnp.asarray(tokens_pre, jnp.int32), n_micro=2))
    loss, grads = jpp.pp_llm_train_step(mesh, "stage", params, cfg,
                                        jnp.asarray(tokens, jnp.int32),
                                        jnp.asarray(targets, jnp.int32), 2)
    for s, o in enumerate(outs):
        np.testing.assert_allclose(o["pre"], h, rtol=1e-4, atol=1e-5)
        assert o["layout"] == sorted(k for k in grads)
        for sched in ("1f1b", "gpipe"):
            got_loss, got = o[sched]
            np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
            for k in got:
                np.testing.assert_allclose(got[k], np.asarray(grads[k][s]), rtol=2e-4,
                                           atol=5e-4, err_msg=f"{sched} stage {s} {k}")
