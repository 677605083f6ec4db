"""Speculative serving in the port's engine (``ServingEngine(spec_lookup=G)``,
``llm.make_serving_fns(spec_lookup=G)``) against the JAX package's, on the
CPU at tiny widths, f32, greedy: one case for each case of
tests/test_serving_spec.py (MLA's is in test_torch_port_serving_families.py).
Every request's tokens equal the JAX spec engine's and its solo
generation; the draft lookup equals the JAX function on random
histories.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.serving import ServingEngine as JaxEngine
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.serving import ServingEngine
from clearcam_tpu_torch.testing import torch_threads

from test_llm import tiny_cfg
from test_torch_port_serving import _solo, port_cfg


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _pair(max_context, seed=4):
    cfg = tiny_cfg(max_context=max_context)
    jp = jllm.init_params(cfg, seed=seed)
    return cfg, jp, tllm.params_from_jax(jp)


def _both(cfg, jp, tp, drive, **kw):
    """drive(engine) -> result, for the port's engine and the JAX one."""
    return (drive(ServingEngine(tp, port_cfg(cfg), **kw)),
            drive(JaxEngine(jp, cfg, **kw)))


@pytest.mark.parametrize("seed,b,s,gamma", [(0, 3, 40, 3), (1, 4, 64, 4), (2, 2, 96, 1)])
def test_device_lookup_draft_matches_jax(seed, b, s, gamma):
    """Random histories over a small alphabet (many bigram repeats), the
    tail positions from 0 to past the end, x0 inside and outside the
    history."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 5, (b, s)).astype(np.int32)
    pos = rng.integers(0, s, b).astype(np.int32)
    pos[0] = 0
    x0 = rng.integers(0, 6, b).astype(np.int32)
    want = np.asarray(jllm._device_lookup_draft(jnp.asarray(ids), jnp.asarray(pos),
                                                jnp.asarray(x0), gamma))
    got = tllm._device_lookup_draft(torch.from_numpy(ids), torch.from_numpy(pos),
                                    torch.from_numpy(x0), gamma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_serving_aux_layout():
    cfg = port_cfg(tiny_cfg(max_context=96))
    aux = tllm.init_serving_aux(cfg, 3)
    want = jllm.init_serving_aux(tiny_cfg(max_context=96), 3)
    assert set(aux) == set(want)
    for k, v in aux.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.int32
        assert not v.any()


def test_spec_staggered_matches_jax_and_solo():
    cfg, jp, tp = _pair(96)
    long_prompt = list(range(1, 41))

    def drive(eng):
        r1 = eng.submit([1, 2, 3, 4, 5], max_new=8)
        for _ in range(3):
            eng.step()
        r2 = eng.submit(long_prompt, max_new=6)
        eng.step()
        r3 = eng.submit([9, 8, 7], max_new=5)
        eng.run_until_idle()
        return [r.wait(1) for r in (r1, r2, r3)]

    got, want = _both(cfg, jp, tp, drive, n_slots=2, spec_lookup=3)
    assert got == want
    assert got == [_solo(jp, cfg, [1, 2, 3, 4, 5], 8), _solo(jp, cfg, long_prompt, 6),
                   _solo(jp, cfg, [9, 8, 7], 5)]


def test_spec_accepts_drafts_on_periodic_output():
    """The tiny model falls into a periodic greedy cycle that the bigram
    lookup drafts: fewer decode dispatches than tokens, every emitted token
    counted, and the same dispatches as the JAX engine."""
    cfg, jp, tp = _pair(160)
    solo = _solo(jp, cfg, [1, 2, 3], 48)
    assert len(set(zip(solo, solo[1:]))) < len(solo) - 4

    def drive(eng):
        r = eng.submit([1, 2, 3], max_new=48)
        eng.run_until_idle()
        return r.wait(1), eng.stats["decode_steps"], eng.stats["spec_emitted"]

    got, want = _both(cfg, jp, tp, drive, n_slots=1, spec_lookup=4, sync_lag=0,
                      fetch_every=1)
    assert got == want
    assert got[0] == solo and got[1] < len(solo) and got[2] == len(solo)


def test_spec_eos_mid_window():
    cfg, jp, tp = _pair(96)
    eos = _solo(jp, cfg, [1, 2, 3], 6)[2]

    def drive(eng):
        r1 = eng.submit([1, 2, 3], max_new=12, eos_id=eos)
        r2 = eng.submit([7, 1, 7, 1], max_new=4)
        eng.run_until_idle()
        return r1.wait(1), r2.wait(1)

    got, want = _both(cfg, jp, tp, drive, n_slots=1, spec_lookup=4)
    assert got == want
    assert got[0] == _solo(jp, cfg, [1, 2, 3], 12, eos_id=eos) and got[0][-1] == eos
    assert got[1] == _solo(jp, cfg, [7, 1, 7, 1], 4)


@pytest.mark.parametrize("lag,fetch", [(0, 1), (2, 1), (6, 4)])
def test_spec_lag_and_fetch_invariance(lag, fetch):
    cfg, jp, tp = _pair(128, seed=5)

    def drive(eng):
        rs = [eng.submit([1, 2, 3, 4], max_new=10), eng.submit([9, 8], max_new=10)]
        eng.run_until_idle()
        return [r.wait(1) for r in rs]

    got, want = _both(cfg, jp, tp, drive, n_slots=2, spec_lookup=3, sync_lag=lag,
                      fetch_every=fetch)
    assert got == want == [_solo(jp, cfg, [1, 2, 3, 4], 10), _solo(jp, cfg, [9, 8], 10)]


def test_spec_prefix_reuse():
    cfg, jp, tp = _pair(160)
    p1 = list(range(1, 40))

    def drive(eng):
        r1 = eng.submit(p1, max_new=6)
        eng.run_until_idle()
        follow = p1 + r1.wait(1) + [11, 12]
        r2 = eng.submit(follow, max_new=6)
        eng.run_until_idle()
        return follow, r2.wait(1), eng.stats["reused_tokens"]

    got, want = _both(cfg, jp, tp, drive, n_slots=1, spec_lookup=3)
    assert got == want
    assert got[1] == _solo(jp, cfg, got[0], 6) and got[2] >= tllm.CHUNK


def test_spec_mixed_temperature():
    """A temperature > 0 row rides beside a greedy one, one sampled token a
    window: the greedy row is exact; the sampled row has its length and
    valid ids (the two packages draw different noise)."""
    cfg, jp, tp = _pair(96)

    def drive(eng):
        rg = eng.submit([1, 2, 3, 4, 5], max_new=8)
        rt = eng.submit([5, 4, 3], max_new=8, temperature=1.0)
        eng.run_until_idle()
        return rg.wait(1), rt.wait(1)

    (g_port, t_port), (g_jax, _) = _both(cfg, jp, tp, drive, n_slots=2, spec_lookup=3)
    assert g_port == g_jax == _solo(jp, cfg, [1, 2, 3, 4, 5], 8)
    assert len(t_port) == 8 and all(0 <= t < cfg.vocab_size for t in t_port)


def test_spec_kv_quant():
    cfg, jp, tp = _pair(96)
    oracle = jllm.generate_batch(jp, cfg, [[1, 2, 3, 4, 5]], max_new=6, kv_quant=True)[0]

    def drive(eng):
        r = eng.submit([1, 2, 3, 4, 5], max_new=6)
        r2 = eng.submit([6, 5, 6, 5, 6], max_new=9)
        eng.run_until_idle()
        return r.wait(1), r2.wait(1)

    got, want = _both(cfg, jp, tp, drive, n_slots=2, kv_quant=True, spec_lookup=3)
    assert got == want and got[0] == oracle


def test_spec_batched_prefill_and_cancel():
    cfg, jp, tp = _pair(160)
    prompts = [list(range(1, 40)), list(range(2, 36)), [7, 8, 9, 10]]

    def drive(eng):
        rs = [eng.submit(p, max_new=6) for p in prompts]
        eng.step()                               # one batched prefill tick
        batched = eng.stats["prefill_batched_steps"]
        eng.cancel(rs[1])
        eng.run_until_idle()
        return batched, rs[0].wait(1), rs[2].wait(1), rs[1].done

    got, want = _both(cfg, jp, tp, drive, n_slots=3, spec_lookup=3)
    assert got == want
    assert got[0] >= 1 and got[3]
    assert got[1] == _solo(jp, cfg, prompts[0], 6) and got[2] == _solo(jp, cfg, prompts[2], 6)


def test_spec_max_new_mid_window():
    cfg, jp, tp = _pair(160)
    full = _solo(jp, cfg, [1, 2, 3], 40)

    def drive(eng):
        r = eng.submit([1, 2, 3], max_new=17)
        eng.run_until_idle()
        return r.wait(1)

    got, want = _both(cfg, jp, tp, drive, n_slots=1, spec_lookup=4)
    assert got == want == full[:17]


def test_spec_refused_for_ssm_and_the_decode_kernel():
    """Spec on an SSM stack raises where the JAX engine turns spec off (a
    rejected draft's recurrent update cannot be rolled back); spec with
    use_pallas_decode raises where the JAX engine turns spec off, since a
    window has G+1 queries and the decode kernels take one; constraints,
    logprobs and seeds raise as in the reference."""
    ssm = tllm.SSMConfig(conv_kernel=3, state_size=8, group_count=2, time_step_rank=4,
                         inner_size=32)
    scfg = dataclasses.replace(port_cfg(tiny_cfg(full_attention_interval=2, qk_norm=8)),
                               ssm=ssm)
    with pytest.raises(ValueError, match="GatedDeltaNet state update cannot be rolled back"):
        tllm.make_serving_fns(scfg, spec_lookup=4)
    cfg, _, tp = _pair(96)
    with pytest.raises(ValueError, match="use_pallas_decode"):
        ServingEngine(tp, port_cfg(cfg), spec_lookup=4, use_pallas_decode=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tllm.make_serving_fns(port_cfg(cfg), use_pallas_decode=True, spec_lookup=4)
    with pytest.raises(ValueError, match="constrained decoding"):
        ServingEngine(tp, port_cfg(cfg), spec_lookup=4, constraint_rows=64)
    eng = ServingEngine(tp, port_cfg(cfg), spec_lookup=4)
    for kw, what in ((dict(logprobs=2), "logprobs"), (dict(seed=3), "seed"),
                     (dict(constraint="json"), "constraint")):
        with pytest.raises(ValueError, match=f"{what} unsupported with spec_lookup"):
            eng.submit([1, 2], max_new=2, **kw)
