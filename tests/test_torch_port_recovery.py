"""Crash recovery in the port's serving engine (``ServingEngine(max_restarts=)``,
``_recover``), the cases of the JAX package's tests/test_serving_soak.py on
the port's engine, on the CPU at tiny widths, f32, greedy: a crash injected
at the Nth ``decode_all`` call (``_flaky``, before the graph runs) requeues
requests with no token read yet, fails the ones that streamed with a valid
prefix, exhausts a restart budget loudly, and ages out of a sliding
window. Tokens are held exactly equal to the JAX package's solo
``Transformer.generate`` on the same numpy weights (``params_from_jax``);
one case recovers a speculative engine (``spec_lookup=3``) the same way.
"""
import time

import pytest

from clearcam_tpu.models import llm as jllm
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.serving import ServingEngine
from clearcam_tpu_torch.testing import torch_threads

from test_llm import tiny_cfg
from test_torch_port_serving import _solo, port_cfg


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, the port's cfg, the port's params), seed 4."""
    cfg = tiny_cfg(max_context=96)
    jp = jllm.init_params(cfg, seed=4)
    return cfg, jp, port_cfg(cfg), tllm.params_from_jax(jp)


def _flaky(eng, fail_on):
    """Wrap eng.decode_all to raise on the Nth call (1-based)."""
    orig = eng.decode_all
    calls = {"n": 0}

    def wrapper(*a, **k):
        calls["n"] += 1
        if calls["n"] in fail_on:
            raise RuntimeError("injected decode failure")
        return orig(*a, **k)

    eng.decode_all = wrapper
    return calls


@pytest.mark.parametrize("spec", [0, 3])
def test_recovery_requeues_unobserved_requests(model, spec):
    """A crash before any token materialized requeues the in-flight
    requests; after the restart they complete with exactly their solo
    greedy tokens (fresh cache and aux: nothing poisoned survives), and a
    fresh request does too."""
    cfg, jp, tc, tp = model
    # sync_lag=4: tokens materialize late, so a crash at decode call 2
    # comes before any client-observed token -> both requeue
    eng = ServingEngine(tp, tc, n_slots=2, max_restarts=3, sync_lag=4, spec_lookup=spec)
    _flaky(eng, fail_on={2})
    eng.start()
    try:
        r1 = eng.submit([1, 2, 3, 4, 5], max_new=6)
        r2 = eng.submit([9, 8, 7], max_new=5)
        assert r1.wait(30) == _solo(jp, cfg, [1, 2, 3, 4, 5], 6)
        assert r2.wait(30) == _solo(jp, cfg, [9, 8, 7], 5)
        assert not r1.failed and not r2.failed
        assert eng.stats["scheduler_restarts"] == 1
        r3 = eng.submit([5, 5], max_new=4)
        assert r3.wait(30) == _solo(jp, cfg, [5, 5], 4)
        if spec:
            assert eng.stats["spec_emitted"] > 0
    finally:
        eng.close()


def test_recovery_fails_streamed_requests(model):
    """A request that already streamed tokens does not restart silently
    mid-stream: it completes failed=True with its partial tokens, a prefix
    of its solo tokens; a later request runs clean on the reset state."""
    cfg, jp, tc, tp = model
    # sync_lag=0 fetch_every=1: tokens materialize every step, so by
    # decode call 6 the request has observed tokens -> fail, not requeue
    eng = ServingEngine(tp, tc, n_slots=1, max_restarts=3, sync_lag=0, fetch_every=1)
    _flaky(eng, fail_on={6})
    eng.start()
    try:
        r1 = eng.submit([1, 2, 3], max_new=12)
        toks = r1.wait(30)
        assert r1.failed and 0 < len(toks) < 12
        assert toks == _solo(jp, cfg, [1, 2, 3], 12)[:len(toks)]
        r2 = eng.submit([7, 1, 7, 1], max_new=4)
        assert r2.wait(30) == _solo(jp, cfg, [7, 1, 7, 1], 4)
        assert not r2.failed
    finally:
        eng.close()


def test_restart_budget_exhaustion_fails_loudly(model):
    """More crashes than max_restarts inside the window: every waiter
    completes failed and a further submit raises."""
    _, _, tc, tp = model
    eng = ServingEngine(tp, tc, n_slots=1, max_restarts=1)
    _flaky(eng, fail_on={1, 2})          # crash, recover, crash again
    eng.start()
    try:
        r = eng.submit([1, 2, 3], max_new=4)
        r.wait(30)
        assert r.failed
        assert eng.stats["scheduler_restarts"] == 1
        with pytest.raises(RuntimeError):
            eng.submit([1], max_new=1)
    finally:
        eng.close()


def test_restart_window_slides(model):
    """Old restart marks age out: two crashes farther apart than the
    window both recover, even with max_restarts=1."""
    cfg, jp, tc, tp = model
    eng = ServingEngine(tp, tc, n_slots=1, max_restarts=1, restart_window_s=0.05)
    calls = _flaky(eng, fail_on={1})
    eng.start()
    try:
        r1 = eng.submit([1, 2, 3], max_new=4)
        assert r1.wait(30) == _solo(jp, cfg, [1, 2, 3], 4)
        # drain (the lag window's junk steps still call decode_all after r1
        # retires) and let the first restart mark age out of the window
        deadline = time.monotonic() + 20
        while eng._has_work() and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        calls["n"] = 0                        # arm the next injected failure
        r2 = eng.submit([5, 5], max_new=4)
        assert r2.wait(30) == _solo(jp, cfg, [5, 5], 4)
        assert eng.stats["scheduler_restarts"] == 2
    finally:
        eng.close()
