"""The port's LLM micro-benchmark (clearcam_tpu_torch.tools.llm_bench) on the
CPU at one block of a tiny width, ``--device cpu``: one case per mode family
(``bench_mode``'s weight, cache and kernel flags, the batched-decode ladder,
the engine with and without speculative windows, scoring), each line's JSON
keys equal to the JAX tool's for the same measurement.
"""
import json

import jax.numpy as jnp
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.tools import llm_bench as jbench
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.tools import llm_bench as tbench

from test_llm import tiny_cfg
from test_torch_port_llm import port_cfg
from test_torch_port_llm_families import NEXT


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


# one block, head_dim 128 (the decode kernels' width), a small vocab
CFG = tiny_cfg(num_blocks=1, head_dim=128, rope_dim=128, v_head_dim=128, n_heads=4,
               n_kv_heads=2, max_context=256, dim=64, hidden_dim=128)


@pytest.fixture(scope="module")
def models():
    jp = jllm.init_params(CFG, seed=0, dtype=jnp.bfloat16)
    return jp, tllm.params_from_jax(jp)


def _keys(r):
    return set(json.loads(json.dumps(r)))


@pytest.mark.parametrize("mode", ["bf16", "int8+kv16", "int4+kv8+pallas"])
def test_bench_mode_keys_and_rates(models, mode):
    jp, tp = models
    got = tbench.bench_mode(port_cfg(CFG), tp, mode, 128, 2)
    assert got["mode"] == mode and got["decode_tok_s"] > 0 and got["prefill_tok_s"] > 0
    assert _keys(got) == _keys(jbench.bench_mode(CFG, jp, "bf16", 128, 1))


@pytest.mark.parametrize("pallas", [False, True])
def test_bench_batched_keys(models, pallas, capsys):
    jp, tp = models
    got = tbench.bench_batched(port_cfg(CFG), tllm.quantize_params_int8(tp, min_dim=64),
                               [1, 3], 2, pos=20, pallas=pallas)
    assert [r["batch"] for r in got] == [1, 3] and all(r["decode_tok_s"] > 0 for r in got)
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == got
    want = jbench.bench_batched(CFG, jp, [1], 1, pos=20)
    assert all(_keys(r) == _keys(want[0]) for r in got)


@pytest.mark.parametrize("spec", [0, 3])
def test_bench_serving_keys(models, spec):
    jp, tp = models
    kw = dict(n_slots=2, n_requests=3, prompt_len=12, max_new=5, spec=spec,
              loop_prompts=3, shared_prefix=4)
    got = tbench.bench_serving(port_cfg(CFG), tllm.quantize_params_int8(tp, min_dim=64),
                               **kw)
    assert got["generated"] == 15 and got["agg_tok_s"] > 0
    want = jbench.bench_serving(CFG, jllm.quantize_params_int8(jp, min_dim=64), **kw)
    assert _keys(got) == _keys(want)
    if spec:
        assert got["tokens_per_window"] > 0


def test_bench_score_keys(models):
    jp, tp = models
    got = tbench.bench_score(port_cfg(CFG), tp, 40)
    assert got["length"] == 40 and got["score_tok_s"] > 0
    assert _keys(got) == _keys(jbench.bench_score(CFG, jp, 40))


def test_main_runs_modes_and_the_ladder_on_cpu(monkeypatch, capsys):
    """main(--device cpu) builds the model from qwen3_2b_cfg (here the
    tiny one) and runs both --modes and --decode-batch when both are
    given."""
    monkeypatch.setattr(tllm, "qwen3_2b_cfg", lambda blocks, ctx: port_cfg(CFG))
    out = tbench.main(["--device", "cpu", "--blocks", "1", "--ctx", "256", "--steps", "2",
                       "--modes", "bf16,int8+kv8+pallas", "--decode-batch", "1,2"])
    assert [r.get("batch", r.get("mode")) for r in out] == [1, 2, "bf16", "int8+kv8+pallas"]
    text = capsys.readouterr().out
    assert text.startswith("# 1 blocks") and "device cpu" in text.splitlines()[0]
    # --ssm: the hybrid from qwen3_next_cfg (here a tiny one, one block of each kind)
    monkeypatch.setattr(tllm, "qwen3_next_cfg", lambda blocks, ctx: port_cfg(NEXT))
    out = tbench.main(["--device", "cpu", "--ssm", "--blocks", "2", "--ctx", "256",
                       "--steps", "2", "--modes", "bf16"])
    assert [r["mode"] for r in out] == ["bf16"] and out[0]["decode_tok_s"] > 0


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tbench.main(["--blocks", "1"])
