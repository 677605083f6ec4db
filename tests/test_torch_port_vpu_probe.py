"""The port's FMA-rate probe (clearcam_tpu_torch.tools.vpu_probe) against the
JAX package's: ``probe_reference``, the kernel's plain version, equals the
TPU kernel body ``_kernel`` run through ``pl.pallas_call(interpret=True)``
on the CPU, f32 and bf16, at 64 multiply-adds per chain; the wrapper runs
the plain version on a CPU tensor and refuses what the kernel cannot take;
``main()`` prints the JAX tool's keys.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from clearcam_tpu.tools import vpu_probe as jvp
from clearcam_tpu_torch.tools import vpu_probe as tvp

ITERS = 64


def _jax_tile(x: np.ndarray, dtype, monkeypatch):
    monkeypatch.setattr(jvp, "ITERS", ITERS)
    xj = jnp.asarray(x).astype(dtype)
    out = pl.pallas_call(functools.partial(jvp._kernel, dtype=dtype),
                         out_shape=jax.ShapeDtypeStruct(xj.shape, dtype),
                         interpret=True)(xj)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["ones", "random"])
def test_probe_reference_matches_jax_kernel(name, kind, monkeypatch):
    """Exact, both dtypes: the JAX package (XLA on the CPU) contracts the
    f32 body into an FMA and rounds the bf16 product and sum apart, and so
    does the plain version. x = ones is the tool's input."""
    rng = np.random.default_rng(3)
    x = np.ones((jvp.ROWS, 128), np.float32) if kind == "ones" else \
        rng.uniform(0.25, 2.0, (jvp.ROWS, 128)).astype(np.float32)
    want = _jax_tile(x, getattr(jnp, name), monkeypatch)
    tdt = getattr(torch, name)
    got = tvp.probe_reference(torch.from_numpy(x).to(tdt), ITERS)
    assert got.dtype == tdt and tuple(got.shape) == (jvp.ROWS, 128)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_probe_shape_constants_match_jax():
    assert (tvp.ROWS, tvp.ITERS, tvp.UNROLL) == (jvp.ROWS, jvp.ITERS, jvp.UNROLL)
    assert tvp.macs_per_call() == jvp.ROWS * 128 * jvp.ITERS == 2_147_483_648


def test_chains_contract_to_their_fixed_points():
    """Each chain converges to x / (1 - c_j): the f32 tile of ones sums to
    ~95.41 after enough steps, so the probe never overflows."""
    out = tvp.probe_reference(torch.ones((2, 128)), 2048)
    want = sum(1 / (1 - (0.875 + 0.01 * j)) for j in range(8))
    assert abs(out[0, 0].item() - want) < 1e-3


def test_wrapper_runs_the_plain_version_on_cpu_and_checks_inputs():
    x = torch.ones((4, 128), dtype=torch.bfloat16)
    before = tvp.probe.launches
    torch.testing.assert_close(tvp.probe(x, 16), tvp.probe_reference(x, 16), rtol=0, atol=0)
    assert tvp.probe.launches == before               # no kernel on the CPU
    with pytest.raises(ValueError, match="multiple of 8"):
        tvp.probe_reference(x, 12)


def test_main_prints_the_jax_tools_keys(monkeypatch, capsys):
    monkeypatch.setattr(tvp, "ITERS", 16)
    res = tvp.main(["--device", "cpu", "--steps", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    jax_keys = {"vpu_f32_tmacs", "vpu_bf16_tmacs", "conv1_ms_at_measured_bf16_rate"}
    assert jax_keys <= set(line) and line["device"] == "cpu"
    assert all(np.isfinite(line[k]) and line[k] > 0 for k in jax_keys)


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tvp.main([])
