"""The port's multi-device core (clearcam_tpu_torch.parallel.mesh and
federation) against the JAX package's, on the CPU: gloo ranks spawned by
``torch_ranks.run_ranks`` (file:// rendezvous in tmp_path, one torch
thread a rank, a 120 s deadline a spawn), the JAX side on conftest's 8
virtual devices. Covers the mesh axes, sharded detect and the leading
``BatchDetector(mesh=)`` (5 frames padded to a dp-4 bucket), multi-process
federation over tcp://, every public function of the JAX parallel
modules, and ``python -m clearcam_tpu_torch --mesh 2 --device cpu``
booting and detecting."""
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from clearcam_tpu.models import yolov9 as jyolo
from clearcam_tpu.parallel import mesh as jmesh
from clearcam_tpu.runtime.nvr import BatchDetector as JaxBatchDetector

import torch_parallel_workers as W
from torch_ranks import run_ranks

ROOT = Path(__file__).resolve().parent.parent


def _frames(n, seed0=0):
    return np.stack([np.random.default_rng(seed0 + i).integers(0, 255, (96, 128, 3),
                                                               np.uint8)
                     for i in range(n)])


def test_sharded_detect_and_batch_detector_match_jax(tmp_path):
    """dp 4 over 4 gloo ranks: sharded_detect_fn's gathered rows for 8
    frames and the leading BatchDetector's for 5 (bucket 8, 3 pad rows)
    equal the JAX BatchDetector on a dp-8 mesh within 2e-3; buckets are dp
    times a power of two; 4 ranks default to a (2, 2) mesh."""
    params = jyolo.init_params("t", seed=0)
    frames = _frames(8)
    jdet = JaxBatchDetector("t", res=64, params=params, mesh=jmesh.make_mesh(8, data=8))
    ref = np.stack(jdet.detect_many(list(frames)))
    outs = run_ranks(W.detect_ranks, 4, tmp_path, params, frames, frames[:5])
    for r, o in enumerate(outs):
        assert o["default"] == {"data": 2, "model": 2}
        assert o["local_rows"] == (2, 96, 128, 3)
        assert o["buckets"] == [8, 16]
        np.testing.assert_allclose(o["sharded"], ref, rtol=2e-3, atol=2e-3,
                                   err_msg=f"rank {r}")
    np.testing.assert_allclose(outs[0]["batch"], ref[:5], rtol=2e-3, atol=2e-3)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_federation_detect(tmp_path):
    """2 processes x 2 cameras joined over tcp://: the global mesh (data 2),
    each process's row offset, and fetch_local equal to a solo detect of
    its own frames; a model axis wider than a host's processes raises."""
    frames = [_frames(2, 0), _frames(2, 10)]
    outs = run_ranks(W.federation_rank, 2, tmp_path, _free_port(), frames, init=False)
    for r, o in enumerate(outs):
        assert o["shape"] == {"data": 2, "model": 1}
        assert (o["start"], o["total"]) == (2 * r, 4)
        assert o["mine"].shape == o["solo"].shape and o["mine"].shape[0] == 2
        np.testing.assert_allclose(o["mine"], o["solo"], rtol=2e-4, atol=2e-4)
        assert o["refused"]


@pytest.mark.parametrize("name", ["mesh", "federation", "ringattn", "long_prefill",
                                  "pipeline"])
def test_every_jax_parallel_function_has_a_counterpart(name):
    """Each public function of clearcam_tpu.parallel.<name> exists in the
    port's module of the same name."""
    import importlib
    jmod = importlib.import_module(f"clearcam_tpu.parallel.{name}")
    tmod = importlib.import_module(f"clearcam_tpu_torch.parallel.{name}")
    public = [k for k, v in vars(jmod).items() if inspect.isfunction(v)
              and v.__module__ == jmod.__name__ and not k.startswith("_")]
    assert public
    missing = [k for k in public if not callable(getattr(tmod, k, None))]
    assert not missing, missing


def test_main_boots_with_mesh(tmp_path):
    """`python -m clearcam_tpu_torch --mesh 2 --device cpu`: rank 0 serves
    and starts rank 1 itself; detect batches shard over both ranks (the
    synthetic camera's frames tick through), with no detect or tracker
    errors, and both ranks leave at SIGTERM."""
    from clearcam_tpu_torch.runtime.settings import GlobalSettings
    from clearcam_tpu_torch.utils.db import KVStore

    db = KVStore(tmp_path / "cc_cache.db")
    db.run_put("links", "cam1", "synthetic://320x180")
    db.run_put("global_settings", "all", GlobalSettings(model_size="t", model_res=64))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS="1", CLEARCAM_DTYPE="f32")
    proc = subprocess.Popen(
        [sys.executable, "-m", "clearcam_tpu_torch", "--port", str(port),
         "--data", str(tmp_path), "--weights", str(tmp_path / "weights"),
         "--device", "cpu", "--mesh", "2"],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    snap = None
    try:
        deadline = time.time() + 100
        while time.time() < deadline:
            assert proc.poll() is None, proc.stdout.read()
            try:
                snap = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=2).read())
                if snap["counters"].get("frames", 0) >= 3:
                    break
            except OSError:
                pass
            time.sleep(0.5)
        assert snap is not None, "server never served /metrics"
        assert snap["counters"].get("frames", 0) >= 3, snap
        assert not snap["counters"].get("detect_errors"), snap
        assert not snap["counters"].get("tracker_errors"), snap
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate(timeout=10)
    assert "mesh: detect Mesh({'data': 2, 'model': 1}" in out, out
    assert proc.returncode == 0, out
