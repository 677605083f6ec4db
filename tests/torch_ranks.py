"""Spawned gloo ranks for the port's multi-device tests (no jax here: the
ranks import only torch and clearcam_tpu_torch).

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes
(spawn), each joining a gloo group with ``file://`` rendezvous in
``tmp_path`` and one torch thread, runs ``fn(rank, *args)`` and sends its
return value (numpy and plain Python) back through a queue. Each spawn has
a deadline: past it every rank is killed and the test fails with their
stderr."""
from __future__ import annotations

import os
import sys
import time
import traceback


def _entry(rank, world, path, fn, args, q, log, init):
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(fd, 2)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        if init:
            dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                                    world_size=world)
        out = fn(rank, *args)
        q.put((rank, "ok", out))
        from clearcam_tpu_torch.parallel import comm
        comm.shutdown(60)
    except BaseException:  # noqa: BLE001
        traceback.print_exc()
        q.put((rank, "error", traceback.format_exc()))
        sys.stderr.flush()
        os._exit(1)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 120.0,
              init: bool = True):
    """-> [fn(0, *args), ..., fn(world - 1, *args)]. ``init=False`` leaves
    joining a group to ``fn``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    tag = f"{fn.__name__}-{time.monotonic_ns()}"
    path = os.path.join(str(tmp_path), f"rdv-{tag}")
    logs = [os.path.join(str(tmp_path), f"rank{r}-{tag}.log") for r in range(world)]
    procs = [ctx.Process(target=_entry, args=(r, world, path, fn, args, q, logs[r], init),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, failure = {}, None
    try:
        while len(results) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = f"ranks past their {timeout} s deadline"
                break
            try:
                r, status, out = q.get(timeout=min(left, 1.0))
            except Exception:  # noqa: BLE001
                if any(p.exitcode not in (None, 0) for p in procs):
                    failure = "a rank died"
                continue
            if status != "ok":
                failure = f"rank {r} failed:\n{out}"
            results[r] = out
        if failure is None:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        err = "\n".join(f"--- rank {r} stderr ---\n{open(lg).read()[-3000:]}"
                        for r, lg in enumerate(logs) if os.path.exists(lg))
        raise AssertionError(f"{failure}\n{err}")
    return [results[r] for r in range(world)]
