"""The collectives of the port's multi-device paths, each in one place, and
the start-up of their ranks.

One process runs per device (``torch.distributed``): NCCL between cards, one
rank a card; gloo on the CPU when the caller asks for ``device="cpu"``; and
gloo between ranks that share a card, when the caller asks for it by name
(two ranks on one H100 check the sharded shapes, not scale-out).

gloo and CUDA tensors, decided by backend and op, never by catching an
error. ``GLOO_CUDA_OPS`` names the ops PyTorch's gloo backend takes CUDA
tensors for, as ``tools/gloo_cuda_probe.py`` found them on the H100
machine (torch 2.11.0+cu128, two ranks on one card, each op in a fresh
pair of processes): every collective it tried ran with the right values
(``all_reduce``, ``broadcast``, ``all_gather``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``scatter``, ``gather``, ``all_to_all_single``),
while ``send``/``recv`` raised and ``batch_isend_irecv`` aborted the
process. Point-to-point on a CUDA tensor under gloo is therefore staged
through pinned host memory: copied down, sent or received on the CPU
copy, and copied back.
"""
from __future__ import annotations

import datetime
import os
import sys
import tempfile
import threading

import torch
import torch.distributed as dist

GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                           "reduce_scatter_tensor", "scatter", "gather",
                           "all_to_all_single"})

# this process's rank device, once init_group has chosen it
DEVICE: torch.device | None = None

# the deadline of every collective but the command channel's wait for the
# next command (seconds)
TIMEOUT_S = 600.0


def backend_of(group=None) -> str:
    return str(dist.get_backend(group))


def staged(op: str, t: torch.Tensor, group=None) -> bool:
    """True when ``op`` on ``t`` goes through host memory: a CUDA tensor
    under gloo, for an op gloo does not take on the card."""
    return t.is_cuda and backend_of(group) == "gloo" and op not in GLOO_CUDA_OPS


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns it."""
    if staged("all_reduce", t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from the global rank ``src`` to every rank of ``group``, in place."""
    if staged("broadcast", t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in the
    group's rank order, on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _host(t) if staged("all_gather", t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if out.device != t.device else out


def scatter(out: torch.Tensor, chunks: list | None, group=None) -> torch.Tensor:
    """Group rank 0's ``chunks`` (one a rank, shaped like ``out``) into each
    rank's ``out``, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    if staged("scatter", out, group):
        h = torch.empty(out.shape, dtype=out.dtype)
        dist.scatter(h, [c.cpu() for c in chunks] if chunks is not None else None,
                     src, group=group)
        out.copy_(h)
    else:
        dist.scatter(out, chunks, src, group=group)
    return out


def exchange(sends: list, recvs: list, group=None) -> None:
    """Point-to-point in one batch: ``sends`` [(tensor, group rank)] and
    ``recvs`` [(tensor, group rank)] written in place, all posted together
    with ``dist.batch_isend_irecv`` and waited for."""
    exchange_start(sends, recvs, group)()


def exchange_start(sends: list, recvs: list, group=None):
    """``exchange`` posted now; the returned function waits for it, so
    arithmetic can run between the two (the ring's overlap)."""
    if not sends and not recvs:
        return lambda: None
    some = (sends or recvs)[0][0]
    host = staged("p2p", some, group)
    ops, back = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, _host(t) if host else t.contiguous(),
                              group=group, group_peer=peer))
    for t, peer in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if host else t
        ops.append(dist.P2POp(dist.irecv, buf, group=group, group_peer=peer))
        back.append((t, buf))
    reqs = dist.batch_isend_irecv(ops)

    def finish():
        for r in reqs:
            r.wait()
        for t, buf in back:
            if buf is not t:
                t.copy_(buf)
    return finish


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def rank_device(device: str, backend: str, rank: int, local_rank: int) -> torch.device:
    """The device of a rank: cuda:local_rank under NCCL (one rank a card),
    cuda:(rank % cards) under gloo (ranks may share a card), or the CPU."""
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    cards = torch.cuda.device_count()
    idx = local_rank if backend == "nccl" else rank % cards
    dev = torch.device("cuda", idx)
    torch.cuda.set_device(dev)
    return dev


def default_backend(device: str) -> str:
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def init_group(rank: int, world: int, init_method: str, device: str = "cuda",
               backend: str | None = None, local_rank: int | None = None,
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device. The first
    collective (a barrier) carries the deadline ``timeout_s``, so a rank
    that never arrives makes the others raise."""
    backend = backend or default_backend(device)
    dev = rank_device(device, backend, rank, rank if local_rank is None else local_rank)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    dist.barrier()
    global DEVICE
    DEVICE = dev
    return dev


def _follower_entry(i: int, world: int, init_method: str, device: str, backend: str,
                    fn, args) -> None:
    # rank 0 decides when the group ends: a Ctrl-C or SIGTERM sent to the
    # whole process group reaches the leader's shutdown, which stops the
    # followers (and a follower whose leader is gone fails its next
    # collective)
    import signal
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    rank = i + 1
    init_group(rank, world, init_method, device, backend)
    try:
        fn(*args)
    finally:
        shutdown()


class Ranks:
    """The ranks of one multi-device run as rank 0 sees them: followers it
    started itself (``torch.multiprocessing`` spawn), or none under
    ``torchrun``. A follower that dies ends the leader's process: the
    leader never carries on alone."""

    def __init__(self, procs=None, tmpdir=None):
        self.procs, self.tmpdir = procs, tmpdir
        self._closing = False
        if procs is not None:
            threading.Thread(target=self._watch, daemon=True,
                             name="rank-watch").start()

    def _watch(self):
        for p in self.procs.processes:
            p.join()
            if p.exitcode != 0 and not self._closing:
                print(f"rank process {p.pid} exited with {p.exitcode}: "
                      "stopping the leader", file=sys.stderr, flush=True)
                os._exit(1)

    def close(self, timeout_s: float = 60.0) -> None:
        """Leave the group with the followers (after the leader's channel
        has stopped them, where they follow one) and wait for them, killing
        any still there at the deadline."""
        self._closing = True
        shutdown(timeout_s)
        if self.procs is not None:
            for p in self.procs.processes:
                p.join(timeout_s)
                if p.is_alive():
                    p.kill()
        if self.tmpdir is not None:
            self.tmpdir.cleanup()


def start_ranks(n: int, follower, args=(), device: str = "cuda",
                backend: str | None = None) -> tuple[int, torch.device, Ranks]:
    """Put this process in an n-rank group and return (rank, device, Ranks).

    Under ``torchrun`` (RANK and WORLD_SIZE set) it joins that group; a rank
    other than 0 then runs ``follower(*args)`` and exits here. Otherwise
    this process is rank 0 and starts ranks 1..n-1 itself, each running
    ``follower(*args)`` (a module-level function), with ``file://``
    rendezvous in a temporary directory."""
    backend = backend or default_backend(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if world != n:
            raise RuntimeError(f"--mesh {n} under torchrun with WORLD_SIZE={world}")
        dev = init_group(rank, world, "env://", device, backend,
                         int(os.environ.get("LOCAL_RANK", rank)))
        if rank != 0:
            try:
                follower(*args)
            finally:
                shutdown()
            sys.exit(0)
        return rank, dev, Ranks()
    if backend == "nccl" and n > torch.cuda.device_count():
        raise RuntimeError(f"--mesh {n}: only {torch.cuda.device_count()} card(s) "
                           "visible")
    tmp = tempfile.TemporaryDirectory(prefix="clearcam-rdv-")
    init_method = "file://" + os.path.join(tmp.name, "rendezvous")
    procs = None
    if n > 1:
        import torch.multiprocessing as mp
        if follower.__module__ == "__main__":
            # a tool run with ``python -m``: the spawned ranks import it by
            # its module name, where ``follower`` is found
            import importlib
            spec = sys.modules["__main__"].__spec__
            follower = getattr(importlib.import_module(spec.name), follower.__name__)
        procs = mp.start_processes(_follower_entry, args=(n, init_method, device, backend,
                                                          follower, args),
                                   nprocs=n - 1, join=False, start_method="spawn")
    dev = init_group(0, n, init_method, device, backend)
    return 0, dev, Ranks(procs, tmp)


def shutdown(timeout_s: float = 60.0) -> None:
    """Leave the process group with a deadline: a barrier that must finish
    within ``timeout_s``, then ``destroy_process_group`` (on a thread that
    is abandoned at the deadline)."""
    if not dist.is_initialized():
        return
    err = []

    def run():
        try:
            dist.barrier()
            dist.destroy_process_group()
        except Exception as e:  # noqa: BLE001
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        raise RuntimeError(f"leaving the process group took over {timeout_s} s")
    if err:
        raise err[0]
