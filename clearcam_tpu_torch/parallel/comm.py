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

Mirrored calls. A step that rank 0 starts with a command and every rank
runs (``mesh.Channel.call``) records its collectives on each rank, in
order (``Call``). When rank 0 raised inside the step, a follower may wait
in one of them (gloo blocks the host; NCCL may, while it connects a new
algorithm's peers) or have enqueued ones rank 0 never posts (NCCL). Its
channel thread, free of the step, sends rank 0 the sequence; rank 0 posts
the ones it never reached with inert operands (zeros: ``post_inert``);
every op completes, none is left pending, and the follower leaves the
step by ``Released`` once it has posted as many as rank 0 matched.
"""
from __future__ import annotations

import contextlib
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


class Released(Exception):
    """Ends a follower's mirrored call once it has posted every collective
    rank 0, which raised inside the call, matches (``mesh.Channel``)."""


class Call:
    """The collectives of one mirrored call on this rank, in order: ``ops``
    holds (op, shape, dtype, group key, device type) for each, ``done`` how
    many have returned. On a follower, the channel's thread sets
    ``stop_at`` when rank 0 asks for a release: the call ends (``Released``)
    once it has posted that many. ``lock`` guards the three."""

    def __init__(self):
        self.ops: list = []
        self.done = 0
        self.stop_at: int | None = None
        self.failed = False
        self.lock = threading.Lock()

    def stopped(self) -> bool:
        return self.stop_at is not None and len(self.ops) >= self.stop_at


_local = threading.local()

# the groups made by ``new_group``, in the order every rank made them: a
# collective's group key is its index here (-1: the default group); none is
# destroyed, so ``_KEYS``' ids stay theirs
_GROUPS: list = []
_KEYS: dict = {}


def new_group(ranks=None):
    """A process group of its own over ``ranks`` (every rank by default), on
    the default group's backend; a collective call every rank makes in the
    same order."""
    g = dist.new_group(ranks, backend=backend_of(),
                       timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _KEYS[id(g)] = len(_GROUPS)
    _GROUPS.append(g)
    return g


def _key(group) -> int:
    if group is None or group is dist.group.WORLD:
        return -1
    if id(group) not in _KEYS:
        raise ValueError("a mirrored call's collective on a group not made by "
                         "comm.new_group")
    return _KEYS[id(group)]


def group_of(key: int):
    return None if key < 0 else _GROUPS[key]


@contextlib.contextmanager
def mirrored(call: Call):
    """Records this thread's collectives in ``call``."""
    prev, _local.call = getattr(_local, "call", None), call
    try:
        yield call
    finally:
        _local.call = prev


def _collective(op: str, t: torch.Tensor, group, post) -> None:
    """Run ``post()``, one collective on ``t``; inside a mirrored call,
    record it, and end the call (``Released``) where rank 0 asked."""
    call = getattr(_local, "call", None)
    if call is None:
        post()
        return
    with call.lock:
        if call.stopped():
            raise Released
        call.ops.append((op, tuple(t.shape), t.dtype, _key(group), t.device.type))
    try:
        post()
    except BaseException:
        call.failed = True
        raise
    with call.lock:
        call.done += 1
        if call.stopped():
            raise Released


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
    buf = _host(t) if staged("all_reduce", t, group) else t
    _collective("all_reduce", t, group, lambda: dist.all_reduce(buf, group=group))
    if buf is not t:
        t.copy_(buf)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from the global rank ``src`` to every rank of ``group``, in place."""
    buf = _host(t) if staged("broadcast", t, group) else t
    _collective("broadcast", t, group, lambda: dist.broadcast(buf, src, group=group))
    if buf is not t:
        t.copy_(buf)
    return t


def all_gather(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in the
    group's rank order, on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _host(t) if staged("all_gather", t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _collective("all_gather", t, group, lambda: dist.all_gather(parts, src, group=group))
    out = torch.cat(parts, dim)
    return out.to(t.device) if out.device != t.device else out


def scatter(out: torch.Tensor, chunks: list | None, group=None) -> torch.Tensor:
    """Group rank 0's ``chunks`` (one a rank, shaped like ``out``) into each
    rank's ``out``, in place."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    buf = out
    if staged("scatter", out, group):
        buf = torch.empty(out.shape, dtype=out.dtype)
        chunks = [c.cpu() for c in chunks] if chunks is not None else None
    _collective("scatter", out, group, lambda: dist.scatter(buf, chunks, src, group=group))
    if buf is not out:
        out.copy_(buf)
    return out


def post_inert(op: str, shape: tuple, dtype, key: int, device: str) -> None:
    """Rank 0: the match of a follower's pending collective, with operands
    that change nothing it keeps (zeros to a sum or a gather, zeros from
    rank 0 to a broadcast or a scatter: the follower's call is ended and
    its state reset after it)."""
    group = group_of(key)
    dev = DEVICE if device == "cuda" and DEVICE is not None else torch.device(device)
    z = torch.zeros(shape, dtype=dtype, device=dev)
    if op == "all_reduce":
        all_reduce(z, group)
    elif op == "broadcast":
        broadcast(z, 0, group)
    elif op == "all_gather":
        all_gather(z, group)
    elif op == "scatter":
        scatter(z, [torch.zeros_like(z) for _ in range(dist.get_world_size(group))], group)
    else:
        raise ValueError(f"no inert match for {op}")


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
