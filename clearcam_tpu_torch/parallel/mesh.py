"""Device-mesh scaling over torch.distributed, the counterpart of
``clearcam_tpu.parallel.mesh``.

The JAX package is single-controller: one process puts arrays on a
``Mesh`` and GSPMD inserts the collectives. Here one process runs per
device, SPMD: every rank runs the same code on its own shard, and the code
that communicates says so. Axes, as in the JAX package:

  data   camera streams / batch rows (detect batches, training rows)
  model  tensor and expert parallelism (the LLM, YOLOv9 training)

A ``Mesh`` wraps a ``torch.distributed.device_mesh.DeviceMesh`` and keeps
the names the port reads: ``mesh.shape["data"]``, ``mesh.shape["model"]``,
``mesh.group(axis)`` and ``mesh.coord(axis)``.

Leader and followers. Where the JAX single controller owns the host work,
rank 0 owns it here (HTTP, ingest, the serving queue). Each device step
starts with a command from rank 0, broadcast on the gloo ``Channel`` (what
runs next, with its host arguments); the other ranks sit in
``Channel.follow()`` and run the same step, so every rank makes the same
collective calls in the same order. Anything a rank could compute
differently comes from rank 0: the frames, the admission order and the
sampled token ids. A rank that drifted would hang the job, not fail it.
Where the JAX program is one program, and a fault costs one step, a raise
on rank 0 inside a step leaves the followers inside it: ``Channel.call``
releases them (``Channel.repair``) so the step's caller can recover as on
one device.

The collectives, each in one place (``parallel.comm`` holds their gloo
staging and the record of a mirrored step's):
  * ``Channel.send`` / ``follow``: a header and a pickled payload
    ``broadcast`` a command on the gloo group of every rank; after a fault
    inside a step, ``Channel.repair``'s ``gather_object`` of each
    follower's collectives and its inert matches of them;
  * ``sharded_detect_fn``: ``all_gather`` of each data rank's [rows, 300, 6]
    detections; ``BatchDetector(mesh=)`` first ``scatter``s rank 0's
    frames, one slice of rows a data rank; both on the detector's own
    group of every rank;
  * tensor-parallel LLM (``models.llm``): one ``all_reduce`` over the
    ``model`` axis's own group (``Mesh.new_group``, never the default
    group) after each row-split product (``attn_output``, ``ffn_down``) and
    after the experts of an expert-parallel MoE block;
  * the serving engine under a mesh: one ``broadcast`` of the [2, B] token
    rows a decode step (the previous step's samples and the prefills'
    first tokens) on the engine's own group of every rank, after the
    command; under speculative serving instead one after each graph, of
    rank 0's first tokens (prefill) or its window positions and last
    tokens (decode);
  * YOLOv9 training (``shard_params_tp``): the channel gather of each split
    conv's output (``nn.functional``), the ``all_reduce`` of the gradients
    over ``data`` and of the split gradients' squared norm over ``model``.

Layout. The JAX package puts P("model", None) on every 2-D weight and lets
GSPMD place the collectives. The port uses the Megatron split, which
computes the same function with two collectives a block: ``attn_q/k/v``
(and their biases) and ``ffn_gate/up`` split on their output rows by whole
heads and hidden units, ``attn_output`` and ``ffn_down`` on their input
columns, each followed by the ``all_reduce``. MoE expert banks split by
expert (E/m a rank), the router is replicated, each rank runs its own
experts for all tokens and the ``all_reduce`` sums them. Embeddings, the
output head, norms, shared experts, MLA blocks and GatedDeltaNet blocks are
replicated, as the JAX package leaves them. The KV cache splits on its
KV-head dimension where the attention splits (``n_kv_heads % m == 0``),
else it is replicated. Weights are quantized before they are split, so
the ``min_dim`` rule makes the choices it makes on one device.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import queue
import sys
import threading
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

from . import comm


# ---------------------------------------------------------------------------
# mesh
# ---------------------------------------------------------------------------

class Mesh:
    """The ranks of the process group as a named grid (``DeviceMesh``);
    ``device`` is this rank's."""

    def __init__(self, shape: dict, device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh
        self.shape = dict(shape)
        n = math.prod(shape.values())
        if n != dist.get_world_size():
            raise ValueError(f"a {self.shape} mesh needs {n} ranks; the group has "
                             f"{dist.get_world_size()}")
        self.device = torch.device(device)
        self.backend = comm.backend_of()
        kind = "cuda" if self.backend == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(kind, torch.arange(n).reshape(*shape.values()),
                                      mesh_dim_names=tuple(shape))
        self.channel = channel()

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def new_group(self, axis: str | None = None):
        """A group of its own (``comm.new_group``) over this rank's line of
        the mesh along ``axis``, or over every rank: one path's collectives
        then never pair with another's. A collective call: every rank makes
        every line's group, in the same order."""
        ranks = self.device_mesh.mesh
        if axis is None:
            return comm.new_group(ranks.flatten().tolist())
        dim = list(self.shape).index(axis)
        mine = None
        for line in ranks.movedim(dim, -1).reshape(-1, ranks.shape[dim]).tolist():
            g = comm.new_group(line)
            if dist.get_rank() in line:
                mine = g
        return mine

    def coord(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def is_leader(self) -> bool:
        return dist.get_rank() == 0

    def follow(self) -> None:
        """A follower's loop (``Channel.follow``)."""
        self.channel.follow()

    def stop_followers(self) -> None:
        """Rank 0 ends every follower's loop; no-op elsewhere."""
        if self.is_leader:
            self.channel.stop()

    def __repr__(self):
        return f"Mesh({self.shape}, backend={self.backend}, device={self.device})"


def _split(n: int, data: int | None):
    if data is None:
        # favor data parallelism; the model axis gets 2 where n is even
        data = n if n % 2 else n // 2
    if n % data:
        raise ValueError(f"data={data} does not divide {n} ranks")
    return data, n // data


def make_mesh(n_devices: int | None = None, data: int | None = None,
              device=None) -> Mesh:
    """A (data, model) mesh over the process group's ranks, the JAX rule for
    the axes: with n even, data = n // 2, so 2 ranks give (1, 2). Every rank
    calls it, in the same order as every other mesh. ``device`` defaults to
    this rank's current one (the CPU under gloo without a card)."""
    n = n_devices or dist.get_world_size()
    d, m = _split(n, data)
    return Mesh({"data": d, "model": m}, _current_device(device))


def _current_device(device=None) -> torch.device:
    """``device``, else the one ``comm.init_group`` chose for this rank, else
    the current card under NCCL, else the CPU."""
    if device is not None:
        return torch.device(device)
    if comm.DEVICE is not None:
        return comm.DEVICE
    if torch.cuda.is_available() and comm.backend_of() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_batch(mesh: Mesh, x):
    """This data rank's contiguous rows of the batch ``x`` (the same array
    on every rank), on the mesh's device."""
    d = mesh.shape["data"]
    if x.shape[0] % d:
        raise ValueError(f"batch {x.shape[0]} does not split over data={d}")
    rows = x.shape[0] // d
    i = mesh.coord("data")
    return torch.as_tensor(np.asarray(x[i * rows:(i + 1) * rows])
                           if not isinstance(x, torch.Tensor)
                           else x[i * rows:(i + 1) * rows]).to(mesh.device)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of a dict (or list) of arrays on every rank, as
    tensors on the mesh's device: one ``broadcast`` a leaf."""
    def put(a):
        if isinstance(a, dict):
            return {k: put(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(put(v) for v in a)
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        t = t.to(mesh.device).contiguous().clone()
        return comm.broadcast(t, 0)
    return put(tree)


# ---------------------------------------------------------------------------
# leader and followers
# ---------------------------------------------------------------------------

_CMD, _STOP, _REPAIR = 0, 1, 2


class Channel:
    """Rank 0's commands to the other ranks, on a gloo group of every rank
    whose wait for the next command has no practical deadline (an idle
    server sends none for hours).

    A command is (target, method, args): the object registered on each rank
    as ``target`` (in the same construction order everywhere) runs
    ``method(*args)``. It goes out as a header ([kind, bytes] int64) and a
    pickled payload. A follower takes them on a thread of its own and runs
    the commands in order on the thread that called ``follow``, so a
    release reaches it inside a step. Rank 0 holds
    ``lock`` from the command through the step's last collective, so steps
    started from several threads (the NVR tick, HTTP offload) never
    interleave.

    ``call`` runs a mirrored step. When it raises on rank 0 after its
    command went out, the followers may sit in one of the step's
    collectives, or (NCCL) have enqueued ones rank 0 never posts;
    ``repair`` releases them before the raise goes on: a ``_REPAIR`` header,
    each follower's sequence of the call gathered, and rank 0's inert
    matches (``comm.post_inert``) of the ones past its own. Every group is
    then as before the call, with no collective pending, and the next
    command (a ``reset``) runs on every rank. A repair that fails (rank 0's
    own collective raised, the ranks' sequences differ, an op outside rank
    0's groups) sets ``broken``: every later command raises, and a follower
    told so leaves its process."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo",
                                    timeout=datetime.timedelta(days=30))
        self.world = dist.group.WORLD
        self.objects: dict = {}
        self._counts: dict = {}
        self.lock = threading.RLock()
        self.broken: str | None = None
        # a follower: {"t" (monotonic), "ops", "waiting": in the last op} of
        # each release
        self.releases: list = []

    def register(self, prefix: str, obj) -> str:
        k = self._counts.get(prefix, 0)
        self._counts[prefix] = k + 1
        name = f"{prefix}:{k}"
        self.objects[name] = obj
        return name

    def register_as(self, name: str, obj) -> str:
        self.objects[name] = obj
        return name

    # -- rank 0 ------------------------------------------------------------

    def _put(self, kind: int, data: bytes = b"") -> None:
        dist.broadcast(torch.tensor([kind, len(data)], dtype=torch.int64), 0,
                       group=self.group)
        if data:
            dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8), 0,
                           group=self.group)

    def send(self, target, method: str, *args) -> None:
        """Rank 0: the command (hold ``lock`` across it and its step)."""
        if self.broken is not None:
            raise RuntimeError(f"the mesh is broken: {self.broken}")
        try:
            self._put(_CMD, pickle.dumps((target, method, args)))
        except BaseException as e:
            self.broken = f"a command failed to go out: {e!r}"
            raise

    def call(self, target, method: str, args: tuple, run):
        """Rank 0: ``method``'s command, then ``run()`` (this rank's share of
        the step), under ``lock``; a raise from ``run`` is repaired, then
        goes on."""
        with self.lock:
            self.send(target, method, *args)
            call = comm.Call()
            try:
                with comm.mirrored(call):
                    return run()
            except BaseException:
                self.repair(call)
                raise

    def repair(self, call: comm.Call) -> None:
        """Rank 0, under ``lock``, after its share of a step raised: release
        every follower from the step (see the class docstring)."""
        try:
            self._put(_REPAIR)
            seqs = [None] * dist.get_world_size()
            dist.gather_object(None, seqs, dst=0, group=self.group)
            why, todo = _unmatched(call, seqs[1:])
            dist.broadcast_object_list([None if why else len(call.ops) + len(todo)],
                                       src=0, group=self.group)
            if why:
                raise RuntimeError(why)
            for op, shape, dtype, key, dev in todo:
                comm.post_inert(op, shape, dtype, key, dev)
        except BaseException as e:
            self.broken = f"the release of the other ranks from a failed step failed: {e!r}"
            raise

    def stop(self) -> None:
        with self.lock:
            self._put(_STOP)

    # -- followers ---------------------------------------------------------

    def _take(self):
        """The next header and its payload: (kind, command or None)."""
        hdr = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(hdr, 0, group=self.group)
        kind, n = hdr.tolist()
        if not n:
            return kind, None
        buf = torch.empty(n, dtype=torch.uint8)
        dist.broadcast(buf, 0, group=self.group)
        return kind, pickle.loads(buf.numpy().tobytes())

    def _report(self, call: comm.Call) -> None:
        """A ``_REPAIR`` header came: send rank 0 this rank's collectives of
        ``call``, the last command's, and take where the call ends. Where
        rank 0 cannot release this rank, the step may never end here: the
        process says so and exits (a dead rank ends the job, ``comm.Ranks``)."""
        with call.lock:
            dist.gather_object(call.ops, None, dst=0, group=self.group)
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            if box[0] is None:
                print(f"rank {dist.get_rank()}: rank 0 could not release this rank from "
                      f"a failed step (its collectives {call.ops}): leaving",
                      file=sys.stderr, flush=True)
                os._exit(1)
            call.stop_at = box[0]
            self.releases.append({"t": time.monotonic(), "ops": [o[0] for o in call.ops],
                                  "waiting": call.done < len(call.ops)})

    def _listen(self, todo: queue.SimpleQueue) -> None:
        """The channel's thread: every command in order onto ``todo`` with
        its ``Call``, ``None`` at ``stop``; a repair answered at once,
        whatever the step's thread is doing."""
        last = comm.Call()
        try:
            while True:
                kind, cmd = self._take()
                if kind == _STOP:
                    todo.put(None)
                    return
                if kind == _REPAIR:
                    self._report(last)
                    continue
                last = comm.Call()
                todo.put((last, cmd))
        except BaseException as e:  # noqa: BLE001 (raised again by follow)
            todo.put(e)

    def follow(self) -> None:
        """Run rank 0's commands until it sends ``stop``."""
        todo = queue.SimpleQueue()
        listener = threading.Thread(target=self._listen, args=(todo,), daemon=True,
                                    name="channel")
        listener.start()
        while (item := todo.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            call, (target, method, args) = item
            try:
                with comm.mirrored(call):
                    getattr(self.objects[target], method)(*args)
            except comm.Released:
                pass
        listener.join()


def _unmatched(call: comm.Call, seqs: list) -> tuple:
    """-> (why rank 0 cannot release the followers or None, the followers'
    collectives it never posted), from rank 0's ``call`` and each
    follower's sequence of it: every one must agree with rank 0's as far as
    both went, and with the longest, and wait in a group of rank 0's."""
    if not seqs:
        return None, []
    if call.failed:
        return "a collective of the step raised on rank 0", []
    n0, longest = len(call.ops), max(seqs, key=len)
    for seq in seqs:
        if seq[:n0] != call.ops[:len(seq)] or seq != longest[:len(seq)]:
            return f"the ranks' collectives differ: rank 0 {call.ops}, a follower {seq}", []
    todo = longest[n0:]
    for op in todo:
        g = comm.group_of(op[3])
        if g is not None and 0 not in dist.get_process_group_ranks(g):
            return f"a follower waits in {op} on a group without rank 0", []
    return None, todo


_CHANNEL: Channel | None = None


def channel() -> Channel:
    """The process group's command channel, made on first use (a collective:
    every rank makes its first mesh in the same order). One a process: every
    mesh over the group shares it, so a follower's one loop serves the
    detector's and the summary engine's steps alike."""
    global _CHANNEL
    if _CHANNEL is None or _CHANNEL.world is not dist.group.WORLD:
        _CHANNEL = Channel()
    return _CHANNEL


# ---------------------------------------------------------------------------
# detection (data parallel)
# ---------------------------------------------------------------------------

def gather_rows(mesh: Mesh, out: torch.Tensor, group) -> torch.Tensor:
    """Each data rank's rows -> the whole batch on every rank, in data
    order: one ``all_gather`` over ``group`` (every rank, in rank order),
    keeping model coordinate 0 of each data row."""
    full = comm.all_gather(out.contiguous(), group, 0)
    d, m = mesh.shape["data"], mesh.shape["model"]
    return full.reshape(d, m, *out.shape)[:, 0].reshape(d * out.shape[0], *out.shape[1:])


def sharded_detect_fn(mesh: Mesh, size: str = "t", res: int = 640, group=None, **kw):
    """-> (step, in_spec). ``in_spec(frames)`` is this data rank's rows of a
    batch (``shard_batch``); ``step(params, rows)`` detects them (params in
    the port's layout, ``yolov9.params_from_jax``) and returns the whole
    [B, 300, 6] on every rank, as the JAX step's output sharding does. The
    gather runs on ``group`` (every rank), else on a group made here."""
    from ..models import yolov9
    group = group if group is not None else mesh.new_group()

    def step(params, frames):
        with torch.inference_mode():
            out = yolov9.detect(params, frames, size=size, res=res, **kw)
            return gather_rows(mesh, out, group)

    return step, (lambda x: shard_batch(mesh, x))


# ---------------------------------------------------------------------------
# LLM: tensor and expert parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TP:
    """A tensor-parallel rank's context, read by ``models.llm``'s blocks:
    ``split`` names the row-split weights (their product is a partial sum
    that ``reduce`` completes on ``group``, the model axis's own group:
    ``Mesh.new_group``) and the expert stacks (``ffn_down_exps``:
    this rank holds experts [rank * E/size, (rank + 1) * E/size)).
    ``stats`` counts the reductions and their host seconds (the time to
    return: the whole collective under gloo, which completes before it
    returns; only the enqueue under NCCL)."""
    group: object
    size: int
    rank: int
    split: frozenset
    stats: dict = field(default_factory=lambda: {"calls": 0, "seconds": 0.0},
                        compare=False)

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        comm.all_reduce(t, self.group)
        self.stats["calls"] += 1
        self.stats["seconds"] += time.perf_counter() - t0
        return t


class ShardedParams(dict):
    """One rank's LLM params: the rank's shards of the split weights, the
    replicated rest, and ``tp``."""

    def __init__(self, items, tp: TP):
        super().__init__(items)
        self.tp = tp


def attn_split(cfg, m: int) -> bool:
    """Attention splits by KV heads over m ranks where the heads divide and
    the qk-norm is per head (a norm over the whole projection would need
    the other ranks' heads)."""
    return m > 1 and cfg.n_kv_heads % m == 0 and cfg.qk_norm in (0, cfg.head_dim)


def _slice_rows(w, r: int, m: int):
    from ..ops import quant_matmul as qm
    if isinstance(w, (qm.QuantLinear, qm.QuantLinear4)):
        n = w.out_features // m
        return qm.slice_rows(w, r * n, (r + 1) * n)
    n = w.shape[0] // m
    return w[r * n:(r + 1) * n].contiguous()


def _slice_cols(w, r: int, m: int):
    from ..ops import quant_matmul as qm
    if isinstance(w, (qm.QuantLinear, qm.QuantLinear4)):
        n = w.in_features // m
        return qm.slice_cols(w, r * n, (r + 1) * n)
    n = w.shape[1] // m
    return w[:, r * n:(r + 1) * n].contiguous()


def _slice_experts(w, r: int, m: int):
    from ..ops import quant_matmul as qm
    n = w.shape[0] // m
    if isinstance(w, qm.QuantExpert):
        return qm.QuantExpert(w.q[r * n:(r + 1) * n].contiguous(),
                              w.s[r * n:(r + 1) * n].contiguous())
    return w[r * n:(r + 1) * n].contiguous()


def shard_llm_params(mesh: Mesh, params: dict, cfg) -> ShardedParams:
    """This rank's shards of an LLM's params over the ``model`` axis (the
    Megatron layout in the module docstring). Unlike the JAX function it
    takes ``cfg``: the split is by whole heads. Quantize first: the int8 and
    int4 weights are sliced exactly (int8 scales follow the output rows,
    int4 group-128 scales split on group boundaries; a split that is not
    whole groups raises)."""
    m, r = mesh.shape["model"], mesh.coord("model")
    out, split = dict(params), set()
    if m > 1:
        for i in range(cfg.num_blocks):
            bc, pre = cfg.block_cfg(i), f"blk.{i}"
            if cfg.block_kind(i) == "attn" and attn_split(cfg, m):
                for nm in ("attn_q", "attn_k", "attn_v"):
                    for suf in ("weight", "bias"):
                        k = f"{pre}.{nm}.{suf}"
                        if k in params:
                            out[k] = _slice_rows(params[k], r, m)
                out[f"{pre}.attn_output.weight"] = _slice_cols(
                    params[f"{pre}.attn_output.weight"], r, m)
                split.add(f"{pre}.attn_output.weight")
            if f"{pre}.ffn_gate.weight" in params and bc.hidden_dim % m == 0:
                for nm in ("ffn_gate", "ffn_up"):
                    out[f"{pre}.{nm}.weight"] = _slice_rows(params[f"{pre}.{nm}.weight"], r, m)
                out[f"{pre}.ffn_down.weight"] = _slice_cols(
                    params[f"{pre}.ffn_down.weight"], r, m)
                split.add(f"{pre}.ffn_down.weight")
            if f"{pre}.ffn_gate_exps.weight" in params and bc.num_experts % m == 0:
                for nm in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                    out[f"{pre}.{nm}.weight"] = _slice_experts(
                        params[f"{pre}.{nm}.weight"], r, m)
                split.add(f"{pre}.ffn_down_exps.weight")
    return ShardedParams(out, TP(mesh.new_group("model"), m, r, frozenset(split)))


def state_cfg(cfg, mesh: Mesh | None):
    """The config a rank allocates its serving state with: n_kv_heads / m
    where the attention splits."""
    if mesh is None or not attn_split(cfg, mesh.shape["model"]):
        return cfg
    return replace(cfg, n_kv_heads=cfg.n_kv_heads // mesh.shape["model"])


def shard_llm_state(mesh: Mesh, cfg, state: list) -> list:
    """This rank's slice of a decode/serving cache: attention K/V (and
    their int8 scales) split on the KV-head dimension where the attention
    splits; MLA latents and GatedDeltaNet states replicated. Each slice is
    made contiguous once, here."""
    m, r = mesh.shape["model"], mesh.coord("model")
    if not attn_split(cfg, m):
        return state
    n = cfg.n_kv_heads // m
    out = []
    for i, s in enumerate(state):
        if cfg.block_kind(i) == "attn":
            s = {k: v[:, r * n:(r + 1) * n].contiguous() for k, v in s.items()}
        out.append(s)
    return out


def serving_engine_tp(params: dict, cfg, mesh: Mesh, **engine_kw):
    """Tensor/expert-parallel continuous batching: a ``ServingEngine`` on
    every rank with this rank's shards (``shard_llm_params``) and its slice
    of the KV cache. Rank 0's engine is driven as on one device (``submit``,
    ``step``, ``run_until_idle``); every other rank runs
    ``mesh.follow()``, mirroring each prefill and decode call."""
    from ..serving.engine import ServingEngine
    return ServingEngine(shard_llm_params(mesh, params, cfg), cfg, mesh=mesh, **engine_kw)


def sharded_llm_prefill(mesh: Mesh, params: dict, cfg):
    """-> prefill(state, tokens, start_pos, n_real, temperature, gen=None)
    -> (token [B], state), every rank with its ``shard_llm_params`` shards
    and ``shard_llm_state`` cache (the tp/ep collectives inside the
    forward). The batch is replicated over ``data``."""
    from ..models import llm
    freqs = llm.freqs_for(cfg, mesh.device)

    @torch.inference_mode()
    def prefill(state, tokens, start_pos, n_real, temperature, gen=None):
        tokens = torch.as_tensor(tokens).to(mesh.device)
        hidden, state = llm.forward(params, cfg, state, tokens, int(start_pos), freqs)
        logits = llm.logits_at(params, cfg, hidden, int(n_real) - 1)
        noise = torch.zeros_like(logits) if float(temperature) == 0.0 else \
            llm._gumbel_like(logits, gen)
        return llm.sample_filtered(logits, llm.pack_samp(float(temperature)), noise), state

    return prefill


class EngineRanks:
    """The serving engine's graphs under a mesh (``ServingEngine(mesh=)``).

    On rank 0 the engine's ``prefill_slot``, ``decode_all``,
    ``prefill_many`` and ``custom_prefill`` are wrapped: each sends its
    host arguments as a command, then runs. On the other ranks this object
    is the command's target: it runs the same graph on the rank's shards
    and cache. The sampling-only tensors (penalty counts, bias, grammar
    table and states, logprob rows) stay on rank 0; a follower passes inert
    ones of the same shapes, so its samples may differ from rank 0's, and
    it keeps none of them:

    - a plain decode step takes rank 0's [2, B] token rows (the previous
      step's samples and the prefills' first tokens), broadcast before the
      graph;
    - under ``spec_lookup`` a prefill's first tokens [B], and a window's
      ``aux`` positions and last tokens [2, B], are broadcast after the
      graph and replace the follower's own. Each window's inputs (the first
      or last token, the drafts read from ``aux["ids"]`` at ``aux["pos"]``)
      and the history rows it records are then rank 0's on every rank, and
      only rank 0 decides what a window accepted: no rank compares its own
      all-reduced logits.

    Each call goes through ``Channel.call``: a raise inside it, after its
    command went out (a follower may wait in one of the graph's reductions
    or broadcasts), is repaired before it reaches the engine, whose
    ``_recover`` then resets every rank. The broadcasts run on a group of
    their own, the reductions on ``params.tp``'s. ``broken``: a repair
    failed; the engine then fails its waiters and never resets."""

    def __init__(self, eng, mesh: Mesh):
        self.eng, self.mesh = eng, mesh
        # the engine's own graphs, which every rank runs
        self._slot, self._decode = eng.prefill_slot, eng.decode_all
        self._many, self._custom = eng.prefill_many, eng.custom_prefill
        self.name = mesh.channel.register("engine", self)
        self.group = mesh.new_group()
        self.steps = 0
        self.comm_s = 0.0
        dev, b, v = eng.device, eng.n_slots, eng.cfg.vocab_size
        if mesh.is_leader:
            eng.prefill_slot, eng.decode_all = self._lead_prefill_slot, self._lead_decode_all
            if eng.prefill_many is not None:
                eng.prefill_many = self._lead_prefill_many
            if eng.custom_prefill is not None:
                eng.custom_prefill = self._lead_custom_prefill
        else:
            from ..models import llm
            self._tok = torch.zeros((b,), dtype=torch.int32, device=dev)
            self._lp = torch.zeros((b, 1 + 2 * llm.LP_K), device=dev)
            self._cnt = torch.zeros((b, v), dtype=torch.int32, device=dev)
            self._cnt_o = torch.zeros((b, v), dtype=torch.int32, device=dev)
            self._bias = torch.zeros((b, v), device=dev)
            self._ctab = torch.zeros((1, v), dtype=torch.int16, device=dev)
            self._cinit = torch.full((b,), -1, dtype=torch.int32, device=dev)
            # the inert tensors each graph takes after its host arguments
            # (a spec graph has no grammar and no logprob rows)
            self._prefill_tail = (self._cnt, self._cnt_o, self._bias) + (
                () if eng.spec else (self._ctab, self._cinit, self._cinit))
            self._decode_tail = (self._cnt_o, self._cnt, self._bias) + (
                () if eng.spec else (self._ctab, self._cinit))

    @property
    def broken(self) -> bool:
        return self.mesh.channel.broken is not None

    def _bcast(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``t`` on every rank, in place."""
        t0 = time.perf_counter()
        comm.broadcast(t, 0, self.group)
        self.comm_s += time.perf_counter() - t0
        return t

    def _rows(self, n: int) -> torch.Tensor:
        """A follower's buffer for rank 0's [n, B] int32 rows, received."""
        return self._bcast(torch.empty((n, self.eng.n_slots), dtype=torch.int32,
                                       device=self.eng.device))

    # -- rank 0 ------------------------------------------------------------

    def _mirrored(self, method, args, run):
        """Rank 0: ``method``'s command, then ``run()`` (``Channel.call``)."""
        t0 = time.perf_counter()

        def timed():
            self.comm_s += time.perf_counter() - t0
            return run()
        return self.mesh.channel.call(self.name, method, args, timed)

    @staticmethod
    def _slot_args(tokens, slot, start_pos, n_real, samp, seed, base_seed):
        return (np.asarray(tokens), int(slot), int(start_pos), int(n_real),
                np.asarray(samp, np.float32), int(seed), int(base_seed))

    # The graphs' arguments: params, state, then (first_tok, first_lp) or
    # under spec (aux, first_tok), then the host arguments from index 4,
    # then device tensors.

    def _prefilled(self, out):
        """A prefill's result; under spec, after rank 0's first tokens went
        out, which the followers take in place of their own."""
        if self.eng.spec:
            self._bcast(out[0])
        return out

    def _lead_prefill_slot(self, *args):
        return self._mirrored("prefill_slot", self._slot_args(*args[4:11]),
                              lambda: self._prefilled(self._slot(*args)))

    def _lead_prefill_many(self, *args):
        tokens, meta, samp, base_seed = args[4:8]
        return self._mirrored(
            "prefill_many", (np.asarray(tokens), np.asarray(meta, np.int32),
                             np.asarray(samp, np.float32), int(base_seed)),
            lambda: self._prefilled(self._many(*args)))

    def _lead_decode_all(self, *args):
        spec = self.eng.spec
        meta, samp, base_seed = args[4:7]

        def run():
            if not spec:      # the token rows (prev_tok, first_tok) the followers read
                self._bcast(torch.stack(args[2:4]).to(torch.int32))
            out = self._decode(*args)
            if spec:          # the window's positions and last tokens, which replace theirs
                self._bcast(torch.stack([args[2]["pos"], args[2]["last"]]))
            return out
        self.steps += 1
        return self._mirrored(
            "decode_all", (np.asarray(meta, np.int32), np.asarray(samp, np.float32),
                           int(base_seed)) + ((int(args[7]),) if spec else ()), run)

    def _lead_custom_prefill(self, state, slot, start_pos, payload):
        host = payload.cpu() if isinstance(payload, torch.Tensor) else payload
        return self._mirrored("custom_prefill", (int(slot), int(start_pos), host),
                              lambda: self._custom(state, slot, start_pos, payload))

    def reset_all(self) -> None:
        """Rank 0, recovering from a fault: every rank's cache, ``aux`` and
        sampling tensors afresh."""
        self._mirrored("reset", (), self.eng.reset_device)

    # -- followers ---------------------------------------------------------

    def _head(self) -> tuple:
        """A follower's graph arguments after params and state."""
        return (self.eng.aux, self._tok) if self.eng.spec else (self._tok, self._lp)

    @torch.inference_mode()
    def prefill_slot(self, tokens, slot, start_pos, n_real, samp, seed, base_seed):
        e = self.eng
        self._slot(e.params, e.state, *self._head(), tokens, slot, start_pos, n_real, samp,
                   seed, base_seed, *self._prefill_tail)
        if e.spec:
            self._bcast(self._tok)

    @torch.inference_mode()
    def decode_all(self, meta, samp, base_seed, step=None):
        e = self.eng
        self._cnt_o.zero_()
        if e.spec:
            head, step_arg = self._head(), (step,)
        else:
            head, step_arg = tuple(self._rows(2)), ()
        self._decode(e.params, e.state, *head, meta, samp, base_seed, *step_arg,
                     *self._decode_tail)
        if e.spec:
            rows = self._rows(2)
            e.aux["pos"].copy_(rows[0])
            e.aux["last"].copy_(rows[1])

    @torch.inference_mode()
    def prefill_many(self, tokens, meta, samp, base_seed):
        e = self.eng
        self._many(e.params, e.state, *self._head(), tokens, meta, samp, base_seed,
                   *self._prefill_tail)
        if e.spec:
            self._bcast(self._tok)

    def custom_prefill(self, slot, start_pos, payload):
        e = self.eng
        if isinstance(payload, torch.Tensor):
            payload = payload.to(e.device)
        self._custom(e.state, slot, start_pos, payload)

    @torch.inference_mode()
    def reset(self) -> None:
        self.eng.reset_device()
        for t in (self._tok, self._lp, self._cnt, self._cnt_o, self._bias):
            t.zero_()


# ---------------------------------------------------------------------------
# YOLOv9 training (dp x tp)
# ---------------------------------------------------------------------------

def shard_params_tp(mesh: Mesh, params: dict) -> dict:
    """This rank's training params: each conv filter and its bias whose
    output channels (OIHW dim 0; the JAX layout's last dim) divide by the
    model size m and number at least 8m keeps its slice of output channels,
    as a new leaf tensor marked with ``tp_group``; the rest stay whole (the
    DFL's 16-value projection too, which the head contracts with rather
    than convolves). The port's conv (``nn.functional.conv2d_oihw``) sees
    the mark, runs the slice and gathers the channels back."""
    m, r = mesh.shape["model"], mesh.coord("model")
    if m == 1:
        return params
    g = mesh.group("model")
    out = {}
    for k, v in params.items():
        o = v.shape[0] if v.dim() >= 1 else 0
        conv = v.dim() == 4 or (v.dim() == 1 and k.endswith(".bias"))
        if conv and o % m == 0 and o >= 8 * m:
            n = o // m
            t = v.detach()[r * n:(r + 1) * n].clone().requires_grad_(v.requires_grad)
            t.tp_group = g
            out[k] = t
        else:
            out[k] = v
    return out


def gather_params_tp(params: dict) -> dict:
    """Whole tensors of ``shard_params_tp``'s slices (a collective over
    each marked tensor's group), detached; unmarked ones as they are."""
    out = {}
    for k, v in params.items():
        g = getattr(v, "tp_group", None)
        out[k] = comm.all_gather(v.detach().contiguous(), g, 0) if g is not None \
            else v.detach()
    return out


def make_train_step(size: str = "t", lr: float = 1e-3, kind: str = "detect",
                    mesh: Mesh | None = None):
    """A full optimizer step on YOLOv9, ``(step, opt)``.

    kind="detect": the fine-tuning objective (``yolo_loss.make_finetune_step``)
    — step(params, opt_state, frames, gt_boxes, gt_cls). kind="distill": SGD
    on the MSE of the raw head against targets — step(params, opt_state,
    frames, targets). Under ``mesh`` each rank passes its data rank's rows
    and its ``shard_params_tp`` params; the gradients are averaged over
    ``data`` before the global-norm clip, so every rank steps on the same
    gradients, and the loss returned is the mean over ``data``."""
    from ..models import yolo_loss, yolov9

    if kind == "detect":
        return yolo_loss.make_finetune_step(size, lr, mesh=mesh)

    class _SGD:
        def init(self, params):
            return torch.optim.SGD(list(params.values()), lr=lr)

    def step(params, opt_state, frames, targets):
        leaves = list(params.values())
        raw = yolov9.forward_raw(params, frames, size, train=True)
        loss = torch.mean((raw - targets) ** 2)
        grads = list(torch.autograd.grad(loss, leaves))
        loss = loss.detach()
        if mesh is not None:
            loss = yolo_loss.average_over_data(mesh, grads, loss)
        for p, g in zip(leaves, grads):
            p.grad = g
        opt_state.step()
        for p in leaves:
            p.grad = None
        return params, opt_state, loss

    return step, _SGD()
