"""Slot-based continuous batching over models/llm.make_serving_fns, the
counterpart of ``clearcam_tpu.serving.engine`` (its scheduler as of
f773d1e: prefill and decode ticks alternate, prefill runs oldest
admission first, chunked and batched prefill, prefix reuse and park
positions, cancel, deadlines, backpressure, crash recovery, runtime
grammar registration, and ``close()`` completing its waiters).

The device sees three graphs: ``prefill_slot`` (one chunk of one slot's
prompt, on the slot's view of the state), ``prefill_many`` (a chunk of
every mid-prefill slot in one weight sweep) and ``decode_all`` (every slot
one token at its own position). The host scheduler owns admission, the
prefill/decode interleave, retirement, and the park positions of rows that
are not decoding: a free slot rides every decode step at its park
position (0, or its history length under prefix reuse), where junk K/V is
rewritten before any causal mask can reach it.

Speculative serving (``spec_lookup=G``, llm.make_serving_fns): each decode
dispatch verifies a (G+1)-token window per live slot, drafted on the card
from the slot's own history, and emits 1..G+1 tokens (greedy rows; a
stochastic row emits one). The positions advance on the card by the
accepted length, so the host's cursor stops at the prompt's end and the
lagged records carry [G+2] candidate rows that the host cuts at eos or
max_new. Not with constraints, logprobs, seeds or use_pallas_decode, as in
the reference.

Lagged token streaming: sampled tokens chain step to step on the card
(first_tok and prev_tok), and the host reads them ``sync_lag`` ticks late.
Every ``fetch_every`` decode steps the tokens are stacked into one [k, B]
tensor and copied to pinned host memory without blocking, with a CUDA
event behind the copy; the host waits on that event only when the record
is old enough. So the launch queue stays full and EOS / max_new are found
up to sync_lag steps late: a finishing slot runs junk steps whose tokens
are dropped by per-slot occupancy epochs.

What changed from the JAX engine: the lagged fetch (copy_to_host_async and
a jitted stack) is the pinned copy + event above; the jitted row writers
(``_cupd``, ``_cnt_row_set``) are in-place tensor writes; the serving
state is preallocated and written in place (no donation); the scheduler
thread sets its CUDA device before its first launch; ``kv_quant`` with
``use_pallas_decode`` runs the int8 decode kernel with the cache's scales
(the JAX engine's graphs drop them); ``spec_lookup`` with
``use_pallas_decode`` or on a GatedDeltaNet (SSM) stack raises where the
JAX engine turns spec off. SSM stacks serve without prefix reuse, as in
the JAX engine (a recurrent state cannot be reused in part).

Under a mesh (``mesh=``; ``parallel.mesh.serving_engine_tp``), where the
JAX engine's graphs GSPMD-partition, every rank builds this engine on its
shards and its slice of the cache; rank 0's is driven as on one device
and the others mirror each graph call (``parallel.mesh.EngineRanks``),
speculative windows included: rank 0's first tokens and window positions
and last tokens are broadcast after each graph, so every rank's ``aux``
stays rank 0's. Crash recovery there resets every rank's cache, ``aux``
and sampling tensors (a ``reset`` command), as the JAX engine's does,
wherever the fault was raised: a fault inside a mirrored call (after its
command, where the other ranks may wait in a block reduction for rank 0)
first releases them (``parallel.mesh.Channel.repair``). Only a release
that itself failed leaves the engine unrecoverable: its waiters fail.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import llm


@dataclass(eq=False)      # identity eq/hash: queue/cancel bookkeeping must
class Request:            # never conflate two requests with equal prompts
    """One generation request; ``wait()`` blocks until completion.

    ``segments`` generalizes the prompt: ("text", [token ids]) and
    ("custom", payload, n_positions) entries, the custom ones run by the
    engine's ``custom_prefill`` hook; the last segment must be text.
    eos_id: one id or an iterable. Sampling fields as in the JAX
    package's Request: top_p/top_k/min_p filter the temperature-scaled
    distribution; presence/frequency (generated tokens) and repetition
    (prompt + generated) penalties and logit_bias change greedy output;
    logprobs = number of alternatives recorded per token in ``lp``;
    seed = reproducible draws (same seed, same noise on any slot beside
    any companions); constraint = a registered grammar's name."""
    prompt: list | None
    max_new: int
    temperature: float = 0.0
    eos_id: object = None
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    logit_bias: dict | None = None
    logprobs: int = 0
    lp: list = field(default_factory=list)
    seed: int | None = None
    constraint: str | None = None
    segments: list | None = None
    tokens: list = field(default_factory=list)   # generated ids (incl. eos)
    deadline: float | None = None                # monotonic; engine-enforced
    timed_out: bool = False                      # set when deadline cut it
    failed: bool = False                         # scheduler died in flight
    # client-observed latency marks (monotonic), taken at host
    # materialization, so TTFT includes the lagged pipeline's depth
    t_submit: float = 0.0
    t_first: float | None = None
    t_done: float | None = None
    _done: threading.Event = field(default_factory=threading.Event)

    @property
    def pen_active(self) -> bool:
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0)

    @property
    def ttft_s(self) -> float | None:
        """Submit -> first token (client-observed), seconds."""
        return None if self.t_first is None else self.t_first - self.t_submit

    @property
    def tpot_s(self) -> float | None:
        """Mean inter-token time past the first, seconds."""
        if self.t_done is None or self.t_first is None or len(self.tokens) < 2:
            return None
        return (self.t_done - self.t_first) / (len(self.tokens) - 1)

    def __post_init__(self):
        if self.segments is None:
            assert self.prompt, "empty prompt"
            self.segments = [("text", list(self.prompt))]
        assert self.segments[-1][0] == "text" and self.segments[-1][1], \
            "last segment must be non-empty text"
        self.total_len = sum(len(s[1]) if s[0] == "text" else s[2]
                             for s in self.segments)
        if self.eos_id is None:
            self.stop_ids = frozenset()
        elif isinstance(self.eos_id, int):
            self.stop_ids = frozenset([self.eos_id])
        else:
            self.stop_ids = frozenset(self.eos_id)

    def wait(self, timeout: float | None = None) -> list:
        if not self._done.wait(timeout):
            raise TimeoutError("request not finished")
        return self.tokens

    @property
    def done(self) -> bool:
        return self._done.is_set()


class QueueFull(Exception):
    """Admission backpressure: the waiting queue is at ``max_waiting``;
    callers shed load (HTTP 503 + Retry-After)."""


class _Fetch:
    """A device->host copy started when made: non_blocking into pinned
    memory with a CUDA event recorded behind it. ``numpy()`` waits on that
    event only (a CPU tensor is read as it is)."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


_FREE, _PREFILL, _LIVE = 0, 1, 2


class ServingEngine:
    """Continuous-batching engine: ``submit()`` from any thread; tokens come
    from interleaved prefill/decode ticks (``step()``, or the background
    thread started by ``start()``). The device is the params' unless
    ``device`` is given."""

    def __init__(self, params, cfg, n_slots: int = 4,
                 state_dtype=torch.float32, kv_quant: bool = False,
                 use_pallas_decode: bool = False, seed: int = 0,
                 sync_lag: int = 4, custom_prefill=None,
                 prefix_cache: bool = True, fetch_every: int = 4,
                 prefill_batch: bool = True, max_waiting: int | None = None,
                 spec_lookup: int = 0, max_restarts: int = 0,
                 restart_window_s: float = 600.0,
                 constraints: dict | None = None, constraint_rows: int = 0,
                 device=None, mesh=None):
        assert cfg.max_context % llm.CHUNK == 0
        # device-drafted (G+1)-token verify windows, 1..G+1 tokens a dispatch;
        # make_serving_fns refuses them with use_pallas_decode or SSM blocks
        self.spec = int(spec_lookup)
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else \
            params["output_norm.weight"].device
        self.n_slots = n_slots
        self.sync_lag = sync_lag
        # prefix reuse needs the recurrent state at the reuse boundary, which
        # no position-addressed cache holds: attention and MLA stacks only
        self.prefix_cache = prefix_cache and cfg.ssm is None
        dev = self.device
        with torch.inference_mode():
            # grammar constraints: every registered automaton packs into ONE
            # [S_total, V] int16 table on the card; engines without any ride
            # the same graphs with an inert [1, V] table
            self._cstarts: dict[str, int] = {}
            self._cap = self._cused = 0
            self._cblocks: dict[str, tuple[int, int]] = {}
            self._cfree: list[tuple[int, int]] = []
            self._clru: dict[str, int] = {}
            self._clock = 0
            init_rows = sum(c.trans.shape[0] for c in (constraints or {}).values())
            total = init_rows + max(0, int(constraint_rows))
            if total and self.spec:
                raise ValueError(
                    "constrained decoding unsupported with spec_lookup (a drafted "
                    "verify window has no per-position grammar state)")
            if total == 0:
                self._ctab = torch.zeros((1, cfg.vocab_size), dtype=torch.int16,
                                         device=dev)
            else:
                assert total < np.iinfo(np.int16).max, \
                    "constraint table too tall for int16 states"
                tab = np.full((total, cfg.vocab_size), -1, np.int16)
                base = 0
                for nm, c in (constraints or {}).items():
                    assert c.trans.shape[1] == cfg.vocab_size, \
                        f"constraint {nm}: vocab {c.trans.shape[1]} != " \
                        f"cfg {cfg.vocab_size}"
                    n = c.trans.shape[0]
                    tab[base:base + n] = np.where(
                        c.trans >= 0, (c.trans.astype(np.int32) + base).astype(np.int16),
                        np.int16(-1))
                    self._cstarts[nm] = base + c.start
                    base += n
                self._cap, self._cused = total, base
                self._ctab = torch.from_numpy(tab).to(dev)
            # runtime-registered grammars stay out of the fingerprint: the HTTP
            # layer names them by content hash
            self.fingerprint_cfg = (n_slots, str(state_dtype).replace("torch.", ""),
                                    bool(kv_quant), self.spec, bool(use_pallas_decode),
                                    tuple(sorted(self._cstarts)))
            self.hist: list[list[int]] = [[] for _ in range(n_slots)]
            self.stats = {"prefill_chunks": 0, "prefill_tokens": 0,
                          "reused_tokens": 0, "decode_steps": 0,
                          "prefill_batched_steps": 0, "spec_emitted": 0,
                          "scheduler_restarts": 0}
            self.max_restarts = int(max_restarts)
            self.restart_window_s = float(restart_window_s)
            self._restart_marks: deque[float] = deque()
            self.prefill_slot, self.decode_all, self.prefill_many = \
                llm.make_serving_fns(cfg, use_pallas_decode=use_pallas_decode,
                                     constraints=not self.spec, kv_quant=kv_quant,
                                     spec_lookup=self.spec)
            if not prefill_batch:
                self.prefill_many = None     # always one slot-chunk per tick
            self._state_dtype, self._kv_quant = state_dtype, kv_quant
            # under a mesh the cache holds this rank's KV heads
            self._state_cfg = cfg
            if mesh is not None:
                from ..parallel import mesh as pmesh
                self._state_cfg = pmesh.state_cfg(cfg, mesh)
            self.state = llm.init_state(self._state_cfg, batch=n_slots, dtype=state_dtype,
                                        kv_quant=kv_quant, device=dev)
            self.aux = llm.init_serving_aux(cfg, n_slots, device=dev) if self.spec else None
            self.custom_prefill = custom_prefill     # (state, slot, pos, payload)
            self.phase = [_FREE] * n_slots
            self.req: list[Request | None] = [None] * n_slots
            self.epoch = [0] * n_slots                   # occupancy generation
            self.cursor = np.zeros(n_slots, np.int64)    # prefill progress / pos
            self.seg_idx = [0] * n_slots
            self.seg_start = np.zeros(n_slots, np.int64)
            # packed per-slot sampling rows (llm.pack_samp columns), host-side:
            # the graphs upload them and read their on/off flags here
            self.samp = np.zeros((n_slots, llm.SAMP_W), np.float32)
            self.samp[:, 1] = 1.0                        # top_p off
            self.samp[:, 6] = 1.0                        # repetition off
            # penalty histograms (prompt / generated) and dense logit-bias
            # rows, per slot, on the card; refreshed at admission only for
            # requests that use them (stale rows are inert: their samp
            # coefficients are off)
            self._cnt_p = torch.zeros((n_slots, cfg.vocab_size), dtype=torch.int32,
                                      device=dev)
            self._cnt_o = torch.zeros_like(self._cnt_p)
            self._bias = torch.zeros((n_slots, cfg.vocab_size), device=dev)
            # grammar states: admission-time start (host) and live (device)
            self._cinit_np = np.full(n_slots, -1, np.int32)
            self._cinit_dev = llm.upload(self._cinit_np, dev)
            self._cinit_dirty = False
            self._cstate = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
            self._tok_dev = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
            self._first_tok = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
            self._first_lp = torch.zeros((n_slots, 1 + 2 * llm.LP_K), device=dev)
        self._seed_np = np.zeros(n_slots, np.int32)
        self._plen_np = np.zeros(n_slots, np.int32)
        self._seed_rng = np.random.default_rng()
        self._inject = np.zeros(n_slots, bool)       # consume first_tok[b]
        self._pending: deque = deque()               # unmaterialized tokens
        self._waiting: deque[Request] = deque()
        self._cancel: set = set()                    # retire at next tick
        self.max_waiting = max_waiting
        self._deadlines = 0                          # live deadline count
        self.fetch_every = max(1, fetch_every)
        self._acc: list = []                         # (epochs, mask, tok, lp)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._ttft_ewma: float | None = None
        self._tpot_ewma: float | None = None
        self._base_seed = int(seed)
        self._step_n = 0
        self._tick_n = 0
        self._admit_n = 0
        self._admit_seq = [0] * n_slots              # admission order
        self._prefer_decode = False                  # prefill/decode alternation
        self._thread: threading.Thread | None = None
        self._stop = False
        self._dead = False
        self.mesh = mesh
        self.ranks = None
        if mesh is not None:
            from ..parallel import mesh as pmesh
            self.ranks = pmesh.EngineRanks(self, mesh)

    # -- client API --------------------------------------------------------

    def submit(self, prompt: list | None = None, max_new: int = 64,
               temperature: float = 0.0, eos_id=None,
               segments: list | None = None,
               timeout_s: float | None = None, top_p: float = 1.0,
               top_k: int = 0, min_p: float = 0.0,
               presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0,
               repetition_penalty: float = 1.0,
               logit_bias: dict | None = None,
               logprobs: int = 0, seed: int | None = None,
               constraint: str | None = None) -> Request:
        """Queue a request (see Request). timeout_s: a waiting request is
        dropped at its deadline, a running one retired with its partial
        tokens. Raises QueueFull when the queue is at ``max_waiting``.
        Under speculative serving constraints, logprobs and seeds raise (the
        lagged fetch carries candidate windows, not per-step rows)."""
        if self.spec and (constraint is not None or logprobs or seed is not None):
            what = "constraint" if constraint is not None else \
                "logprobs" if logprobs else "seed"
            raise ValueError(f"{what} unsupported with spec_lookup")
        if constraint is not None and constraint not in self._cstarts:
            raise ValueError(f"engine has no constraint {constraint!r} "
                             f"(registered: {sorted(self._cstarts) or 'none'})")
        if logprobs:
            top = min(llm.LP_K, self.cfg.vocab_size)
            if not 0 < int(logprobs) <= top:
                raise ValueError(f"logprobs must be 1..{top}")
        if seed is not None:
            seed = int(seed) % (1 << 31)     # OpenAI seeds are 64-bit
        r = Request(list(prompt) if prompt is not None else None,
                    max_new, temperature, eos_id, segments=segments,
                    top_p=top_p, top_k=top_k, min_p=min_p,
                    presence_penalty=presence_penalty,
                    frequency_penalty=frequency_penalty,
                    repetition_penalty=repetition_penalty,
                    logit_bias=dict(logit_bias) if logit_bias else None,
                    logprobs=int(logprobs), seed=seed, constraint=constraint)
        r.t_submit = time.monotonic()
        if timeout_s is not None:
            r.deadline = r.t_submit + timeout_s
        # spec windows are G+1 wide: the last real one must fit in the cache
        assert r.total_len + max_new + self.spec <= self.cfg.max_context, \
            "prompt+max_new overflow ctx"
        # every text chunk writes CHUNK wide at its start; a start past
        # S - CHUNK would run past the cache
        pos = 0
        for s in r.segments:
            if s[0] == "text":
                last = pos + (len(s[1]) - 1) // llm.CHUNK * llm.CHUNK
                assert last + llm.CHUNK <= self.cfg.max_context, \
                    "a prompt chunk would write past max_context"
                pos += len(s[1])
            else:
                pos += s[2]
        assert self.custom_prefill is not None or all(
            s[0] == "text" for s in r.segments), \
            "custom segments need a custom_prefill hook"
        with self._work:
            if self._dead:
                raise RuntimeError("serving engine stopped (closed, or scheduler "
                                   "died — see traceback above)")
            if self.max_waiting is not None and len(self._waiting) >= self.max_waiting:
                raise QueueFull(f"waiting queue at max_waiting={self.max_waiting}")
            if r.constraint is not None:
                if r.constraint not in self._cstarts:
                    raise ValueError(f"constraint {r.constraint!r} was evicted — "
                                     "re-register and resubmit")
                if r.constraint in self._clru:
                    self._clock += 1
                    self._clru[r.constraint] = self._clock
            self._waiting.append(r)
            if r.deadline is not None:
                self._deadlines += 1
            self._work.notify()
        return r

    def _cinflight(self) -> set:
        """Constraint names a live or waiting request needs (lock held)."""
        names = {r.constraint for r in self._waiting if r.constraint}
        names.update(r.constraint for r in self.req if r is not None and r.constraint)
        return names

    def _calloc(self, pad: int) -> int | None:
        """Best-fit a block of ``pad`` rows from the free list, else extend
        the tail. Returns the base row or None."""
        fits = [(p, b) for b, p in self._cfree if p >= pad]
        if fits:
            p, b = min(fits)
            self._cfree.remove((b, p))
            if p > pad:
                self._cfree.append((b + pad, p - pad))
            return b
        if self._cused + pad <= self._cap:
            b = self._cused
            self._cused += pad
            return b
        return None

    def register_constraint(self, name: str, tc) -> None:
        """Register a grammar at runtime (json_schema / guided_choice): its
        rows are written in place into the table's reserved space
        (``constraint_rows``), so the table never changes shape. Idempotent
        per name; blocks round up to 64 rows; when the space is full,
        least-recently-used runtime grammars with no request in flight are
        evicted. Raises when even eviction cannot make room."""
        with self._work:
            if name in self._cstarts:
                self._clock += 1
                if name in self._clru:
                    self._clru[name] = self._clock
                return
            n = tc.trans.shape[0]
            assert tc.trans.shape[1] == self.cfg.vocab_size
            pad = -(-n // 64) * 64

            def try_alloc():
                for want in dict.fromkeys((pad, n)):   # padded, then exact fit
                    b = self._calloc(want)
                    if b is not None:
                        return b, want
                return None, 0

            base, size = try_alloc()
            if base is None:
                busy = self._cinflight()
                for victim in sorted(self._cblocks, key=lambda k: self._clru.get(k, 0)):
                    if victim in busy:
                        continue
                    vb, vp = self._cblocks.pop(victim)
                    del self._cstarts[victim]
                    self._clru.pop(victim, None)
                    self._cfree.append((vb, vp))
                    self._cfree.sort()                # coalesce neighbours and the tail
                    merged = []
                    for fb, fp in self._cfree:
                        if merged and merged[-1][0] + merged[-1][1] == fb:
                            merged[-1] = (merged[-1][0], merged[-1][1] + fp)
                        else:
                            merged.append((fb, fp))
                    if merged and merged[-1][0] + merged[-1][1] == self._cused:
                        self._cused = merged.pop()[0]
                    self._cfree = merged
                    base, size = try_alloc()
                    if base is not None:
                        break
                if base is None:
                    raise ValueError(
                        f"constraint table full ({n} rows needed, {self._cap} total, "
                        "every registered grammar in flight) — raise "
                        "constraint_rows (serve_llm --constraint-rows)")
            blk = np.full((size, self.cfg.vocab_size), -1, np.int16)
            blk[:n] = np.where(tc.trans >= 0,
                               (tc.trans.astype(np.int32) + base).astype(np.int16),
                               np.int16(-1))
            with torch.inference_mode():
                self._ctab[base:base + size] = llm.upload(blk, self.device)
            self._cstarts[name] = base + tc.start
            self._cblocks[name] = (base, size)
            self._clock += 1
            self._clru[name] = self._clock

    def cancel(self, r: Request) -> None:
        """Abandon a request: a waiting one is dropped now; a running one
        is retired at the next tick (only the scheduler touches slots)."""
        with self._work:
            if r.done:
                return
            if r in self._waiting:
                self._waiting.remove(r)
                if r.deadline is not None:
                    self._deadlines -= 1
                r._done.set()
                return
            self._cancel.add(r)
            self._work.notify()

    def start(self):
        """Run the scheduler on a daemon thread until ``close()``."""
        def loop():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            while True:
                with self._work:
                    if not self._stop and not self._has_work():
                        self._publish_metrics()
                    while not self._stop and not self._has_work():
                        self._work.wait(timeout=0.5)
                    if self._stop:
                        return
                try:
                    self.step()
                except Exception:     # never hang the waiters: recover within
                    import traceback  # the restart budget, else fail them
                    traceback.print_exc()
                    try:
                        recovered = self._recover()
                    except Exception:     # a reset that failed fails them too
                        traceback.print_exc()
                        recovered = False
                    if recovered:
                        continue
                    self._fail_all()
                    return
        self._thread = threading.Thread(target=loop, daemon=True, name="llm-serving")
        self._thread.start()
        return self

    def _recover(self) -> bool:
        """Reset slot and device state after a failed tick. A request with
        no materialized token is requeued at the front and re-runs from
        scratch (seeded ones redraw identically); one that already streamed
        tokens completes with ``failed=True``. Returns False when more than
        ``max_restarts`` recoveries landed within ``restart_window_s``, or
        when the release of the other ranks from a fault inside a mirrored
        call failed (``ranks.broken``)."""
        now = time.monotonic()
        with self._work:
            if self.ranks is not None and self.ranks.broken:
                return False
            while self._restart_marks and \
                    now - self._restart_marks[0] > self.restart_window_s:
                self._restart_marks.popleft()
            if len(self._restart_marks) >= self.max_restarts:
                return False
            self._restart_marks.append(now)
            self.stats["scheduler_restarts"] += 1
            requeue = []
            for b in range(self.n_slots):
                r = self.req[b]
                if r is not None and not r.done:
                    if r.tokens:
                        r.failed = True
                        r._done.set()
                    else:
                        r.t_first = None
                        requeue.append(r)
                self.req[b] = None
                self.phase[b] = _FREE
                self.epoch[b] += 1
                self.hist[b] = []
            for r in reversed(requeue):
                self._waiting.appendleft(r)
            self._deadlines = sum(1 for w in self._waiting if w.deadline is not None)
            self._cancel = {r for r in self._cancel if not r.done}
            if self.ranks is not None:
                self.ranks.reset_all()        # every rank's, in one command
            else:
                self.reset_device()
            self.cursor[:] = 0
            self.seg_idx = [0] * self.n_slots
            self.seg_start[:] = 0
            self._inject[:] = False
            self.samp[:] = 0.0
            self.samp[:, 1] = 1.0
            self.samp[:, 6] = 1.0
            self._pending.clear()
            self._acc = []
        return True

    def reset_device(self) -> None:
        """A fresh cache (this rank's slice under a mesh), ``aux`` and
        sampling tensors: the device half of a recovery."""
        with torch.inference_mode():
            self.state = llm.init_state(self._state_cfg, batch=self.n_slots,
                                        dtype=self._state_dtype,
                                        kv_quant=self._kv_quant, device=self.device)
            if self.spec:
                self.aux = llm.init_serving_aux(self.cfg, self.n_slots, device=self.device)
            self._cnt_p.zero_()
            self._cnt_o.zero_()
            self._bias.zero_()
            self._cinit_np[:] = -1
            self._cinit_dev = llm.upload(self._cinit_np, self.device)
            self._cinit_dirty = False
            self._cstate.fill_(-1)
            self._tok_dev = torch.zeros_like(self._tok_dev)
            self._first_tok = torch.zeros_like(self._first_tok)
            self._first_lp = torch.zeros_like(self._first_lp)

    def _fail_all(self) -> None:
        """Scheduler death: complete every request with ``failed=True`` and
        refuse further submits."""
        with self._work:
            self._dead = True
            for r in list(self._waiting):
                r.failed = True
                r._done.set()
            self._waiting.clear()
            for r in self.req:
                if r is not None and not r.done:
                    r.failed = True
                    r._done.set()

    def close(self):
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # a graceful close must not leave clients blocked in wait()
        self._fail_all()

    # -- scheduler ---------------------------------------------------------

    def _has_work(self) -> bool:
        return bool(self._waiting) or bool(self._pending) \
            or bool(self._acc) or any(p != _FREE for p in self.phase)

    def has_work(self) -> bool:
        """Advisory: pending requests or unmaterialized tokens exist."""
        return self._has_work()

    def _reuse_len(self, b: int, r: Request) -> int:
        """CHUNK-aligned shared prefix of slot b's valid cache history and
        r's leading text segment (at least one token is left to prefill)."""
        if not self.prefix_cache or r.segments[0][0] != "text":
            return 0
        hist, toks = self.hist[b], r.segments[0][1]
        n = 0
        for h, t in zip(hist, toks):
            if h != t:
                break
            n += 1
        n = min(n, r.total_len - 1)
        return n // llm.CHUNK * llm.CHUNK

    def _admit(self):
        free = [b for b in range(self.n_slots) if self.phase[b] == _FREE]
        while self._waiting and free:
            r = self._waiting.popleft()
            reuses = {s: self._reuse_len(s, r) for s in free}
            b = max(free, key=reuses.__getitem__)
            free.remove(b)
            reuse = reuses[b]
            self.req[b] = r
            self.phase[b] = _PREFILL
            self._admit_n += 1
            self._admit_seq[b] = self._admit_n
            self.cursor[b] = reuse
            covered = reuse == len(r.segments[0][1]) if reuse else False
            self.seg_idx[b] = 1 if covered else 0
            self.seg_start[b] = reuse if covered else 0
            self.stats["reused_tokens"] += reuse
            self._seed_np[b] = (r.seed if r.seed is not None
                                else int(self._seed_rng.integers(1 << 31)))
            self._plen_np[b] = min(r.total_len, (1 << 31) - 1)
            ci = self._cstarts[r.constraint] if r.constraint else -1
            if ci != self._cinit_np[b]:
                self._cinit_np[b] = ci
                self._cinit_dirty = True
            self.samp[b] = [r.temperature, r.top_p, float(r.top_k), r.min_p,
                            r.presence_penalty, r.frequency_penalty,
                            r.repetition_penalty, 1.0 if r.logit_bias else 0.0]
            if r.logit_bias:
                brow = np.zeros(self.cfg.vocab_size, np.float32)
                for t, v in r.logit_bias.items():
                    brow[int(t)] = float(v)
                self._bias[b] = llm.upload(brow, self.device)
            if r.pen_active:
                # fresh histograms: prompt counts over every text token
                # (reused prefixes included), zero generated counts
                cp = np.zeros(self.cfg.vocab_size, np.int64)
                for s in r.segments:
                    if s[0] == "text" and s[1]:
                        cp += np.bincount(np.asarray(s[1], np.int64),
                                          minlength=self.cfg.vocab_size)
                self._cnt_p[b] = llm.upload(cp.astype(np.int32), self.device)
                self._cnt_o[b] = 0

    def _retire(self, b: int, r: Request) -> None:
        mid_prefill = self.phase[b] == _PREFILL
        r.t_done = time.monotonic()
        if r.ttft_s is not None:
            self._ttft_ewma = (r.ttft_s if self._ttft_ewma is None
                               else 0.8 * self._ttft_ewma + 0.2 * r.ttft_s)
        if r.tpot_s is not None:
            self._tpot_ewma = (r.tpot_s if self._tpot_ewma is None
                               else 0.8 * self._tpot_ewma + 0.2 * r.tpot_s)
        if r.deadline is not None:
            self._deadlines -= 1
        self.phase[b] = _FREE
        self.req[b] = None
        self.epoch[b] += 1            # stale pending records become no-ops
        self._inject[b] = False
        if self.prefix_cache:
            # rows still valid for a future occupant: the leading text
            # segment, plus (single-segment requests) every generated token
            # but the last, whose row only a junk lag step may have written
            lead = r.segments[0][1] if r.segments[0][0] == "text" else []
            h = list(lead) + r.tokens[:-1] if len(r.segments) == 1 else list(lead)
            self.hist[b] = h[:int(self.cursor[b])] if mid_prefill else h
            # park AT the history length: parking below it would let the
            # free slot's junk decode writes corrupt the reusable prefix
            self.cursor[b] = min(len(self.hist[b]), self.cfg.max_context - 1)
        else:
            self.cursor[b] = 0
        r._done.set()

    def _emit(self, b: int, tok: int, lp=None) -> None:
        """Record one (lag-materialized) token for slot b; retire on eos,
        max_new or a full context."""
        r = self.req[b]
        r.tokens.append(tok)
        if r.logprobs and lp is not None:
            k = r.logprobs
            ids = lp[1 + llm.LP_K:1 + llm.LP_K + k].astype(np.int64)
            r.lp.append((float(lp[0]), list(zip(ids.tolist(), lp[1:1 + k].tolist()))))
        if r.t_first is None:
            r.t_first = time.monotonic()
        ctx_full = r.total_len + len(r.tokens) >= self.cfg.max_context
        if tok in r.stop_ids or len(r.tokens) >= r.max_new or ctx_full:
            self._retire(b, r)

    def _publish_metrics(self) -> None:
        """Mirror engine state into the shared metrics registry (/metrics)."""
        from ..runtime import metrics
        live = sum(1 for p in self.phase if p == _LIVE)
        pref = sum(1 for p in self.phase if p == _PREFILL)
        metrics.gauge("serving.slots_live", live)
        metrics.gauge("serving.slots_prefill", pref)
        metrics.gauge("serving.slots_free", self.n_slots - live - pref)
        metrics.gauge("serving.waiting", len(self._waiting))
        if self._ttft_ewma is not None:
            metrics.gauge("serving.ttft_ms", round(self._ttft_ewma * 1e3, 2))
        if self._tpot_ewma is not None:
            metrics.gauge("serving.tpot_ms", round(self._tpot_ewma * 1e3, 2))
        for k, v in self.stats.items():
            metrics.gauge("serving." + k, v)

    def _flush_acc(self) -> None:
        """Stack the accumulated decode steps' tokens (and logprob rows)
        into one [k, B] tensor ([k, B, G+2] windows under spec), start its
        host copy, and queue one pending record for all k steps."""
        if not self._acc:
            return
        with torch.inference_mode():
            toks = _Fetch(torch.stack([t for _, _, t, _ in self._acc]))
            lps = None if self.spec else \
                _Fetch(torch.stack([lp for _, _, _, lp in self._acc]))
        self._pending.append(("decs", [(e, m) for e, m, _, _ in self._acc],
                              toks, lps, self._step_n))
        self._acc = []

    @staticmethod
    def _materialize(rec):
        """Wait for a pending record's host copies (outside the lock)."""
        if rec[0] == "first":
            k, b, ep, tok, lp, born = rec
            return (k, b, ep, tok.numpy(), lp.numpy(), born)
        k, metas, toks, lps, born = rec
        return (k, metas, toks.numpy(), None if lps is None else lps.numpy(), born)

    def _process(self, rec) -> None:
        """Emit a materialized record's tokens (under the lock)."""
        if rec[0] == "first":
            _, b, ep, tok, lp, _born = rec             # [B] first_tok snapshot
            if self.phase[b] == _LIVE and self.epoch[b] == ep:
                self._emit(b, int(tok[b]), lp[b])
            return
        _, metas, arr, lp_arr, _born = rec    # [k, B] or [k, B, G+2]; [k, B, 1+2K]
        for j, (epochs, mask) in enumerate(metas):
            # a retirement at step j bumps the slot's epoch, so its later
            # rows in this record drop
            for b in range(self.n_slots):
                if not (mask[b] and self.phase[b] == _LIVE and self.epoch[b] == epochs[b]):
                    continue
                if not self.spec:
                    self._emit(b, int(arr[j, b]), lp_arr[j, b])
                    continue
                # a window's n_emit leading candidates; a retirement inside
                # it (eos, max_new, deadline) drops the rest, and what the
                # card consumed past the stop is never claimed as history
                n = min(int(arr[j, b, -1]), self.spec + 1)
                self.stats["spec_emitted"] += max(n, 0)
                for t in arr[j, b, :n]:
                    if self.phase[b] != _LIVE or self.epoch[b] != epochs[b]:
                        break
                    self._emit(b, int(t))

    def _first_record(self, b: int, fetched: list) -> None:
        """Queue slot b's first token; the tick's host copy of first_tok
        and first_lp is started once and shared (``fetched`` holds it)."""
        if not fetched:
            with torch.inference_mode():
                fetched += [_Fetch(self._first_tok), _Fetch(self._first_lp)]
        self._pending.append(("first", b, self.epoch[b], fetched[0], fetched[1],
                              self._step_n))

    def _upload_cinit(self):
        if self._cinit_dirty:
            self._cinit_dev = llm.upload(self._cinit_np, self.device)
            self._cinit_dirty = False

    def _prefill_batched(self, rows: list) -> None:
        """Advance every row in ``rows`` (mid-prefill, on text segments) by
        one chunk in one prefill_many call. meta rows are [start_pos,
        n_real, valid, seed]; invalid rows park at their cursor and their
        caches stay untouched."""
        toks = np.zeros((self.n_slots, llm.CHUNK), np.int32)
        meta = np.zeros((4, self.n_slots), np.int32)
        meta[3] = self._seed_np
        meta[0] = np.minimum(self.cursor, self.cfg.max_context - 1)
        meta[1] = 1                              # keep n_real - 1 >= 0
        fin = []                                 # (b, request, new_cursor, seg_done)
        for b in rows:
            r = self.req[b]
            cur = int(self.cursor[b])
            seg_toks = r.segments[self.seg_idx[b]][1]
            off = cur - int(self.seg_start[b])
            n = min(llm.CHUNK, len(seg_toks) - off)
            toks[b, :n] = seg_toks[off:off + n]
            meta[0, b] = cur
            meta[1, b] = n
            meta[2, b] = 1
            fin.append((b, r, cur + n, off + n == len(seg_toks)))
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
        self.stats["prefill_batched_steps"] += 1
        self._step_n += 1
        if self.spec:
            self._first_tok, self.state, self.aux = self.prefill_many(
                self.params, self.state, self.aux, self._first_tok, toks, meta, self.samp,
                self._base_seed, self._cnt_p, self._cnt_o, self._bias)
        else:
            self._upload_cinit()
            self._first_tok, self._first_lp, self.state, self._cstate = self.prefill_many(
                self.params, self.state, self._first_tok, self._first_lp, toks, meta,
                self.samp, self._base_seed, self._cnt_p, self._cnt_o, self._bias,
                self._ctab, self._cinit_dev, self._cstate)
        fetched: list = []
        with self._lock:
            for b, r, new_cur, seg_done in fin:
                self.cursor[b] = new_cur
                if seg_done:
                    self.seg_idx[b] += 1
                    self.seg_start[b] = new_cur
                    if self.seg_idx[b] == len(r.segments):
                        self.phase[b] = _LIVE
                        self._inject[b] = True   # device value, no sync
                        self._first_record(b, fetched)

    def step(self) -> bool:
        """One scheduler tick; returns False when there was nothing to do."""
        with torch.inference_mode():
            return self._step()

    def _step(self) -> bool:
        with self._lock:
            if self._deadlines:
                now = time.monotonic()
                for b in range(self.n_slots):
                    r = self.req[b]
                    if r is not None and r.deadline is not None and now >= r.deadline:
                        r.timed_out = True
                        self._retire(b, r)   # keeps its partial tokens
                for r in [w for w in self._waiting
                          if w.deadline is not None and now >= w.deadline]:
                    self._waiting.remove(r)
                    r.timed_out = True
                    self._deadlines -= 1
                    r._done.set()
            if self._cancel:
                for b in range(self.n_slots):
                    if self.req[b] in self._cancel:
                        self._retire(b, self.req[b])
                self._cancel.clear()
            self._admit()
            # oldest admission first, not slot order
            pre = sorted((b for b in range(self.n_slots) if self.phase[b] == _PREFILL),
                         key=lambda b: self._admit_seq[b])
            has_dec = any(self.phase[b] == _LIVE
                          and (self.spec or self.cursor[b] <= self.cfg.max_context - 1)
                          for b in range(self.n_slots))

        # chunked-prefill fairness: with both prefill and decode work,
        # alternate ticks, so a long prompt never stalls live decodes for
        # more than one chunk
        if pre and has_dec and self._prefer_decode:
            pre = []
        did = False
        batch_rows = []
        if pre and self.prefill_many is not None \
                and self.req[pre[0]].segments[self.seg_idx[pre[0]]][0] == "text":
            batch_rows = [b for b in pre
                          if self.req[b].segments[self.seg_idx[b]][0] == "text"]
        if len(batch_rows) >= 2:
            self._prefill_batched(batch_rows)
            self._prefer_decode = True
            did = True
        elif pre:
            b = pre[0]
            r = self.req[b]
            cur = int(self.cursor[b])
            seg = r.segments[self.seg_idx[b]]
            if seg[0] == "custom":
                # one tick = the whole custom segment (e.g. an image prefill)
                _, payload, n = seg
                self.state = self.custom_prefill(self.state, b, cur, payload)
                with self._lock:
                    self.cursor[b] = cur + n
                    self.seg_idx[b] += 1
                    self.seg_start[b] = cur + n
                self._prefer_decode = True
                return True
            toks = seg[1]
            off = cur - int(self.seg_start[b])
            n = min(llm.CHUNK, len(toks) - off)
            chunk = toks[off:off + n] + [0] * (llm.CHUNK - n)
            self._step_n += 1
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            if self.spec:
                self._first_tok, self.state, self.aux = self.prefill_slot(
                    self.params, self.state, self.aux, self._first_tok,
                    np.asarray([chunk], np.int32), b, cur, n, self.samp[b],
                    int(self._seed_np[b]), self._base_seed, self._cnt_p, self._cnt_o,
                    self._bias)
            else:
                self._upload_cinit()
                self._first_tok, self._first_lp, self.state, self._cstate = \
                    self.prefill_slot(
                        self.params, self.state, self._first_tok, self._first_lp,
                        np.asarray([chunk], np.int32), b, cur, n, self.samp[b],
                        int(self._seed_np[b]), self._base_seed, self._cnt_p,
                        self._cnt_o, self._bias, self._ctab, self._cinit_dev,
                        self._cstate)
            with self._lock:
                self.cursor[b] = cur + n
                if off + n == len(toks):
                    self.seg_idx[b] += 1
                    self.seg_start[b] = cur + n
                    if self.seg_idx[b] == len(r.segments):
                        self.phase[b] = _LIVE
                        self._inject[b] = True       # device value, no sync
                        self._first_record(b, [])
            self._prefer_decode = True
            did = True
        else:
            self._prefer_decode = False
            dec = [b for b in range(self.n_slots)
                   if self.phase[b] == _LIVE
                   and (self.spec or self.cursor[b] <= self.cfg.max_context - 1)]
            if dec and self.spec:
                mask = np.zeros(self.n_slots, bool)
                mask[dec] = True
                self.stats["decode_steps"] += 1
                self._step_n += 1
                # positions live on the card under spec (each window advances
                # its row by a length only the card knows): [live, inject, seed]
                meta = np.stack([mask, self._inject, self._seed_np]).astype(np.int32)
                self._inject[:] = False
                out_dev, self.state, self.aux, self._cnt_o = self.decode_all(
                    self.params, self.state, self.aux, self._first_tok, meta, self.samp,
                    self._base_seed, self._step_n, self._cnt_o, self._cnt_p, self._bias)
                self._acc.append((tuple(self.epoch), mask, out_dev, None))
                if len(self._acc) >= self.fetch_every:
                    self._flush_acc()
                did = True
            elif dec:
                mask = np.zeros(self.n_slots, bool)
                mask[dec] = True
                self.stats["decode_steps"] += 1
                self._step_n += 1
                # one packed upload per step: [pos, live, inject, seed, plen]
                meta = np.zeros((5, self.n_slots), np.int32)
                meta[0] = np.minimum(self.cursor, self.cfg.max_context - 1)
                meta[1] = mask
                meta[2] = self._inject
                meta[3] = self._seed_np
                meta[4] = self._plen_np
                self._inject[:] = False
                tok_dev, self.state, self._cnt_o, lp_dev, self._cstate = \
                    self.decode_all(self.params, self.state, self._tok_dev,
                                    self._first_tok, meta, self.samp,
                                    self._base_seed, self._cnt_o, self._cnt_p,
                                    self._bias, self._ctab, self._cstate)
                self._tok_dev = tok_dev
                with self._lock:
                    for b in dec:
                        self.cursor[b] += 1
                self._acc.append((tuple(self.epoch), mask, tok_dev, lp_dev))
                if len(self._acc) >= self.fetch_every:
                    self._flush_acc()
                did = True

        # materialize by age: a record is read once its newest step is
        # sync_lag dispatches behind the head, so the card always has
        # sync_lag steps queued when the host waits; with nothing left to
        # queue, flush and drain everything
        target = self.sync_lag if did else 0
        if not did:
            self._flush_acc()
        popped = False
        while self._pending and self._step_n - self._pending[0][-1] >= target:
            with self._lock:
                rec = self._pending.popleft()
            rec = self._materialize(rec)      # waits outside the lock
            with self._lock:
                self._process(rec)
            popped = True
        self._tick_n += 1
        if self._tick_n % 32 == 0 or not (did or popped):
            self._publish_metrics()
        return did or popped

    def run_until_idle(self, max_steps: int = 1_000_000):
        """Drive the scheduler inline (tests / synchronous callers)."""
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError("serving engine did not drain")
