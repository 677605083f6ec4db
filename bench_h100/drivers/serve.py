"""The LLM serving engine: ``serving.engine.ServingEngine`` under a closed
loop of clients, each sending its next request as soon as its last one is
done.

Set-up builds the model the way ``tools.serve_llm --int8 --pallas`` serves
it: the configuration's widths (``models.llm.TransformerConfig``), weights
made on the card from the seed, ``llm.quantize_params_int8``, an engine with
a bfloat16 cache and the decode-attention kernel. It warms up the three
serving graphs at the traffic's batch (a lone prefill chunk and decode, then
every slot's chunk in one batched prefill), then runs the clients' loop
until the first wave of requests has its first tokens (``lead_in``). The
window drives ``ServingEngine.step`` inline from the clients' loop for
``seconds``; then the loop runs on, under the same load, until every
request sent in the window has its first token. The check regenerates the
weights from the seed and runs the plain reference (``reference/qwen3.py``)
over requests sent from the window on, drawn from the seed, the longest
among them, and reads how far below the reference's best logit each served
token lies (``compare.logit_gap``).
"""
from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import compare, weights
from ..reference import qwen3 as ref

TAIL_S = 120.0       # the most the loop runs on for first tokens after the window


def transformer_config(llm, hf: dict):
    """The program's config for a Qwen3-style configuration file."""
    hd = hf["head_dim"]
    return llm.TransformerConfig(
        num_blocks=hf["num_hidden_layers"], dim=hf["hidden_size"],
        hidden_dim=hf["intermediate_size"], n_heads=hf["num_attention_heads"],
        n_kv_heads=hf["num_key_value_heads"], norm_eps=hf["rms_norm_eps"],
        vocab_size=hf["vocab_size"], head_dim=hd, rope_theta=float(hf["rope_theta"]),
        rope_dim=hd, v_head_dim=hd, max_context=hf["serving"]["cache_positions"], qk_norm=hd)


class Cell:
    def __init__(self, cell, seed: int, device, spans, log):
        self.cell, self.seed, self.device, self.spans, self.log = cell, seed, device, spans, log
        self.hf = cell.config
        self.mix = cell.traffic

    def setup(self) -> None:
        from clearcam_tpu_torch.models import llm
        from clearcam_tpu_torch.serving import ServingEngine

        self.llm = llm
        hf, sv = self.hf, self.hf["serving"]
        self.cfg = transformer_config(llm, hf)
        params = weights.llm(hf, self.seed, self.device)
        if sv["weights"] == "int8":
            params = llm.quantize_params_int8(params)
        # keep no view of the draw's flat buffer: only what is served stays
        params = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in params.items()}
        self.engine = ServingEngine(params, self.cfg, n_slots=int(self.mix["slots"]),
                                    state_dtype=getattr(torch, sv["cache_dtype"]),
                                    use_pallas_decode=bool(sv["decode_attention_kernel"]),
                                    device=self.device)
        gen = importlib.import_module(f"bench_h100.traffic.{self.mix['generator']}")
        self.requests = gen.make(self.mix, self.seed, hf["vocab_size"])
        self._warm()

    def _warm(self) -> None:
        """prefill_slot and decode_all (one request), then prefill_many at
        the full batch (every slot at once)."""
        eng, chunk = self.engine, self.llm.CHUNK
        eng.submit([1] * (chunk + 1), max_new=3)
        eng.run_until_idle()
        rs = [eng.submit([2 + b] * (chunk + 1), max_new=2) for b in range(eng.n_slots)]
        eng.run_until_idle()
        assert all(r.done and not r.failed for r in rs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _wrap_calls(self) -> None:
        """Log every serving-graph call (host time, kind, meta) for the
        per-layer readers: traced runs only."""
        self.calls: list = []
        eng, calls = self.engine, self.calls

        def wrap(kind, fn, meta_of):
            def call(*a):
                calls.append((time.perf_counter(), kind, meta_of(a)))
                return fn(*a)
            return call
        eng.decode_all = wrap("decode", eng.decode_all, lambda a: np.array(a[4], np.int64))
        eng.prefill_many = wrap("prefill_many", eng.prefill_many,
                                lambda a: np.array(a[5], np.int64))
        eng.prefill_slot = wrap("prefill_slot", eng.prefill_slot,
                                lambda a: (int(a[6]), int(a[7])))

    def _send(self):
        i = len(self.sent)
        _, olen = self.requests.lengths(i)
        r = self.engine.submit(self.requests.prompt(i), max_new=olen,
                               temperature=float(self.mix["temperature"]))
        self.sent.append((i, r))
        return r

    def _step(self) -> None:
        """One engine step, then every client whose request is done sends
        its next one."""
        with self.spans("engine.step"):
            self.engine.step()
        for c, r in enumerate(self.live):
            if r.done:
                self.live[c] = self._send()

    def lead_in(self) -> None:
        """Every client sends its first request at once, and the loop runs
        until each of these has its first token: the window opens on a
        loop in which the clients' sends are spread out, and the first
        wave's cold start (every prompt queued behind every other) stays
        out of the tail. Part of set-up."""
        self.sent: list = []                  # (index, Request)
        self.live = [self._send() for _ in range(int(self.mix["clients"]))]
        first = list(self.live)
        t0 = time.perf_counter()
        while any(r.t_first is None and not r.done for r in first):
            self._step()
        self.log(f"lead-in: {len(self.sent)} requests sent, "
                 f"{time.perf_counter() - t0:.1f} s to the first wave's first tokens")

    def run_window(self, seconds: float, tracer) -> SimpleNamespace:
        eng, spans = self.engine, self.spans
        self.calls = []
        if tracer.enabled:
            self._wrap_calls()
        stats0 = dict(eng.stats)
        self.n_lead = len(self.sent)
        tokens0 = sum(len(r.tokens) for _, r in self.sent)
        t_start = time.perf_counter()
        t_end = None
        while True:
            now = time.perf_counter()
            if t_end is None and now - t_start >= seconds:
                t_end = now
                tracer.stop()
                stats1 = dict(eng.stats)
                n_window = len(self.sent)
                tokens_in_window = sum(len(r.tokens) for _, r in self.sent) - tokens0
            if t_end is not None:
                waiting = [r for _, r in self.sent[self.n_lead:n_window]
                           if r.t_first is None and not r.done]
                if not waiting or now - t_end > TAIL_S:
                    break
            else:
                tracer.poll(now, t_start, seconds)
            self._step()
        window_s = t_end - t_start
        steps = np.array([b - a for a, b in spans.within("engine.step", t_start, t_end)]) * 1e3
        kinds: dict = {}
        for _, k, _ in self.calls:
            kinds[k] = kinds.get(k, 0) + 1
        win_reqs = [r for _, r in self.sent[self.n_lead:n_window]]
        self.log(f"window: {len(steps)} engine steps, ms p50 {np.percentile(steps, 50):.1f} "
                 f"p95 {np.percentile(steps, 95):.1f} max {steps.max():.1f}; "
                 f"{len(win_reqs)} requests sent (the TTFT tail is taken over them), "
                 f"{tokens_in_window} tokens; calls {kinds}; "
                 f"tail {time.perf_counter() - t_end:.1f} s")
        failed = sum(1 for r in win_reqs if r.failed or r.timed_out or r.t_first is None)
        ttft = [r.ttft_s if r.ttft_s is not None else time.monotonic() - r.t_submit
                for r in win_reqs]
        tpot = [r.tpot_s for r in win_reqs
                if r.done and r.tpot_s is not None and r.t_done <= self._mono(t_end)]
        return SimpleNamespace(
            attempted=len(win_reqs), failed=failed, window_s=window_s, t_start=t_start,
            t_end=t_end,
            metrics={"gen_tok_s": tokens_in_window / window_s,
                     "ttft_p95_ms": float(np.percentile(np.array(ttft) * 1e3, 95))},
            tpot_ms=[x * 1e3 for x in tpot], stats0=stats0, stats1=stats1,
            calls=[c for c in self.calls if c[0] <= t_end],
            n_slots=eng.n_slots, chunk=self.llm.CHUNK, hf=self.hf)

    @staticmethod
    def _mono(t_perf: float) -> float:
        """A perf_counter time on the engine's clock (time.monotonic)."""
        return t_perf - time.perf_counter() + time.monotonic()

    def release(self) -> None:
        self.engine.close()
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        """The finished requests sent in the window (or after it, under the
        same load) that the check reads: the longest, and others drawn from
        the seed, ``check.requests`` in all."""
        done = [(i, r) for i, r in self.sent[self.n_lead:]
                if r.done and not r.failed and r.tokens]
        if not done:
            return []
        longest = max(done, key=lambda ir: len(ir[1].prompt) + len(ir[1].tokens))
        rng = np.random.default_rng([int(self.seed), 5])
        k = int(self.cell.cell["check"]["requests"])
        pick = rng.choice(len(done), size=min(k, len(done)), replace=False)
        chosen = {done[j][0]: done[j][1] for j in pick}
        chosen[longest[0]] = longest[1]
        return sorted(chosen.items())

    def check(self) -> list[tuple[str, float, float]]:
        reqs = self.sample()
        limit = float(self.cell.cell["limits"]["logit_gap"])
        if not reqs:
            return [("logit_gap", float("inf"), limit)]
        w = weights.llm(self.hf, self.seed, self.device)
        model = ref.Model(self.hf, w, weight_bits=8 if self.hf["serving"]["weights"] == "int8"
                          else 16)
        worst = 0.0
        for _, r in reqs:
            worst = max(worst, served_gap(model, r.prompt, r.tokens))
        served = sum(len(r.tokens) for _, r in reqs)
        self.log(f"check: {len(reqs)} requests, {served} served tokens")
        return [("logit_gap", worst, limit)]

    @torch.no_grad()
    def controls(self) -> dict:
        """``int4``: ``logit_gap`` of the program's own lower precision, int4
        weights (``llm.quantize_params_int4``), teacher forced over the
        sampled requests' prompts and served tokens: at each position the
        token the int4 model puts first, read under the int8 reference. No
        reading where the window finished no request."""
        from clearcam_tpu_torch.nn import functional as F
        llm = self.llm
        reqs = self.sample()
        if not reqs:
            return {}
        w = weights.llm(self.hf, self.seed, self.device)
        model = ref.Model(self.hf, w, weight_bits=8)
        p4 = llm.quantize_params_int4(w)
        cfg = self.cfg
        freqs = llm.freqs_for(cfg, self.device)
        worst = 0.0
        for _, r in reqs:
            seq = list(r.prompt) + list(r.tokens[:-1])
            rows = list(range(len(r.prompt) - 1, len(seq)))
            state = llm.init_state(cfg, 1, dtype=getattr(torch, self.hf["serving"]["cache_dtype"]),
                                   device=self.device)
            toks = torch.as_tensor([seq], dtype=torch.long, device=self.device)
            hidden, _ = llm.forward(p4, cfg, state, toks, 0, freqs)
            h = hidden[0, rows]
            lg = F.linear(F.rms_norm(h, p4["output_norm.weight"], cfg.norm_eps),
                          p4["output.weight"])
            worst = max(worst, compare.logit_gap(model.logits(seq, rows), lg.argmax(-1)))
        return {"int4": {"logit_gap": worst}}


def served_gap(model, prompt: list, tokens: list) -> float:
    """The widest gap of the served ``tokens`` under the reference, teacher
    forced over the prompt and the served tokens."""
    seq = list(prompt) + list(tokens[:-1])
    rows = list(range(len(prompt) - 1, len(seq)))
    return compare.logit_gap(model.logits(seq, rows), tokens)
