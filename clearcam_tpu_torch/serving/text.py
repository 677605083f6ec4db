"""Text-in/text-out adapter over the continuous-batching engine.

Pairs a ServingEngine with an LLMTokenizer so callers (the HTTP
/generate endpoint, the serve_llm CLI) speak strings while the engine
speaks token ids. Chat framing uses the tokenizer's preset-aware helpers
(utils/llm_tokenizer.role/end_turn/prefix — the reference's chat presets,
qwen3vl.py:71-90); ``raw=True`` skips framing for completion-style use.

Streaming: token ids land on ``Request.tokens`` as the engine
materializes them; ``text_delta`` re-decodes the full id list each call
and returns the suffix past what the caller has seen — re-decoding (not
per-token decode) keeps multi-byte BPE merges correct at chunk borders.
"""
from __future__ import annotations

import json
import re
import threading
import uuid

from .engine import Request, ServingEngine

# Assistant tool-call block (the Qwen-family convention the chat presets
# train on: one JSON object per <tool_call> tag)
_TOOL_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)


class TextServing:
    """String-level submit/stream over a (engine, tokenizer) pair."""

    def __init__(self, engine, tok, chat: bool = True):
        # accept a raw ServingEngine or a wrapper exposing .engine (VLM)
        self.engine: ServingEngine = getattr(engine, "engine", engine)
        self.tok = tok
        self.chat = chat
        self._score = None                   # lazy llm.make_score_fn(cfg)
        self._score_lock = threading.Lock()

    def has_work(self) -> bool:
        return self.engine._has_work()

    def fingerprint(self) -> str:
        """OpenAI ``system_fingerprint``: stable per serving config, changed
        by anything that affects the compiled batch shape or sampling
        numerics (slot count, KV dtype/quant, spec decoding, Pallas decode).
        Clients comparing seeded outputs across deployments should treat a
        fingerprint change as "draws may differ" (PARITY.md batch-width
        caveat)."""
        import hashlib
        cfg = getattr(self.engine, "fingerprint_cfg", ())
        return "fp_cc_" + hashlib.sha1(repr(cfg).encode()).hexdigest()[:10]

    def cancel(self, req: Request) -> None:
        self.engine.cancel(req)

    def encode_prompt(self, prompt: str, raw: bool = False) -> list[int]:
        if raw or not self.chat:
            return self.tok.encode(prompt)
        return (self.tok.prefix() + self.tok.role("user")
                + self.tok.encode(prompt) + self.tok.end_turn()
                + self.tok.role("assistant"))

    def encode_messages(self, messages, tools=None) -> list[int]:
        """OpenAI-style ``[{"role": .., "content": ..}]`` history -> chat-
        framed ids (every turn via the tokenizer preset), ending with the
        assistant role header so generation continues the reply.

        tools: OpenAI function specs — declared to the model inside a
        <tools> block appended to the system turn; role "tool" results
        are framed as user turns wrapped in <tool_response> tags, and
        assistant history entries carrying ``tool_calls`` re-emit their
        <tool_call> JSON blocks (the Qwen chat-template convention the
        preset-trained checkpoints expect)."""
        msgs = [dict(m) for m in messages]
        if tools:
            spec = "\n".join(
                json.dumps(t.get("function", t), ensure_ascii=False)
                for t in tools)
            blurb = (
                "\n\n# Tools\n\nYou may call one or more functions to "
                "assist with the user query. You are provided with "
                "function signatures within <tools></tools> XML tags:\n"
                "<tools>\n" + spec + "\n</tools>\n\nFor each function "
                "call, return a json object with function name and "
                "arguments within <tool_call></tool_call> XML tags:\n"
                "<tool_call>\n{\"name\": <function-name>, \"arguments\": "
                "<args-json-object>}\n</tool_call>")
            if msgs and msgs[0].get("role") == "system":
                msgs[0]["content"] = str(msgs[0].get("content") or "") \
                    + blurb
            else:
                msgs.insert(0, {"role": "system", "content": blurb})
        ids = list(self.tok.prefix())
        for m in msgs:
            role = str(m.get("role", "user"))
            content = str(m.get("content") or "")
            if role == "tool":
                role = "user"
                content = ("<tool_response>\n" + content
                           + "\n</tool_response>")
            elif role == "assistant" and m.get("tool_calls"):
                blocks = []
                for c in m["tool_calls"]:
                    fn = c.get("function", {})
                    args = fn.get("arguments", {})
                    if isinstance(args, str):
                        try:
                            args = json.loads(args)
                        except ValueError:
                            pass          # leave the raw string in place
                    blocks.append(
                        "<tool_call>\n" + json.dumps(
                            {"name": fn.get("name"), "arguments": args},
                            ensure_ascii=False) + "\n</tool_call>")
                joined = "\n".join(blocks)
                content = (content + "\n" + joined) if content else joined
            ids += (self.tok.role(role) + self.tok.encode(content)
                    + self.tok.end_turn())
        return ids + self.tok.role("assistant")

    def parse_tool_calls(self, text: str):
        """-> (content, tool_calls): extract well-formed <tool_call> JSON
        blocks into the OpenAI response shape (arguments re-serialized as
        a JSON string, fresh call ids); malformed blocks stay in the
        content verbatim rather than being silently dropped."""
        calls = []

        def repl(m):
            try:
                obj = json.loads(m.group(1))
                name = obj["name"]
            except (ValueError, KeyError, TypeError):
                return m.group(0)
            calls.append({
                "id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
                "function": {"name": str(name),
                             "arguments": json.dumps(
                                 obj.get("arguments", {}),
                                 ensure_ascii=False)}})
            return ""

        content = _TOOL_RE.sub(repl, text).strip()
        return content, calls

    def _stops(self):
        stop = {self.tok.eos_id}
        if getattr(self.tok, "eot_id", None) is not None:
            stop.add(self.tok.eot_id)
        return stop

    def submit(self, prompt: str, max_new: int = 128,
               temperature: float = 0.0, raw: bool = False,
               timeout_s: float | None = None, **samp) -> Request:
        """``samp``: any engine sampling knobs (top_p, top_k, min_p,
        presence_penalty, frequency_penalty, repetition_penalty)."""
        return self.engine.submit(self.encode_prompt(prompt, raw),
                                  max_new=max_new, temperature=temperature,
                                  eos_id=self._stops(), timeout_s=timeout_s,
                                  **samp)

    def submit_messages(self, messages, max_new: int = 128,
                        temperature: float = 0.0,
                        timeout_s: float | None = None, tools=None,
                        **samp) -> Request:
        """Multi-turn chat submission (the /v1/chat/completions body)."""
        return self.engine.submit(self.encode_messages(messages, tools),
                                  max_new=max_new, temperature=temperature,
                                  eos_id=self._stops(), timeout_s=timeout_s,
                                  **samp)

    def _visible(self, req: Request) -> list[int]:
        toks = list(req.tokens)
        # only strip a TRAILING end token: re-decoding a stable prefix is
        # what keeps streamed deltas append-only
        while toks and self.tok.is_end(toks[-1]):
            toks.pop()
        return toks

    def text(self, req: Request) -> str:
        return self.tok.decode(self._visible(req))

    def logprobs_payload(self, req: Request, chat: bool = False,
                         n_top: int = 0, max_chars: int | None = None):
        """OpenAI logprobs object for a finished request (the engine
        recorded ``Request.lp`` rows because submit got logprobs=k).

        Completions shape: {tokens, token_logprobs, top_logprobs,
        text_offset}; chat shape: {content: [{token, logprob, bytes,
        top_logprobs: [...]}]}. Token strings decode per id — a
        multi-byte char split across ids shows U+FFFD here by design
        (the OpenAI schema is per-token; joined text is the text field).
        Covers visible tokens only (trailing end tokens stripped, same
        as text()); ``max_chars`` further cuts to tokens starting before
        that text offset (host-side stop-sequence truncation — the
        payload stays aligned with the truncated text field)."""
        out = self._lp_build(req, 0, chat, n_top, max_chars)[0]
        if out is None:                   # zero visible tokens: empty shape
            out = {"content": []} if chat else {
                "tokens": [], "token_logprobs": [],
                "top_logprobs": [] if n_top else None, "text_offset": []}
        return out

    def logprobs_delta(self, req: Request, start: int, chat: bool = False,
                       n_top: int = 0, max_chars: int | None = None):
        """Streaming slice of logprobs_payload: entries for visible
        tokens [start:] whose rows have materialized -> (payload | None,
        next_start). text_offset stays absolute (offsets into the full
        generated text), so concatenating chunk payloads reconstructs
        the non-streamed object."""
        return self._lp_build(req, start, chat, n_top, max_chars)

    def _lp_build(self, req, start, chat, n_top, max_chars):
        toks = self._visible(req)
        rows = req.lp[:len(toks)]
        # per-request decode cache: streaming polls call this every few
        # ms, and re-decoding EVERY visible token per poll is O(n^2) over
        # a long generation — tokens only append (a trailing end token
        # retires the request), so cached (string, cumulative end offset)
        # pairs stay valid and each poll decodes only the new slice
        cache = getattr(req, "_lp_dec", None)
        if cache is None:
            cache = req._lp_dec = []
        while len(cache) < len(rows):
            i = len(cache)
            s = self.tok.decode([toks[i]])
            cache.append((s, (cache[-1][1] if cache else 0) + len(s)))
        strs = [s for s, _ in cache[:len(rows)]]
        n = len(rows)
        if max_chars is not None:
            n = 0
            for _, end in cache[:len(rows)]:
                if end - len(strs[n]) >= max_chars:
                    break
                n += 1
        if start >= n:
            return None, max(start, n)

        def alts(row):
            return {self.tok.decode([i]): lp for i, lp in row[1][:n_top]}

        if not chat:
            offs = []
            pos = cache[start - 1][1] if start else 0
            for s in strs[start:n]:
                offs.append(pos)
                pos += len(s)
            return ({"tokens": strs[start:n],
                     "token_logprobs": [r[0] for r in rows[start:n]],
                     "top_logprobs": ([alts(r) for r in rows[start:n]]
                                      if n_top else None),
                     "text_offset": offs}, n)
        return ({"content": [
            {"token": s, "logprob": r[0], "bytes": list(s.encode()),
             "top_logprobs": [
                 {"token": self.tok.decode([i]), "logprob": lp,
                  "bytes": list(self.tok.decode([i]).encode())}
                 for i, lp in r[1][:n_top]]}
            for s, r in zip(strs[start:n], rows[start:n])]}, n)

    def score_ids(self, ids: list[int]):
        """Teacher-forcing prompt scores (llm.make_score_fn): [N-1] rows
        of (chosen_lp, [(alt_id, alt_lp) x K]) — row i-1 scores ids[i]
        given ids[:i]. Built lazily (one compiled chunk graph); the lock
        serializes scoring walks (each owns a fresh batch-1 KV state; XLA
        safely interleaves the dispatches with the engine thread's)."""
        with self._score_lock:
            if self._score is None:
                from ..models import llm
                self._score = llm.make_score_fn(self.engine.cfg)
            return self._score(self.engine.params, ids)

    def echo_logprobs(self, ids: list[int], n_top: int = 0):
        """Completions-shaped logprobs object for PROMPT tokens (the
        OpenAI ``echo`` surface): first entry null (no conditional for
        the first token), absolute text offsets from 0."""
        rows = self.score_ids(ids) if len(ids) > 1 else []
        strs = [self.tok.decode([t]) for t in ids]
        offs, pos = [], 0
        for s in strs:
            offs.append(pos)
            pos += len(s)

        def alts(row):
            return {self.tok.decode([i]): lp for i, lp in row[1][:n_top]}

        return {"tokens": strs,
                "token_logprobs": [None] + [r[0] for r in rows],
                "top_logprobs": ([None] + [alts(r) for r in rows]
                                 if n_top else None),
                "text_offset": offs}

    def text_delta(self, req: Request, seen: str) -> str:
        """Newly-decodable text past ``seen`` (monotone under streaming).

        BPE ids decode to byte runs, so a char split ACROSS tokens shows
        up transiently as a trailing U+FFFD (LLMTokenizer.decode uses
        errors="replace") — hold trailing replacement chars back until
        the request finishes, which keeps the emitted stream append-only."""
        full = self.text(req)
        if not req.done:
            while full.endswith("�"):
                full = full[:-1]
        return full[len(seen):] if full.startswith(seen) else full
