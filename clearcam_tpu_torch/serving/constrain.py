"""Device-side constrained decoding (OpenAI ``response_format`` JSON mode).

A depth-bounded JSON grammar is compiled to a byte-level DFA, then lifted
to a TOKEN-level transition table ``trans[S, V] int16`` where ``trans[s, t]``
is the state after emitting vocab token ``t`` from state ``s`` and ``-1``
means "token t is not allowed in state s". The serving graphs
(llm.make_serving_fns(constraints=True)) keep one int32 state per slot,
gather ``trans[state]`` each step, mask disallowed logits to -inf before
sampling, and advance the state with the token they just sampled — so
constraint enforcement costs ONE [B, V] int16 gather inside the compiled
decode graph: no host round trip, no dynamic shapes, composing with the
lagged token fetch that makes the engine fast through a high-latency link.

This is the vLLM/outlines FSM-masking idea re-designed for XLA: instead of
a host-side mask computed per step (which would stall the dispatch
pipeline the engine exists to keep full), the WHOLE automaton ships to the
device once as data. The reference has no structured-output support at
all (its sampler is temperature-only Gumbel, utils/model.py:318-319).

Grammar notes (deliberate bounds — all checked by tests/test_constrain.py):
- The root value is an OBJECT (OpenAI json_object semantics) and nesting
  is bounded at ``max_depth`` containers; the automaton state enumerates
  the container-type stack exactly, so brackets always match.
- Strings enforce full UTF-8 structure (continuation ranges incl. the
  E0/ED/F0/F4 special cases) — a byte-fallback BPE token carrying an
  invalid sequence can never enter a string, so finished outputs always
  ``json.loads``.
- In the ACCEPT state (root object closed) only EOS is allowed: generation
  terminates immediately instead of rambling trailing whitespace.
- From any live state at least one single-byte continuation exists, so a
  byte-fallback vocab can never paint itself into a corner.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

_WS = (0x20, 0x09, 0x0A, 0x0D)
_HEX = tuple(b"0123456789abcdefABCDEF")
_DIGITS = tuple(b"0123456789")
_ESCAPABLE = tuple(b'"\\/bfnrt')

# string-interior tags per string kind (K = object key, V = value):
# STR body, ESC after backslash, U1..U4 inside \uXXXX, and the UTF-8
# continuation states (B1 = one continuation byte left, B2_*/B3_* = two /
# three left with the first byte range-restricted per RFC 3629)
_STR_TAGS = ("STR", "ESC", "U1", "U2", "U3", "U4",
             "B1", "B2_ANY", "B2_E0", "B2_ED", "B3_ANY", "B3_F0", "B3_F4")


def _str_next(kind: str, tag: str, c: int, end_key):
    """Transitions inside a string of ``kind`` ('K'|'V'); ``end_key`` is the
    (stack, tag) to enter when the closing quote lands."""
    t = tag[1:]                               # strip kind prefix
    if t == "STR":
        if c == 0x22:                         # "
            return end_key
        if c == 0x5C:                         # backslash
            return kind + "ESC"
        if c < 0x20:
            return None
        if c <= 0x7F:
            return kind + "STR"
        if 0xC2 <= c <= 0xDF:
            return kind + "B1"
        if c == 0xE0:
            return kind + "B2_E0"
        if c == 0xED:
            return kind + "B2_ED"
        if 0xE1 <= c <= 0xEF:                 # E1-EC, EE-EF (ED handled)
            return kind + "B2_ANY"
        if c == 0xF0:
            return kind + "B3_F0"
        if 0xF1 <= c <= 0xF3:
            return kind + "B3_ANY"
        if c == 0xF4:
            return kind + "B3_F4"
        return None
    if t == "ESC":
        if c in _ESCAPABLE:
            return kind + "STR"
        if c == 0x75:                         # u
            return kind + "U1"
        return None
    if t in ("U1", "U2", "U3"):
        return kind + "U" + str(int(t[1]) + 1) if c in _HEX else None
    if t == "U4":
        return kind + "STR" if c in _HEX else None
    if t == "B1":
        return kind + "STR" if 0x80 <= c <= 0xBF else None
    if t == "B2_ANY":
        return kind + "B1" if 0x80 <= c <= 0xBF else None
    if t == "B2_E0":
        return kind + "B1" if 0xA0 <= c <= 0xBF else None
    if t == "B2_ED":
        return kind + "B1" if 0x80 <= c <= 0x9F else None
    if t == "B3_F0":
        return kind + "B2_ANY" if 0x90 <= c <= 0xBF else None
    if t == "B3_ANY":
        return kind + "B2_ANY" if 0x80 <= c <= 0xBF else None
    if t == "B3_F4":
        return kind + "B2_ANY" if 0x80 <= c <= 0x8F else None
    raise AssertionError(tag)


def _json_next(key, c: int, max_depth: int):
    """Byte transition of the depth-bounded JSON automaton.

    ``key`` is (stack, tag): ``stack`` a tuple over 'O'/'A' (innermost
    last), ``tag`` the lexical position inside the current container.
    Returns the next key or None (byte not allowed)."""
    stack, tag = key

    def push(kind):
        if len(stack) >= max_depth:
            return None
        s2 = stack + (kind,)
        return (s2, "KEY0") if kind == "O" else (s2, "ELEM0")

    def pop():
        s2 = stack[:-1]
        return ((), "ACCEPT") if not s2 else (s2, "AFTER")

    def value_start(c):
        """Dispatch at a value position (VAL / ELEM0)."""
        if c == 0x22:
            return (stack, "VSTR")
        if c == 0x7B:                          # {
            return push("O")
        if c == 0x5B:                          # [
            return push("A")
        if c == 0x2D:                          # -
            return (stack, "NMINUS")
        if c == 0x30:                          # 0
            return (stack, "NZERO")
        if c in _DIGITS:                       # 1-9
            return (stack, "NINT")
        if c == 0x74:                          # t
            return (stack, "LT1")
        if c == 0x66:                          # f
            return (stack, "LF1")
        if c == 0x6E:                          # n
            return (stack, "LN1")
        return None

    def after(c):
        """Dispatch after a complete value inside the current container."""
        if c in _WS:
            return (stack, "AFTER")
        top = stack[-1]
        if top == "O":
            if c == 0x2C:                      # ,
                return (stack, "KEY")
            if c == 0x7D:                      # }
                return pop()
        else:
            if c == 0x2C:
                return (stack, "VAL")
            if c == 0x5D:                      # ]
                return pop()
        return None

    if tag == "START":
        if c in _WS:
            return key
        if c == 0x7B:
            return push("O")
        return None
    if tag == "ACCEPT":
        return None                            # EOS only (token table)
    if tag == "KEY0":                          # just opened an object
        if c in _WS:
            return key
        if c == 0x22:
            return (stack, "KSTR")
        if c == 0x7D:
            return pop()
        return None
    if tag == "KEY":                           # after ',' in an object
        if c in _WS:
            return key
        return (stack, "KSTR") if c == 0x22 else None
    if tag == "COLON":
        if c in _WS:
            return key
        return (stack, "VAL") if c == 0x3A else None
    if tag in ("VAL", "ELEM0"):
        if c in _WS:
            return key
        if tag == "ELEM0" and c == 0x5D:       # empty array
            return pop()
        return value_start(c)
    if tag == "AFTER":
        return after(c)
    if tag[0] in "KV" and tag[1:] in _STR_TAGS:
        end = (stack, "COLON") if tag[0] == "K" else (stack, "AFTER")
        nxt = _str_next(tag[0], tag, c, end)
        if nxt is None or isinstance(nxt, tuple):
            return nxt
        return (stack, nxt)
    # numbers: a delimiter byte completes the number AND acts from AFTER
    if tag == "NMINUS":
        if c == 0x30:
            return (stack, "NZERO")
        return (stack, "NINT") if c in _DIGITS else None
    if tag in ("NZERO", "NINT", "NFRAC", "NEXP"):
        if tag in ("NZERO", "NINT"):
            if c == 0x2E:                      # .
                return (stack, "NDOT")
            if c in (0x65, 0x45):              # e E
                return (stack, "NE")
            if tag == "NINT" and c in _DIGITS:
                return (stack, "NINT")
        if tag == "NFRAC":
            if c in _DIGITS:
                return (stack, "NFRAC")
            if c in (0x65, 0x45):
                return (stack, "NE")
        if tag == "NEXP" and c in _DIGITS:
            return (stack, "NEXP")
        return after(c)
    if tag == "NDOT":
        return (stack, "NFRAC") if c in _DIGITS else None
    if tag == "NE":
        if c in (0x2B, 0x2D):
            return (stack, "NESIGN")
        return (stack, "NEXP") if c in _DIGITS else None
    if tag == "NESIGN":
        return (stack, "NEXP") if c in _DIGITS else None
    _LIT = {"LT1": (0x72, "LT2"), "LT2": (0x75, "LT3"), "LT3": (0x65, "AFTER"),
            "LF1": (0x61, "LF2"), "LF2": (0x6C, "LF3"), "LF3": (0x73, "LF4"),
            "LF4": (0x65, "AFTER"),
            "LN1": (0x75, "LN2"), "LN2": (0x6C, "LN3"), "LN3": (0x6C, "AFTER")}
    want, nxt = _LIT[tag]
    return (stack, nxt) if c == want else None


@dataclass
class CharDFA:
    """Byte-level DFA: ``trans[S, 256] int16`` (-1 = dead), plus start /
    accepting state indices."""
    trans: np.ndarray
    start: int
    accepting: np.ndarray      # bool [S]


def json_char_dfa(max_depth: int = 4) -> CharDFA:
    """Compile the depth-bounded JSON grammar (root = object) to a byte
    DFA by BFS over reachable (container-stack, lexical-tag) states."""
    ids: dict = {((), "START"): 0}
    rows: list[np.ndarray] = []
    work = [((), "START")]
    while work:
        key = work.pop()
        row = np.full(256, -1, np.int16)
        for c in range(256):
            nxt = _json_next(key, c, max_depth)
            if nxt is None:
                continue
            if nxt not in ids:
                ids[nxt] = len(ids)
                rows.append(None)               # placeholder, filled later
                work.append(nxt)
            row[c] = ids[nxt]
        while len(rows) < len(ids):
            rows.append(None)
        rows[ids[key]] = row
    trans = np.stack(rows)
    acc = np.zeros(len(ids), bool)
    for key, i in ids.items():
        acc[i] = key[1] == "ACCEPT"
    return CharDFA(trans, 0, acc)


def run_char_dfa(dfa: CharDFA, data: bytes, state: int | None = None) -> int:
    """Feed bytes; returns the final state or -1 once dead (tests/sims)."""
    s = dfa.start if state is None else state
    for b in data:
        if s < 0:
            return -1
        s = int(dfa.trans[s, b])
    return s


@dataclass
class TokenConstraint:
    """Token-level constraint automaton: ``trans[S, V] int16`` (-1 = token
    disallowed), ``start`` the generation-time initial state, ``accepting``
    bool [S]. Built once per (grammar, vocab); shared across requests."""
    trans: np.ndarray
    start: int
    accepting: np.ndarray
    name: str = "json"


def token_table(dfa: CharDFA, vocab: list, eos_ids: list[int],
                n_vocab: int | None = None,
                name: str = "json") -> TokenConstraint:
    """Lift a byte DFA to the token level. ``vocab[t]`` is token t's raw
    byte string, or None for special/control tokens (disallowed under the
    constraint). EOS ids are allowed exactly in accepting states (self-
    loop, so the engine's normal eos retirement fires). Vectorized by
    token length: the whole table is a handful of numpy gathers."""
    S = dfa.trans.shape[0]
    V = n_vocab if n_vocab is not None else len(vocab)
    out = np.full((S, V), -1, np.int16)
    by_len: dict[int, list[int]] = defaultdict(list)
    for t, b in enumerate(vocab):
        if t < V and b:
            by_len[len(b)].append(t)
    for L, ids in sorted(by_len.items()):
        ids_a = np.asarray(ids)
        bb = np.frombuffer(b"".join(vocab[t] for t in ids), np.uint8) \
            .reshape(len(ids), L)
        cur = np.broadcast_to(np.arange(S, dtype=np.int16)[:, None],
                              (S, len(ids))).copy()
        for j in range(L):
            nxt = dfa.trans[np.maximum(cur, 0), bb[None, :, j]]
            cur = np.where(cur >= 0, nxt, np.int16(-1))
        out[:, ids_a] = cur
    acc_rows = np.flatnonzero(dfa.accepting)
    for e in eos_ids:
        if e is not None and 0 <= e < V:
            out[:, e] = -1
            out[acc_rows, e] = acc_rows.astype(np.int16)  # self-loop
    return TokenConstraint(out, dfa.start, dfa.accepting.copy(), name=name)


def vocab_bytes_of(tok, n_vocab: int) -> list:
    """Raw byte string per vocab id (None = special/unmapped, disallowed
    under any constraint). Accepts an LLMTokenizer (``normal``: bytes ->
    id) or anything exposing ``vocab_bytes()`` (synthetic tokenizers)."""
    if hasattr(tok, "vocab_bytes"):
        vb = list(tok.vocab_bytes())
        return vb[:n_vocab] + [None] * (n_vocab - len(vb))
    vocab: list = [None] * n_vocab
    for b, tid in tok.normal.items():
        if tid < n_vocab:
            vocab[tid] = b
    return vocab


def _eos_of(tok) -> list:
    return [tok.eos_id, getattr(tok, "eot_id", None)]


def json_token_constraint(tok, n_vocab: int,
                          max_depth: int = 4) -> TokenConstraint:
    """JSON-mode constraint for a tokenizer: normal tokens constrain by
    their raw bytes, special tokens are disallowed, eos/eot terminate
    accepting states."""
    return token_table(json_char_dfa(max_depth),
                       vocab_bytes_of(tok, n_vocab), _eos_of(tok), n_vocab)


def schema_token_constraint(tok, n_vocab: int, schema: dict,
                            max_items: int = 16) -> TokenConstraint:
    """OpenAI structured outputs: response_format json_schema — see
    schema_char_dfa for the supported subset (raises ValueError on
    unsupported constructs)."""
    return token_table(schema_char_dfa(schema, max_items),
                       vocab_bytes_of(tok, n_vocab), _eos_of(tok), n_vocab,
                       name="schema")


def choice_token_constraint(tok, n_vocab: int,
                            options: list[str]) -> TokenConstraint:
    """Guided choice: output is exactly one of ``options`` (raw text)."""
    return token_table(choice_char_dfa(options),
                       vocab_bytes_of(tok, n_vocab), _eos_of(tok), n_vocab,
                       name="choice")


# -- schema / choice grammars -------------------------------------------------
#
# Beyond free-form JSON mode: compile a JSON-Schema subset (OpenAI
# "json_schema" structured outputs) or a literal-choice list (vLLM-style
# guided_choice) to the same byte-DFA -> token-table pipeline. These
# automatons are built per request shape, so they are small (tens to a
# few hundred states) and register into a serving engine's padded device
# table at runtime (ServingEngine.register_constraint) — no recompile:
# the table SHAPE is fixed, only rows upload.

class _Graph:
    """Mutable byte-DFA builder: integer states, per-state {byte: next}."""

    def __init__(self):
        self.rows: list[dict[int, int]] = []
        self.accepting: set[int] = set()
        # (number-complete state, exit state): the delimiter byte that ends
        # a number belongs to the CONTEXT AFTER the number, so complete
        # states inherit the exit's out-edges (and acceptance) in a final
        # pass, once the whole graph is wired
        self._forward: list[tuple[int, int]] = []

    def new(self) -> int:
        self.rows.append({})
        return len(self.rows) - 1

    def edge(self, s: int, bts, t: int) -> None:
        for b in bts:
            if b in self.rows[s] and self.rows[s][b] != t:
                # e.g. anyOf over two object schemas: both start with '{',
                # so the automaton can't tell which branch it is in
                raise ValueError(
                    "grammar alternatives are not byte-deterministic "
                    f"(conflict on byte {b:#x})")
            self.rows[s][b] = t

    def chain(self, s: int, data: bytes) -> int:
        for b in data:
            t = self.rows[s].get(b)
            if t is None:
                t = self.new()
                self.edge(s, [b], t)
            s = t
        return s

    def ws_loop(self, s: int) -> None:
        self.edge(s, _WS, s)

    def finish(self) -> CharDFA:
        for st, exit_ in self._forward:
            for b, t in self.rows[exit_].items():
                self.rows[st].setdefault(b, t)
            if exit_ in self.accepting:
                self.accepting.add(st)
        trans = np.full((len(self.rows), 256), -1, np.int16)
        for i, row in enumerate(self.rows):
            for b, t in row.items():
                trans[i, b] = t
        acc = np.zeros(len(self.rows), bool)
        acc[list(self.accepting)] = True
        return CharDFA(trans, 0, acc)


def _wire_string_body(g: _Graph, s: int, exit_: int) -> None:
    """Wire a JSON string BODY (after the opening quote) ending at
    ``exit_`` on the closing quote — same byte classes as _str_next
    (escapes, \\uXXXX, full UTF-8 continuation structure)."""
    esc, u = g.new(), [g.new() for _ in range(4)]
    b1, b2a, b2e0, b2ed, b3a, b3f0, b3f4 = (g.new() for _ in range(7))
    g.edge(s, [0x22], exit_)
    g.edge(s, [0x5C], esc)
    g.edge(s, [c for c in range(0x20, 0x7F + 1) if c not in (0x22, 0x5C)], s)
    g.edge(s, range(0xC2, 0xE0), b1)
    g.edge(s, [0xE0], b2e0)
    g.edge(s, [0xED], b2ed)
    g.edge(s, [c for c in range(0xE1, 0xF0) if c != 0xED], b2a)
    g.edge(s, [0xF0], b3f0)
    g.edge(s, range(0xF1, 0xF4), b3a)
    g.edge(s, [0xF4], b3f4)
    g.edge(esc, _ESCAPABLE, s)
    g.edge(esc, [0x75], u[0])
    for a, b in zip(u, u[1:] + [None]):
        g.edge(a, _HEX, s if b is None else b)
    g.edge(b1, range(0x80, 0xC0), s)
    g.edge(b2a, range(0x80, 0xC0), b1)
    g.edge(b2e0, range(0xA0, 0xC0), b1)
    g.edge(b2ed, range(0x80, 0xA0), b1)
    g.edge(b3a, range(0x80, 0xC0), b2a)
    g.edge(b3f0, range(0x90, 0xC0), b2a)
    g.edge(b3f4, range(0x80, 0x90), b2a)


def _wire_number(g: _Graph, s: int, exit_: int, integer: bool) -> None:
    """JSON number (or integer) from value state ``s``; complete states
    forward-inherit ``exit_``'s edges (delimiter-terminated)."""
    minus, zero, intg = g.new(), g.new(), g.new()
    g.edge(s, [0x2D], minus)
    g.edge(s, [0x30], zero)
    g.edge(s, _DIGITS[1:], intg)
    g.edge(minus, [0x30], zero)
    g.edge(minus, _DIGITS[1:], intg)
    g.edge(intg, _DIGITS, intg)
    complete = [zero, intg]
    if not integer:
        dot, frac, e, esign, exp = (g.new() for _ in range(5))
        g.edge(zero, [0x2E], dot)
        g.edge(intg, [0x2E], dot)
        g.edge(dot, _DIGITS, frac)
        g.edge(frac, _DIGITS, frac)
        for st in (zero, intg, frac):
            g.edge(st, (0x65, 0x45), e)
        g.edge(e, (0x2B, 0x2D), esign)
        g.edge(e, _DIGITS, exp)
        g.edge(esign, _DIGITS, exp)
        g.edge(exp, _DIGITS, exp)
        complete.append(frac)
        complete.append(exp)
    g._forward.extend((st, exit_) for st in complete)


def _wire_trie(g: _Graph, s: int, literals: list[bytes], exit_: int) -> None:
    """Deterministic trie over ``literals`` from ``s``; each complete
    literal lands on ``exit_`` (shared prefixes merge; a literal that
    prefixes another still exits exactly at its own end)."""
    if not literals or len(set(literals)) != len(literals):
        raise ValueError("choice literals must be non-empty and distinct")
    for a in literals:
        if not a:
            raise ValueError("empty literal")
        for b in literals:
            if a != b and b.startswith(a):
                raise ValueError(
                    f"literal {a!r} is a proper prefix of {b!r} — the "
                    "trie could not tell where the short one ends")
    for lit in literals:
        g.edge(g.chain(s, lit[:-1]), [lit[-1]], exit_)


def _wire_value(g: _Graph, s: int, exit_: int, schema: dict,
                max_items: int) -> None:
    """Compile one schema node: from value-start ``s`` (ws-looped by the
    caller) to ``exit_``."""
    if not isinstance(schema, dict):
        raise ValueError(f"unsupported schema node {schema!r}")
    if "enum" in schema or "const" in schema:
        opts = schema.get("enum", [schema.get("const")])
        lits = [json.dumps(v, ensure_ascii=False).encode() for v in opts]
        _wire_trie(g, s, lits, exit_)
        return
    if "anyOf" in schema:
        # byte-disjoint alternatives share the value-start state: string
        # ("), number (digit/-), object ({), array ([), boolean (t/f),
        # null (n) all dispatch on their first byte; two alternatives of
        # the SAME shape conflict and raise (edge determinism check)
        if not schema["anyOf"]:
            raise ValueError("empty anyOf")
        for sub in schema["anyOf"]:
            _wire_value(g, s, exit_, sub, max_items)
        return
    t = schema.get("type")
    if isinstance(t, list):
        # union type, e.g. ["string", "null"] — the common nullable field
        for tt in t:
            _wire_value(g, s, exit_, {**schema, "type": tt}, max_items)
        return
    if t == "string":
        body = g.new()
        g.edge(s, [0x22], body)
        _wire_string_body(g, body, exit_)
    elif t in ("integer", "number"):
        _wire_number(g, s, exit_, integer=t == "integer")
    elif t == "boolean":
        _wire_trie(g, s, [b"true", b"false"], exit_)
    elif t == "null":
        g.edge(g.chain(s, b"nul"), [0x6C], exit_)
    elif t == "object":
        props = schema.get("properties") or {}
        first = g.new()
        g.edge(s, [0x7B], first)              # {
        g.ws_loop(first)
        cur = first
        names = list(props)
        for i, name in enumerate(names):
            key = json.dumps(name, ensure_ascii=False).encode()
            st = g.chain(cur, key)
            g.ws_loop(st)
            colon = g.new()
            g.edge(st, [0x3A], colon)         # :
            g.ws_loop(colon)
            after = g.new()
            _wire_value(g, colon, after, props[name], max_items)
            g.ws_loop(after)
            if i + 1 < len(names):
                nxt = g.new()
                g.edge(after, [0x2C], nxt)    # ,
                g.ws_loop(nxt)
                cur = nxt
            else:
                g.edge(after, [0x7D], exit_)  # }
        if not names:
            g.edge(first, [0x7D], exit_)
    elif t == "array":
        items = schema.get("items") or {"type": "string"}
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", max_items))
        if not 0 <= lo <= hi or hi > 256:
            raise ValueError(f"bad minItems/maxItems {lo}/{hi}")
        open_ = g.new()
        g.edge(s, [0x5B], open_)              # [
        g.ws_loop(open_)
        if lo == 0:
            g.edge(open_, [0x5D], exit_)      # empty array
        cur = open_
        for k in range(hi):                   # cur expects item k
            after = g.new()
            _wire_value(g, cur, after, items, max_items)
            g.ws_loop(after)
            if k + 1 >= lo:
                g.edge(after, [0x5D], exit_)  # ] only once lo items landed
            if k + 1 < hi:
                nxt = g.new()
                g.edge(after, [0x2C], nxt)    # , -> item k+1 REQUIRED next
                g.ws_loop(nxt)
                cur = nxt
    else:
        raise ValueError(f"unsupported schema node {schema!r} (supported: "
                         "enum/const, string, integer, number, boolean, "
                         "null, object w/ fixed properties, array w/ "
                         "bounded items)")


def schema_char_dfa(schema: dict, max_items: int = 16) -> CharDFA:
    """Compile a JSON-Schema SUBSET to a byte DFA (OpenAI structured-
    outputs style): objects emit every declared property in declaration
    order (strict mode semantics — all properties required, no
    additionalProperties), arrays are bounded ([minItems, maxItems],
    default maxItems=``max_items``), and leaves are string / integer /
    number / boolean / null / enum / const. Unsupported constructs raise
    ValueError (the HTTP surface maps that to 400). Whitespace is allowed
    wherever JSON allows it; the final state accepts EOS only."""
    g = _Graph()
    start = g.new()
    assert start == 0
    g.ws_loop(start)
    end = g.new()
    _wire_value(g, start, end, schema, max_items)
    g.accepting.add(end)
    return g.finish()


def choice_char_dfa(options: list[str]) -> CharDFA:
    """Byte DFA accepting exactly one of ``options`` (raw text, not JSON
    — the guided-choice classification surface)."""
    g = _Graph()
    start = g.new()
    end = g.new()
    _wire_trie(g, start, [o.encode() for o in options], end)
    g.accepting.add(end)
    return g.finish()


def concat_constraints(cons: dict[str, TokenConstraint]):
    """Pack multiple constraints into ONE [S_total, V] table (disjoint row
    blocks, transitions offset by each block's base) so an engine can
    serve several grammars with a single device-resident table; returns
    (table, {name: start_state})."""
    assert cons
    V = {c.trans.shape[1] for c in cons.values()}
    assert len(V) == 1, "constraint tables must share the vocab width"
    tables, starts, base = [], {}, 0
    for name, c in cons.items():
        t = c.trans.astype(np.int32)
        t = np.where(t >= 0, t + base, -1)
        tables.append(t)
        starts[name] = base + c.start
        base += c.trans.shape[0]
    assert base < np.iinfo(np.int16).max, "combined constraint table too tall"
    return np.concatenate(tables).astype(np.int16), starts
