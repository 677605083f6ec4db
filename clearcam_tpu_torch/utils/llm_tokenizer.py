"""GGUF-vocab BPE tokenizer with chat presets.

Clean-room equivalent of the reference's GGUF tokenizer
(llm/qwen3vl.py:12-90): vocab + token types straight from GGUF metadata,
GPT-2 byte<->unicode remap, greedy lowest-merged-id BPE, special-token
splitting, and per-preset chat role/turn framing (qwen2, llama3, olmo,
kimi-k2, glm4, tekken).

The llama.cpp llama3/qwen2 pre-tokenizer regex is reproduced as an explicit
scanner (contractions | optional-prefix letter runs | 1-3 digit runs |
punctuation runs with trailing newlines | newline whitespace | whitespace
lookahead) — no `regex` package needed.
"""
from __future__ import annotations

import sys
import unicodedata
from functools import lru_cache

PRESET_ALIASES = {"qwen35": "qwen2", "qwen35moe": "qwen2", "llama-v3": "llama3",
                  "llama-bpe": "llama3"}
KNOWN_PRESETS = ("llama3", "qwen2", "olmo", "kimi-k2", "tekken", "glm4")


@lru_cache()
def _byte_decoder() -> dict[str, int]:
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    dec = {chr(b): b for b in printable}
    extra = 0
    for b in range(256):
        if b not in printable:
            dec[chr(256 + extra)] = b
            extra += 1
    return dec


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_digit(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_ws(ch: str) -> bool:
    return ch in "\t\n\x0b\x0c\r\x85 " or unicodedata.category(ch).startswith("Z")


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def pre_tokenize(text: str) -> list[str]:
    """llama3/qwen2 word splitter: contractions | [^\\r\\n N L]? L+ | N{1,3}
    | " "? symbol-run + trailing newlines | ws*newlines+ | ws+(lookahead) | ws+.
    """
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        # (?i:'s|'t|'re|'ve|'m|'ll|'d)
        if ch == "'":
            low = text[i:i + 3].lower()
            hit = next((c for c in _CONTRACTIONS if low.startswith(c)), None)
            if hit:
                out.append(text[i:i + len(hit)])
                i += len(hit)
                continue
        # [^\r\n N L]? [L]+  (the optional prefix may be any symbol incl. space)
        if _is_letter(ch) or (ch not in "\r\n" and not _is_digit(ch)
                              and i + 1 < n and _is_letter(text[i + 1])):
            j = (i if _is_letter(ch) else i + 1)
            start = i
            while j < n and _is_letter(text[j]):
                j += 1
            out.append(text[start:j])
            i = j
            continue
        # [N]{1,3}
        if _is_digit(ch):
            j = i
            while j < n and j < i + 3 and _is_digit(text[j]):
                j += 1
            out.append(text[i:j])
            i = j
            continue
        #  " "? [^ws N L]+ [\r\n]*
        is_sym = lambda c: (not _is_ws(c) and not _is_letter(c)  # noqa: E731
                            and not _is_digit(c))
        if is_sym(ch) or (ch == " " and i + 1 < n and is_sym(text[i + 1])):
            start = i
            j = i + 1 if ch == " " else i
            while j < n and is_sym(text[j]):
                j += 1
            while j < n and text[j] in "\r\n":
                j += 1
            out.append(text[start:j])
            i = j
            continue
        # whitespace run
        j = i
        while j < n and _is_ws(text[j]):
            j += 1
        ws = text[i:j]
        last_nl = max(ws.rfind("\n"), ws.rfind("\r"))
        if last_nl >= 0:                       # [ws]*[\r\n]+ binds through nl
            out.append(ws[:last_nl + 1])
            i += last_nl + 1
        elif j >= n:                           # [ws]+ at end of text
            out.append(ws)
            i = j
        elif len(ws) > 1:                      # keep one space for the next token
            out.append(ws[:-1])
            i = j - 1
        else:                                  # lone space the next token rejects
            out.append(ws)
            i = j
    return out


class LLMTokenizer:
    def __init__(self, normal_tokens: dict[str, int],
                 special_tokens: dict[str, int], preset: str = "llama3",
                 bos_id: int | None = None, eos_id: int = 0,
                 eot_id: int | None = None):
        preset = PRESET_ALIASES.get(preset, preset)
        if preset not in KNOWN_PRESETS:
            raise ValueError(f"Invalid tokenizer preset '{preset}'")
        bd = _byte_decoder()
        self.normal: dict[bytes, int] = {
            bytes(bd[c] for c in tok): tid for tok, tid in normal_tokens.items()}
        self.special = dict(special_tokens)
        self._id2bytes = {tid: tok for tok, tid in self.normal.items()}
        self._id2bytes.update({tid: tok.encode() for tok, tid in self.special.items()})
        self.preset = preset
        self.bos_id, self.eos_id, self.eot_id = bos_id, eos_id, eot_id
        # longest-first special matching
        self._specials_sorted = sorted(self.special, key=len, reverse=True)

    @classmethod
    def from_gguf_kv(cls, kv: dict) -> "LLMTokenizer":
        tokens = kv["tokenizer.ggml.tokens"]
        types = kv["tokenizer.ggml.token_type"]
        normal, special = {}, {}
        for tid, tok in enumerate(tokens):
            (normal if types[tid] == 1 else special)[tok] = tid
        return cls(normal, special, kv.get("tokenizer.ggml.pre", "llama3"),
                   bos_id=(kv.get("tokenizer.ggml.bos_token_id")
                           if kv.get("tokenizer.ggml.add_bos_token", True) else None),
                   eos_id=kv.get("tokenizer.ggml.eos_token_id", 0),
                   eot_id=kv.get("tokenizer.ggml.eot_token_id"))

    def _encode_word(self, word: bytes) -> list[int]:
        """Greedy BPE: repeatedly merge the adjacent pair whose merged token
        has the LOWEST vocab id (llama.cpp rank order)."""
        if (tid := self.normal.get(word)) is not None:
            return [tid]
        parts = [bytes([b]) for b in word]
        while len(parts) > 1:
            best, best_rank = -1, sys.maxsize
            for j in range(len(parts) - 1):
                rank = self.normal.get(parts[j] + parts[j + 1], sys.maxsize)
                if rank < best_rank:
                    best, best_rank = j, rank
            if best < 0:
                break
            parts[best:best + 2] = [parts[best] + parts[best + 1]]
        return [self.normal[pt] for pt in parts]

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        pos = 0
        while pos < len(text):
            nxt, tok = len(text), None
            for sp in self._specials_sorted:
                found = text.find(sp, pos)
                if found != -1 and (found < nxt or (found == nxt and tok is None)):
                    nxt, tok = found, sp
            for word in pre_tokenize(text[pos:nxt]):
                ids.extend(self._encode_word(word.encode()))
            if tok is None:
                break
            ids.append(self.special[tok])
            pos = nxt + len(tok)
        return ids

    def decode(self, ids) -> str:
        return b"".join(self._id2bytes[int(t)] for t in ids).decode(errors="replace")

    # -- chat framing (qwen3vl.py:71-90) -----------------------------------
    def role(self, role: str) -> list[int]:
        if self.preset == "olmo":
            return self.encode("<|" + role + "|>\n")
        if self.preset == "kimi-k2":
            return self.encode("<|im_" + role + "|>" + role + "<|im_middle|>")
        if self.preset == "qwen2":
            return self.encode("<|im_start|>" + role + "\n")
        if self.preset == "glm4":
            return self.encode("<|" + role + "|>")
        if self.preset == "tekken":
            if role == "user":
                return self.encode("[INST]")
            if role == "assistant":
                return []
            raise ValueError(f"Unsupported role '{role}' for preset tekken")
        return self.encode("<|start_header_id|>" + role + "<|end_header_id|>\n\n")

    def end_turn(self) -> list[int]:
        if self.preset == "olmo":
            return self.encode("\n")
        if self.preset == "kimi-k2":
            return [self.eos_id]
        if self.preset == "qwen2":
            return [self.eos_id] + self.encode("\n")
        if self.preset == "glm4":
            return []
        if self.preset == "tekken":
            return self.encode("[/INST]")
        return [self.eos_id]

    def prefix(self) -> list[int]:
        pre = [] if self.bos_id is None else [self.bos_id]
        return pre + (self.encode("<sop>") if self.preset == "glm4" else [])

    def is_end(self, token_id: int) -> bool:
        return token_id in (self.eos_id, self.eot_id)
