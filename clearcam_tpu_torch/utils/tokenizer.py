"""CLIP BPE tokenizer (OpenAI vocab format).

Clean-room implementation of the standard CLIP byte-pair encoder the
reference bundles (utils/clip_tokenizer.py + bpe_simple_vocab_16e6.txt.gz):
byte->unicode remap, lowercase + whitespace cleanup, CLIP's word splitter
(contractions | letter runs | single digits | punctuation runs), ranked BPE
merges with the `</w>` end-of-word marker, and the 49408-token vocab with
<|startoftext|>/<|endoftext|>.

The vocab gz is a public OpenAI data artifact; supply it next to the model
weights (weights/bpe_simple_vocab_16e6.txt.gz) or pass an explicit path.
"""
from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from pathlib import Path

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CONTEXT_LENGTH = 77
N_MERGES = 48894  # merges used by CLIP: 49152 - 256 - 2


@lru_cache()
def byte_encoder() -> dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP convention)."""
    printable = (list(range(ord("!"), ord("~") + 1))
                 + list(range(ord("¡"), ord("¬") + 1))
                 + list(range(ord("®"), ord("ÿ") + 1)))
    mapping = {}
    extra = 0
    for b in range(256):
        if b in printable:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.split()).strip().lower()


def split_words(text: str) -> list[str]:
    """CLIP's tokenize pattern without the regex package: contractions,
    letter runs, single digits, non-space symbol runs."""
    out = []
    i, n = 0, len(text)
    contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
    while i < n:
        ch = text[i]
        hit = next((c for c in contractions if text.startswith(c, i)), None)
        if hit:
            out.append(hit)
            i += len(hit)
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("L"):
            j = i + 1
            while j < n and unicodedata.category(text[j]).startswith("L"):
                j += 1
            out.append(text[i:j])
            i = j
        elif cat.startswith("N"):
            out.append(ch)
            i += 1
        elif not ch.isspace():
            j = i + 1
            while (j < n and not text[j].isspace()
                   and not unicodedata.category(text[j]).startswith(("L", "N"))):
                j += 1
            out.append(text[i:j])
            i = j
        else:
            i += 1
    return out


def find_vocab(explicit: str | Path | None = None) -> Path | None:
    if explicit and Path(explicit).exists():
        return Path(explicit)
    cands = [
        os.environ.get("CLEARCAM_BPE_PATH"),
        "weights/bpe_simple_vocab_16e6.txt.gz",
        Path(__file__).parent / "bpe_simple_vocab_16e6.txt.gz",
    ]
    for c in cands:
        if c and Path(c).exists():
            return Path(c)
    return None


class CLIPTokenizer:
    def __init__(self, vocab_path: str | Path | None = None,
                 merges: list[tuple[str, str]] | None = None):
        be = byte_encoder()
        # Vocab id order follows the GPT-2/CLIP convention: printable bytes
        # first, then the remapped non-printables — equivalently, ascending
        # mapped codepoint (verified id-exact vs the reference tokenizer on
        # the real vocab, tests/test_tokenizer_golden.py).
        base = sorted(be.values(), key=ord)
        if merges is None:
            path = find_vocab(vocab_path)
            if path is None:
                raise FileNotFoundError(
                    "CLIP BPE vocab not found — place bpe_simple_vocab_16e6.txt.gz "
                    "in weights/ or set CLEARCAM_BPE_PATH")
            lines = gzip.open(path, "rt", encoding="utf-8").read().split("\n")
            merges = [tuple(l.split()) for l in lines[1:N_MERGES + 1]]
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        vocab = base + [t + "</w>" for t in base]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.byte_enc = be
        self.byte_dec = {v: k for k, v in be.items()}
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]
        self._cache: dict[str, list[str]] = {}

    def _bpe(self, word: str) -> list[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            merged = []
            i = 0
            while i < len(parts):
                if (i < len(parts) - 1 and (parts[i], parts[i + 1]) == best):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        ids = []
        for word in split_words(_clean(text)):
            mapped = "".join(self.byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids
                       if int(i) not in (self.sot_id, self.eot_id))
        raw = bytes(self.byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def encode_padded(self, text: str, length: int = CONTEXT_LENGTH) -> list[int]:
        """[SOT] tokens [EOT] zero-padded to the context length
        (reference objects.py:135-139)."""
        ids = [self.sot_id] + self.encode(text)[: length - 2] + [self.eot_id]
        return ids + [0] * (length - len(ids))
