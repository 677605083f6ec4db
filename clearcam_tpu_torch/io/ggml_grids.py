"""ggml IQ-quant lattice tables.

The IQ* dequant formats (reference utils/gguf.py:73-105) combine three kinds
of constants:

  * `kvalues_iq4nl` — the 16-entry IQ4 non-linear codebook. Small and public;
    inlined below (ggml-common.h).
  * the sign-parity table — 7 stored sign bits + 1 parity bit; derived here.
  * `iq3xxs_grid` / `iq3s_grid` / `iq2s_grid` — 256/512/1024-entry lattice
    codebooks chosen by offline clustering in ggml. These are pure data (several
    KB of magic words, not derivable); they ship with every llama.cpp / tinygrad
    checkout. This sandbox has neither and no network, so they load from
    `weights/ggml_grids.npz` produced by `tools/extract_ggml_grids.py` (one
    command against any llama.cpp `ggml-common.h` or tinygrad
    `ggml_common.py`). All surrounding bit-plumbing is implemented and tested
    against synthetic grids; with the npz in place the IQ formats decode
    end-to-end.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# IQ4 non-linear 4-bit codebook (ggml-common.h kvalues_iq4nl).
KVALUES_IQ4NL = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    np.float32)

# expected raw-word shapes in the npz: (name, dtype, count, bytes-per-word)
GRID_SPECS = {
    "iq3xxs_grid": (np.uint32, 256, 4),
    "iq3s_grid": (np.uint32, 512, 4),
    "iq2s_grid": (np.uint64, 1024, 8),
}

_cache: dict[str, np.ndarray] | None = None


def sign_parity_table() -> np.ndarray:
    """ksigns: 7-bit sign index -> 8 sign bits; bit 7 completes even parity
    (ggml ksigns_iq2xs). Derivable, so computed rather than shipped."""
    idx = np.arange(128, dtype=np.uint8)
    pop = np.array([bin(i).count("1") & 1 for i in range(128)], np.uint8)
    return idx | (pop << 7)


KSIGNS = sign_parity_table()


def words_to_bytes(words: np.ndarray, nbytes: int) -> np.ndarray:
    """Unpack packed grid words into per-element byte values
    (reference gguf.py:10-13): entry e, lane i = (w[e] >> 8i) & 0xFF."""
    shifts = (8 * np.arange(nbytes, dtype=np.uint64))[None, :]
    return ((words[:, None].astype(np.uint64) >> shifts) & 0xFF).astype(np.uint8)


def _grid_paths() -> list[Path]:
    repo = Path(__file__).resolve().parent.parent.parent
    out = []
    if env := os.environ.get("CLEARCAM_GGML_GRIDS"):
        out.append(Path(env))
    out += [Path("weights/ggml_grids.npz"), repo / "weights/ggml_grids.npz"]
    return out


def set_grids(raw: dict[str, np.ndarray] | None) -> None:
    """Inject raw grid words (tests) or clear the cache (None)."""
    global _cache
    if raw is None:
        _cache = None
        return
    _cache = {name: words_to_bytes(np.asarray(raw[name], dt), nb)
              for name, (dt, n, nb) in GRID_SPECS.items()}


def load_grids() -> dict[str, np.ndarray]:
    """-> {name: uint8 [entries, lanes]} byte-expanded lattice tables."""
    global _cache
    if _cache is not None:
        return _cache
    for p in _grid_paths():
        if p.exists():
            with np.load(p) as z:
                raw = {k: z[k] for k in z.files}
            for name, (dt, n, _) in GRID_SPECS.items():
                if name not in raw or raw[name].shape != (n,):
                    raise ValueError(f"{p}: bad or missing {name}")
            set_grids(raw)
            return _cache
    raise FileNotFoundError(
        "IQ lattice tables not found. Run tools/extract_ggml_grids.py "
        "against a llama.cpp ggml-common.h (or tinygrad ggml_common.py) to "
        "produce weights/ggml_grids.npz, or set CLEARCAM_GGML_GRIDS.")
