"""Request traffic for an LLM serving engine, from a mix's parameters and a
seed.

A mix (``traffic/<name>.json`` with ``"generator": "requests"``) gives
``clients`` (closed loop: each client sends its next request as soon as
its last one is done), ``slots`` (the engine's batch), ``prompt`` and
``output`` length distributions (``{"dist": "lognormal", "median",
"sigma", "min", "max"}`` or ``{"dist": "uniform", "min", "max"}``),
``round`` (how many requests make one round) and ``temperature``.

Every seed sends the same lengths in the same order: request lengths come
in rounds, and each round holds the ``round`` quantiles (i + 0.5) / round
of each distribution, paired and ordered by a shuffle of the round's index
alone. So the seed changes what the requests say and not the work they
make: with a closed loop, the order of lengths decides which requests run
side by side, and shuffling it by the seed moved the TTFT tail by 10-20%
between seeds. Prompt tokens are drawn uniformly from [1, vocab - 1), as
``tools/llm_bench.bench_serving`` draws them (commit dc8301a), from the seed
and the request's index.
"""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of a length distribution, whole
    numbers within [min, max]."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "uniform":
        x = lo + q * (hi - lo)
    elif spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(v) for v in q])
        x = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.round(x), lo, hi).astype(np.int64)


class Requests:
    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        self.round = int(mix["round"])
        self.prompt_q = quantiles(mix["prompt"], self.round)
        self.output_q = quantiles(mix["output"], self.round)
        self._rounds: dict[int, tuple] = {}

    def lengths(self, i: int) -> tuple[int, int]:
        """(prompt length, output length) of request i."""
        r, j = divmod(i, self.round)
        if r not in self._rounds:
            rng = np.random.default_rng([2, r])
            self._rounds[r] = (rng.permutation(self.prompt_q), rng.permutation(self.output_q))
        p, o = self._rounds[r]
        return int(p[j]), int(o[j])

    def prompt(self, i: int) -> list[int]:
        n, _ = self.lengths(i)
        return np.random.default_rng([self.seed, 3, i]).integers(1, self.vocab - 1, n).tolist()


def make(mix: dict, seed: int, vocab: int) -> Requests:
    return Requests(mix, seed, vocab)
