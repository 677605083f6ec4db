"""Comparison of detect outputs, shared by the parity tests and
``chip_smoke.py``, and a thread cap for the tests.

Two implementations of ``detect`` (JAX and torch, or GPU and CPU) sum in
different orders, so scores that are nearly tied may swap ranks. The rule:
the same number of live rows per frame; for every live row whose score is
not within ``tie_tol`` of the confidence threshold or of another live score,
the same class id, the score within ``score_tol`` and the box within
``box_tol`` source pixels.
"""
from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def torch_threads(n: int):
    """Run torch's CPU ops on at most ``n`` threads, then restore the count:
    test files run side by side must not each take every core."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(min(n, before))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _compared(scores: np.ndarray, conf_threshold: float, tie_tol: float):
    """Mask of the live scores that are clear of the threshold and of
    every other live score."""
    gaps = np.abs(scores[:, None] - scores[None, :]) + np.diag(
        np.full(len(scores), np.inf))
    return (np.abs(scores - conf_threshold) >= tie_tol) \
        & (gaps.min(1, initial=np.inf) >= tie_tol)


def detection_mismatches(ref, got, conf_threshold: float = 0.25,
                         score_tol: float = 1e-5, box_tol: float = 1e-2,
                         tie_tol: float = 1e-4) -> list[str]:
    """[B, K, 6] rows (x1,y1,x2,y2,score,class) -> list of mismatches
    (empty when the two agree under the rule above)."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return [f"shape {ref.shape} != {got.shape}"]
    problems = []
    for b in range(ref.shape[0]):
        r = ref[b][ref[b, :, 4] > 0]
        g = got[b][got[b, :, 4] > 0]
        if len(r) != len(g):
            problems.append(f"frame {b}: {len(r)} live rows vs {len(g)}")
            continue
        for i in np.nonzero(_compared(r[:, 4], conf_threshold, tie_tol))[0]:
            if r[i, 5] != g[i, 5]:
                problems.append(f"frame {b} row {i}: class {r[i, 5]} vs {g[i, 5]}")
            elif abs(r[i, 4] - g[i, 4]) > score_tol:
                problems.append(f"frame {b} row {i}: score {r[i, 4]} vs {g[i, 4]}")
            elif np.abs(r[i, :4] - g[i, :4]).max() > box_tol:
                problems.append(f"frame {b} row {i}: box {r[i, :4]} vs {g[i, :4]}")
    return problems


def compared_rows(ref, conf_threshold: float = 0.25, tie_tol: float = 1e-4) -> int:
    """How many live rows of ``ref`` the rule compares."""
    ref = np.asarray(ref, np.float64)
    return sum(int(_compared(f[f[:, 4] > 0][:, 4], conf_threshold, tie_tol).sum())
               for f in ref)
