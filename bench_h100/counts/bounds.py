"""The H100's published peaks and the least time a kernel could take.

Frozen copy of ``chip_smoke.py``'s bound arithmetic (``HBM``, ``PEAK``,
``QM_PEAK`` and ``bound``, chip_smoke.py:1023-1032 and 1044-1049 at commit
2b9c445), kept here so that a later change to the program cannot move the
yardstick. NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at
the card's full 700 W power limit.
"""
from __future__ import annotations

HBM = 3.35e12          # HBM3 bytes/s
PEAK = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# the quant-matmul kernel's rate for x of each type: bf16 products on the
# tensor cores, three of them (exact bf16 terms) for an f32 x
QM_PEAK = {"float32": PEAK["bfloat16"] / 3, "bfloat16": PEAK["bfloat16"]}


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(the least seconds the card could take, which of bytes or operations
    sets it): bytes moved over HBM's rate against operations over the peak
    rate of their type."""
    t_bytes, t_ops = nbytes / HBM, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    return bound(nbytes, ops, peak)[0]
