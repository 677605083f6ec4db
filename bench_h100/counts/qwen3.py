"""Operations and bytes of a dense GQA stack's serving calls, worked out
from the shapes and from the meta rows of the calls the engine made.

Model operations (``model_flops``) count the useful work: 2 operations a
weight a token for the matrices of the blocks, 4 * heads * head_dim a
layer for attention over each token's live positions (scores and values),
and the LM head where a call reads logits; padded rows and parked slots are
left out. The kernels' bytes count what their inputs need, each byte read
once: the int8 matrix (padded as the deployment stores it, out to 256 rows
and 1024 columns) with its scales, the f32 activations in and out; the
bf16 K and V of every position a decode row attends to.
"""
from __future__ import annotations

from .bounds import PEAK, QM_PEAK, bound_s

TO, TI = 256, 1024       # the int8 format's padding of outputs and inputs


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def block_mats(hf: dict) -> list[tuple[int, int]]:
    """(out, in) of the seven matrices of one block."""
    d, f, hd = hf["hidden_size"], hf["intermediate_size"], hf["head_dim"]
    qd, kd = hd * hf["num_attention_heads"], hd * hf["num_key_value_heads"]
    return [(qd, d), (kd, d), (kd, d), (d, qd), (f, d), (f, d), (d, f)]


def qm_cost(rows: int, o: int, k: int, x_bytes: int = 4) -> tuple[float, float]:
    """(bytes, operations) of one quant-matmul call."""
    nbytes = _pad(o, TO) * _pad(k, TI) + 4 * _pad(o, TO) + rows * k * x_bytes + rows * o * x_bytes
    return float(nbytes), 2.0 * rows * o * k


def call_rows(kind: str, meta, n_slots: int, chunk: int) -> tuple[int, int]:
    """(rows through the blocks' matrices, rows through the LM head) of a
    call as the kernels see them, padding included."""
    if kind == "decode":
        return n_slots, n_slots
    if kind == "prefill_many":
        return n_slots * chunk, n_slots
    return chunk, 1


def qm_bound_s(hf: dict, calls, n_slots: int, chunk: int) -> float:
    """Least seconds of every quant-matmul launch of ``calls``."""
    total = 0.0
    for kind, meta in calls:
        body, head = call_rows(kind, meta, n_slots, chunk)
        for o, k in block_mats(hf):
            total += hf["num_hidden_layers"] * bound_s(*qm_cost(body, o, k), QM_PEAK["float32"])
        total += bound_s(*qm_cost(head, hf["vocab_size"], hf["hidden_size"]),
                         QM_PEAK["float32"])
    return total


def decode_attn_bound_s(hf: dict, calls, cache_bytes: int = 2) -> float:
    """Least seconds of the decode-attention launches of the decode calls:
    each row reads K and V at positions 0..pos, every layer."""
    hd, nh, nkv = hf["head_dim"], hf["num_attention_heads"], hf["num_key_value_heads"]
    total = 0.0
    for kind, meta in calls:
        if kind != "decode":
            continue
        pos = [int(p) + 1 for p in meta[0]]
        b = len(pos)
        nbytes = sum(pos) * nkv * hd * 2 * cache_bytes + 2 * b * nh * hd * 4
        ops = 4.0 * nh * hd * sum(pos)
        total += hf["num_hidden_layers"] * bound_s(nbytes, ops, PEAK["bfloat16"])
    return total


def model_flops(hf: dict, calls) -> float:
    """Useful model operations of ``calls``: live decode rows and the real
    tokens of valid prefill rows."""
    layers = hf["num_hidden_layers"]
    dense = 2.0 * layers * sum(o * k for o, k in block_mats(hf))
    attn = 4.0 * layers * hf["num_attention_heads"] * hf["head_dim"]
    head = 2.0 * hf["hidden_size"] * hf["vocab_size"]
    total = 0.0
    for kind, meta in calls:
        if kind == "decode":
            for p, live in zip(meta[0], meta[1]):
                if live:
                    total += dense + attn * (int(p) + 1) + head
            continue
        if kind == "prefill_many":
            rows = [(int(s), int(n)) for s, n, v in zip(meta[0], meta[1], meta[2]) if v]
        else:
            rows = [meta]
        for s, n in rows:
            total += dense * n + attn * (n * s + n * (n + 1) / 2) + head
    return total
