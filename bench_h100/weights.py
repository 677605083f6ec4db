"""Weights made from the seed, the same for the program and the reference.

Each set is drawn on the device by one ``torch.Generator`` in one call over
a flat buffer, in the type it is served in, then cut into tensors: no
per-tensor draws and nothing on the host but what the program's interface
asks for there.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import yolov9 as ref_yolo


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator for one stream of draws (weights 0, traffic 1, ...)."""
    return torch.Generator(device=device).manual_seed((int(seed) * 8 + stream) % (1 << 63))


def yolov9(cfg: dict, seed: int, device, frame: np.ndarray) -> dict:
    """HWIO float32 numpy filters, biases and the DFL bins 0..15, keyed by
    checkpoint names: the layout ``runtime.nvr.BatchDetector(params=)``
    takes. Drawn on ``device`` (one transfer to the host).

    Filters are normal with ``init.gain`` times He's std (sqrt(2 /
    fan_in)): below 1, the random network contracts for every seed, so no
    seed amplifies rounding (at gain 1 a seed in a dozen keeps its signal,
    and then a bf16 computation of the plain reference itself moves boxes
    by hundreds of pixels). Biases are zero but the class branch's last
    one, ``init.class_bias``. The head's two last 1x1 convolutions of each
    scale are then rescaled so that, on ``frame`` (uint8 BGR, one frame of
    the traffic), the plain reference's box and class logits have std
    ``init.head_std``: boxes and scores spread as a trained head's do
    instead of sitting at the bins' mean and 0.5."""
    init = cfg["init"]
    specs = ref_yolo.conv_specs(cfg)
    sizes = [k * k * (cin // g) * cout for _, cin, cout, k, _, g, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, 0), device=device)
    stds = torch.cat([torch.full((n,), init["gain"] * (2.0 / (cin // g * k * k)) ** 0.5,
                                 device=device)
                      for n, (_, cin, _, k, _, g, _) in zip(sizes, specs)])
    host = (flat * stds).cpu().numpy()
    out, off = {}, 0
    for n, (pre, cin, cout, k, _, g, _) in zip(sizes, specs):
        out[pre + ".weight"] = host[off:off + n].reshape(k, k, cin // g, cout)
        out[pre + ".bias"] = np.zeros(cout, np.float32)
        off += n
    head = len(ref_yolo.graph_of(cfg)) - 1
    out[f"model.{head}.dfl.conv.weight"] = np.arange(cfg["reg_max"], dtype=np.float32)
    model = ref_yolo.Model(cfg, out, device)
    x = torch.from_numpy(np.ascontiguousarray(frame)[None]).to(device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        branches = model.branch_outputs(x, cfg["input_size"])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for i, (bb, cc) in enumerate(branches):
        for branch, y in (("cv2", bb), ("cv3", cc)):
            key = f"model.{head}.{branch}.{i}.2"
            out[key + ".weight"] = out[key + ".weight"] * np.float32(
                init["head_std"] / max(float(y.std()), 1e-30))
        out[f"model.{head}.cv3.{i}.2.bias"][:] = init["class_bias"]
    return out


def llm_shapes(hf: dict) -> list[tuple[str, tuple]]:
    """(GGUF name, shape) of every drawn matrix of a dense GQA stack with
    qk-norm, in draw order; norms are ones and not drawn."""
    d, f = hf["hidden_size"], hf["intermediate_size"]
    hd = hf["head_dim"]
    qd, kd = hd * hf["num_attention_heads"], hd * hf["num_key_value_heads"]
    out = [("token_embd.weight", (hf["vocab_size"], d))]
    if not hf["tie_word_embeddings"]:
        out.append(("output.weight", (hf["vocab_size"], d)))
    for i in range(hf["num_hidden_layers"]):
        p = f"blk.{i}."
        out += [(p + "attn_q.weight", (qd, d)), (p + "attn_k.weight", (kd, d)),
                (p + "attn_v.weight", (kd, d)), (p + "attn_output.weight", (d, qd)),
                (p + "ffn_gate.weight", (f, d)), (p + "ffn_up.weight", (f, d)),
                (p + "ffn_down.weight", (d, f))]
    return out


def llm(hf: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """A dense GQA stack's weights in ``dtype`` on ``device``, GGUF-named as
    ``models.llm`` takes them: matrices normal with std
    ``initializer_range``, RMS-norm weights ones, the output head the
    embedding when ``tie_word_embeddings``. The matrices are views of one
    flat buffer."""
    shapes = llm_shapes(hf)
    sizes = [int(np.prod(s)) for _, s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, 0), device=device,
                       dtype=dtype)
    flat.mul_(hf["initializer_range"])
    out, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        out[name] = flat[off:off + n].view(shape)
        off += n
    if hf["tie_word_embeddings"]:
        out["output.weight"] = out["token_embd.weight"]
    d, hd = hf["hidden_size"], hf["head_dim"]
    ones = torch.ones(d, dtype=dtype, device=device)
    out["output_norm.weight"] = ones
    head_ones = torch.ones(hd, dtype=dtype, device=device)
    for i in range(hf["num_hidden_layers"]):
        p = f"blk.{i}."
        out[p + "attn_norm.weight"] = ones
        out[p + "ffn_norm.weight"] = ones
        out[p + "attn_q_norm.weight"] = head_ones
        out[p + "attn_k_norm.weight"] = head_ones
    return out
