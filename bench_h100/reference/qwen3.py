"""Plain Qwen3 forward (dense, grouped-query attention with per-head RMS
q/k norms) in float32 PyTorch, written from the published architecture
(Qwen/Qwen3-1.7B's ``config.json`` and the transformers ``Qwen3`` model):

  x = embed[tokens]
  each layer: h = rms(x) * w_in;  q, k, v = h Wq^T, h Wk^T, h Wv^T split in
  heads; q, k = rms(q) * w_q, rms(k) * w_k over the head dim; rotary
  position embedding on each head's two halves (theta ``rope_theta``);
  causal softmax(q k^T / sqrt(head_dim)) v, each KV head shared by
  heads / kv_heads query heads; x += out Wo^T;
  h = rms(x) * w_post;  x += (silu(h Wg^T) * (h Wu^T)) Wd^T
  logits = (rms(x) * w_final) W_out^T

Weights are the benchmark's (GGUF names, as ``weights.llm`` makes them),
taken in float32. With ``weight_bits`` 8, every matrix but the token
embedding with both dims at least 256 is first rounded to the deployment's
int8 format: symmetric, one scale an output row (max |w| / 127), values
rounded half to even and clipped to [-127, 127]. The whole sequence runs in one causal pass; there
is no cache. TF32 is off for every product.
"""
from __future__ import annotations

import torch


def int8_rows(w: torch.Tensor) -> torch.Tensor:
    """w rounded to int8 with one scale an output row, back in float32."""
    w = w.float()
    amax = w.abs().amax(1, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(w / s), -127, 127) * s


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, theta: float):
    """Half-split rotary embedding on [H, T, D] at positions 0..T-1."""
    d = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(0, 2 * d, 2, device=x.device, dtype=torch.float64)
                           / (2 * d)))
    ang = torch.arange(x.shape[1], device=x.device, dtype=torch.float64)[:, None] * inv[None]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :d], x[..., d:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


class Model:
    def __init__(self, hf: dict, weights: dict, weight_bits: int = 8):
        self.hf, self.w, self.bits = hf, weights, weight_bits

    def mat(self, name: str) -> torch.Tensor:
        w = self.w[name]
        return int8_rows(w) if self.bits == 8 and min(w.shape) >= 256 else w.float()

    @torch.no_grad()
    def logits(self, tokens: list[int], rows, q_block: int = 1024) -> torch.Tensor:
        """float32 logits [len(rows), V] at the positions ``rows`` of a
        causal pass over ``tokens``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        hf, w = self.hf, self.w
        eps, hd = hf["rms_norm_eps"], hf["head_dim"]
        nh, nkv = hf["num_attention_heads"], hf["num_key_value_heads"]
        dev = w["token_embd.weight"].device
        ids = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        x = w["token_embd.weight"][ids].float()
        t = x.shape[0]
        for i in range(hf["num_hidden_layers"]):
            p = f"blk.{i}."
            h = _rms(x, w[p + "attn_norm.weight"], eps)
            q = (h @ self.mat(p + "attn_q.weight").T).reshape(t, nh, hd).transpose(0, 1)
            k = (h @ self.mat(p + "attn_k.weight").T).reshape(t, nkv, hd).transpose(0, 1)
            v = (h @ self.mat(p + "attn_v.weight").T).reshape(t, nkv, hd).transpose(0, 1)
            q = _rope(_rms(q, w[p + "attn_q_norm.weight"], eps), hf["rope_theta"])
            k = _rope(_rms(k, w[p + "attn_k_norm.weight"], eps), hf["rope_theta"])
            rep = nh // nkv
            k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
            out = torch.empty_like(q)
            for a in range(0, t, q_block):
                b = min(t, a + q_block)
                s = q[:, a:b] @ k[:, :b].transpose(1, 2) / hd ** 0.5
                mask = torch.arange(b, device=dev)[None] > torch.arange(a, b, device=dev)[:, None]
                s = s.masked_fill(mask, float("-inf"))
                out[:, a:b] = torch.softmax(s, -1) @ v[:, :b]
            x = x + out.transpose(0, 1).reshape(t, nh * hd) @ self.mat(p + "attn_output.weight").T
            h = _rms(x, w[p + "ffn_norm.weight"], eps)
            g = torch.nn.functional.silu(h @ self.mat(p + "ffn_gate.weight").T)
            x = x + (g * (h @ self.mat(p + "ffn_up.weight").T)) @ self.mat(p + "ffn_down.weight").T
        h = _rms(x[torch.as_tensor(rows, dtype=torch.long, device=dev)],
                 w["output_norm.weight"], eps)
        return h @ self.mat("output.weight").T
