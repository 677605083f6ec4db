"""Qwen3-VL over torch, for the NVR's AI alert summaries: a ViT vision tower
(mmproj GGUF) and the port's language model (``models.llm``) with the image
embeddings spliced in and deepstack features added, the counterpart of
``clearcam_tpu.models.qwen3vl``.

The reference's surface (llm/qwen3vl.py): letterbox to a fixed multiple-of-32
resolution, 16 px patches with the temporal pair and a 2x2 spatial merge
(one image = H*W/32^2 tokens), bilinearly interpolated learned position
embeddings, 2D rotary attention in the vision blocks, deepstack side
features added after the matching language blocks during the image
prefill, multi-image streaming context with explicit resets, and a
2000-token budget.

On CUDA the tower's attention runs the port's ``vit_attention`` kernel
(head dim 64), as the CLIP tower's does; the language model's decode step
runs the decode-attention kernels when its ``Transformer`` was built with
``use_pallas_decode``. Resets rebuild the language state in the format the
``Transformer`` was built with (``Transformer.reset_state``): bf16 or int8
caches stay bf16 or int8, where the JAX package's resets fall back to an f32
cache without scales (qwen3vl.py:334, 350, 357).
"""
from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as tF

from ..device import resolve_device
from ..nn import functional as F
from ..ops.vit_attention import mha_flash
from . import llm as llm_mod

TEMP = 0.7
MAX_CONTEXT = 2000


def qwen3vl_2b_cfg(blocks: int = 28, ctx: int = 2048) -> llm_mod.TransformerConfig:
    """Qwen/Qwen3-VL-2B-Instruct's language model (its config.json's
    text_config): hidden 2048, 28 layers, 16 heads, 8 KV heads of 128,
    intermediate 6144, vocab 151936, rope theta 5e6, RMS eps 1e-6, qk-norm
    per head. ``blocks`` cuts the depth; ``ctx`` is the cache length (2048
    holds the 2000-token summary budget)."""
    return llm_mod.TransformerConfig(
        num_blocks=blocks, dim=2048, hidden_dim=6144, n_heads=16, n_kv_heads=8,
        norm_eps=1e-6, vocab_size=151936, head_dim=128, rope_theta=5e6,
        rope_dim=128, v_head_dim=128, max_context=ctx, qk_norm=128)


def vision_2b_random(blocks: int = 24, deepstack=(5, 11, 17), seed: int = 0):
    """(kv, numpy params) of a random tower at Qwen3-VL-2B's vision widths
    (its config.json's vision_config): width 1024, 16 heads of 64, MLP 4096,
    patch 16 with the temporal pair, 2x2 merge, a 48x48 position grid,
    deepstack at vision blocks 5, 11 and 17, and mergers 4096 -> 4096 ->
    2048. ``blocks`` cuts the depth."""
    return VisionTower.init_random(n_blocks=blocks, width=1024, heads=16, merge_dim=4096,
                                   lang_dim=2048, grid_side=48, deepstack=deepstack,
                                   seed=seed, merger_hidden=4096)


# ---------------------------------------------------------------------------
# static geometry helpers (numpy)
# ---------------------------------------------------------------------------

def window_order(gh: int, gw: int, merge: int) -> np.ndarray:
    """Indices mapping row-major patch order -> 2x2-merge-window order."""
    idx = np.arange(gh * gw).reshape(gh, gw)
    idx = idx.reshape(gh // merge, merge, gw // merge, merge)
    return idx.transpose(0, 2, 1, 3).reshape(-1)


def position_ids(gh: int, gw: int, merge: int) -> np.ndarray:
    """[N,2] (h,w) positions in window order (qwen3vl.py:189-194)."""
    hh, ww = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    order = window_order(gh, gw, merge)
    return np.stack([hh.reshape(-1)[order], ww.reshape(-1)[order]], -1)


def bilinear_pos_weights(gh: int, gw: int, grid_side: int, merge: int):
    """(indices [4,N], weights [4,N]) to resample the learned pos-emb grid to
    (gh, gw), in window order (qwen3vl.py:154-187)."""
    hg = np.linspace(0, grid_side - 1, gh)
    wg = np.linspace(0, grid_side - 1, gw)
    hf, wf = hg.astype(int), wg.astype(int)
    hc = np.minimum(hf + 1, grid_side - 1)
    wc = np.minimum(wf + 1, grid_side - 1)
    ha, wa = hg - hf, wg - wf
    idx = np.stack([
        (hf[:, None] * grid_side + wf[None, :]).reshape(-1),
        (hf[:, None] * grid_side + wc[None, :]).reshape(-1),
        (hc[:, None] * grid_side + wf[None, :]).reshape(-1),
        (hc[:, None] * grid_side + wc[None, :]).reshape(-1)])
    wgt = np.stack([
        ((1 - ha)[:, None] * (1 - wa)[None, :]).reshape(-1),
        ((1 - ha)[:, None] * wa[None, :]).reshape(-1),
        (ha[:, None] * (1 - wa)[None, :]).reshape(-1),
        (ha[:, None] * wa[None, :]).reshape(-1)])
    order = window_order(gh, gw, merge)
    return idx[:, order], wgt[:, order].astype(np.float32)


def rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], -1)


def _gelu_tanh(x):
    """tanh-approximate GELU: the published checkpoints are trained with
    gelu_pytorch_tanh (HF qwen3_vl config)."""
    return tF.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------

def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """mmproj tensors (numpy, or the JAX package's arrays) as the tower's
    torch params on ``device`` in ``dtype``, plus ``_patch_proj``: the two
    temporal patch filters stacked into one [C*2*p*p, O] matrix, as the
    JAX ``VisionTower`` builds it."""
    dev = resolve_device(device)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(dev, dtype)
         for k, v in params.items()}
    w0 = np.asarray(params["v.patch_embd.weight"], np.float32)
    w1 = np.asarray(params["v.patch_embd.weight.1"], np.float32)
    w = np.stack([w0, w1], 2).reshape(w0.shape[0], -1)          # [O, C*2*p*p]
    p["_patch_proj"] = torch.from_numpy(np.ascontiguousarray(w.T)).to(dev, dtype)
    return p


class VisionTower:
    """ViT from mmproj GGUF metadata + tensors, on ``device``."""

    def __init__(self, kv: dict, params: dict, dtype=torch.float32, device="cuda"):
        self.merge = kv["clip.vision.spatial_merge_size"]
        self.patch = kv["clip.vision.patch_size"]
        self.mean = np.asarray(kv["clip.vision.image_mean"], np.float32)
        self.std = np.asarray(kv["clip.vision.image_std"], np.float32)
        self.n_heads = kv["clip.vision.attention.head_count"]
        self.width = kv["clip.vision.embedding_length"]
        self.merge_dim = kv["clip.vision.feed_forward_length"]
        self.n_blocks = kv["clip.vision.block_count"]
        deep = kv.get("clip.vision.is_deepstack_layers", [False] * self.n_blocks)
        self.deepstack_idx = [i for i, v in enumerate(deep) if v]
        self.grid_side = int(round(np.sqrt(
            np.asarray(params["v.position_embd.weight"]).shape[0])))
        self.p = params_from_jax(params, device, dtype)
        self.device = self.p["_patch_proj"].device

    def patchify(self, img):
        """float [H,W,3] RGB 0..255 -> ([N, C*2*p*p] rows in window order,
        (gh, gw))."""
        h, w = img.shape[:2]
        mean = torch.from_numpy(self.mean).to(img.device)
        std = torch.from_numpy(self.std).to(img.device)
        x = (img / 255.0 - mean) / std
        gh, gw = h // self.patch, w // self.patch
        m, pt = self.merge, self.patch
        x = x.permute(2, 0, 1)                                    # [C,H,W]
        x = x.reshape(3, gh // m, m, pt, gw // m, m, pt)
        x = x.permute(1, 4, 2, 5, 0, 3, 6)                        # gh/m,gw/m,m,m,C,p,p
        x = x[..., None, :, :].expand(*x.shape[:5], 2, pt, pt)   # temporal pair
        return x.reshape(gh * gw, -1), (gh, gw)

    def __call__(self, img):
        return self.apply(self.p, img)

    @torch.inference_mode()
    def apply(self, p, img):
        """float [H,W,3] RGB -> (merged image embeds [N/4, lang_dim],
        deepstack features, one [N/4, lang_dim] per deepstack block in
        ``deepstack_idx`` order)."""
        img = torch.as_tensor(img, dtype=torch.float32).to(self.device)
        rows, (gh, gw) = self.patchify(img)
        dt = p["_patch_proj"].dtype
        x = rows.to(dt) @ p["_patch_proj"] + p["v.patch_embd.bias"]

        idx, wgt = bilinear_pos_weights(gh, gw, self.grid_side, self.merge)
        idx_t = torch.from_numpy(idx).to(x.device)
        wgt_t = torch.from_numpy(wgt).to(x.device, dt)
        x = x + (p["v.position_embd.weight"][idx_t] * wgt_t[:, :, None]).sum(0)

        pid = position_ids(gh, gw, self.merge)                    # [N,2]
        inv = 1.0 / (10000.0 ** (np.arange(0, 32, 2, dtype=np.float32) / 32))
        ang = (pid[:, :, None] * inv[None, None]).reshape(len(pid), -1)
        emb = np.concatenate([ang, ang], -1)
        cos = torch.from_numpy(np.cos(emb).astype(np.float32)).to(x.device, dt)[:, None]
        sin = torch.from_numpy(np.sin(emb).astype(np.float32)).to(x.device, dt)[:, None]

        n = x.shape[0]
        deepstack = []
        for i in range(self.n_blocks):
            pre = f"v.blk.{i}"
            h = F.layer_norm_p(p, pre + ".ln1", x, eps=1e-6)
            qkv = F.linear(h, p[pre + ".attn_qkv.weight"], p.get(pre + ".attn_qkv.bias"))
            q, k, v = qkv.reshape(n, 3, self.n_heads, -1).permute(1, 0, 2, 3)
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin
            # [1, heads, N, hd] views; the kernel reads them in place
            out = mha_flash(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                            v.transpose(0, 1)[None])
            out = out[0].transpose(0, 1).reshape(n, -1)
            x = x + F.linear(out, p[pre + ".attn_out.weight"], p.get(pre + ".attn_out.bias"))
            h = F.layer_norm_p(p, pre + ".ln2", x, eps=1e-6)
            h = _gelu_tanh(F.linear_p(p, pre + ".ffn_up", h))
            x = x + F.linear_p(p, pre + ".ffn_down", h)
            if i in self.deepstack_idx:
                # reference DeepstackLayer (qwen3vl.py:324-334): view to the
                # fc1 input width (2x2 window merge) -> fc1 -> gelu -> fc2;
                # the norm weights exist in the checkpoint but are not applied
                fc1_in = p[f"v.deepstack.{i}.fc1.weight"].shape[1]
                d = F.linear_p(p, f"v.deepstack.{i}.fc1", x.reshape(-1, fc1_in))
                deepstack.append(F.linear_p(p, f"v.deepstack.{i}.fc2", _gelu_tanh(d)))

        x = F.layer_norm_p(p, "v.post_ln", x, eps=1e-6)
        merged = x.reshape(-1, self.merge_dim)                    # 2x2 window concat
        merged = F.linear_p(p, "mm.2", _gelu_tanh(F.linear_p(p, "mm.0", merged)))
        return merged, deepstack

    @staticmethod
    def init_random(n_blocks=2, width=64, heads=1, merge_dim=256, lang_dim=32,
                    grid_side=8, deepstack=(0,), seed=0, merger_hidden=None):
        """A synthetic tower's (kv, numpy params): the JAX package's draws,
        in the same order, so both packages build the same tower from one
        seed. The merger is merge_dim -> merger_hidden -> lang_dim;
        merger_hidden defaults to lang_dim, the JAX package's shape (the
        published checkpoints have merger_hidden = merge_dim)."""
        mlp = 4 * width
        mh = lang_dim if merger_hidden is None else merger_hidden
        rng = np.random.default_rng(seed)
        kv = {"clip.vision.spatial_merge_size": 2, "clip.vision.patch_size": 16,
              "clip.vision.image_mean": [0.5] * 3, "clip.vision.image_std": [0.5] * 3,
              "clip.vision.attention.head_count": heads,
              "clip.vision.embedding_length": width,
              "clip.vision.feed_forward_length": merge_dim,
              "clip.vision.block_count": n_blocks,
              "clip.vision.is_deepstack_layers": [i in deepstack for i in range(n_blocks)]}

        def t(*s):
            return rng.normal(0, 0.05, s).astype(np.float32)

        p = {"v.patch_embd.weight": t(width, 3, 16, 16),
             "v.patch_embd.weight.1": t(width, 3, 16, 16),
             "v.patch_embd.bias": np.zeros(width, np.float32),
             "v.position_embd.weight": t(grid_side * grid_side, width),
             "v.post_ln.weight": np.ones(width, np.float32),
             "v.post_ln.bias": np.zeros(width, np.float32),
             "mm.0.weight": t(mh, merge_dim),
             "mm.0.bias": np.zeros(mh, np.float32),
             "mm.2.weight": t(lang_dim, mh),
             "mm.2.bias": np.zeros(lang_dim, np.float32)}
        for i in range(n_blocks):
            pre = f"v.blk.{i}"
            p[pre + ".ln1.weight"] = np.ones(width, np.float32)
            p[pre + ".ln1.bias"] = np.zeros(width, np.float32)
            p[pre + ".ln2.weight"] = np.ones(width, np.float32)
            p[pre + ".ln2.bias"] = np.zeros(width, np.float32)
            p[pre + ".attn_qkv.weight"] = t(3 * width, width)
            p[pre + ".attn_qkv.bias"] = np.zeros(3 * width, np.float32)
            p[pre + ".attn_out.weight"] = t(width, width)
            p[pre + ".attn_out.bias"] = np.zeros(width, np.float32)
            p[pre + ".ffn_up.weight"] = t(mlp, width)
            p[pre + ".ffn_up.bias"] = np.zeros(mlp, np.float32)
            p[pre + ".ffn_down.weight"] = t(width, mlp)
            p[pre + ".ffn_down.bias"] = np.zeros(width, np.float32)
        for i in deepstack:
            pre = f"v.deepstack.{i}"
            p[pre + ".norm.weight"] = np.ones(merge_dim, np.float32)
            p[pre + ".norm.bias"] = np.zeros(merge_dim, np.float32)
            p[pre + ".fc1.weight"] = t(merge_dim, merge_dim)
            p[pre + ".fc1.bias"] = np.zeros(merge_dim, np.float32)
            p[pre + ".fc2.weight"] = t(lang_dim, merge_dim)
            p[pre + ".fc2.bias"] = np.zeros(lang_dim, np.float32)
        return kv, p


# ---------------------------------------------------------------------------
# full VLM
# ---------------------------------------------------------------------------

class Qwen3VL:
    """VLM wrapper with the reference surface (qwen3vl.py:92-139):
    generate(prompt, image, reset), prewarm(), streaming multi-image context.

    Without ``lang``, the GGUF pair ``Qwen3VL-{size}-Instruct-F16.gguf`` and
    ``mmproj-Qwen3VL-{size}-Instruct-F16.gguf`` in ``weights_dir`` is loaded
    on ``device`` (the language model bf16, through the decode-attention
    kernels on CUDA); ``CLEARCAM_KV_QUANT=int8`` gives it an int8 cache,
    ``CLEARCAM_LLM_QUANT=int8|int4`` quantized weights and
    ``CLEARCAM_SPEC_LOOKUP=G`` prompt-lookup speculative decoding, as in the
    JAX package."""

    def __init__(self, size: str = "2B", res=(640, 640),
                 weights_dir: str | Path = "weights",
                 lang: llm_mod.Transformer | None = None, tok=None,
                 vision: VisionTower | None = None, device="cuda"):
        self.res = tuple(int(math.ceil(r / 32) * 32) for r in res)
        self.toks_per_img = (self.res[0] * self.res[1]) // (32 * 32)
        self.max_context = MAX_CONTEXT
        weights_dir = Path(weights_dir)
        if lang is None:
            dev = resolve_device(device)
            path = weights_dir / f"Qwen3VL-{size}-Instruct-F16.gguf"
            if not path.exists():
                raise FileNotFoundError(f"{path} not found")
            lang, kv = llm_mod.Transformer.from_gguf(
                path, self.max_context,
                kv_quant=os.environ.get("CLEARCAM_KV_QUANT") == "int8",
                spec_lookup=int(os.environ.get("CLEARCAM_SPEC_LOOKUP", "0") or 0),
                use_pallas_decode=dev.type == "cuda", device=dev)
            quant = os.environ.get("CLEARCAM_LLM_QUANT", "")
            if quant == "int8":
                lang.quantize_int8()
            elif quant == "int4":
                lang.params = llm_mod.quantize_params_int4(lang.params)
            from ..utils.llm_tokenizer import LLMTokenizer
            tok = LLMTokenizer.from_gguf_kv(kv)
        if vision is None:
            from ..io import gguf
            mk, mt = gguf.load(weights_dir / f"mmproj-Qwen3VL-{size}-Instruct-F16.gguf")
            vision = VisionTower(mk, mt, device=lang.device)
        self.lang = lang
        self.tok = tok
        self.vision = vision
        self.start_pos = 0
        self._prefix = tok.encode("<|im_start|>user\n<|vision_start|>")
        self._suffix = tok.encode("<|vision_end|>\n<|im_end|>\n")
        self._freqs = llm_mod.freqs_for(lang.cfg, lang.device)

    # -- image prefill ------------------------------------------------------

    @torch.inference_mode()
    def _image_prefill_impl(self, p, vp, state, img, start_pos):
        """Vision tower + language prefill with the image embeds spliced
        between the vision markers and the deepstack adds (qwen3vl.py:
        259-298); ``state`` is written in place and returned. Deepstack
        feature j is added after language block deepstack_idx[j], the
        vision block it came from, as the JAX package pairs them."""
        cfg = self.lang.cfg
        embeds, deep = self.vision.apply(vp, img)
        dev = p["output_norm.weight"].device
        pre = torch.tensor([self._prefix], device=dev)
        suf = torch.tensor([self._suffix], device=dev)
        h_pre = F.embedding(p["token_embd.weight"], pre).float()
        h_suf = F.embedding(p["token_embd.weight"], suf).float()
        hidden = torch.cat([h_pre, embeds[None].float().to(dev), h_suf], 1)
        npre, nimg = len(self._prefix), embeds.shape[0]
        deepstack = {}
        for j, lang_idx in enumerate(self.vision.deepstack_idx):
            d = torch.zeros_like(hidden)
            d[:, npre:npre + nimg] = deep[j][None].float().to(dev)
            deepstack[lang_idx] = d
        _, state = llm_mod.forward(p, cfg, state, None, int(start_pos), self._freqs,
                                   hidden_override=hidden, deepstack=deepstack)
        return state

    def letterbox(self, image: np.ndarray) -> np.ndarray:
        """Host-side letterbox to self.res (qwen3vl.py:252-256 semantics);
        shared by feed_image and the serving adapter (serving/vlm.py)."""
        import cv2
        th, tw = self.res
        if image.shape[:2] == (th, tw):
            return image
        s = min(tw / image.shape[1], th / image.shape[0])
        r = cv2.resize(image, (int(image.shape[1] * s), int(image.shape[0] * s)))
        top = (th - r.shape[0]) // 2
        left = (tw - r.shape[1]) // 2
        canvas = np.zeros((th, tw, 3), image.dtype)
        canvas[top:top + r.shape[0], left:left + r.shape[1]] = r
        return canvas

    def image_tensor(self, image: np.ndarray) -> torch.Tensor:
        """An RGB uint8 frame letterboxed to self.res, as f32 on the tower's
        device."""
        return torch.from_numpy(np.ascontiguousarray(self.letterbox(image))) \
            .to(self.vision.device).float()

    def feed_image(self, image: np.ndarray, reset: bool = False):
        """BGR-agnostic RGB uint8 frame; letterboxed to self.res on host."""
        if reset:
            self.start_pos = 0
            self.lang.reset_state()
        self.lang.state = self._image_prefill_impl(
            self.lang.params, self.vision.p, self.lang.state, self.image_tensor(image),
            self.start_pos)
        self.start_pos += self.toks_per_img + len(self._prefix) + len(self._suffix)

    # -- public surface -----------------------------------------------------

    def prewarm(self):
        dummy = np.zeros((*self.res, 3), np.uint8)
        self.feed_image(dummy, reset=True)
        for _ in self.lang.generate(self.tok.encode("warm"), temperature=TEMP,
                                    cache_offset=self.start_pos, max_new=1):
            pass
        self.start_pos = 0
        self.lang.reset_state()

    def generate(self, prompt: str | None = None, image: np.ndarray | None = None,
                 reset: bool = False, temperature: float = TEMP,
                 max_new: int | None = None) -> str | None:
        if reset and image is None:
            self.start_pos = 0
            self.lang.reset_state()
        if image is not None:
            self.feed_image(image, reset=reset)
        if prompt is None:
            return None
        toks = self.tok.encode("<|im_start|>user\n" + prompt
                               + "<|im_end|>\n<|im_start|>assistant\n")
        out = []
        for t in self.lang.generate(toks, temperature=temperature,
                                    cache_offset=self.start_pos, max_new=max_new):
            if self.tok.is_end(t):
                break
            out.append(t)
            if self.start_pos + len(toks) + len(out) >= self.max_context:
                break
        self.start_pos += len(toks) + len(out)
        return self.tok.decode(out)
