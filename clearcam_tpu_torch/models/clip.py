"""OpenCLIP ViT-L/14 (laion2B) image and text towers over torch, the
counterpart of ``clearcam_tpu.models.clip``:

  image  uint8 RGB [B,224,224,3] -> patch 14 embed, cls token, 257 positions,
         24 blocks 1024 wide (16 heads of 64), ln_post, proj -> unit [B,768]
  text   int token ids [B,77] -> 12 causal blocks 768 wide (12 heads),
         ln_final, pooled at the argmax id (the eot token),
         text_projection -> unit [B,768]

``init_params`` and ``convert_state_dict`` return numpy arrays in the JAX
layout, equal to the JAX package's (the patch filter HWIO);
``params_from_jax`` turns such a dict into torch tensors once, on one
device, in one dtype. There the patch filter is held as a (1024, 14*14*3)
matrix: a convolution whose stride is its size is a matrix product over
non-overlapping patches, and a matrix product runs in full f32 on the GPU by
default, where cuDNN's f32 convolution takes TF32.

The image tower's attention runs the hand-written CUDA kernel
(``ops.vit_attention.mha_flash``) when its tensors are on CUDA, and the
plain version on the CPU (``flash=None``); ``flash=False`` forces the plain
version. The text tower's causal attention is the plain ``mha``, as in the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..ops.vit_attention import mha_flash

IMG_WIDTH, IMG_BLOCKS, IMG_HEADS = 1024, 24, 16
TXT_WIDTH, TXT_BLOCKS, TXT_HEADS = 768, 12, 12
EMBED_DIM = 768
IMG_RES, PATCH = 224, 14
CTX = 77
VOCAB = 49408
PATCH_KEY = "visual_conv1.weight"


def _n_blocks(p: dict, prefix: str) -> int:
    return 1 + max(int(k.split(".")[1]) for k in p if k.startswith(prefix + "."))


def _attn(x, w_in, b_in, w_out, b_out, n_heads, mask=None, flash=False):
    """Fused-qkv multi-head attention on [B,L,D] (torch MHA layout:
    in_proj (3D,D), out_proj (D,D)). The heads are strided views of the
    qkv projection."""
    q, k, v = (F.split_heads(t, n_heads)
               for t in F.linear(x, w_in, b_in).chunk(3, dim=-1))
    if flash and mask is None:
        out = mha_flash(q, k, v)
    else:
        out = F.mha(q, k, v, mask=mask)
    return F.linear(F.merge_heads(out), w_out, b_out)


def _mlp(p, pre, x):
    h = F.layer_norm_p(p, pre + ".ln_2", x)
    h = F.gelu(F.linear_p(p, pre + ".mlp_c_fc", h))
    return x + F.linear_p(p, pre + ".mlp_c_proj", h)


def patchify(x):
    """[B,224,224,3] -> [B,256,14*14*3], each row one patch in (kh, kw, c)
    order, the order of the HWIO filter's flattened rows."""
    b, hh, ww, c = x.shape
    g = hh // PATCH
    x = x.reshape(b, g, PATCH, ww // PATCH, PATCH, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * (ww // PATCH), PATCH * PATCH * c)


def encode_image(p: dict, pixels, normalize: bool = True,
                 flash: bool | None = None):
    """uint8/float RGB [B,224,224,3] -> L2-normalized [B,768], computed in
    the weights' dtype. The preprocess x/255, (x-0.5)/0.5 is fused here, so
    the host ships raw bytes. ``flash``: None = the kernel on CUDA, the
    plain version on the CPU; False = the plain version."""
    w = p[PATCH_KEY]
    x = pixels.to(w.dtype)
    x = (x / 255.0 - 0.5) / 0.5
    x = F.linear(patchify(x), w)                                 # [B,256,1024]
    b = x.shape[0]
    cls = p["class_embedding"].expand(b, 1, IMG_WIDTH)
    x = torch.cat([cls, x], dim=1) + p["positional_embedding"]
    x = F.layer_norm_p(p, "ln_pre", x)
    use_kernel = flash is None or flash
    for i in range(_n_blocks(p, "resblocks_img")):
        pre = f"resblocks_img.{i}"
        h = F.layer_norm_p(p, pre + ".ln_1", x)
        x = x + _attn(h, p[pre + ".in_proj_weight"], p[pre + ".in_proj_bias"],
                      p[pre + ".out_proj_weight"], p[pre + ".out_proj_bias"],
                      IMG_HEADS, flash=use_kernel)
        x = _mlp(p, pre, x)
    x = F.layer_norm_p(p, "ln_post", x)
    emb = x[:, 0, :] @ p["proj"]
    if normalize:
        emb = emb / (torch.sqrt((emb ** 2).sum(-1, keepdim=True)) + 1e-8)
    return emb


def causal_mask(device) -> torch.Tensor:
    return torch.triu(torch.full((CTX, CTX), float("-inf"), device=device), 1)


def encode_text(p: dict, tokens, normalize: bool = True):
    """int [B,77] padded token ids -> L2-normalized [B,768]. Pools at the
    argmax token id (the eot position)."""
    tokens = tokens.long()
    x = F.embedding(p["token_embedding.weight"], tokens)
    x = x + p["positional_embedding_text"]
    mask = causal_mask(x.device)
    for i in range(_n_blocks(p, "resblocks")):
        pre = f"resblocks.{i}"
        h = F.layer_norm_p(p, pre + ".ln_1", x)
        x = x + _attn(h, p[pre + ".in_proj_weight"], p[pre + ".in_proj_bias"],
                      p[pre + ".attn_out_proj_weight"],
                      p[pre + ".attn_out_proj_bias"], TXT_HEADS, mask=mask)
        x = _mlp(p, pre, x)
    x = F.layer_norm_p(p, "ln_final", x)
    eot = tokens.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    emb = pooled @ p["text_projection"]
    if normalize:
        emb = emb / torch.sqrt((emb ** 2).sum(-1, keepdim=True))
    return emb


# ---------------------------------------------------------------------------
# parameters: numpy in the JAX layout, then torch once
# ---------------------------------------------------------------------------

def convert_state_dict(sd: dict[str, np.ndarray], dtype=np.float32) -> dict:
    """Published safetensors -> flat numpy params as the JAX package
    converts them (patch filter OIHW -> HWIO; derived attn_mask buffers
    skipped)."""
    out = {}
    for k, arr in sd.items():
        if k == "attn_mask" or k.endswith("attn_mask"):
            continue
        arr = np.asarray(arr, np.float32)
        if k == PATCH_KEY:
            arr = F.oihw_to_hwio(arr)
        out[k] = arr.astype(dtype)
    return out


def init_params(seed: int = 0, dtype=np.float32,
                img_blocks: int = IMG_BLOCKS, txt_blocks: int = TXT_BLOCKS) -> dict:
    """Random numpy params with the checkpoint's shapes: the same numbers,
    drawn in the same order, as the JAX package's ``init_params``."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def t(key, *shape, scale=0.02):
        p[key] = np.asarray(rng.normal(0, scale, shape), dtype)

    def zeros(key, *shape):
        p[key] = np.zeros(shape, dtype)

    def ln(prefix, width):
        p[prefix + ".weight"] = np.ones((width,), dtype)
        zeros(prefix + ".bias", width)

    t(PATCH_KEY, PATCH, PATCH, 3, IMG_WIDTH)
    t("class_embedding", IMG_WIDTH)
    t("positional_embedding", 257, IMG_WIDTH)
    ln("ln_pre", IMG_WIDTH); ln("ln_post", IMG_WIDTH)
    t("proj", IMG_WIDTH, EMBED_DIM)
    for i in range(img_blocks):
        pre = f"resblocks_img.{i}"
        ln(pre + ".ln_1", IMG_WIDTH); ln(pre + ".ln_2", IMG_WIDTH)
        t(pre + ".in_proj_weight", 3 * IMG_WIDTH, IMG_WIDTH)
        zeros(pre + ".in_proj_bias", 3 * IMG_WIDTH)
        t(pre + ".out_proj_weight", IMG_WIDTH, IMG_WIDTH)
        zeros(pre + ".out_proj_bias", IMG_WIDTH)
        t(pre + ".mlp_c_fc.weight", 4 * IMG_WIDTH, IMG_WIDTH)
        zeros(pre + ".mlp_c_fc.bias", 4 * IMG_WIDTH)
        t(pre + ".mlp_c_proj.weight", IMG_WIDTH, 4 * IMG_WIDTH)
        zeros(pre + ".mlp_c_proj.bias", IMG_WIDTH)
    t("token_embedding.weight", VOCAB, TXT_WIDTH)
    t("positional_embedding_text", CTX, TXT_WIDTH)
    t("text_projection", TXT_WIDTH, EMBED_DIM)
    ln("ln_final", TXT_WIDTH)
    for i in range(txt_blocks):
        pre = f"resblocks.{i}"
        ln(pre + ".ln_1", TXT_WIDTH); ln(pre + ".ln_2", TXT_WIDTH)
        t(pre + ".in_proj_weight", 3 * TXT_WIDTH, TXT_WIDTH)
        zeros(pre + ".in_proj_bias", 3 * TXT_WIDTH)
        t(pre + ".attn_out_proj_weight", TXT_WIDTH, TXT_WIDTH)
        zeros(pre + ".attn_out_proj_bias", TXT_WIDTH)
        t(pre + ".mlp_c_fc.weight", 3072, TXT_WIDTH)
        zeros(pre + ".mlp_c_fc.bias", 3072)
        t(pre + ".mlp_c_proj.weight", TXT_WIDTH, 3072)
        zeros(pre + ".mlp_c_proj.bias", TXT_WIDTH)
    return p


def weights_dtype(params: dict) -> torch.dtype:
    """The torch dtype of a numpy/JAX param dict: bf16 when its arrays are
    bf16, else f32 (the CLIP compute dtype follows the weights)."""
    return torch.bfloat16 if str(np.asarray(params[PATCH_KEY]).dtype) == "bfloat16" \
        else torch.float32


def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Flat params in the JAX layout (numpy or JAX arrays) -> torch tensors
    on ``device`` in ``dtype``; the HWIO patch filter becomes the
    (1024, 588) matrix that ``encode_image`` multiplies patches by."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        a = np.array(v, np.float32)
        if k == PATCH_KEY:
            a = np.ascontiguousarray(a.reshape(-1, a.shape[-1]).T)
        out[k] = torch.from_numpy(a).to(device=dev, dtype=dtype)
    return out


class CLIP(nn.Module):
    """Module form: ``CLIP()(pixels)`` embeds uint8 RGB [B,224,224,3] crops,
    ``encode_text(tokens)`` embeds [B,77] token ids. Parameters live in a
    ``ParameterDict`` keyed by the checkpoint names with "." -> "/"."""

    def __init__(self, params: dict | None = None, *, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        tensors = params_from_jax(params if params is not None else init_params(),
                                  device, dtype)
        self.params = nn.ParameterDict({
            k.replace(".", "/"): nn.Parameter(v, requires_grad=False)
            for k, v in tensors.items()})

    def flat_params(self) -> dict:
        return {k.replace("/", "."): v for k, v in self.params.items()}

    @torch.inference_mode()
    def forward(self, pixels, flash: bool | None = None):
        return encode_image(self.flat_params(), pixels, flash=flash)

    @torch.inference_mode()
    def encode_text(self, tokens):
        return encode_text(self.flat_params(), tokens)
