"""RF-DETR (LW-DETR) over torch, the counterpart of
``clearcam_tpu.models.rfdetr``: the forward, the COCO-91 remap and the DETR
postprocess.

    uint8 frames -> letterbox (square canvas) + ImageNet normalize ->
    windowed ViT backbone (global attention in a few blocks) -> multi-block
    feature concat -> C2f projector -> two-stage proposal selection (the
    top-Q encoder locations) -> decoder (query self-attention + multi-point
    deformable cross-attention, box refinement per layer) -> sigmoid logits
    + cxcywh boxes -> postprocess (no NMS: DETR queries are set-disjoint)

``init_params`` and ``convert_state_dict`` return numpy arrays in the JAX
layout (the patch filter HWIO), equal to the JAX package's from the same
seed; ``params_from_jax`` turns such a dict into torch tensors once, on one
device, in one dtype (4-D filters OIHW, stored ``channels_last``).

Activations are NHWC, as in ``models.yolov9``. Everything here is plain
PyTorch (cuDNN convolutions, cuBLAS products, ``grid_sample`` for the
deformable sampling): none of it is a Pallas kernel in the JAX package. Two
rules keep it equal to the JAX module: its GELU is ``jax.nn.gelu``'s
default, the tanh form; its ``top_k`` puts the lower index first among
equal scores, which a stable descending sort reproduces on every device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as tF

from ..device import resolve_device
from ..nn import functional as F
from ..ops import boxes as box_ops
from ..ops import image as image_ops

# COCO paper ids (1..90, with gaps) -> contiguous 80-class YOLO ids: the 80
# valid ids in ascending order map to 0..79.
_COCO91_VALID = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
    43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61,
    62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84,
    85, 86, 87, 88, 89, 90,
]
detr_to_yolo = {c91: i for i, c91 in enumerate(_COCO91_VALID)}

_REMAP = np.full(92, -1, np.int64)
for _c91, _y in detr_to_yolo.items():
    _REMAP[_c91] = _y


@F.device_constant(maxsize=64)
def _on(name: str, device: torch.device, dtype=None) -> torch.Tensor:
    """A module constant as a device tensor, uploaded once per device (a
    per-call upload would make the host wait on the card's queue)."""
    t = torch.from_numpy(_CONSTANTS[name])
    return t.to(device=device, dtype=dtype or t.dtype)


def remap_class_ids(ids):
    """Vectorized 91->80 remap; unknown ids -> -1. Lists and arrays give a
    CPU tensor; a tensor keeps its device."""
    ids = torch.as_tensor(ids)
    return _on("remap", ids.device)[ids.long().clamp(0, 91)]


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties broken
    towards the lower index (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def detr_postprocess(logits, boxes_cxcywh, img_hw, conf_threshold: float = 0.5,
                     max_det: int = 300, remap: bool = True,
                     background_last: bool = True, use_sigmoid: bool = False):
    """DETR query outputs -> [B, max_det, 6] rows (x1,y1,x2,y2,score,cls).

    logits [B,Q,C]; scoring is softmax-with-background (classic DETR) or
    per-class sigmoid (the focal-loss family: LW-DETR/RF-DETR). boxes
    [B,Q,4] normalized cxcywh. Top max_det by score; rows below the
    threshold are zeroed (yolov9.detect's output convention)."""
    logits = logits.float()
    boxes_cxcywh = boxes_cxcywh.float()
    if use_sigmoid:
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, -1)
        if background_last:
            probs = probs[..., :-1]
    scores, cls = probs.max(-1)
    if remap:
        cls = remap_class_ids(cls)
    scores = torch.where((scores >= conf_threshold) & (cls >= 0), scores,
                         torch.zeros_like(scores))
    h, w = img_hw
    cx, cy, bw, bh = boxes_cxcywh.unbind(-1)
    rows = torch.stack([
        (cx - bw / 2) * w, (cy - bh / 2) * h,
        (cx + bw / 2) * w, (cy + bh / 2) * h,
        scores, cls.to(boxes_cxcywh.dtype)], -1)
    k = min(max_det, rows.shape[1])
    top_scores, order = top_k(scores, k)
    rows = torch.take_along_dim(rows, order[..., None], 1)
    return rows * (top_scores > 0)[..., None]


class DETRDetector:
    """Tracker-compatible wrapper (``detect_many``) around any DETR-style
    query function of a uint8 [B,H,W,3] tensor on ``device``."""

    def __init__(self, query_fn, img_hw, conf_threshold: float = 0.5,
                 use_sigmoid: bool = False, device="cuda"):
        self._query = query_fn
        self.img_hw = img_hw
        self.conf_threshold = conf_threshold
        self.use_sigmoid = use_sigmoid
        self.device = resolve_device(device)

    @torch.inference_mode()
    def detect_many(self, frames):
        batch = torch.from_numpy(np.stack(frames)).to(self.device)
        out = detr_postprocess(*self._query(batch), self.img_hw,
                               self.conf_threshold,
                               use_sigmoid=self.use_sigmoid).cpu().numpy()
        return [out[i] for i in range(len(frames))]


# ===========================================================================
# Full LW-DETR / RF-DETR forward
# ===========================================================================

@dataclass(frozen=True)
class RFDETRConfig:
    """Architecture hyperparameters. Defaults = nano-class model."""
    resolution: int = 384
    patch_size: int = 16
    vit_dim: int = 192
    vit_depth: int = 12
    vit_heads: int = 3
    num_windows: int = 4                  # window grid per side
    global_blocks: tuple = (2, 5, 8, 11)  # full-image attention blocks
    out_blocks: tuple = (5, 8, 11)        # features tapped for the projector
    d_model: int = 256
    num_queries: int = 300
    dec_layers: int = 3
    sa_heads: int = 8
    ca_heads: int = 16
    ca_points: int = 4                    # deformable sampling points/head
    num_classes: int = 91                 # COCO paper ids, sigmoid scores
    mlp_ratio: int = 4
    projector_n: int = 2                  # C2f bottleneck count

    @property
    def feat_hw(self):
        n = self.resolution // self.patch_size
        return (n, n)


VARIANTS = {
    "nano": RFDETRConfig(),
    "small": RFDETRConfig(vit_dim=384, vit_heads=6),
}

# DINOv2 normalization (ImageNet statistics)
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)
# the tables ``_on`` uploads
_CONSTANTS = {"remap": _REMAP, "mean": _MEAN, "std": _STD}


def _config(variant) -> RFDETRConfig:
    return VARIANTS[variant] if isinstance(variant, str) else variant


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


# -- parameters: numpy in the JAX layout, then torch once --------------------

def init_params(variant: str = "nano", seed: int = 0) -> dict:
    """Random numpy params: the same numbers, drawn in the same order, as the
    JAX package's ``init_params`` (filters HWIO, linear weights (out, in))."""
    c = _config(variant)
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def lin(name, cin, cout, bias=True, std=None):
        s = std if std is not None else (2.0 / cin) ** 0.5 * 0.5
        p[name + ".weight"] = np.asarray(rng.normal(0, s, (cout, cin)), np.float32)
        if bias:
            p[name + ".bias"] = np.zeros((cout,), np.float32)

    def norm(name, dim):
        p[name + ".weight"] = np.ones((dim,), np.float32)
        p[name + ".bias"] = np.zeros((dim,), np.float32)

    def conv(name, cin, cout, k, bias=True):
        fan = cin * k * k
        p[name + ".weight"] = np.asarray(
            rng.normal(0, (2.0 / fan) ** 0.5, (k, k, cin, cout)), np.float32)
        if bias:
            p[name + ".bias"] = np.zeros((cout,), np.float32)

    n_tok = c.feat_hw[0] * c.feat_hw[1]
    conv("backbone.patch_embed", 3, c.vit_dim, c.patch_size)
    p["backbone.pos_embed"] = np.asarray(
        rng.normal(0, 0.02, (n_tok, c.vit_dim)), np.float32)
    for i in range(c.vit_depth):
        b = f"backbone.blocks.{i}"
        norm(b + ".norm1", c.vit_dim)
        lin(b + ".attn.qkv", c.vit_dim, 3 * c.vit_dim)
        lin(b + ".attn.proj", c.vit_dim, c.vit_dim)
        p[b + ".ls1.gamma"] = np.full((c.vit_dim,), 1.0, np.float32)
        norm(b + ".norm2", c.vit_dim)
        lin(b + ".mlp.fc1", c.vit_dim, c.mlp_ratio * c.vit_dim)
        lin(b + ".mlp.fc2", c.mlp_ratio * c.vit_dim, c.vit_dim)
        p[b + ".ls2.gamma"] = np.full((c.vit_dim,), 1.0, np.float32)
    norm("backbone.norm", c.vit_dim)

    # projector: concat taps -> C2f -> d_model
    cin = c.vit_dim * len(c.out_blocks)
    h = c.d_model
    conv("projector.cv1.conv", cin, 2 * h, 1)
    for i in range(c.projector_n):
        conv(f"projector.m.{i}.cv1.conv", h, h, 3)
        conv(f"projector.m.{i}.cv2.conv", h, h, 3)
    conv("projector.cv2.conv", (2 + c.projector_n) * h, h, 1)

    # two-stage proposal head
    lin("enc_output", c.d_model, c.d_model)
    norm("enc_norm", c.d_model)
    lin("enc_class", c.d_model, c.num_classes, std=0.02)
    for i, (a, bdim) in enumerate([(c.d_model, c.d_model),
                                   (c.d_model, c.d_model), (c.d_model, 4)]):
        lin(f"enc_bbox.{i}", a, bdim, std=0.02 if i == 2 else None)

    p["query_embed"] = np.asarray(
        rng.normal(0, 0.02, (c.num_queries, c.d_model)), np.float32)
    lin("ref_point_head.0", 2 * c.d_model, c.d_model)
    lin("ref_point_head.1", c.d_model, c.d_model)

    for li in range(c.dec_layers):
        d = f"decoder.layers.{li}"
        lin(d + ".self_attn.in_proj", c.d_model, 3 * c.d_model)
        lin(d + ".self_attn.out_proj", c.d_model, c.d_model)
        norm(d + ".norm1", c.d_model)
        lin(d + ".cross_attn.sampling_offsets", c.d_model,
            c.ca_heads * c.ca_points * 2, std=0.01)
        lin(d + ".cross_attn.attention_weights", c.d_model,
            c.ca_heads * c.ca_points, std=0.01)
        lin(d + ".cross_attn.value_proj", c.d_model, c.d_model)
        lin(d + ".cross_attn.output_proj", c.d_model, c.d_model)
        norm(d + ".norm2", c.d_model)
        lin(d + ".ffn.fc1", c.d_model, c.mlp_ratio * c.d_model)
        lin(d + ".ffn.fc2", c.mlp_ratio * c.d_model, c.d_model)
        norm(d + ".norm3", c.d_model)
    norm("decoder.norm", c.d_model)

    lin("class_head", c.d_model, c.num_classes, std=0.02)
    for i, (a, bdim) in enumerate([(c.d_model, c.d_model),
                                   (c.d_model, c.d_model), (c.d_model, 4)]):
        lin(f"bbox_head.{i}", a, bdim, std=0.02 if i == 2 else None)
    return p


def convert_state_dict(sd: dict[str, np.ndarray]) -> dict:
    """Published RF-DETR torch checkpoint -> flat numpy params in the JAX
    layout: the torch prefixes (model., module., ema.) stripped, training-only
    entries (denoising embeds) dropped, names passed through (the key layout
    mirrors the torch module tree), and every 4-D conv filter OIHW -> HWIO.
    The JAX package's converter transposes only the patch embed and passes
    the projector's OIHW filters through, which its HWIO convolutions then
    misread; here they are transposed like the patch embed."""
    out: dict[str, np.ndarray] = {}
    for key, arr in sd.items():
        k = key
        for pref in ("module.", "model.", "ema."):
            if k.startswith(pref):
                k = k[len(pref):]
        if any(s in k for s in ("denoising", "dn_", "label_enc")):
            continue
        arr = np.asarray(arr, np.float32)
        if k.endswith(".weight") and arr.ndim == 4:
            arr = F.oihw_to_hwio(arr)
        out[k] = arr
    return out


def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Flat params in the JAX layout (numpy or JAX arrays) -> torch tensors
    on ``device`` in ``dtype``; 4-D filters become OIHW, stored
    ``channels_last``."""
    return F.tensors_from_numpy(params, resolve_device(device), dtype)


# -- backbone ---------------------------------------------------------------

def _vit_attn(p, pre, x, n_heads):
    """x [B*, T, C]: fused-qkv multi-head self-attention (torch MHA layout)."""
    q, k, v = (F.split_heads(t, n_heads)
               for t in F.linear_p(p, pre + ".qkv", x).chunk(3, dim=-1))
    return F.linear_p(p, pre + ".proj", F.merge_heads(F.mha(q, k, v)))


def _to_windows(x, hw, nw):
    """[B, H*W, C] -> [B*nw*nw, (H/nw)*(W/nw), C] non-overlapping windows."""
    b, _, ch = x.shape
    h, w = hw
    wh, ww = h // nw, w // nw
    x = x.reshape(b, nw, wh, nw, ww, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nw * nw, wh * ww, ch)


def _from_windows(x, hw, nw, b):
    h, w = hw
    wh, ww = h // nw, w // nw
    ch = x.shape[-1]
    x = x.reshape(b, nw, nw, wh, ww, ch).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * w, ch)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (not torch's erf
    default)."""
    return tF.gelu(x, approximate="tanh")


def backbone_forward(p, x, cfg: RFDETRConfig):
    """Normalized float [B,H,W,3] -> (tapped token maps [B,N,C], (fh, fw)).

    Windowed ViT: every block attends within num_windows^2 windows except
    the global_blocks (LW-DETR's interleaved window/global attention)."""
    c = cfg
    tok = F.conv2d_p(p, "backbone.patch_embed", x, stride=c.patch_size)
    b, fh, fw, _ = tok.shape
    tok = tok.reshape(b, fh * fw, c.vit_dim) + p["backbone.pos_embed"].to(tok.dtype)
    taps = []
    for i in range(c.vit_depth):
        pre = f"backbone.blocks.{i}"
        h = F.layer_norm_p(p, pre + ".norm1", tok)
        if i in c.global_blocks:
            a = _vit_attn(p, pre + ".attn", h, c.vit_heads)
        else:
            hw_ = _to_windows(h, (fh, fw), c.num_windows)
            a = _from_windows(_vit_attn(p, pre + ".attn", hw_, c.vit_heads),
                              (fh, fw), c.num_windows, b)
        tok = tok + p[pre + ".ls1.gamma"] * a
        h = F.layer_norm_p(p, pre + ".norm2", tok)
        h = F.linear_p(p, pre + ".mlp.fc2", gelu(F.linear_p(p, pre + ".mlp.fc1", h)))
        tok = tok + p[pre + ".ls2.gamma"] * h
        if i in c.out_blocks:
            taps.append(tok)
    taps[-1] = F.layer_norm_p(p, "backbone.norm", taps[-1])
    return taps, (fh, fw)


def projector_forward(p, taps, hw, cfg: RFDETRConfig):
    """Concat tapped maps -> C2f block -> [B, H, W, d_model]."""
    b = taps[0].shape[0]
    fh, fw = hw
    x = torch.cat(taps, -1).reshape(b, fh, fw, -1)
    y = F.silu(F.conv2d_p(p, "projector.cv1.conv", x))
    half = y.shape[-1] // 2
    parts = [y[..., :half], y[..., half:]]
    for i in range(cfg.projector_n):
        m = F.silu(F.conv2d_p(p, f"projector.m.{i}.cv1.conv", parts[-1], padding=1))
        m = F.silu(F.conv2d_p(p, f"projector.m.{i}.cv2.conv", m, padding=1))
        parts.append(parts[-1] + m)
    return F.silu(F.conv2d_p(p, "projector.cv2.conv", torch.cat(parts, -1)))


# -- decoder ----------------------------------------------------------------

def _mlp3(p, pre, x):
    x = F.relu(F.linear_p(p, pre + ".0", x))
    x = F.relu(F.linear_p(p, pre + ".1", x))
    return F.linear_p(p, pre + ".2", x)


def sine_box_embed(boxes, dim_per_coord: int = 128, temperature: float = 10000.0):
    """[..., 4] normalized cxcywh -> [..., 4*dim_per_coord] sine features
    (DETR positional encoding applied per box coordinate)."""
    scale = 2 * np.pi
    freqs = _freqs_on(dim_per_coord // 2, temperature, boxes.device)
    ang = boxes[..., None] * scale / freqs          # [..., 4, half]
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(
        *boxes.shape[:-1], 4 * dim_per_coord)


@F.device_constant(maxsize=16)
def _freqs_on(half: int, temperature: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        temperature ** (np.arange(half, dtype=np.float32) / half)).to(device)


def bilinear_sample(vmap, loc):
    """Zero-padded bilinear sampling. vmap [B,h,w,C]; loc [B,S,2] normalized
    (x, y) in [0,1] -> [B,S,C]: ``grid_sample`` with align_corners=False,
    i.e. pixel centres at half-integers."""
    b, _, _, ch = vmap.shape
    grid = (loc * 2 - 1)[:, :, None, :]                  # [B,S,1,2]
    out = tF.grid_sample(vmap.permute(0, 3, 1, 2), grid.to(vmap.dtype),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False)           # [B,C,S,1]
    return out[..., 0].transpose(1, 2)


def deformable_attention(p, pre, query, value_map, ref_boxes, cfg: RFDETRConfig):
    """Box-relative multi-point deformable cross-attention (single scale).

    query [B,Q,d]; value_map [B,h,w,d]; ref_boxes [B,Q,4] normalized cxcywh.
    Sampling location (head m, point k) = ref_cxcy + offset_mk/points *
    ref_wh/2 (Deformable-DETR's box-relative parameterization)."""
    c = cfg
    b, q, d = query.shape
    hh, ww = value_map.shape[1], value_map.shape[2]
    dh = d // c.ca_heads
    off = F.linear_p(p, pre + ".sampling_offsets", query) \
        .reshape(b, q, c.ca_heads, c.ca_points, 2)
    attn = torch.softmax(F.linear_p(p, pre + ".attention_weights", query)
                         .reshape(b, q, c.ca_heads, c.ca_points), -1)
    val = F.linear_p(p, pre + ".value_proj", value_map.reshape(b, hh * ww, d)) \
        .reshape(b, hh, ww, c.ca_heads, dh)

    loc = ref_boxes[:, :, None, None, :2] + \
        off / c.ca_points * ref_boxes[:, :, None, None, 2:] * 0.5

    # fold heads into batch: each head samples its own channel slice
    val_h = val.permute(0, 3, 1, 2, 4).reshape(b * c.ca_heads, hh, ww, dh)
    loc_h = loc.permute(0, 2, 1, 3, 4).reshape(b * c.ca_heads, q * c.ca_points, 2)
    sampled = bilinear_sample(val_h, loc_h).reshape(b, c.ca_heads, q, c.ca_points, dh)
    out = (sampled * attn.permute(0, 2, 1, 3)[..., None]).sum(3)
    out = out.permute(0, 2, 1, 3).reshape(b, q, d)
    return F.linear_p(p, pre + ".output_proj", out)


def decoder_forward(p, memory_map, refs, tgt, cfg: RFDETRConfig):
    """The decoder with per-layer box refinement -> (tgt, boxes)."""
    c = cfg
    for li in range(c.dec_layers):
        pre = f"decoder.layers.{li}"
        pos = F.linear_p(p, "ref_point_head.1", F.relu(
            F.linear_p(p, "ref_point_head.0", sine_box_embed(refs, c.d_model // 2))))
        # self-attention over queries: q/k carry the box positional
        # embedding, v is the bare content (DETR convention)
        qq, kk, _ = F.linear_p(p, pre + ".self_attn.in_proj", tgt + pos).chunk(3, dim=-1)
        w_in = p[pre + ".self_attn.in_proj.weight"]
        b_in = p[pre + ".self_attn.in_proj.bias"]
        vv = F.linear(tgt, w_in[2 * c.d_model:], b_in[2 * c.d_model:])
        heads = c.sa_heads
        sa = F.merge_heads(F.mha(F.split_heads(qq, heads), F.split_heads(kk, heads),
                                 F.split_heads(vv, heads)))
        tgt = F.layer_norm_p(p, pre + ".norm1",
                             tgt + F.linear_p(p, pre + ".self_attn.out_proj", sa))
        # deformable cross-attention into the projector map
        ca = deformable_attention(p, pre + ".cross_attn", tgt + pos, memory_map, refs, c)
        tgt = F.layer_norm_p(p, pre + ".norm2", tgt + ca)
        ff = F.linear_p(p, pre + ".ffn.fc2",
                        F.relu(F.linear_p(p, pre + ".ffn.fc1", tgt)))
        tgt = F.layer_norm_p(p, pre + ".norm3", tgt + ff)
        # iterative box refinement
        refs = torch.sigmoid(inverse_sigmoid(refs) + _mlp3(p, "bbox_head", tgt))
    return F.layer_norm_p(p, "decoder.norm", tgt), refs


def proposals(params, memory_map, cfg: RFDETRConfig):
    """Two-stage selection: score every location of the projector map and
    keep the top-Q as the initial reference boxes -> (scores [B,N], indices
    [B,Q], refs [B,Q,4])."""
    c = cfg
    b, fh, fw, _ = memory_map.shape
    mem = memory_map.reshape(b, -1, c.d_model)
    enc = F.layer_norm_p(params, "enc_norm", F.linear_p(params, "enc_output", mem))
    scores = torch.sigmoid(F.linear_p(params, "enc_class", enc)).amax(-1)
    _, top = top_k(scores, c.num_queries)
    sel = torch.take_along_dim(enc, top[..., None], 1)
    gx = ((top % fw).to(enc.dtype) + 0.5) / fw
    gy = ((top // fw).to(enc.dtype) + 0.5) / fh
    anchors = torch.stack([gx, gy, torch.full_like(gx, 0.1),
                           torch.full_like(gy, 0.1)], -1)
    refs = torch.sigmoid(inverse_sigmoid(anchors) + _mlp3(params, "enc_bbox", sel))
    return scores, top, refs


def forward(params, x, cfg: RFDETRConfig):
    """Normalized float [B,H,W,3] -> (logits [B,Q,classes], boxes [B,Q,4])."""
    c = cfg
    taps, hw = backbone_forward(params, x, c)
    memory_map = projector_forward(params, taps, hw, c)
    _, _, refs = proposals(params, memory_map, c)
    tgt = params["query_embed"].to(memory_map.dtype).expand(
        memory_map.shape[0], c.num_queries, c.d_model)
    tgt, boxes = decoder_forward(params, memory_map, refs, tgt, c)
    return F.linear_p(params, "class_head", tgt), boxes


def preprocess(frames, res: int, bgr: bool = True, dtype=torch.float32):
    """uint8 [B,H,W,3] -> letterboxed, ImageNet-normalized float.

    auto=False: the ViT takes a fixed square res x res canvas (the full
    letterbox pad), unlike YOLO's minimal stride-32 pad."""
    x = image_ops.letterbox(frames, res, auto=False, bgr_to_rgb=bgr, dtype=dtype)
    return (x - _on("mean", x.device, dtype)) / _on("std", x.device, dtype)


def detect(params, frames, *, cfg: RFDETRConfig, conf_threshold: float = 0.5,
           max_det: int = 300):
    """uint8 frames [B,H,W,3] -> [B,max_det,6] source-pixel detections,
    computed in the params' dtype (the postprocess in f32)."""
    b, h, w, _ = frames.shape
    x = preprocess(frames, cfg.resolution, dtype=params["backbone.pos_embed"].dtype)
    logits, boxes = forward(params, x, cfg)
    rows = detr_postprocess(logits, boxes, (cfg.resolution, cfg.resolution),
                            conf_threshold, max_det, use_sigmoid=True)
    gain, pad_x, pad_y = image_ops.scale_boxes_params((h, w), cfg.resolution,
                                                      auto=False)
    scaled = box_ops.scale_boxes(rows[..., :4], gain, pad_x, pad_y, (h, w))
    live = (rows[..., 4] > 0)[..., None]
    return torch.cat([scaled * live, rows[..., 4:]], -1)


class RFDETR:
    """Host-side wrapper: uint8 BGR frame(s) -> [max_det,6] source-px rows.

    The same call surface as YOLOv9 and ``BatchDetector.detect_many``, so
    the MOT and evaluation tools can switch detectors. ``params``: numpy (or
    JAX) arrays in the JAX layout, random from seed 0 when None."""

    def __init__(self, variant: str = "nano", params: dict | None = None,
                 conf_threshold: float = 0.5, *, device="cuda"):
        self.cfg = _config(variant)
        self.conf_threshold = conf_threshold
        self.device = resolve_device(device)
        self.params = params_from_jax(
            params if params is not None else init_params(self.cfg), self.device)

    @classmethod
    def from_checkpoint(cls, path, variant: str = "nano", **kw):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "model" in sd:
            sd = sd["model"]
        sd = {k: v.float().numpy() for k, v in sd.items()}
        return cls(variant, params=convert_state_dict(sd), **kw)

    @torch.inference_mode()
    def __call__(self, frames):
        frames = torch.as_tensor(frames, device=self.device)
        single = frames.ndim == 3
        if single:
            frames = frames[None]
        out = detect(self.params, frames, cfg=self.cfg,
                     conf_threshold=self.conf_threshold)
        return out[0] if single else out

    def detect_many(self, frames):
        out = self(torch.from_numpy(np.stack(frames))).cpu().numpy()
        return [out[i] for i in range(len(frames))]
