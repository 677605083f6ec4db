"""YOLOv9 (t/s/m/c/e) over torch — the counterpart of
``clearcam_tpu.models.yolov9``:

    uint8 BGR frames -> letterbox -> backbone/neck -> DDetect + DFL
    -> dense triu-IoU NMS -> boxes scaled back to source pixels

The layer graphs are the same data as the JAX package's; parameters are a
flat dict keyed by the reference checkpoint names. ``init_params`` and
``convert_state_dict`` return numpy arrays in the JAX layout (HWIO), equal
to the JAX package's, and ``params_from_jax`` turns such a dict into torch
tensors once (OIHW filters stored ``channels_last``, on one device, in one
dtype; for the stem kernel, its float32 HWIO operands and its bf16 GEMM
operands besides). Activations are NHWC throughout.

Blocks 0-1 of the graphs whose stem is conv 3->16 s2 then 16->32 s2 (size
``t`` and ``dryrun``) run in the hand-written CUDA stem kernel
(``ops.stem``); other sizes run them through ``conv2d``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..nn import functional as F
from ..ops import boxes as box_ops
from ..ops import image as image_ops
from ..ops.nms import yolo_postprocess
from ..ops import stem as stem_ops

# channel hyperparameters per size: a..w (architecture facts)
SIZES = {
    "t": [16, 64, 96, 24, 128, 256, 224, 160, 48, 144, 192, 80, 32, 16, 3, 96, 32, 64, 128, 64, 64, 128],
    "s": [32, 128, 192, 48, 256, 512, 448, 320, 96, 288, 384, 128, 64, 32, 3, 192, 64, 64, 128, 128, 128, 256],
    "m": [32, 240, 360, 90, 480, 960, 840, 600, 184, 544, 720, 240, 128, 60, 1, 360, 120, 64, 128, 240, 240, 480],
    "c": [64, 256, 512, 128, 256, 1024, 1024, 1024, 128, 768, 1024, 256, 128, 64, 1, 256, 128, 128, 256, 128, 512, 512],
}

NUM_CLASSES = 80
REG_MAX = 16
STRIDES = (8, 16, 32)


@dataclass
class Layer:
    kind: str
    f: object = -1            # input: -1 (previous), int index, or list
    args: dict = field(default_factory=dict)


def _graph_small(size: str) -> list[Layer]:
    """23-layer graph for t/s/m/c."""
    a, b, c, d, e, f_, g, h, i, j, k, l, m, n, p, q, r, s, t, u, v, w = SIZES[size]
    L = Layer
    return [
        L("conv", args=dict(cin=3, cout=a, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=a, cout=a * 2, k=3, s=2, pad=1)),
        L("elan1", args=dict(ch0=a * 2, ch1=m, ch2=a, ch3=b)) if size in ("t", "s")
        else L("repncspelan4", args=dict(a=s, b=32, c=t, n=p)),
        L("adown", args=dict(ch=128)) if size == "c"
        else L("aconv", args=dict(cin=m, cout=u)),
        L("repncspelan4", args=dict(a=b, b=n, c=v, n=p)),
        L("adown", args=dict(ch=256)) if size == "c" else L("aconv", args=dict(cin=b, cout=q)),
        L("repncspelan4", args=dict(a=c, b=d, c=c, n=p)),
        L("adown", args=dict(ch=256)) if size == "c" else L("aconv", args=dict(cin=q, cout=e)),
        L("repncspelan4", args=dict(a=w, b=r, c=w, n=p)),
        L("sppelan", args=dict(ch0=w, ch1=b, ch2=f_, ch3=w)),
        L("upsample"),
        L("concat", f=[-1, 6]),
        L("repncspelan4", args=dict(a=g, b=d, c=c, n=p)),
        L("upsample"),
        L("concat", f=[-1, 4]),
        L("repncspelan4", args=dict(a=h, b=n, c=b, n=p)),
        L("adown", args=dict(ch=128)) if size == "c" else L("aconv", args=dict(cin=v, cout=i)),
        L("concat", f=[-1, 12]),
        L("repncspelan4", args=dict(a=j, b=d, c=c, n=p)),
        L("adown", args=dict(ch=256)) if size == "c" else L("aconv", args=dict(cin=q, cout=b)),
        L("concat", f=[-1, 9]),
        L("repncspelan4", args=dict(a=k, b=r, c=w, n=p)),
        L("ddetect", f=[15, 18, 21], args=dict(chs=(b, c, w), d=l)),
    ]


def _graph_e() -> list[Layer]:
    """43-layer GELAN-E graph with the CBLinear/CBFuse aux branch."""
    L = Layer
    return [
        L("silence"),
        L("conv", args=dict(cin=3, cout=64, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=64, cout=128, k=3, s=2, pad=1)),
        L("repncspelan4", args=dict(a=128, b=32, c=256, n=2)),
        L("adown", args=dict(ch=128)),
        L("repncspelan4", args=dict(a=256, b=64, c=512, n=2)),
        L("adown", args=dict(ch=256)),
        L("repncspelan4", args=dict(a=512, b=128, c=1024, n=2)),
        L("adown", args=dict(ch=512)),
        L("repncspelan4", args=dict(a=1024, b=128, c=1024, n=2)),
        L("cblinear", f=1, args=dict(cin=64, cout=64, c2s=(64,))),
        L("cblinear", f=3, args=dict(cin=256, cout=192, c2s=(64, 128))),
        L("cblinear", f=5, args=dict(cin=512, cout=448, c2s=(64, 128, 256))),
        L("cblinear", f=7, args=dict(cin=1024, cout=960, c2s=(64, 128, 256, 512))),
        L("cblinear", f=9, args=dict(cin=1024, cout=1984, c2s=(64, 128, 256, 512, 1024))),
        L("conv", f=0, args=dict(cin=3, cout=64, k=3, s=2, pad=1)),
        L("cbfuse", f=[10, 11, 12, 13, 14, -1], args=dict(idx=(0, 0, 0, 0, 0))),
        L("conv", args=dict(cin=64, cout=128, k=3, s=2, pad=1)),
        L("cbfuse", f=[11, 12, 13, 14, -1], args=dict(idx=(1, 1, 1, 1))),
        L("repncspelan4", args=dict(a=128, b=32, c=256, n=2)),
        L("adown", args=dict(ch=128)),
        L("cbfuse", f=[12, 13, 14, -1], args=dict(idx=(2, 2, 2))),
        L("repncspelan4", args=dict(a=256, b=64, c=512, n=2)),
        L("adown", args=dict(ch=256)),
        L("cbfuse", f=[13, 14, -1], args=dict(idx=(3, 3))),
        L("repncspelan4", args=dict(a=512, b=128, c=1024, n=2)),
        L("adown", args=dict(ch=512)),
        L("cbfuse", f=[14, -1], args=dict(idx=(4,))),
        L("repncspelan4", args=dict(a=1024, b=128, c=1024, n=2)),
        L("sppelan", f=28, args=dict(ch0=1024, ch1=256, ch2=1024, ch3=512)),
        L("upsample"),
        L("concat", f=[-1, 25]),
        L("repncspelan4", args=dict(a=1536, b=128, c=512, n=2)),
        L("upsample"),
        L("concat", f=[-1, 22]),
        L("repncspelan4", args=dict(a=1024, b=64, c=256, n=2)),
        L("adown", args=dict(ch=128)),
        L("concat", f=[-1, 32]),
        L("repncspelan4", args=dict(a=768, b=128, c=512, n=2)),
        L("adown", args=dict(ch=256)),
        L("concat", f=[-1, 29]),
        L("repncspelan4", args=dict(a=1024, b=256, c=512, n=2)),
        L("ddetect", f=[35, 38, 41], args=dict(chs=(256, 512, 512), d=256)),
    ]


def _graph_dryrun() -> list[Layer]:
    """Slim 6-layer graph: stride-32 conv stem + the full 3-scale DDetect."""
    L = Layer
    return [
        L("conv", args=dict(cin=3, cout=16, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=16, cout=32, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=32, cout=32, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=32, cout=64, k=3, s=2, pad=1)),
        L("conv", args=dict(cin=64, cout=64, k=3, s=2, pad=1)),
        L("ddetect", f=[2, 3, 4], args=dict(chs=(32, 64, 64), d=32)),
    ]


def layer_graph(size: str) -> list[Layer]:
    if size == "dryrun":
        return _graph_dryrun()
    return _graph_e() if size == "e" else _graph_small(size)


_STEM_ARGS = (dict(cin=3, cout=16, k=3, s=2, pad=1),
              dict(cin=16, cout=32, k=3, s=2, pad=1))
# the stem kernel's operands, made once by params_from_jax with ops.stem.pack:
# its f32 HWIO ones (from these layers), then the bf16 route's, in Packed's order
STEM_KEYS = {"stem.w1": "model.0.conv.weight", "stem.b1": "model.0.conv.bias",
             "stem.w2": "model.1.conv.weight", "stem.b2": "model.1.conv.bias"}
STEM_PACKED_KEYS = (*STEM_KEYS, "stem.w1k", "stem.w2k")


def uses_stem_kernel(size: str) -> bool:
    """True when layers 0-1 are conv 3->16 s2 then 16->32 s2, the shapes
    of the fused stem kernel (sizes ``t`` and ``dryrun``)."""
    l0, l1 = layer_graph(size)[:2]
    return (l0.kind == l1.kind == "conv" and l1.f == -1
            and (l0.args, l1.args) == _STEM_ARGS)


# ---------------------------------------------------------------------------
# parameters: numpy in the JAX layout (HWIO), then torch once
# ---------------------------------------------------------------------------

class _Init:
    """Random params keyed by reference names; the same numpy stream, in
    the same order, as the JAX package's ``_Init``."""

    def __init__(self, rng: np.random.Generator, dtype=np.float32):
        self.rng = rng
        self.params: dict[str, np.ndarray] = {}
        self.dtype = dtype

    def conv(self, prefix, cin, cout, k, groups=1, bias=True):
        fan_in = cin // groups * k * k
        w = self.rng.normal(0, (2.0 / fan_in) ** 0.5, (k, k, cin // groups, cout))
        self.params[prefix + ".weight"] = np.asarray(w, self.dtype)
        if bias:
            self.params[prefix + ".bias"] = np.zeros((cout,), self.dtype)


def _init_block(ini: _Init, kind: str, prefix: str, args: dict):
    cv = ini.conv
    if kind == "conv":
        cv(prefix + ".conv", args["cin"], args["cout"], args["k"])
    elif kind == "aconv":
        cv(prefix + ".cv1.conv", args["cin"], args["cout"], 3)
    elif kind == "adown":
        ch = args["ch"]
        cv(prefix + ".cv1.conv", ch, ch, 3)
        cv(prefix + ".cv2.conv", ch, ch, 1)
    elif kind == "elan1":
        ch0, ch1, ch2, ch3 = args["ch0"], args["ch1"], args["ch2"], args["ch3"]
        cv(prefix + ".cv1.conv", ch0, ch1, 1)
        cv(prefix + ".cv2.conv", ch2, ch2, 3)
        cv(prefix + ".cv3.conv", ch2, ch2, 3)
        cv(prefix + ".cv4.conv", ch3, ch1, 1)
    elif kind == "repncsp":
        a, b, n = args["a"], args["b"], args["n"]
        cv(prefix + ".cv1.conv", a, b, 1)
        cv(prefix + ".cv2.conv", a, b, 1)
        cv(prefix + ".cv3.conv", a, a, 1)
        for i in range(n):
            cv(f"{prefix}.m.{i}.cv1.conv", b, b, 3)
            cv(f"{prefix}.m.{i}.cv2.conv", b, b, 3)
    elif kind == "repncspelan4":
        a, b, n = args["a"], args["b"], args["n"]
        cv(prefix + ".cv1.conv", a, b * 4, 1)
        _init_block(ini, "repncsp", prefix + ".cv2.0", dict(a=b * 2, b=b, n=n))
        cv(prefix + ".cv2.1.conv", b * 2, b * 2, 3)
        _init_block(ini, "repncsp", prefix + ".cv3.0", dict(a=b * 2, b=b, n=n))
        cv(prefix + ".cv3.1.conv", b * 2, b * 2, 3)
        cv(prefix + ".cv4.conv", b * 8, args["c"], 1)
    elif kind == "sppelan":
        cv(prefix + ".cv1.conv", args["ch0"], args["ch1"], 1)
        cv(prefix + ".cv5.conv", args["ch2"], args["ch3"], 1)
    elif kind == "cblinear":
        cv(prefix + ".conv", args["cin"], args["cout"], 1)
    elif kind == "ddetect":
        chs, d = args["chs"], args["d"]
        for i, cin in enumerate(chs):
            cv(f"{prefix}.cv2.{i}.0.conv", cin, 64, 3)
            cv(f"{prefix}.cv2.{i}.1.conv", 64, 64, 3, groups=4)
            cv(f"{prefix}.cv2.{i}.2", 64, 64, 1, groups=4)
            cv(f"{prefix}.cv3.{i}.0.conv", cin, d, 3)
            cv(f"{prefix}.cv3.{i}.1.conv", d, d, 3)
            cv(f"{prefix}.cv3.{i}.2", d, NUM_CLASSES, 1)
        # DFL integration weights (bin expectation: arange)
        ini.params[prefix + ".dfl.conv.weight"] = np.arange(REG_MAX, dtype=ini.dtype)
    elif kind in ("upsample", "concat", "silence", "cbfuse"):
        pass
    else:
        raise ValueError(kind)


def init_params(size: str = "t", seed: int = 0, dtype=np.float32) -> dict:
    """Random HWIO numpy params, equal to ``clearcam_tpu``'s for the same
    (size, seed): a camera without weights detects the same in both."""
    ini = _Init(np.random.default_rng(seed), dtype)
    for idx, layer in enumerate(layer_graph(size)):
        _init_block(ini, layer.kind, f"model.{idx}", layer.args)
    return ini.params


def convert_state_dict(sd: dict[str, np.ndarray], dtype=np.float32) -> dict:
    """Published yolov9-{size}.safetensors state dict (tinygrad names, OIHW)
    -> flat HWIO numpy params, as the JAX package converts it."""
    out: dict[str, np.ndarray] = {}
    for key, arr in sd.items():
        k = key.replace(".list.", ".").replace(".list", "")
        if k.endswith(("anchors", "strides")):
            continue  # recomputed from the feature shapes
        arr = np.asarray(arr, np.float32)
        if k.endswith("dfl.conv.weight"):
            out[k] = arr.reshape(-1).astype(dtype)
            continue
        if k.endswith(".weight") and arr.ndim == 4:
            arr = F.oihw_to_hwio(arr)
        out[k] = arr.astype(dtype)
    return out


def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Flat HWIO params (numpy, or JAX arrays) -> torch tensors on
    ``device`` in ``dtype``: filters become OIHW once, stored
    ``channels_last`` so cuDNN reads them beside NHWC activations without
    a per-call transpose.

    When layers 0-1 have the stem kernel's shapes (sizes ``t`` and
    ``dryrun``), the dict also holds the kernel's operands under
    ``STEM_PACKED_KEYS``: ``ops.stem.pack`` of the same values rounded to
    ``dtype`` (float32 HWIO, and bf16 K-major), so no step re-packs them."""
    out = F.tensors_from_numpy(params, resolve_device(device), dtype)
    w1, w2 = params.get("model.0.conv.weight"), params.get("model.1.conv.weight")
    if (np.shape(w1), np.shape(w2)) == ((3, 3, 3, 16), (3, 3, 16, 32)):
        hwio = (F.oihw_to_hwio(out[src]) if out[src].ndim == 4 else out[src]
                for src in STEM_KEYS.values())
        out.update(zip(STEM_PACKED_KEYS, stem_ops.pack(*hwio)))
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _conv_silu(p, prefix, x, s=1, pad=None, groups=1):
    w = p[prefix + ".weight"]
    if pad is None:
        pad = w.shape[-1] // 2
    return F.silu(F.conv2d_oihw(x, w, p.get(prefix + ".bias"), stride=s,
                                padding=pad, groups=groups))


def _apply_repncsp(p, prefix, x, n):
    x1 = _conv_silu(p, prefix + ".cv1.conv", x)
    for i in range(n):
        bp = f"{prefix}.m.{i}"
        x1 = x1 + _conv_silu(p, bp + ".cv2.conv", _conv_silu(p, bp + ".cv1.conv", x1))
    x3 = _conv_silu(p, prefix + ".cv2.conv", x)
    return _conv_silu(p, prefix + ".cv3.conv", torch.cat([x1, x3], -1))


def _apply_layer(p, idx, layer: Layer, x):
    kind, args = layer.kind, layer.args
    pre = f"model.{idx}"
    if kind == "silence":
        return x
    if kind == "conv":
        return _conv_silu(p, pre + ".conv", x, s=args["s"], pad=args["pad"])
    if kind == "aconv":
        x = F.avg_pool2d(x, 2, 1, 0, count_include_pad=True)
        return _conv_silu(p, pre + ".cv1.conv", x, s=2, pad=1)
    if kind == "adown":
        x = F.avg_pool2d(x, 2, 1, 0, count_include_pad=True)
        c = x.shape[-1] // 2
        x1 = _conv_silu(p, pre + ".cv1.conv", x[..., :c], s=2, pad=1)
        x2 = F.max_pool2d(x[..., c:], 3, 2, 1)
        x2 = _conv_silu(p, pre + ".cv2.conv", x2)
        return torch.cat([x1, x2], -1)
    if kind == "elan1":
        y = _conv_silu(p, pre + ".cv1.conv", x)
        c = y.shape[-1] // 2
        y0, y1 = y[..., :c], y[..., c:]
        y2 = _conv_silu(p, pre + ".cv2.conv", y1)
        y3 = _conv_silu(p, pre + ".cv3.conv", y2)
        return _conv_silu(p, pre + ".cv4.conv", torch.cat([y0, y1, y2, y3], -1))
    if kind == "repncspelan4":
        y = _conv_silu(p, pre + ".cv1.conv", x)
        c = y.shape[-1] // 2
        y0, y1 = y[..., :c], y[..., c:]
        y2 = _apply_repncsp(p, pre + ".cv2.0", y1, args["n"])
        y2 = _conv_silu(p, pre + ".cv2.1.conv", y2)
        y3 = _apply_repncsp(p, pre + ".cv3.0", y2, args["n"])
        y3 = _conv_silu(p, pre + ".cv3.1.conv", y3)
        return _conv_silu(p, pre + ".cv4.conv", torch.cat([y0, y1, y2, y3], -1))
    if kind == "sppelan":
        y = [_conv_silu(p, pre + ".cv1.conv", x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], 5, 1, 2))
        return _conv_silu(p, pre + ".cv5.conv", torch.cat(y, -1))
    if kind == "upsample":
        return F.upsample_nearest(x, 2)
    if kind == "concat":
        return torch.cat(x, -1)
    if kind == "cblinear":
        y = F.conv2d_oihw(x, p[pre + ".conv.weight"], p[pre + ".conv.bias"])
        return torch.split(y, list(args["c2s"]), dim=-1)
    if kind == "cbfuse":
        *branches, base = x
        total = base
        for i, br in enumerate(branches):
            sel = br[args["idx"][i]]
            # half-pixel nearest, as jax.image.resize(method="nearest")
            up = torch.nn.functional.interpolate(
                sel.permute(0, 3, 1, 2), size=tuple(base.shape[1:3]),
                mode="nearest-exact")
            total = total + up.permute(0, 2, 3, 1)
        return total
    if kind == "ddetect":
        return _apply_ddetect(p, pre, x)
    raise ValueError(kind)


def _make_anchors(shapes_hw, strides=STRIDES, offset=0.5):
    """Anchor centres + per-anchor stride from the feature shapes (numpy)."""
    pts, strs = [], []
    for (h, w), s in zip(shapes_hw, strides):
        sx = np.arange(w, dtype=np.float32) + offset
        sy = np.arange(h, dtype=np.float32) + offset
        gx = np.tile(sx[None, :], (h, 1)).reshape(-1)
        gy = np.tile(sy[:, None], (1, w)).reshape(-1)
        pts.append(np.stack([gx, gy], -1))
        strs.append(np.full((h * w,), s, np.float32))
    return np.concatenate(pts), np.concatenate(strs)


@functools.lru_cache(maxsize=64)
def _anchors_on(shapes_hw: tuple, device: torch.device):
    """Anchors as device tensors, made once per (feature shapes, device)."""
    anchors, strides = _make_anchors(shapes_hw)
    return (torch.from_numpy(anchors).to(device),
            torch.from_numpy(strides).to(device))


def _apply_ddetect(p, pre, feats):
    """DDetect head: per-scale box/cls convs, DFL expectation, dist2bbox."""
    outs, shapes = [], []
    for i, f in enumerate(feats):
        bb = _conv_silu(p, f"{pre}.cv2.{i}.0.conv", f)
        bb = _conv_silu(p, f"{pre}.cv2.{i}.1.conv", bb, groups=4)
        bb = F.conv2d_oihw(bb, p[f"{pre}.cv2.{i}.2.weight"],
                           p[f"{pre}.cv2.{i}.2.bias"], groups=4)
        cc = _conv_silu(p, f"{pre}.cv3.{i}.0.conv", f)
        cc = _conv_silu(p, f"{pre}.cv3.{i}.1.conv", cc)
        cc = F.conv2d_oihw(cc, p[f"{pre}.cv3.{i}.2.weight"],
                           p[f"{pre}.cv3.{i}.2.bias"])
        y = torch.cat([bb, cc], -1)                  # [B,h,w,64+nc]
        b, h, w, ch = y.shape
        shapes.append((h, w))
        outs.append(y.reshape(b, h * w, ch))
    y = torch.cat(outs, 1)                           # [B,N,64+nc]
    box, cls = y[..., : REG_MAX * 4], y[..., REG_MAX * 4:]

    anchors, strides = _anchors_on(tuple(shapes), y.device)
    b, n = box.shape[:2]
    # DFL: softmax over 16 bins, expectation with the integration weights
    dist = box.reshape(b, n, 4, REG_MAX).float()
    dist = torch.softmax(dist, -1) @ p[f"{pre}.dfl.conv.weight"].float()
    dbox = box_ops.dist2bbox(dist, anchors, xywh=True) * strides[None, :, None]
    return torch.cat([dbox, torch.sigmoid(cls.float())], -1)   # [B,N,4+nc]


def forward_raw(params, x, size: str = "t"):
    """Letterboxed NHWC input [B,H,W,3] (RGB, 0..1) -> head output
    [B,N,4+nc] float32."""
    graph = layer_graph(size)
    y: list = []
    cur = x
    if uses_stem_kernel(size):
        cur = stem_ops.stem_packed(
            x, stem_ops.Packed(*(params[k] for k in STEM_PACKED_KEYS)))
        y = [None, cur]          # no later layer reads layer 0 of t/dryrun
    for idx in range(len(y), len(graph)):
        layer = graph[idx]
        if layer.f != -1:
            if isinstance(layer.f, int):
                cur = y[layer.f]
            else:
                cur = [cur if j == -1 else y[j] for j in layer.f]
        cur = _apply_layer(params, idx, layer, cur)
        y.append(cur)
    return cur


def detect(params, frames, *, size: str = "t", res: int = 960,
           conf_threshold: float = 0.25, iou_threshold: float = 0.45,
           max_det: int = 300, bgr: bool = True, compute_dtype=torch.float32):
    """uint8 [B,H,W,3] frames -> [B,max_det,6] detections (x1,y1,x2,y2,
    score,class) in source-pixel coordinates, suppressed rows zeroed."""
    h, w = frames.shape[1:3]
    x = image_ops.letterbox(frames, res, bgr_to_rgb=bgr, dtype=compute_dtype)
    raw = forward_raw(params, x, size)
    preds = yolo_postprocess(raw, max_det, conf_threshold, iou_threshold)
    gain, pad_x, pad_y = image_ops.scale_boxes_params((h, w), res)
    scaled = box_ops.scale_boxes(preds[..., :4], gain, pad_x, pad_y, (h, w))
    # keep zeroed (suppressed) rows zeroed after the affine rescale
    live = (preds[..., 4] > 0)[..., None]
    return torch.cat([scaled * live, preds[..., 4:]], -1)


class YOLOv9(nn.Module):
    """Module form: ``YOLOv9("t", res=640)(frames)`` on [H,W,3] or
    [B,H,W,3] uint8 BGR frames (numpy or tensor). Parameters live in a
    ``ParameterDict`` whose keys are the checkpoint names with "." -> "/"
    (a parameter name cannot hold ".")."""

    def __init__(self, size: str = "t", res: int = 960, params: dict | None = None,
                 *, dtype=torch.float32, device="cuda"):
        super().__init__()
        self.size, self.res, self.dtype = size, res, dtype
        tensors = params_from_jax(params if params is not None
                                  else init_params(size), device, dtype)
        self.params = nn.ParameterDict({
            k.replace(".", "/"): nn.Parameter(v, requires_grad=False)
            for k, v in tensors.items()})

    def flat_params(self) -> dict:
        return {k.replace("/", "."): v for k, v in self.params.items()}

    @torch.inference_mode()
    def forward(self, frames):
        dev = next(iter(self.params.values())).device
        frames = torch.as_tensor(frames, device=dev)
        single = frames.ndim == 3
        if single:
            frames = frames[None]
        out = detect(self.flat_params(), frames, size=self.size, res=self.res,
                     compute_dtype=self.dtype)
        return out[0] if single else out
