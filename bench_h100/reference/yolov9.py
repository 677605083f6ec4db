"""Plain YOLOv9 detect (the t/s/m/c graphs) in float32 PyTorch.

Written from the published architecture (WongKinYiu/yolov9,
models/detect/gelan-{t,s,m,c}.yaml with the re-parameterised RepConvN
folded into one 3x3 conv, batch norm folded into each conv's bias, as the
converted checkpoints ship), with nothing of the program: NCHW tensors,
``torch.nn.functional`` convolutions, one plain loop over the layer graph.

What it computes for uint8 BGR frames:

  letterbox to ``res`` (stride-32 "auto" padding, zero pad; the resize is an
  exact centre tap for an odd integer downscale, the 2x2 mean for an even
  one, half-pixel bilinear otherwise), BGR -> RGB, / 255
  -> backbone and neck -> DDetect: per scale a box branch (DFL logits,
  4 x 16 bins) and a class branch (80 logits)
  -> DFL expectation over the bins, dist2bbox (xywh) times the stride,
  class sigmoid
  -> dense NMS: the top ``max_det`` anchors by class score (stable sort),
  a box dropped when any higher-ranked box of its class overlaps it by more
  than ``iou_threshold`` (even one that was itself dropped), scores below
  ``conf_threshold`` dead
  -> boxes mapped back to source pixels and clipped.

``cast`` is applied to every convolution's input and filter: the identity
gives float32, ``fp8`` a lower precision (the control of the benchmark's
comparison).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

REG_MAX = 16
STRIDES = (8, 16, 32)


def graph(ch: list[int], elan1: bool, adown: bool) -> list[tuple]:
    """The 23 layers of the t/s/m/c graphs from the 22 channel numbers of
    the configuration (``channels``): (kind, inputs, args); inputs -1 is
    the previous layer. ``elan1``: layer 2 is ELAN1 (t, s), else
    RepNCSPELAN4; ``adown``: the downsamples are ADown (c), else AConv."""
    a, b, c, d, e, f_, g, h, i, j, k, l, m, n, p, q, r, s, t, u, v, w = ch

    def down(cin, cout, ch_):
        return ("adown", -1, dict(ch=ch_)) if adown else ("aconv", -1, dict(cin=cin, cout=cout))
    return [
        ("conv", -1, dict(cin=3, cout=a, k=3, s=2, pad=1)),
        ("conv", -1, dict(cin=a, cout=a * 2, k=3, s=2, pad=1)),
        ("elan1", -1, dict(ch0=a * 2, ch1=m, ch2=a, ch3=b)) if elan1
        else ("repncspelan4", -1, dict(a=s, b=32, c=t, n=p)),
        down(m, u, 128),
        ("repncspelan4", -1, dict(a=b, b=n, c=v, n=p)),
        down(b, q, 256),
        ("repncspelan4", -1, dict(a=c, b=d, c=c, n=p)),
        down(q, e, 256),
        ("repncspelan4", -1, dict(a=w, b=r, c=w, n=p)),
        ("sppelan", -1, dict(ch0=w, ch1=b, ch2=f_, ch3=w)),
        ("upsample", -1, {}),
        ("concat", [-1, 6], {}),
        ("repncspelan4", -1, dict(a=g, b=d, c=c, n=p)),
        ("upsample", -1, {}),
        ("concat", [-1, 4], {}),
        ("repncspelan4", -1, dict(a=h, b=n, c=b, n=p)),
        down(v, i, 128),
        ("concat", [-1, 12], {}),
        ("repncspelan4", -1, dict(a=j, b=d, c=c, n=p)),
        down(q, b, 256),
        ("concat", [-1, 9], {}),
        ("repncspelan4", -1, dict(a=k, b=r, c=w, n=p)),
        ("ddetect", [15, 18, 21], dict(chs=(b, c, w), d=l)),
    ]


def conv_specs(cfg: dict) -> list[tuple]:
    """Every convolution of the graph in checkpoint order: (name prefix,
    cin, cout, k, stride, groups, silu). The weights are ``prefix +
    ".weight"`` (HWIO), the biases ``prefix + ".bias"``."""
    out = []

    def cv(pre, cin, cout, k, s=1, groups=1, act=True):
        out.append((pre, cin, cout, k, s, groups, act))

    def repncsp(pre, a, b, n):
        cv(pre + ".cv1.conv", a, b, 1)
        cv(pre + ".cv2.conv", a, b, 1)
        cv(pre + ".cv3.conv", a, a, 1)
        for i in range(n):
            cv(f"{pre}.m.{i}.cv1.conv", b, b, 3)
            cv(f"{pre}.m.{i}.cv2.conv", b, b, 3)

    num_classes = cfg["num_classes"]
    for idx, (kind, _, args) in enumerate(graph_of(cfg)):
        pre = f"model.{idx}"
        if kind == "conv":
            cv(pre + ".conv", args["cin"], args["cout"], args["k"], args["s"])
        elif kind == "aconv":
            cv(pre + ".cv1.conv", args["cin"], args["cout"], 3, 2)
        elif kind == "adown":
            cv(pre + ".cv1.conv", args["ch"], args["ch"], 3, 2)
            cv(pre + ".cv2.conv", args["ch"], args["ch"], 1)
        elif kind == "elan1":
            cv(pre + ".cv1.conv", args["ch0"], args["ch1"], 1)
            cv(pre + ".cv2.conv", args["ch2"], args["ch2"], 3)
            cv(pre + ".cv3.conv", args["ch2"], args["ch2"], 3)
            cv(pre + ".cv4.conv", args["ch3"], args["ch1"], 1)
        elif kind == "repncspelan4":
            a, b, n = args["a"], args["b"], args["n"]
            cv(pre + ".cv1.conv", a, b * 4, 1)
            repncsp(pre + ".cv2.0", b * 2, b, n)
            cv(pre + ".cv2.1.conv", b * 2, b * 2, 3)
            repncsp(pre + ".cv3.0", b * 2, b, n)
            cv(pre + ".cv3.1.conv", b * 2, b * 2, 3)
            cv(pre + ".cv4.conv", b * 8, args["c"], 1)
        elif kind == "sppelan":
            cv(pre + ".cv1.conv", args["ch0"], args["ch1"], 1)
            cv(pre + ".cv5.conv", args["ch2"], args["ch3"], 1)
        elif kind == "ddetect":
            for i, cin in enumerate(args["chs"]):
                cv(f"{pre}.cv2.{i}.0.conv", cin, 64, 3)
                cv(f"{pre}.cv2.{i}.1.conv", 64, 64, 3, groups=4)
                cv(f"{pre}.cv2.{i}.2", 64, 64, 1, groups=4, act=False)
                cv(f"{pre}.cv3.{i}.0.conv", cin, args["d"], 3)
                cv(f"{pre}.cv3.{i}.1.conv", args["d"], args["d"], 3)
                cv(f"{pre}.cv3.{i}.2", args["d"], num_classes, 1, act=False)
    return out


def _identity(t):
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale a tensor (amax -> 448), back in
    float32."""
    s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def graph_of(cfg: dict) -> list[tuple]:
    """``graph`` for a configuration file's dict."""
    return graph(cfg["channels"], cfg["layer2"] == "elan1", cfg["downsample"] == "adown")


class Model:
    """The float32 network on ``device`` from HWIO numpy weights keyed by
    checkpoint names (the benchmark's inputs)."""

    def __init__(self, cfg: dict, weights: dict, device, cast=None):
        self.graph = graph_of(cfg)
        self.cast = cast or _identity
        self.w = {}
        self.meta = {}
        for pre, cin, cout, k, s, groups, act in conv_specs(cfg):
            hwio = np.asarray(weights[pre + ".weight"], np.float32)
            self.w[pre] = (torch.from_numpy(hwio).permute(3, 2, 0, 1).contiguous().to(device),
                           torch.from_numpy(np.asarray(weights[pre + ".bias"], np.float32))
                           .to(device))
            self.meta[pre] = (k, s, groups, act)
        self.dfl = torch.from_numpy(np.asarray(
            weights[f"model.{len(self.graph) - 1}.dfl.conv.weight"], np.float32)).to(device)

    def conv(self, pre, x, stride=None):
        k, s, groups, act = self.meta[pre]
        w, b = self.w[pre]
        y = tF.conv2d(self.cast(x), self.cast(w), b, stride=stride or s,
                      padding=k // 2, groups=groups)
        return tF.silu(y) if act else y

    def repncsp(self, pre, x, n):
        x1 = self.conv(pre + ".cv1.conv", x)
        for i in range(n):
            x1 = x1 + self.conv(f"{pre}.m.{i}.cv2.conv", self.conv(f"{pre}.m.{i}.cv1.conv", x1))
        return self.conv(pre + ".cv3.conv", torch.cat([x1, self.conv(pre + ".cv2.conv", x)], 1))

    def layer(self, idx, kind, args, x):
        pre = f"model.{idx}"
        if kind == "conv":
            return self.conv(pre + ".conv", x)
        if kind == "aconv":
            return self.conv(pre + ".cv1.conv", tF.avg_pool2d(x, 2, 1, 0))
        if kind == "adown":
            x = tF.avg_pool2d(x, 2, 1, 0)
            c = x.shape[1] // 2
            return torch.cat([self.conv(pre + ".cv1.conv", x[:, :c]),
                              self.conv(pre + ".cv2.conv", tF.max_pool2d(x[:, c:], 3, 2, 1))], 1)
        if kind == "elan1":
            y = self.conv(pre + ".cv1.conv", x)
            c = y.shape[1] // 2
            y2 = self.conv(pre + ".cv2.conv", y[:, c:])
            y3 = self.conv(pre + ".cv3.conv", y2)
            return self.conv(pre + ".cv4.conv", torch.cat([y[:, :c], y[:, c:], y2, y3], 1))
        if kind == "repncspelan4":
            y = self.conv(pre + ".cv1.conv", x)
            c = y.shape[1] // 2
            y2 = self.conv(pre + ".cv2.1.conv", self.repncsp(pre + ".cv2.0", y[:, c:], args["n"]))
            y3 = self.conv(pre + ".cv3.1.conv", self.repncsp(pre + ".cv3.0", y2, args["n"]))
            return self.conv(pre + ".cv4.conv", torch.cat([y[:, :c], y[:, c:], y2, y3], 1))
        if kind == "sppelan":
            ys = [self.conv(pre + ".cv1.conv", x)]
            for _ in range(3):
                ys.append(tF.max_pool2d(ys[-1], 5, 1, 2))
            return self.conv(pre + ".cv5.conv", torch.cat(ys, 1))
        if kind == "upsample":
            return tF.interpolate(x, scale_factor=2, mode="nearest")
        if kind == "concat":
            return torch.cat(x, 1)
        if kind == "ddetect":
            return self.head(pre, x)
        raise ValueError(kind)

    def branches(self, pre, feats):
        """Per scale, the box branch's DFL logits and the class branch's
        logits, [B, 64, h, w] and [B, nc, h, w]."""
        out = []
        for i, f in enumerate(feats):
            bb = self.conv(f"{pre}.cv2.{i}.2", self.conv(f"{pre}.cv2.{i}.1.conv",
                                                          self.conv(f"{pre}.cv2.{i}.0.conv", f)))
            cc = self.conv(f"{pre}.cv3.{i}.2", self.conv(f"{pre}.cv3.{i}.1.conv",
                                                          self.conv(f"{pre}.cv3.{i}.0.conv", f)))
            out.append((bb, cc))
        return out

    def head(self, pre, feats):
        outs, anchors, strides = [], [], []
        for (bb, cc), s in zip(self.branches(pre, feats), STRIDES):
            y = torch.cat([bb, cc], 1)
            nb, ch, h, w = y.shape
            outs.append(y.reshape(nb, ch, h * w))
            gy, gx = torch.meshgrid(torch.arange(h, device=y.device, dtype=torch.float32) + 0.5,
                                    torch.arange(w, device=y.device, dtype=torch.float32) + 0.5,
                                    indexing="ij")
            anchors.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
            strides.append(torch.full((h * w,), float(s), device=y.device))
        y = torch.cat(outs, 2).transpose(1, 2)             # [B, N, 64 + nc]
        anchors, strides = torch.cat(anchors), torch.cat(strides)
        nb, n = y.shape[:2]
        dist = torch.softmax(y[..., :4 * REG_MAX].reshape(nb, n, 4, REG_MAX), -1) @ self.dfl
        x1y1, x2y2 = anchors - dist[..., :2], anchors + dist[..., 2:]
        box = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * strides[:, None]
        return box, torch.sigmoid(y[..., 4 * REG_MAX:])   # xywh [B,N,4], probs [B,N,nc]

    @torch.no_grad()
    def branch_outputs(self, frames: torch.Tensor, res: int):
        """``branches`` of the letterboxed frames (the head's raw outputs)."""
        ys, cur = [], letterbox(frames, res)
        for idx, (kind, src, args) in enumerate(self.graph):
            if src != -1:
                cur = ys[src] if isinstance(src, int) else [cur if j == -1 else ys[j] for j in src]
            if kind == "ddetect":
                return self.branches(f"model.{idx}", cur)
            cur = self.layer(idx, kind, args, cur)
            ys.append(cur)
        raise ValueError("the graph has no head")

    def forward(self, x):
        ys, cur = [], x
        for idx, (kind, src, args) in enumerate(self.graph):
            if src != -1:
                cur = ys[src] if isinstance(src, int) else [cur if j == -1 else ys[j] for j in src]
            cur = self.layer(idx, kind, args, cur)
            ys.append(cur)
        return cur


def letterbox_geometry(h: int, w: int, res: int, stride: int = 32):
    """(new_h, new_w, pad_top, pad_left, out_h, out_w) of the letterbox."""
    r = min(res / h, res / w)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = (res - new_w) % stride, (res - new_h) % stride
    pl, pt = int(round(dw / 2 - 0.1)), int(round(dh / 2 - 0.1))
    return new_h, new_w, pt, pl, new_h + 2 * pt, new_w + 2 * pl


def letterbox(frames: torch.Tensor, res: int) -> torch.Tensor:
    """uint8 BGR [B,H,W,3] -> float32 RGB [B,3,H',W'] in [0, 1]."""
    nb, h, w, _ = frames.shape
    new_h, new_w, pt, pl, out_h, out_w = letterbox_geometry(h, w, res)
    x = frames.permute(0, 3, 1, 2).float()
    if (new_h, new_w) != (h, w):
        k = h // new_h
        exact = h % new_h == 0 and w % new_w == 0 and w // new_w == k and k > 1
        if exact and k % 2 == 1:
            x = x[:, :, (k - 1) // 2::k, (k - 1) // 2::k]
        elif exact:
            x = tF.avg_pool2d(x[:, :, k // 2 - 1:, k // 2 - 1:], 2, k)[:, :, :new_h, :new_w]
        else:
            x = tF.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False)
    x = x.flip(1) / 255.0
    return tF.pad(x, (pl, out_w - new_w - pl, pt, out_h - new_h - pt))


def xywh_to_xyxy(b):
    xc, yc, bw, bh = b.unbind(-1)
    return torch.stack([xc - bw / 2, yc - bh / 2, xc + bw / 2, yc + bh / 2], -1)


def to_source(xyxy, h: int, w: int, res: int):
    """Letterbox-space xyxy [..., 4] -> source-pixel xyxy, clipped."""
    _, _, _, _, out_h, out_w = letterbox_geometry(h, w, res)
    gain = min(out_h / h, out_w / w)
    px, py = (out_w - w * gain) / 2, (out_h - h * gain) / 2
    x1, y1, x2, y2 = xyxy.unbind(-1)
    return torch.stack([((x1 - px) / gain).clamp(0, w), ((y1 - py) / gain).clamp(0, h),
                        ((x2 - px) / gain).clamp(0, w), ((y2 - py) / gain).clamp(0, h)], -1)


def nms_rows(box_xywh, probs, max_det=300, conf=0.25, iou=0.45):
    """[B,N,4] letterbox xywh and [B,N,nc] probs -> ([B,K,6] rows (xyxy in
    letterbox space, score, class), suppressed rows zero; [B,K] the anchor
    of each row, -1 where suppressed)."""
    score, cls = probs.max(-1)
    score = torch.where(score >= conf, score, torch.zeros_like(score))
    k = min(max_det, score.shape[1])
    top, order = torch.sort(score, dim=1, descending=True, stable=True)
    top, order = top[:, :k], order[:, :k]
    xyxy = xywh_to_xyxy(torch.gather(box_xywh, 1, order[..., None].expand(-1, -1, 4)))
    c = torch.gather(cls, 1, order)
    x1, y1, x2, y2 = xyxy.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iw = (torch.minimum(x2[:, :, None], x2[:, None]) - torch.maximum(x1[:, :, None], x1[:, None]))
    ih = (torch.minimum(y2[:, :, None], y2[:, None]) - torch.maximum(y1[:, :, None], y1[:, None]))
    inter = iw.clamp(min=0) * ih.clamp(min=0)
    over = inter / (area[:, :, None] + area[:, None] - inter) > iou
    earlier = torch.ones(k, k, dtype=torch.bool, device=score.device).triu(1)
    drop = (over & earlier & (c[:, :, None] == c[:, None])).any(1)
    keep = ~drop & (top > 0)
    rows = torch.cat([xyxy, top[..., None], c[..., None].float()], -1)
    return rows * keep[..., None], torch.where(keep, order, torch.full_like(order, -1))


@torch.no_grad()
def detect(model: Model, frames: torch.Tensor, res: int, max_det=300, conf=0.25, iou=0.45):
    """uint8 BGR [B,H,W,3] frames of one shape -> (rows [B,K,6] in source
    pixels, the anchor each row comes from [B,K] (-1: suppressed), boxes
    of every anchor [B,N,4] source-pixel xyxy, probs [B,N,nc])."""
    h, w = frames.shape[1:3]
    box, probs = model.forward(letterbox(frames, res))
    rows, kept = nms_rows(box, probs, max_det, conf, iou)
    live = rows[..., 4:5] > 0
    src = to_source(rows[..., :4], h, w, res) * live
    return (torch.cat([src, rows[..., 4:]], -1), kept,
            to_source(xywh_to_xyxy(box), h, w, res), probs)
