"""Letterbox preprocessing over torch (counterpart of
``clearcam_tpu.ops.image``): uint8 frames -> resize -> pad -> BGR->RGB -> /255.

The geometry (``letterbox_plan``, ``scale_boxes_params``) is pure Python and
identical to the JAX package's. 1080p at res 640 letterboxes to 384x640.
"""
from __future__ import annotations

import torch
import torch.nn.functional as tF


def letterbox_plan(src_hw: tuple[int, int], res: int, stride: int = 32,
                   auto: bool = True, scaleup: bool = True):
    """Static letterbox geometry -> (new_w, new_h, pad_left, pad_top,
    out_w, out_h, gain). ``auto=True`` pads only to the next stride multiple."""
    h, w = src_hw
    r = min(res / h, res / w)
    if not scaleup:
        r = min(r, 1.0)
    new_w, new_h = int(round(w * r)), int(round(h * r))
    dw, dh = res - new_w, res - new_h
    if auto:
        dw, dh = dw % stride, dh % stride
    pad_left = int(round(dw / 2 - 0.1))
    pad_top = int(round(dh / 2 - 0.1))
    return (new_w, new_h, pad_left, pad_top, new_w + 2 * pad_left,
            new_h + 2 * pad_top, r)


def letterbox(frames: torch.Tensor, res: int, stride: int = 32,
              auto: bool = True, bgr_to_rgb: bool = True,
              dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,H,W,3] frames -> letterboxed, normalized [B,H',W',3] in [0,1].

    Four resize branches, as in the JAX package: identity; an exact odd
    downscale k (1080p->640 is k=3) is a single centre tap, a strided slice
    of the raw uint8; an exact even k is the 2x2 mean around the half-pixel
    centre; anything else is half-pixel bilinear with antialias off.
    """
    b, h, w, c = frames.shape
    new_w, new_h, pl, pt, out_w, out_h, _ = letterbox_plan((h, w), res, stride,
                                                           auto)
    kh = h // new_h if new_h and h % new_h == 0 else 0
    kw = w // new_w if new_w and w % new_w == 0 else 0
    if (new_h, new_w) == (h, w):
        x = frames.to(dtype)
    elif kh == kw and kh > 1 and kh % 2 == 1:
        off = (kh - 1) // 2
        x = frames[:, off::kh, off::kw, :].to(dtype)
    elif kh == kw and kh > 1:
        lo, hi = kh // 2 - 1, kh // 2
        x = (frames[:, lo::kh, lo::kw, :].to(dtype)
             + frames[:, lo::kh, hi::kw, :].to(dtype)
             + frames[:, hi::kh, lo::kw, :].to(dtype)
             + frames[:, hi::kh, hi::kw, :].to(dtype)) * 0.25
    else:
        x = tF.interpolate(frames.to(dtype).permute(0, 3, 1, 2),
                           size=(new_h, new_w), mode="bilinear",
                           align_corners=False, antialias=False)
        x = x.permute(0, 2, 3, 1)
    if bgr_to_rgb:
        x = x.flip(-1)
    x = x / 255.0
    return tF.pad(x, (0, 0, pl, out_w - new_w - pl, pt, out_h - new_h - pt))


def scale_boxes_params(src_hw: tuple[int, int], res: int, stride: int = 32,
                       auto: bool = True):
    """(gain, pad_x, pad_y) mapping letterboxed-space boxes to source pixels."""
    h, w = src_hw
    _, _, _, _, out_w, out_h, _ = letterbox_plan((h, w), res, stride, auto)
    gain = min(out_h / h, out_w / w)
    return gain, (out_w - w * gain) / 2, (out_h - h * gain) / 2
