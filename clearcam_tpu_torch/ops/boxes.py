"""Box geometry over torch (counterpart of ``clearcam_tpu.ops.boxes``)."""
from __future__ import annotations

import torch


def xywh_to_xyxy(b):
    xc, yc, w, h = b.unbind(-1)
    return torch.stack([xc - w / 2, yc - h / 2, xc + w / 2, yc + h / 2], -1)


def iou_matrix(boxes):
    """Pairwise IoU of [..., N, 4] xyxy boxes -> [..., N, N]."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter / union


def dist2bbox(distance, anchor_points, xywh: bool = True):
    """DFL distances (l,t,r,b) [..., N, 4] + anchor points [N, 2] -> boxes."""
    lt, rb = distance[..., :2], distance[..., 2:]
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def clip_boxes(boxes, hw):
    h, w = hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def scale_boxes(boxes, gain, pad_x, pad_y, src_hw):
    """Letterbox-space xyxy -> source-pixel xyxy, clipped."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    out = torch.stack([(x1 - pad_x) / gain, (y1 - pad_y) / gain,
                       (x2 - pad_x) / gain, (y2 - pad_y) / gain], -1)
    return clip_boxes(out, src_hw)
