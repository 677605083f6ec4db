"""Dense triu-IoU NMS over torch (counterpart of ``clearcam_tpu.ops.nms``).

The semantics are the reference's, not greedy NMS: a box is dropped when any
higher-ranked box of the same class overlaps it by more than the threshold,
even if that higher-ranked box was itself dropped (clearcam_tpu/ops/nms.py
:34-41). ``torchvision.ops.batched_nms`` keeps other rows, so it is not used.
"""
from __future__ import annotations

import torch

from .boxes import iou_matrix, xywh_to_xyxy


def batched_nms(boxes_xyxy, scores, class_ids, max_det: int = 300,
                iou_threshold: float = 0.45, class_aware: bool = True):
    """[B,N,4] xyxy, [B,N] scores (below-threshold already zero), [B,N]
    class ids -> [B, K, 6] rows (x1,y1,x2,y2,score,class), K = min(max_det, N),
    suppressed rows zeroed."""
    n = scores.shape[1]
    k = min(max_det, n)
    # stable descending sort: ties keep the lower index first, as
    # jax.lax.top_k does (bf16 logits give many exact ties)
    top_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, order = top_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes_xyxy, 1, order[..., None].expand(-1, -1, 4))
    top_cls = torch.gather(class_ids, 1, order)

    ious = iou_matrix(top_boxes)
    # only higher-ranked (earlier) boxes suppress: strict upper triangle
    tri = torch.ones((k, k), dtype=torch.bool, device=scores.device).triu(1)
    overlap = (ious > iou_threshold) & tri
    if class_aware:
        overlap &= top_cls[:, :, None] == top_cls[:, None, :]
    keep = ~overlap.any(dim=1) & (top_scores > 0)

    rows = torch.cat([top_boxes, top_scores[..., None],
                      top_cls[..., None].to(top_boxes.dtype)], -1)
    return rows * keep[..., None]


def yolo_postprocess(raw, max_det: int = 300, conf_threshold: float = 0.25,
                     iou_threshold: float = 0.45):
    """YOLO head output [B, N, 4+nc] (xywh + class scores) -> NMS'd
    [B, max_det, 6] rows."""
    probs, class_ids = raw[..., 4:].max(dim=-1)
    probs = torch.where(probs >= conf_threshold, probs, torch.zeros_like(probs))
    return batched_nms(xywh_to_xyxy(raw[..., :4]), probs, class_ids, max_det,
                       iou_threshold)
