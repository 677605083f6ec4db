"""Detection evaluation: COCO-style mAP over a YOLO-format dataset, the
counterpart of ``clearcam_tpu.tools.evaluate`` with its flags and output.

Scores any detect_many-compatible detector (the port's
``runtime.nvr.BatchDetector`` or ``models.rfdetr.RFDETR``) against
images/ + labels/ ground truth.

AP follows the COCO protocol: per class, detections sorted by confidence,
greedy-matched to the highest-IoU unmatched GT at each threshold,
101-point-interpolated precision/recall; mAP50 and mAP50-95 reported.

Usage:
    python -m clearcam_tpu_torch.tools.evaluate <dataset_root> \\
        [--size t --res 640] [--weights weights/] [--detector yolo|rfdetr] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4] x [M,4] xyxy -> [N,M]."""
    if not len(a) or not len(b):
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def average_precision(scores, matched, n_gt) -> float:
    """101-point interpolated AP for one (class, IoU threshold)."""
    if n_gt == 0:
        return float("nan")
    if not len(scores):
        return 0.0
    order = np.argsort(-np.asarray(scores))
    tp = np.asarray(matched, float)[order]
    fp = 1.0 - tp
    tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope + 101-point sampling
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    points = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, points, side="left")
    return float(np.where(idx < len(precision), precision[np.clip(idx, 0, len(precision) - 1)], 0.0).mean())


def evaluate(preds_per_image: list[np.ndarray], gts_per_image: list[tuple]):
    """preds: [N,6] (x1,y1,x2,y2,score,cls) rows per image (zero rows
    ignored); gts: (boxes [M,4], cls [M]) per image. -> dict of metrics."""
    classes = sorted({int(c) for _, gc in gts_per_image for c in gc})
    ap_per_thr_cls = np.full((len(IOU_THRESHOLDS), len(classes)), np.nan)
    for ci, cls in enumerate(classes):
        n_gt = sum(int((gc == cls).sum()) for _, gc in gts_per_image)
        for ti, thr in enumerate(IOU_THRESHOLDS):
            scores, matched = [], []
            for preds, (gb, gc) in zip(preds_per_image, gts_per_image):
                rows = preds[(preds[:, 4] > 0) & (preds[:, 5] == cls)]
                rows = rows[np.argsort(-rows[:, 4])]
                gt_boxes = gb[gc == cls]
                used = np.zeros(len(gt_boxes), bool)
                ious = iou_matrix(rows[:, :4], gt_boxes)
                for r in range(len(rows)):
                    scores.append(rows[r, 4])
                    if len(gt_boxes):
                        free = ~used
                        cand = np.where(free, ious[r], -1.0)
                        j = int(cand.argmax())
                        if cand[j] >= thr:
                            used[j] = True
                            matched.append(1.0)
                            continue
                    matched.append(0.0)
            ap_per_thr_cls[ti, ci] = average_precision(scores, matched, n_gt)
    map50 = float(np.nanmean(ap_per_thr_cls[0]))
    map5095 = float(np.nanmean(ap_per_thr_cls))
    return {"mAP50": round(map50, 4), "mAP50-95": round(map5095, 4),
            "classes": {int(c): round(float(np.nanmean(ap_per_thr_cls[:, i])), 4)
                        for i, c in enumerate(classes)}}


def load_gt(root: str | Path):
    """-> (image paths, [(boxes xyxy px, cls)] aligned)."""
    import cv2
    root = Path(root)
    paths = sorted(p for p in (root / "images").iterdir()
                   if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    gts = []
    for p in paths:
        img = cv2.imread(str(p))
        h, w = img.shape[:2]
        label = root / "labels" / (p.stem + ".txt")
        if label.exists():
            rows = np.loadtxt(label, ndmin=2, dtype=np.float32)
            if rows.size:
                cls = rows[:, 0]
                cx, cy, bw, bh = (rows[:, i + 1] for i in range(4))
                boxes = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                                  (cx + bw / 2) * w, (cy + bh / 2) * h], 1)
                gts.append((boxes, cls))
                continue
        gts.append((np.zeros((0, 4)), np.zeros((0,))))
    return paths, gts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--size", default="t")
    ap.add_argument("--res", type=int, default=640)
    ap.add_argument("--weights", default="weights")
    ap.add_argument("--detector", default="yolo", choices=["yolo", "rfdetr"])
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import cv2
    if args.detector == "rfdetr":
        from ..models.rfdetr import RFDETR
        det = RFDETR("nano", conf_threshold=args.conf, device=args.device)
    else:
        from ..io import safetensors as st
        from ..models import yolov9
        from ..runtime.nvr import BatchDetector
        path = Path(args.weights) / f"yolov9-{args.size}.safetensors"
        params = yolov9.convert_state_dict(st.load(path)) if path.exists() else None
        det = BatchDetector(args.size, args.res, params=params, device=args.device)

    paths, gts = load_gt(args.dataset)
    preds = []
    for p in paths:
        preds.append(np.asarray(det.detect_many([cv2.imread(str(p))])[0]))
    out = evaluate(preds, gts)
    print(out)
    return out


if __name__ == "__main__":
    main()
