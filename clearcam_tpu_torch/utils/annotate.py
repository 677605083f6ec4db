"""Frame annotation for event images (reference draw_predictions,
clearcam.py:635-645 / helpers.py:60-125): labeled boxes with per-class colors
and contrast-aware label text."""
from __future__ import annotations

import numpy as np

from .labels import COCO_LABELS, class_colors, is_bright


def draw_rect(img: np.ndarray, pt1, pt2, color, thickness=1) -> np.ndarray:
    """Pure-numpy rectangle (fill with thickness=-1), clipped to the image."""
    x1, y1 = max(0, int(pt1[0])), max(0, int(pt1[1]))
    x2, y2 = min(img.shape[1] - 1, int(pt2[0])), min(img.shape[0] - 1, int(pt2[1]))
    if x2 < x1 or y2 < y1:
        return img
    if thickness == -1:
        img[y1:y2 + 1, x1:x2 + 1] = color
    else:
        img[y1:y1 + thickness, x1:x2 + 1] = color
        img[max(y1, y2 - thickness + 1):y2 + 1, x1:x2 + 1] = color
        img[y1:y2 + 1, x1:x1 + thickness] = color
        img[y1:y2 + 1, max(x1, x2 - thickness + 1):x2 + 1] = color
    return img


def draw_predictions(frame: np.ndarray, preds, labels=None,
                     thickness: int = 3) -> np.ndarray:
    """Draw [x1,y1,x2,y2,score,class(,track)] rows onto a BGR frame."""
    labels = labels or COCO_LABELS
    colors = class_colors(labels)
    try:
        import cv2
    except ImportError:
        cv2 = None
    for row in preds:
        x1, y1, x2, y2, conf, cls = row[:6]
        if conf == 0:
            continue
        cls = int(cls)
        if not 0 <= cls < len(labels):
            continue
        color = colors[labels[cls]]
        draw_rect(frame, (x1, y1), (x2, y2), color, thickness)
        if cv2 is not None:
            label = f"{labels[cls]}:{conf:.2f}"
            (tw, th), _ = cv2.getTextSize(label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
            font_color = (0, 0, 0) if is_bright(color) else (255, 255, 255)
            draw_rect(frame, (x1, y1 - th - 10), (x1 + tw + 2, y1), color, -1)
            cv2.putText(frame, label, (int(x1), int(y1) - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, font_color, 1, cv2.LINE_AA)
    return frame
