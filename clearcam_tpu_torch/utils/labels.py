"""COCO class labels + deterministic colors.

The reference fetches coco.names at startup (clearcam.py:1434 — a network
dependency); we embed the standard 80-class list so the NVR starts offline.
Color formula matches the reference (clearcam.py:1435) so overlays look the
same to users.
"""

COCO_LABELS = [
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "sofa", "pottedplant",
    "bed", "diningtable", "toilet", "tvmonitor", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def class_colors(labels=None):
    labels = labels or COCO_LABELS
    return {label: (((i + 1) * 50) % 256, ((i + 1) * 100) % 256,
                    ((i + 1) * 150) % 256)
            for i, label in enumerate(labels)}


def is_bright(color) -> bool:
    r, g, b = color
    return (r * 299 + g * 587 + b * 114) / 1000 > 127
