"""BlazeFace (back model, 256x256, 896 anchors) over torch, the counterpart
of ``clearcam_tpu.models.blazeface``: a 5x5 stem conv, 31 depthwise-
separable BlazeBlocks with stride-2 transitions at blocks 7/15/23
(24 -> 24 -> 48 -> 96 channels), a final stride-2 block to 8x8, the
per-scale classifier and regressor heads, the anchor-relative box and
6-keypoint decode, and the dense triu-IoU NMS. NHWC activations.

Output rows: [ymin, xmin, ymax, xmax, kp0x, kp0y, ... kp5x, kp5y, score]
in 256-px space, suppressed rows zeroed.

``init_params`` and ``convert_state_dict`` return numpy arrays in the JAX
layout (HWIO), equal to the JAX package's; ``params_from_jax`` turns them
into torch tensors once (OIHW filters, ``channels_last``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..device import resolve_device
from ..nn import functional as F
from ..ops.boxes import iou_matrix

RES = 256
N_ANCHORS = 896
SCORE_CLIP = 100.0
MIN_SCORE = 0.85
IOU_THRESHOLD = 0.3

# (index, cin, cout) of the stride-2 transitions; other blocks are identity
_STAGES = [(7, 24, 24), (15, 24, 48), (23, 48, 96)]


def _block_dims(i: int) -> tuple[int, int, int]:
    """(stride, cin, cout) of backbone block i."""
    for idx, cin, cout in _STAGES:
        if i == idx:
            return 2, cin, cout
    if i < 15:
        return 1, 24, 24
    if i < 23:
        return 1, 48, 48
    return 1, 96, 96


def _pad_hw(x, top_left: int, bottom_right: int):
    """Zero-pad an NHWC tensor's H and W by (top_left, bottom_right)."""
    return tF.pad(x, (0, 0, top_left, bottom_right, top_left, bottom_right))


def _blaze_block(p, pre, x, stride, cin, cout):
    if stride == 2:
        # the stride-2 depthwise conv pads (0, 2), not symmetrically
        h = F.conv2d_p(p, pre + ".conv0_tiny", _pad_hw(x, 0, 2), stride=2,
                       groups=cin)
        x = F.max_pool2d(x, 2, 2)
    else:
        h = F.conv2d_p(p, pre + ".conv0_tiny", x, padding=1, groups=cin)
    h = F.conv2d_p(p, pre + ".conv1_tiny", h)
    if cout > cin:          # the skip gains zero channels
        x = tF.pad(x, (0, cout - cin))
    return F.relu(x + h)


def forward(p: dict, x):
    """Normalized [B,256,256,3] -> (regressors [B,896,16], scores [B,896,1])."""
    x = F.relu(F.conv2d_p(p, "conv_tiny", _pad_hw(x, 1, 2), stride=2))
    for i in range(31):
        x = _blaze_block(p, f"backbone_tiny.{i}", x, *_block_dims(i))
    h = F.conv2d_p(p, "final.conv0_tiny", _pad_hw(x, 0, 2), stride=2, groups=96)
    h = F.relu(F.conv2d_p(p, "final.conv1_tiny", h))
    b = x.shape[0]
    c1 = F.conv2d_p(p, "classifier_8_tiny", x).reshape(b, -1, 1)     # [B,512,1]
    c2 = F.conv2d_p(p, "classifier_16_tiny", h).reshape(b, -1, 1)    # [B,384,1]
    r1 = F.conv2d_p(p, "regressor_8_tiny", x).reshape(b, -1, 16)
    r2 = F.conv2d_p(p, "regressor_16_tiny", h).reshape(b, -1, 16)
    return torch.cat([r1, r2], 1), torch.cat([c1, c2], 1)


def decode(p: dict, raw_boxes, raw_scores):
    """Anchor decode, score floor and NMS -> [B,896,17] rows; suppressed
    and below-floor rows zeroed. A box is dropped when any higher-ranked
    live box overlaps it by more than IOU_THRESHOLD, even one that was
    itself dropped (the reference's chain rule), over a stable descending
    sort of the scores."""
    anchors = p["anchors"]                                      # [896,4] x,y,w,h
    ax, ay, aw, ah = anchors.unbind(-1)
    xc = raw_boxes[..., 0] / RES * aw + ax
    yc = raw_boxes[..., 1] / RES * ah + ay
    w = raw_boxes[..., 2] / RES * aw
    h = raw_boxes[..., 3] / RES * ah
    boxes = torch.stack([yc - h / 2, xc - w / 2, yc + h / 2, xc + w / 2], -1)
    kp = raw_boxes[..., 4:].reshape(*raw_boxes.shape[:-1], 6, 2)
    kx = kp[..., 0] / RES * aw[:, None] + ax[:, None]
    ky = kp[..., 1] / RES * ah[:, None] + ay[:, None]
    kps = torch.stack([kx, ky], -1).reshape(*raw_boxes.shape[:-1], 12)
    scores = torch.sigmoid(raw_scores.clamp(-SCORE_CLIP, SCORE_CLIP))[..., 0]
    scores = torch.where(scores >= MIN_SCORE, scores, torch.zeros_like(scores))

    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = torch.take_along_dim(boxes, order[..., None], 1)
    kps_s = torch.take_along_dim(kps, order[..., None], 1)
    scores_s = torch.take_along_dim(scores, order, 1)
    n = boxes.shape[1]
    tri = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    suppressed = ((iou_matrix(boxes_s) > IOU_THRESHOLD) & tri).any(dim=1)
    keep = ~suppressed & (scores_s > 0)
    rows = torch.cat([boxes_s, kps_s, scores_s[..., None]], -1)
    return rows * keep[..., None]


def detect(p: dict, img256):
    """Letterboxed uint8/float RGB [256,256,3] -> [896,17] rows; box and
    keypoint columns in 256-px coordinates, the score a probability."""
    x = img256.float() / 127.5 - 1.0
    raw, scores = forward(p, x[None])
    rows = decode(p, raw, scores)[0]
    return torch.cat([rows[:, :16] * RES, rows[:, 16:]], -1)


# ---------------------------------------------------------------------------
# parameters: numpy in the JAX layout (HWIO), then torch once
# ---------------------------------------------------------------------------

def convert_state_dict(sd: dict[str, np.ndarray], dtype=np.float32) -> dict:
    """Published blazeface.safetensors (tinygrad names, OIHW) -> flat HWIO
    numpy params, as the JAX package converts it."""
    out = {}
    for k, arr in sd.items():
        k = k.replace(".list.", ".").replace(".list", "")
        arr = np.asarray(arr, np.float32)
        if k.endswith(".weight") and arr.ndim == 4:
            arr = F.oihw_to_hwio(arr)
        out[k] = arr.astype(dtype)
    return out


def default_anchors() -> np.ndarray:
    """The standard back-model anchor grid: 16x16 cells x 2 anchors + 8x8
    cells x 6 anchors, unit w/h, normalized centres. Published checkpoints
    carry their own ``anchors``; this is the fallback."""
    anchors = []
    for grid, per in ((16, 2), (8, 6)):
        for y in range(grid):
            for x in range(grid):
                anchors += [[(x + 0.5) / grid, (y + 0.5) / grid, 1.0, 1.0]] * per
    return np.array(anchors, np.float32)


def init_params(seed: int = 0, dtype=np.float32) -> dict:
    """Random HWIO numpy params, equal to the JAX package's for the same
    seed."""
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(pre, cin, cout, k, groups=1):
        fan = cin // groups * k * k
        p[pre + ".weight"] = np.asarray(
            rng.normal(0, (2 / fan) ** 0.5, (k, k, cin // groups, cout)), dtype)
        p[pre + ".bias"] = np.zeros((cout,), dtype)

    conv("conv_tiny", 3, 24, 5)
    for i in range(31):
        _, cin, cout = _block_dims(i)
        conv(f"backbone_tiny.{i}.conv0_tiny", cin, cin, 3, groups=cin)
        conv(f"backbone_tiny.{i}.conv1_tiny", cin, cout, 1)
    conv("final.conv0_tiny", 96, 96, 3, groups=96)
    conv("final.conv1_tiny", 96, 96, 1)
    conv("classifier_8_tiny", 96, 2, 1)
    conv("classifier_16_tiny", 96, 6, 1)
    conv("regressor_8_tiny", 96, 32, 1)
    conv("regressor_16_tiny", 96, 96, 1)
    p["anchors"] = default_anchors().astype(dtype)
    return p


def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Flat HWIO params (numpy or JAX arrays) -> torch tensors on
    ``device`` in ``dtype`` (filters OIHW, ``channels_last``)."""
    return F.tensors_from_numpy(params, resolve_device(device), dtype)
