"""Zone (polygon) logic for alert filtering.

Reference behavior (clearcam.py:647-665, usage :599-610): each camera may have
a normalized polygon; a detection is "outside" when *none* of its four box
corners falls inside the polygon (ray-casting test), and the per-camera
`outside` flag inverts the meaning. Vectorized over corners and polygon edges.
"""
from __future__ import annotations

import numpy as np


def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Ray-casting point-in-polygon, vectorized. points [P,2], poly [V,2]
    -> bool [P]. Matches the reference's edge-inclusion conventions
    (y in (min, max], x <= intersection)."""
    points = np.asarray(points, np.float64)
    poly = np.asarray(poly, np.float64)
    p1 = poly
    p2 = np.roll(poly, -1, axis=0)
    x, y = points[:, 0:1], points[:, 1:2]           # [P,1]
    y1, y2 = p1[None, :, 1], p2[None, :, 1]         # [1,V]
    x1, x2 = p1[None, :, 0], p2[None, :, 0]

    cond = (y > np.minimum(y1, y2)) & (y <= np.maximum(y1, y2)) & (x <= np.maximum(x1, x2))
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = np.where(y1 != y2, (y - y1) * (x2 - x1) / (y2 - y1) + x1, x1)
    crossings = cond & ((x1 == x2) | (x <= x_int))
    return crossings.sum(axis=1) % 2 == 1


def box_outside_zone(tlbr: np.ndarray, poly_norm: np.ndarray,
                     frame_hw: tuple[float, float], invert: bool = False) -> bool:
    """True when the box should be filtered: no corner inside the (scaled)
    polygon, XOR'd with the camera's `outside` inversion flag."""
    x1, y1, x2, y2 = tlbr[:4]
    corners = np.array([[x1, y1], [x2, y1], [x1, y2], [x2, y2]])
    poly = np.asarray(poly_norm, np.float64) * np.array([frame_hw[1], frame_hw[0]])
    outside = not points_in_polygon(corners, poly).any()
    return bool(outside ^ invert)


def boxes_outside_zone(tlbr: np.ndarray, poly_norm: np.ndarray,
                       frame_hw: tuple[float, float], invert: bool = False) -> np.ndarray:
    """Batched variant: [N,4+] boxes -> bool [N]."""
    tlbr = np.asarray(tlbr, np.float64)
    if len(tlbr) == 0:
        return np.zeros((0,), bool)
    poly = np.asarray(poly_norm, np.float64) * np.array([frame_hw[1], frame_hw[0]])
    corners = np.stack([
        tlbr[:, [0, 1]], tlbr[:, [2, 1]], tlbr[:, [0, 3]], tlbr[:, [2, 3]],
    ], axis=1)                                       # [N,4,2]
    inside = points_in_polygon(corners.reshape(-1, 2), poly).reshape(-1, 4)
    return inside.any(axis=1) == bool(invert)
