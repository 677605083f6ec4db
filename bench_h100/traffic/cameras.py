"""Camera traffic: the frames a fleet of cameras hands the NVR each tick,
and the detections its tracker is fed, from a mix's parameters and a seed.

A mix (``traffic/<name>.json`` with ``"generator": "cameras"``) gives
``groups`` ([{"cameras", "height", "width"}]: 8-bit BGR frames of that
size), ``pool_frames`` (the distinct frames a camera cycles through, as a
decoder's ring hands them over), ``shapes_per_frame`` (filled boxes moving
over uniform noise), ``objects_per_camera`` and ``track_ticks`` (the moving
boxes fed to the tracker, ``synth_tracks``). Tick t hands every camera its
frame t mod ``pool_frames``; cameras are ordered group by group.
"""
from __future__ import annotations

import numpy as np
import torch


def synth_tracks(n_cams: int, n_ticks: int, n_obj: int = 8, seed: int = 0):
    """Moving-box detection streams (bouncing, so tracks persist instead of
    degenerating into constant respawn churn), [n_obj, 6] rows per camera
    per tick.

    Frozen copy of ``clearcam_tpu_torch/tools/cotenancy_bench.synth_tracks``
    (commit c66412c), unchanged."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(200, 1500, (n_cams, n_obj, 2))
    vel = rng.normal(0, 5, (n_cams, n_obj, 2))
    wh = rng.uniform(60, 200, (n_cams, n_obj, 2))
    out = []
    for _ in range(n_ticks):
        pos = pos + vel
        for d, lim in ((0, 1920), (1, 1080)):
            hit = (pos[..., d] < 60) | (pos[..., d] > lim - 60)
            vel[..., d][hit] *= -1
            pos[..., d] = np.clip(pos[..., d], 60, lim - 60)
        conf = np.full((n_cams, n_obj, 1), 0.8)
        cls = np.zeros((n_cams, n_obj, 1))          # person
        out.append(np.concatenate([pos - wh / 2, pos + wh / 2, conf, cls], -1))
    return out


class Cameras:
    def __init__(self, mix: dict, seed: int, device):
        from ..weights import generator
        gen = generator(device, seed, 1)
        rng = np.random.default_rng([int(seed), 1])
        self.pool = int(mix["pool_frames"])
        self.frames: list[list[np.ndarray]] = []      # [camera][pool index]
        for g in mix["groups"]:
            n, h, w = int(g["cameras"]), int(g["height"]), int(g["width"])
            x = torch.randint(0, 256, (n, self.pool, h, w, 3), generator=gen,
                              device=device, dtype=torch.uint8)
            for c in range(n):
                for s in range(int(mix["shapes_per_frame"])):
                    bh, bw = rng.integers(h // 12, h // 3), rng.integers(w // 12, w // 3)
                    y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
                    vy, vx = rng.integers(-h // 40, h // 40 + 1), rng.integers(-w // 40, w // 40 + 1)
                    color = torch.from_numpy(rng.integers(0, 256, 3).astype(np.uint8)).to(device)
                    for j in range(self.pool):
                        y = int(np.clip(y0 + j * vy, 0, h - bh))
                        xx = int(np.clip(x0 + j * vx, 0, w - bw))
                        x[c, j, y:y + bh, xx:xx + bw] = color
            host = x.cpu().numpy()
            self.frames += [[host[c, j] for j in range(self.pool)] for c in range(n)]
        self.n_cams = len(self.frames)
        self.tracks = synth_tracks(self.n_cams, int(mix["track_ticks"]),
                                   int(mix["objects_per_camera"]), int(seed) % (1 << 32))

    def frames_at(self, tick: int) -> list[np.ndarray]:
        return [f[tick % self.pool] for f in self.frames]

    def tracks_at(self, tick: int) -> dict:
        rows = self.tracks[tick % len(self.tracks)]
        return {c: rows[c] for c in range(self.n_cams)}


def make(mix: dict, seed: int, device) -> Cameras:
    return Cameras(mix, seed, device)
