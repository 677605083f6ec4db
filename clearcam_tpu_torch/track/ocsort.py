"""OC-SORT multi-object tracker, vectorized.

Behavioral re-implementation of the reference tracker
(the reference's ocsort_tracker/ocsort.py, association.py, STrack.py):
observation-centric SORT with velocity-direction association cost, a BYTE
second pass over low-score detections, observation-centric re-update
(freeze/unfreeze virtual trajectories, see track/kalman.py), rolling per-class
vote for the track's class, and the same output filtering
(time_since_update<1, hit_streak gate, id+1).

Re-design: all per-track scalars live in parallel numpy arrays (SoA) and the
Kalman slots are batched (BatchKalman); association costs are single
vectorized expressions. Only spawn/death and the rare unfreeze replay touch
individual rows. This runs on host by design — per frame it is O(M·N) small
arrays, while the detector owns the TPU.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .kalman import BatchKalman, bbox_to_z, z_to_bbox


@dataclass(slots=True)
class Track:
    """Public per-frame track output (reference STrack surface, STrack.py:4-17)."""
    tlwh: np.ndarray
    score: float
    class_id: float
    track_id: float
    tracklet_len: float = 0.0
    speed: float = 0.0

    @property
    def tlbr(self) -> np.ndarray:
        t = self.tlwh
        return np.array([t[0], t[1], t[0] + t[2], t[1] + t[3]])


# ---------------------------------------------------------------------------
# association (vectorized; association.py:3-110)
# ---------------------------------------------------------------------------

def iou_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,4+] x [M,4+] xyxy -> [N,M] IoU."""
    a = a[:, None, :]
    b = b[None, :, :]
    x1 = np.maximum(a[..., 0], b[..., 0])
    y1 = np.maximum(a[..., 1], b[..., 1])
    x2 = np.minimum(a[..., 2], b[..., 2])
    y2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def greedy_assignment(cost: np.ndarray) -> np.ndarray:
    """Greedy min-cost matching: scan cost cells in ascending order, take a
    pair when both row and col are free (reference linear_assignment,
    association.py:32-52 — same row-major tie-breaking via flat argsort).

    The argsort stays in numpy (its tie order is part of output parity); the
    scan loop runs in C when native/track/assoc.c is built, Python otherwise.
    """
    if cost.size == 0:
        return np.empty((0, 2), dtype=int)
    rows, cols = cost.shape
    order = np.argsort(cost, axis=None)
    from ..runtime.native_loader import greedy_scan
    native = greedy_scan(order, rows, cols)
    if native is not None:
        return native.reshape(-1, 2)
    row_used = np.zeros(rows, bool)
    col_used = np.zeros(cols, bool)
    out = []
    for flat in order:
        r, c = divmod(int(flat), cols)
        if not row_used[r] and not col_used[c]:
            out.append((r, c))
            row_used[r] = col_used[c] = True
            if row_used.all() or col_used.all():
                break
    return np.array(out, dtype=int).reshape(-1, 2)


def _angle_cost(dets: np.ndarray, prev_obs: np.ndarray, velocities: np.ndarray,
                vdc_weight: float) -> np.ndarray:
    """Velocity-direction consistency cost [N_det, M_trk]
    (association.py:54-77): angle between each track's velocity and the
    direction from its k-step-back observation to each detection."""
    dcx = (dets[:, 0] + dets[:, 2])[None, :] / 2.0 - (prev_obs[:, 0] + prev_obs[:, 2])[:, None] / 2.0
    dcy = (dets[:, 1] + dets[:, 3])[None, :] / 2.0 - (prev_obs[:, 1] + prev_obs[:, 3])[:, None] / 2.0
    norm = np.sqrt(dcx ** 2 + dcy ** 2) + 1e-6
    dir_x, dir_y = dcx / norm, dcy / norm                     # [M, N]
    cos = velocities[:, 1:2] * dir_x + velocities[:, 0:1] * dir_y
    angle = np.arccos(np.clip(cos, -1.0, 1.0))
    score = (np.pi / 2.0 - np.abs(angle)) / np.pi             # [M, N]
    valid = (prev_obs[:, 4] >= 0).astype(np.float64)[:, None]
    cost = (valid * score * vdc_weight).T                     # [N, M]
    return cost * dets[:, 4:5]                                # scaled by det score


def associate(dets, trk_boxes, iou_threshold, velocities, prev_obs, vdc_weight,
              costs=None):
    """First-round association. Returns (matches [k,2], unmatched_dets,
    unmatched_trks) with reference semantics (association.py:54-110) including
    the shortcut: if IoU>threshold adjacency is already a perfect matching,
    skip the assignment solve. `costs=(iou, angle)` lets a caller supply
    precomputed matrices (MultiCamOCSort batches them across cameras)."""
    n, m = len(dets), len(trk_boxes)
    if m == 0:
        return np.empty((0, 2), int), np.arange(n), np.empty((0,), int)

    if costs is not None:
        iou, angle = costs
    else:
        iou = iou_batch(dets, trk_boxes)
        angle = _angle_cost(dets, prev_obs, velocities, vdc_weight)

    if min(iou.shape) > 0:
        adj = (iou > iou_threshold).astype(np.int32)
        if adj.sum(1).max() == 1 and adj.sum(0).max() == 1:
            matched = np.stack(np.where(adj), axis=1)
        else:
            matched = greedy_assignment(-(iou + angle))
    else:
        matched = np.empty((0, 2), int)

    # vectorized split, preserving the reference's ordering exactly:
    # ascending never-matched indices first, then below-threshold pairs in
    # matched order (spawn ids and greedy tie-breaks depend on this order)
    um_d_mask = np.ones(n, bool)
    um_t_mask = np.ones(m, bool)
    if len(matched):
        um_d_mask[matched[:, 0]] = False
        um_t_mask[matched[:, 1]] = False
        good = iou[matched[:, 0], matched[:, 1]] >= iou_threshold
        matches = matched[good].reshape(-1, 2)
        um_dets = np.concatenate([np.where(um_d_mask)[0], matched[~good, 0]])
        um_trks = np.concatenate([np.where(um_t_mask)[0], matched[~good, 1]])
    else:
        matches = np.empty((0, 2), int)
        um_dets = np.where(um_d_mask)[0]
        um_trks = np.where(um_t_mask)[0]
    return matches, um_dets.astype(int), um_trks.astype(int)


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------

class OCSort:
    """SoA OC-SORT. API mirror of the reference (ocsort.py:163-309):
    `update(dets[N,6], det_thresh)` once per frame -> list[Track]."""

    def __init__(self, det_thresh: float = 0.25, max_age: int = 30,
                 min_hits: int = 3, iou_threshold: float = 0.3,
                 delta_t: int = 3, inertia: float = 0.2, use_byte: bool = False):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.delta_t = delta_t
        self.inertia = inertia
        self.use_byte = use_byte
        self.frame_count = 0
        self.next_id = 0

        self.kf = BatchKalman()
        z = lambda *s: np.zeros(s)
        self.ids = z(0)
        self.age = z(0)
        self.tsu = z(0)                     # time_since_update
        self.hits = z(0)
        self.hit_streak = z(0)
        self.last_obs = np.full((0, 5), -1.0)   # xyxy+score; -1s = never observed
        self.velocity = z(0, 2)
        self.avg_vel = z(0, 2)
        self.speed = z(0)
        self.class_id = z(0)
        self.score = z(0)                   # score at spawn (reference quirk)
        # per-slot python state: recent observations {age: bbox5} and class votes
        self.obs_hist: list[dict] = []
        self.class_votes: list[dict] = []

    def __len__(self):
        return len(self.ids)

    # -- slot management -----------------------------------------------------

    def _spawn_many(self, dets: np.ndarray, cls: np.ndarray, scores: np.ndarray):
        """Batch-spawn k tracks with one concatenate per SoA column (a
        per-track np.append chain was a profiler hotspot at NVR scale)."""
        k = len(dets)
        if k == 0:
            return
        self.kf.add_many(bbox_to_z(dets[:, :4]))
        self.ids = np.concatenate([self.ids, np.arange(self.next_id,
                                                       self.next_id + k)])
        self.next_id += k
        zk = np.zeros(k)
        self.age = np.concatenate([self.age, zk])
        self.tsu = np.concatenate([self.tsu, zk])
        self.hits = np.concatenate([self.hits, zk])
        self.hit_streak = np.concatenate([self.hit_streak, zk])
        self.last_obs = np.concatenate([self.last_obs, np.full((k, 5), -1.0)])
        self.velocity = np.concatenate([self.velocity, np.zeros((k, 2))])
        self.avg_vel = np.concatenate([self.avg_vel, np.zeros((k, 2))])
        self.speed = np.concatenate([self.speed, zk])
        self.class_id = np.concatenate([self.class_id, np.asarray(cls, float)])
        self.score = np.concatenate([self.score, np.asarray(scores, float)])
        for c in np.asarray(cls, float):
            self.obs_hist.append({})
            self.class_votes.append({c: 1.0})

    def _kill(self, i: int):
        self.kf.remove(i)
        for name in ("ids", "age", "tsu", "hits", "hit_streak", "last_obs",
                     "velocity", "avg_vel", "speed", "class_id", "score"):
            setattr(self, name, np.delete(getattr(self, name), i, axis=0))
        del self.obs_hist[i]
        del self.class_votes[i]

    _NO_OBS = np.full(5, -1.0)
    _NO_OBS.setflags(write=False)

    def _k_previous_obs(self, i: int) -> np.ndarray:
        """Observation delta_t frames back (or nearest newer / latest);
        [-1]*5 when never observed (ocsort.py:11-19)."""
        hist = self.obs_hist[i]
        if not hist:
            return self._NO_OBS
        for dt in range(self.delta_t, 0, -1):
            if self.age[i] - dt in hist:
                return hist[self.age[i] - dt]
        return hist[max(hist)]

    # -- observed update -------------------------------------------------------

    def _observe(self, i: int, det5: np.ndarray, score: float, cls: float,
                 z_new: np.ndarray):
        """Track i matched to detection det5 (xyxy+score, z_new = its
        measurement): velocity estimate from delta_t-back observation, class
        vote, OCR unfreeze when coming back from occlusion
        (ocsort.py:104-141). The caller applies ONE batched KF update for all
        matches (per-row updates are independent, and the per-call overhead
        dominated the NVR tick at 32+ cameras)."""
        votes = self.class_votes[i]
        votes[cls] = votes.get(cls, 0.0) + score
        self.class_id[i] = max(votes, key=votes.get)

        if self.last_obs[i].sum() >= 0:  # has a previous observation
            prev = None
            for dt in range(self.delta_t, 0, -1):
                if self.age[i] - dt in self.obs_hist[i]:
                    prev = self.obs_hist[i][self.age[i] - dt]
                    break
            if prev is None:
                prev = self.last_obs[i]
            dy = (det5[1] + det5[3]) / 2.0 - (prev[1] + prev[3]) / 2.0
            dx = (det5[0] + det5[2]) / 2.0 - (prev[0] + prev[2]) / 2.0
            norm = np.sqrt(dx * dx + dy * dy) + 1e-6
            self.velocity[i] = (dy / norm, dx / norm)
            self.avg_vel[i] = self.avg_vel[i] + np.array([dy, dx]) / float(self.age[i])
            self.speed[i] = abs(self.avg_vel[i][0]) + abs(self.avg_vel[i][1])

        if not self.kf.observed[i] and self.kf.has_saved[i]:
            # re-observation after a gap: replay virtual trajectory
            z_prev = bbox_to_z(self.last_obs[i][:4])
            self.kf.unfreeze_replay(i, z_prev, z_new, int(self.tsu[i]))

        self.last_obs[i] = det5
        self.obs_hist[i][self.age[i]] = det5.copy()
        # keep only the delta_t window (older fallback == last_obs)
        for k in [k for k in self.obs_hist[i] if k < self.age[i] - self.delta_t]:
            del self.obs_hist[i][k]

        self.tsu[i] = 0
        self.hits[i] += 1
        self.hit_streak[i] += 1

    def _observe_many(self, pairs):
        """pairs: iterable of (track_idx, det5, score, cls); one batched
        measurement conversion + one batched KF update for the whole set."""
        if not pairs:
            return
        idxs = np.fromiter((t for t, *_ in pairs), int, len(pairs))
        zs = bbox_to_z(np.stack([det5[:4] for _, det5, _, _ in pairs]))
        for j, (t, det5, score, cls) in enumerate(pairs):
            self._observe(t, det5, score, cls, zs[j])
        self.kf.update_batch(idxs, zs)

    # -- per-frame step --------------------------------------------------------

    def update(self, output_results: np.ndarray, det_thresh: float = 0.25) -> list[Track]:
        """One frame. output_results: [N,6+] rows (x1,y1,x2,y2,score,class).
        Call every frame (empty array for no detections)."""
        if output_results is None:
            return []
        self.frame_count += 1
        output_results = np.asarray(output_results, np.float64).reshape(-1, output_results.shape[-1]) \
            if len(output_results) else np.zeros((0, 6))

        scores = output_results[:, 4]
        dets_all = np.concatenate([output_results[:, :4], scores[:, None]], axis=1)
        cls_all = output_results[:, 5]
        second_mask = (scores > 0.1) & (scores < det_thresh)
        high_mask = scores > det_thresh
        dets = dets_all[high_mask]
        cls_high = cls_all[high_mask]
        dets_second = dets_all[second_mask]
        cls_second = cls_all[second_mask]

        # 1. predict all slots, collect predicted boxes
        self.kf.predict_all()
        self.age += 1
        self.hit_streak[self.tsu > 0] = 0
        self.tsu += 1
        m = len(self)
        trk_boxes = np.zeros((m, 5))
        if m:
            trk_boxes[:, :4] = z_to_bbox(self.kf.x)
        prev_obs = np.stack([self._k_previous_obs(i) for i in range(m)]) if m \
            else np.zeros((0, 5))

        # 2. first association: IoU + velocity-direction cost
        matched, um_dets, um_trks = associate(
            dets, trk_boxes, self.iou_threshold, self.velocity, prev_obs, self.inertia)
        self._observe_many([(t, dets[d], dets[d, 4], cls_high[d])
                            for d, t in matched])

        # 3. BYTE pass: low-score dets vs still-unmatched tracks (ocsort.py:234-252)
        if self.use_byte and len(dets_second) and len(um_trks):
            iou = iou_batch(dets_second, trk_boxes[um_trks])
            if iou.max() > self.iou_threshold:
                rematch = greedy_assignment(-iou)
                drop, obs = [], []
                for r, c in rematch:
                    if iou[r, c] < self.iou_threshold:
                        continue
                    t = um_trks[c]
                    obs.append((t, dets_second[r], dets_second[r, 4],
                                cls_second[r]))
                    drop.append(t)
                self._observe_many(obs)
                um_trks = np.setdiff1d(um_trks, np.array(drop))

        # 4. OCR pass: unmatched dets vs last observations (ocsort.py:254-276)
        if len(um_dets) and len(um_trks):
            iou = iou_batch(dets[um_dets], self.last_obs[um_trks])
            if iou.max() > self.iou_threshold:
                rematch = greedy_assignment(-iou)
                drop_d, drop_t, obs = [], [], []
                for r, c in rematch:
                    if iou[r, c] < self.iou_threshold:
                        continue
                    d, t = um_dets[r], um_trks[c]
                    obs.append((t, dets[d], dets[d, 4], cls_high[d]))
                    drop_d.append(d)
                    drop_t.append(t)
                self._observe_many(obs)
                um_dets = np.setdiff1d(um_dets, np.array(drop_d))
                um_trks = np.setdiff1d(um_trks, np.array(drop_t))

        # 5. freeze unmatched tracks (reference update(None))
        self.kf.freeze(np.asarray(um_trks, int))

        # 6. spawn new tracks (batched)
        um_dets = np.asarray(um_dets, int)
        self._spawn_many(dets[um_dets], cls_high[um_dets], dets[um_dets, 4])

        # 7. emit + reap (ocsort.py:288-309); reference emits newest-first
        out: list[Track] = []
        for i in reversed(range(len(self))):
            if self.tsu[i] >= 1:
                continue
            if not (self.hit_streak[i] >= self.min_hits or self.frame_count <= self.min_hits):
                continue
            box = self.last_obs[i][:4] if self.last_obs[i].sum() >= 0 else self.kf.state_bbox(i)
            out.append(Track(
                tlwh=np.array([box[0], box[1], box[2] - box[0], box[3] - box[1]]),
                score=float(self.score[i]), class_id=float(self.class_id[i]),
                track_id=float(self.ids[i] + 1), tracklet_len=float(self.age[i]),
                speed=float(self.speed[i])))
        for i in reversed(range(len(self))):
            if self.tsu[i] > self.max_age and (self.speed[i] > 2 or self.tsu[i] > 600):
                self._kill(i)
        return out
