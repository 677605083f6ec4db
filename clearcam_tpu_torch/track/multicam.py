"""Cross-camera batched OC-SORT.

`OCSort` (ocsort.py) is the per-camera reference implementation — bit-parity
with the golden fixtures. At NVR scale (32-128 cameras) running one Python
update per camera per tick is overhead-bound: the numpy calls are tiny and
per-call cost dominates (profiled ~1.1 ms/camera ≈ 24 streams @30fps on one
core).

`MultiCamOCSort` holds EVERY camera's tracks in one SoA store and runs the
per-frame math globally, mirroring how the detector batches frames across
cameras (runtime/nvr.py BatchDetector):

  * one batched Kalman predict over all tracks of all cameras
  * one vectorized k-previous-observation lookup (ring buffer, no dicts)
  * IoU + velocity-direction costs as a single padded [C, Nmax, Mmax] tensor
  * per-camera matching on slices (greedy solve only when the adjacency
    shortcut fails — reference association.py:85-94 semantics)
  * one batched Kalman update for every match across all cameras
  * batched spawns; per-camera id counters so outputs match per-camera OCSort

Output parity: update_all(dets_per_cam) produces exactly what one OCSort per
camera would (same ids, boxes, scores — tested in tests/test_multicam.py).
"""
from __future__ import annotations

import numpy as np

from .kalman import BatchKalman, bbox_to_z, z_to_bbox
from .ocsort import Track, associate, greedy_assignment, iou_batch

# ring-age sentinel: must never equal a lookup target (targets reach
# age-delta_t, which can be slightly negative for young tracks)
_NEVER = -1e9
_RANK_NEVER = np.iinfo(np.int64).max


def _iou3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[C,N,5] x [C,M,5] -> [C,N,M] IoU; cell-for-cell the math of
    ocsort.iou_batch (padded cells may be nan — sliced away by the caller)."""
    a = a[:, :, None, :]
    b = b[:, None, :, :]
    x1 = np.maximum(a[..., 0], b[..., 0])
    y1 = np.maximum(a[..., 1], b[..., 1])
    x2 = np.minimum(a[..., 2], b[..., 2])
    y2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter)


def _angle_cost3(dets, prev, vel, vdc_weight):
    """Batched ocsort._angle_cost: [C,N,5],[C,M,5],[C,M,2] -> [C,N,M]."""
    dcx = (dets[..., 0] + dets[..., 2])[:, None, :] / 2.0 \
        - (prev[..., 0] + prev[..., 2])[:, :, None] / 2.0      # [C,M,N]
    dcy = (dets[..., 1] + dets[..., 3])[:, None, :] / 2.0 \
        - (prev[..., 1] + prev[..., 3])[:, :, None] / 2.0
    norm = np.sqrt(dcx ** 2 + dcy ** 2) + 1e-6
    dir_x, dir_y = dcx / norm, dcy / norm
    cos = vel[..., 1][:, :, None] * dir_x + vel[..., 0][:, :, None] * dir_y
    angle = np.arccos(np.clip(cos, -1.0, 1.0))
    score = (np.pi / 2.0 - np.abs(angle)) / np.pi
    valid = (prev[..., 4] >= 0).astype(np.float64)[:, :, None]
    cost = (valid * score * vdc_weight).transpose(0, 2, 1)
    return cost * dets[..., 4][:, :, None]


class MultiCamOCSort:
    def __init__(self, det_thresh: float = 0.25, max_age: int = 30,
                 min_hits: int = 3, iou_threshold: float = 0.3,
                 delta_t: int = 3, inertia: float = 0.2, use_byte: bool = False):
        self.max_age = max_age
        self.min_hits = min_hits
        self.iou_threshold = iou_threshold
        self.delta_t = delta_t
        self.inertia = inertia
        self.use_byte = use_byte
        self.frame_count: dict = {}         # per-camera frame counters
        self.next_id: dict = {}             # per-camera id counters
        self._cam_ids: dict = {}            # camera key (any hashable) -> int

        self.kf = BatchKalman()
        z = lambda *s: np.zeros(s)
        self.cam = np.zeros(0, int)
        self.ids = z(0)
        self.age = z(0)
        self.tsu = z(0)
        self.hits = z(0)
        self.hit_streak = z(0)
        self.last_obs = np.full((0, 5), -1.0)
        self.velocity = z(0, 2)
        self.avg_vel = z(0, 2)
        self.speed = z(0)
        self.class_id = z(0)
        self.score = z(0)
        # observation ring buffer replacing per-track {age: box} dicts:
        # W = delta_t + 1 slots cover every age the lookup can request
        self.W = delta_t + 1
        self.ring_box = np.zeros((0, self.W, 5))
        self.ring_age = np.full((0, self.W), _NEVER)
        # class votes as arrays (reference: per-track dict cls->cum score,
        # argmax with dict-insertion-order tie-break). votes[m, c] = cum
        # score; vote_rank[m, c] = insertion order of class c for track m
        # (big sentinel = never voted) so ties resolve exactly like
        # max(dict, key=dict.get).
        self.votes = np.zeros((0, 1))
        self.vote_rank = np.full((0, 1), _RANK_NEVER, np.int64)
        self.vote_n = np.zeros(0, np.int64)

    def __len__(self):
        return len(self.ids)

    # -- vectorized observation history --------------------------------------

    def _k_previous_obs_all(self) -> np.ndarray:
        """[M,5] delta_t-back observation per track (ocsort.py:11-19):
        prefer age-delta_t, then nearer, else the latest observation, else
        -1s. One vectorized lookup replacing M dict scans."""
        m = len(self)
        if m == 0:
            return np.zeros((0, 5))
        dts = np.arange(self.delta_t, 0, -1)                  # [3,2,1]
        target = self.age[:, None] - dts[None, :]             # [M,K]
        slots = (target % self.W).astype(int)
        valid = np.take_along_axis(self.ring_age, slots, 1) == target
        first = np.argmax(valid, 1)                           # first hit in dt order
        any_valid = valid.any(1)
        sel = np.take_along_axis(
            self.ring_box, slots[np.arange(m), first][:, None, None]
            .repeat(5, 2), 1)[:, 0]
        has_obs = self.last_obs[:, :4].sum(1) >= 0
        out = np.where(any_valid[:, None], sel,
                       np.where(has_obs[:, None], self.last_obs,
                                np.full((1, 5), -1.0)))
        return out

    # -- slot management ------------------------------------------------------

    def _spawn_many(self, cam: int, dets: np.ndarray, cls, scores):
        k = len(dets)
        if k == 0:
            return
        self.kf.add_many(bbox_to_z(dets[:, :4]))
        nid = self.next_id.setdefault(cam, 0)
        self.cam = np.concatenate([self.cam, np.full(k, cam, int)])
        self.ids = np.concatenate([self.ids, np.arange(nid, nid + k)])
        self.next_id[cam] = nid + k
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
        self.ring_box = np.concatenate([self.ring_box,
                                        np.zeros((k, self.W, 5))])
        self.ring_age = np.concatenate([self.ring_age,
                                        np.full((k, self.W), _NEVER)])
        ci = np.asarray(cls, float).astype(int)
        self._grow_vote_width(int(ci.max(initial=0)) + 1)
        w = self.votes.shape[1]
        nv = np.zeros((k, w))
        nr = np.full((k, w), _RANK_NEVER, np.int64)
        nv[np.arange(k), ci] = 1.0          # reference: votes = {cls: 1.0}
        nr[np.arange(k), ci] = 0
        self.votes = np.concatenate([self.votes, nv])
        self.vote_rank = np.concatenate([self.vote_rank, nr])
        self.vote_n = np.concatenate([self.vote_n, np.ones(k, np.int64)])

    def _grow_vote_width(self, w: int):
        cur = self.votes.shape[1]
        if w <= cur:
            return
        m = len(self.votes)
        self.votes = np.concatenate(
            [self.votes, np.zeros((m, w - cur))], 1)
        self.vote_rank = np.concatenate(
            [self.vote_rank, np.full((m, w - cur), _RANK_NEVER, np.int64)], 1)

    def _kill_many(self, idxs: np.ndarray):
        if len(idxs) == 0:
            return
        keep = np.ones(len(self), bool)
        keep[idxs] = False
        for name in ("cam", "ids", "age", "tsu", "hits", "hit_streak",
                     "last_obs", "velocity", "avg_vel", "speed", "class_id",
                     "score", "ring_box", "ring_age", "votes", "vote_rank",
                     "vote_n"):
            setattr(self, name, getattr(self, name)[keep])
        for name in ("x", "P", "saved_x", "saved_P", "has_saved", "observed"):
            setattr(self.kf, name, getattr(self.kf, name)[keep])

    # -- observe --------------------------------------------------------------

    def _observe_many(self, idxs: np.ndarray, det5s: np.ndarray,
                      cls: np.ndarray, prev_obs_all: np.ndarray = None):
        """Batched observation of matched tracks across all cameras:
        idxs [K] global track indices (unique — a track matches at most once
        per tick), det5s [K,5] xyxy+score, cls [K]. Measurement conversion,
        velocity math, class votes and the KF update are all batched; only
        the rare frozen->unfreeze replay stays scalar. prev_obs_all: the
        caller's _k_previous_obs_all() result (rings unchanged since
        association, so it is still valid here)."""
        if len(idxs) == 0:
            return
        idxs = np.asarray(idxs, int)
        zs = bbox_to_z(det5s[:, :4])

        # velocity/average speed for tracks that had a previous observation
        if prev_obs_all is None:
            prev_obs_all = self._k_previous_obs_all()
        prev = prev_obs_all[idxs]           # fancy index -> fresh copy
        no_prev_hist = prev[:, :4].sum(1) < 0
        prev[no_prev_hist] = self.last_obs[idxs][no_prev_hist]
        had_obs = self.last_obs[idxs].sum(1) >= 0
        dy = (det5s[:, 1] + det5s[:, 3]) / 2.0 - (prev[:, 1] + prev[:, 3]) / 2.0
        dx = (det5s[:, 0] + det5s[:, 2]) / 2.0 - (prev[:, 0] + prev[:, 2]) / 2.0
        norm = np.sqrt(dx * dx + dy * dy) + 1e-6
        upd = np.where(had_obs)[0]
        gi = idxs[upd]
        self.velocity[gi, 0] = (dy / norm)[upd]
        self.velocity[gi, 1] = (dx / norm)[upd]
        self.avg_vel[gi] += np.stack([dy, dx], 1)[upd] / self.age[gi][:, None]
        self.speed[gi] = np.abs(self.avg_vel[gi]).sum(1)

        # class votes: votes[cls] += score; class_id = argmax with
        # first-inserted-wins tie-break (== max(dict, key=dict.get))
        ci = np.asarray(cls, float).astype(int)
        self._grow_vote_width(int(ci.max(initial=0)) + 1)
        fresh = self.vote_rank[idxs, ci] == _RANK_NEVER
        self.vote_rank[idxs[fresh], ci[fresh]] = self.vote_n[idxs[fresh]]
        self.vote_n[idxs[fresh]] += 1
        self.votes[idxs, ci] += det5s[:, 4]
        v = self.votes[idxs]
        tied = np.where(v == v.max(1, keepdims=True),
                        self.vote_rank[idxs], _RANK_NEVER)
        self.class_id[idxs] = tied.argmin(1)

        # frozen tracks re-observed: virtual-trajectory replay (rare)
        replay = np.where(~self.kf.observed[idxs] & self.kf.has_saved[idxs])[0]
        for j in replay:
            i = idxs[j]
            z_prev = bbox_to_z(self.last_obs[i][:4])
            self.kf.unfreeze_replay(i, z_prev, zs[j], int(self.tsu[i]))

        self.last_obs[idxs] = det5s
        slot = (self.age[idxs] % self.W).astype(int)
        self.ring_box[idxs, slot] = det5s
        self.ring_age[idxs, slot] = self.age[idxs]
        self.tsu[idxs] = 0
        self.hits[idxs] += 1
        self.hit_streak[idxs] += 1
        self.kf.update_batch(idxs, zs)

    # -- per-tick step ----------------------------------------------------------

    def reset_cam(self, key) -> None:
        """Drop a camera's tracks and counters — equivalent to giving it a
        fresh per-camera OCSort (camera re-add / VOD re-analysis)."""
        cid = self._cam_ids.get(key)
        if cid is None:
            return
        if len(self):
            self._kill_many(np.where(self.cam == cid)[0])
        self.next_id.pop(cid, None)
        self.frame_count.pop(cid, None)

    def update_all(self, dets_per_cam: dict, det_thresh=0.25) -> dict:
        """{cam_key: [N,6+] rows} -> {cam_key: list[Track]}. One call per NVR
        tick; cameras absent from the dict are not advanced (no frame this
        tick). det_thresh: float, or {cam_key: float} for per-camera
        thresholds (per-camera zone settings, clearcam.py:585).

        The whole tick is batched across cameras: one padded [C,Nmax,Mmax]
        cost tensor, and the associate() adjacency shortcut (one IoU>thr
        candidate per row AND column -> perfect matching) resolved for ALL
        cameras in one np.where. Python falls back to per-camera associate()
        only for 'hard' cameras (ambiguous adjacency -> greedy solve, whose
        argsort tie order is part of output parity) and for cameras needing
        the BYTE / second-chance passes."""
        keys = list(dets_per_cam.keys())
        cams = [self._cam_ids.setdefault(k, len(self._cam_ids)) for k in keys]
        C = len(cams)
        cams_arr = np.asarray(cams, int)
        thr = np.array([det_thresh[k] if isinstance(det_thresh, dict)
                        else det_thresh for k in keys], float)
        for cam in cams:
            self.frame_count[cam] = self.frame_count.get(cam, 0) + 1
        active = np.isin(self.cam, cams_arr) if len(self) else np.zeros(0, bool)

        # 1. global predict on active cameras' tracks
        act_idx = np.where(active)[0]
        if len(act_idx):
            sub = BatchKalman.__new__(BatchKalman)  # predict on a view
            for name in ("x", "P"):
                setattr(sub, name, getattr(self.kf, name)[act_idx])
            sub.predict_all()
            self.kf.x[act_idx] = sub.x
            self.kf.P[act_idx] = sub.P
            self.age[act_idx] += 1
            hs = self.hit_streak[act_idx]
            hs[self.tsu[act_idx] > 0] = 0
            self.hit_streak[act_idx] = hs
            self.tsu[act_idx] += 1

        trk_boxes_all = np.zeros((len(self), 5))
        if len(self):
            trk_boxes_all[:, :4] = z_to_bbox(self.kf.x)
        prev_obs_all = self._k_previous_obs_all()

        # 2. active tracks grouped by camera slot: g = global indices sorted
        # by slot (stable -> per-camera slot order preserved), with per-slot
        # offsets/counts. tidx of camera ci == g[m_off[ci] : m_off[ci]+m_per[ci]]
        if len(act_idx):
            lut = np.full(int(cams_arr.max()) + 1, -1)
            lut[cams_arr] = np.arange(C)
            t_ci = lut[self.cam[act_idx].astype(int)]
            order = np.argsort(t_ci, kind="stable")
            g = act_idx[order]
            gci = t_ci[order]
            m_per = np.bincount(gci, minlength=C)
        else:
            g = np.zeros(0, int)
            gci = np.zeros(0, int)
            m_per = np.zeros(C, int)
        m_off = np.concatenate([[0], np.cumsum(m_per)[:-1]]).astype(int) \
            if C else np.zeros(0, int)
        m_pos = (np.arange(len(g)) - m_off[gci]) if len(g) else np.zeros(0, int)
        mmax = int(m_per.max()) if len(g) else 0

        # 3. global det prep: one concat + vectorized high split and
        # within-camera ranks (replaces the per-camera asarray/concat loop)
        rows_l = []
        counts = np.empty(C, int)
        for ci, k in enumerate(keys):
            r = np.asarray(dets_per_cam[k], np.float64)
            r = r.reshape(-1, r.shape[-1])[:, :6] if r.size else \
                np.zeros((0, 6))
            rows_l.append(r)
            counts[ci] = len(r)
        all_rows = np.concatenate(rows_l, 0) if C else np.zeros((0, 6))
        ci_of_row = np.repeat(np.arange(C), counts)
        scores = all_rows[:, 4]
        thr_row = thr[ci_of_row]
        high = scores > thr_row
        second = (scores > 0.1) & (scores < thr_row)
        csum0 = np.concatenate([[0], np.cumsum(high)])
        seg_end = np.cumsum(counts)
        seg_start = seg_end - counts
        base = csum0[seg_start]                       # highs before each cam
        n_per = (csum0[seg_end] - base).astype(int)
        ssum0 = np.concatenate([[0], np.cumsum(second)])
        s_per = (ssum0[seg_end] - ssum0[seg_start]).astype(int)
        nmax = int(n_per.max()) if C else 0
        hi = np.flatnonzero(high)
        hi_ci = ci_of_row[hi]
        pos_high = (csum0[hi + 1] - 1 - base[hi_ci]).astype(int)
        det_pad = np.zeros((C, nmax, 5))
        cls_pad = np.zeros((C, nmax))
        if len(hi):
            det_pad[hi_ci, pos_high, :4] = all_rows[hi, :4]
            det_pad[hi_ci, pos_high, 4] = scores[hi]
            cls_pad[hi_ci, pos_high] = all_rows[hi, 5]

        # 4. padded association costs for every camera at once
        iou3 = angle3 = adj3 = None
        if nmax and mmax:
            trk_pad = np.zeros((C, mmax, 5))
            vel_pad = np.zeros((C, mmax, 2))
            prev_pad = np.full((C, mmax, 5), -1.0)  # col4=-1 -> angle invalid
            trk_pad[gci, m_pos] = trk_boxes_all[g]
            vel_pad[gci, m_pos] = self.velocity[g]
            prev_pad[gci, m_pos] = prev_obs_all[g]
            with np.errstate(divide="ignore", invalid="ignore"):
                iou3 = _iou3(det_pad, trk_pad)
                angle3 = _angle_cost3(det_pad, prev_pad, vel_pad, self.inertia)
                adj3 = iou3 > self.iou_threshold      # nan/pad -> False

        # 5. the adjacency shortcut, batched across all cameras
        obs_t = [np.zeros(0, int)]
        obs_d = [np.zeros((0, 5))]
        obs_c = [np.zeros(0)]
        dmatched = np.zeros((C, nmax), bool)
        tmatched = np.zeros((C, mmax), bool)
        has_nm = (n_per > 0) & (m_per > 0)
        hard = np.zeros(C, bool)
        if adj3 is not None:
            shortcut = has_nm & (adj3.sum(2).max(1) == 1) \
                & (adj3.sum(1).max(1) == 1)
            hard = has_nm & ~shortcut
            if shortcut.any():
                sci, sd, st = np.where(adj3 & shortcut[:, None, None])
                obs_t.append(g[m_off[sci] + st])
                obs_d.append(det_pad[sci, sd])
                obs_c.append(cls_pad[sci, sd])
                dmatched[sci, sd] = True
                tmatched[sci, st] = True

        # 6. per-camera fallbacks: greedy solve for hard cameras; BYTE and
        # second-chance rematch wherever unmatched remain (exact reference
        # order — spawn ids and tie-breaks depend on it)
        need_byte = self.use_byte & (s_per > 0) & (m_per > 0)
        need_rem = has_nm
        spawn_order: dict = {}
        if adj3 is not None:
            um_t_left = m_per - tmatched.sum(1)
            um_d_left = n_per - dmatched.sum(1)
            need_byte &= um_t_left > 0
            need_rem = ~hard & (um_d_left > 0) & (um_t_left > 0)
        for ci in np.flatnonzero(hard | need_byte | need_rem):
            tidx = g[m_off[ci]: m_off[ci] + m_per[ci]]
            n, m = n_per[ci], m_per[ci]
            dets = det_pad[ci, :n]
            cls_high = cls_pad[ci, :n]
            tb = trk_boxes_all[tidx]
            if hard[ci]:
                matched, um_dets, um_trks = associate(
                    dets, tb, self.iou_threshold, None, None, self.inertia,
                    costs=(iou3[ci, :n, :m], angle3[ci, :n, :m]))
                if len(matched):
                    obs_t.append(tidx[matched[:, 1]])
                    obs_d.append(dets[matched[:, 0]])
                    obs_c.append(cls_high[matched[:, 0]])
                    dmatched[ci, matched[:, 0]] = True
                    tmatched[ci, matched[:, 1]] = True
            else:
                um_dets = np.flatnonzero(~dmatched[ci, :n])
                um_trks = np.flatnonzero(~tmatched[ci, :m])

            if self.use_byte and s_per[ci] and len(um_trks):
                seg = slice(seg_start[ci], seg_end[ci])
                rs = all_rows[seg][second[seg]]
                dets_second = rs[:, [0, 1, 2, 3, 4]]
                cls_second = rs[:, 5]
                iou = iou_batch(dets_second, tb[um_trks])
                if iou.max() > self.iou_threshold:
                    rematch = greedy_assignment(-iou)
                    drop = []
                    for r, c in rematch:
                        if iou[r, c] < self.iou_threshold:
                            continue
                        t = um_trks[c]
                        obs_t.append(tidx[t:t + 1])
                        obs_d.append(dets_second[r:r + 1])
                        obs_c.append(cls_second[r:r + 1])
                        tmatched[ci, t] = True
                        drop.append(t)
                    um_trks = np.setdiff1d(um_trks, np.array(drop))

            if len(um_dets) and len(um_trks):
                iou = iou_batch(dets[um_dets], self.last_obs[tidx[um_trks]])
                if iou.max() > self.iou_threshold:
                    rematch = greedy_assignment(-iou)
                    drop_d = []
                    for r, c in rematch:
                        if iou[r, c] < self.iou_threshold:
                            continue
                        d, t = um_dets[r], um_trks[c]
                        obs_t.append(tidx[t:t + 1])
                        obs_d.append(dets[d:d + 1])
                        obs_c.append(cls_high[d:d + 1])
                        dmatched[ci, d] = True
                        tmatched[ci, t] = True
                        drop_d.append(d)
                    um_dets = np.setdiff1d(um_dets, np.array(drop_d))
            if hard[ci]:
                # hard cameras' spawn order is associate()'s um ordering
                # (ascending never-matched, then below-threshold pairs in
                # matched order), not plain ascending
                spawn_order[ci] = np.asarray(um_dets, int)

        # 7. batched freeze / observe, then per-camera spawns (id order)
        self.kf.freeze(g[~tmatched[gci, m_pos]] if len(g)
                       else np.zeros(0, int))
        self._observe_many(np.concatenate(obs_t), np.concatenate(obs_d),
                           np.concatenate(obs_c), prev_obs_all)
        for ci in range(C):
            um = spawn_order.get(ci)
            if um is None:
                um = np.flatnonzero(~dmatched[ci, :n_per[ci]])
            if len(um):
                self._spawn_many(cams[ci], det_pad[ci, um], cls_pad[ci, um],
                                 det_pad[ci, um, 4])
        out: dict = {}

        # 3. emit per camera (reference order: newest slot first) + reap.
        # Emission candidates are vectorized: only tracks observed this tick
        # (tsu==0) that pass the streak/grace gate produce Track objects.
        emit = (self.tsu < 1) & (self.hit_streak >= self.min_hits)
        for cam in cams:
            if self.frame_count[cam] <= self.min_hits:
                emit |= (self.tsu < 1) & (self.cam == cam)
        cand = np.flatnonzero(emit)
        cand = cand[np.isin(self.cam[cand], cams)]
        cand = cand[::-1]                        # newest slot first
        boxes = np.where(self.last_obs[cand].sum(1)[:, None] >= 0,
                         self.last_obs[cand, :4],
                         z_to_bbox(self.kf.x[cand])) if len(cand) \
            else np.zeros((0, 4))
        # one vectorized pass builds every output field; the per-track loop
        # only wraps rows into Track objects (at 128 cams the old per-track
        # np.array/float() conversions dominated the tick)
        tlwh = np.empty((len(cand), 4))
        tlwh[:, :2] = boxes[:, :2]
        tlwh[:, 2:] = boxes[:, 2:] - boxes[:, :2]
        scalars = np.stack([self.score[cand], self.class_id[cand],
                            self.ids[cand] + 1, self.age[cand],
                            self.speed[cand]], 1).tolist() if len(cand) else []
        by_cam: dict = {cam: [] for cam in cams}
        for j, ci in enumerate(self.cam[cand].tolist()):
            s = scalars[j]
            by_cam[ci].append(Track(tlwh=tlwh[j], score=s[0], class_id=s[1],
                                    track_id=s[2], tracklet_len=s[3],
                                    speed=s[4]))
        out.update(by_cam)
        dead = (self.tsu > self.max_age) & ((self.speed > 2) | (self.tsu > 600))
        self._kill_many(np.where(dead)[0])
        return {k: out[c] for k, c in zip(keys, cams)}
