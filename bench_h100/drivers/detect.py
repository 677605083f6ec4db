"""The NVR's detect tick: ``runtime.nvr.BatchDetector.detect_many`` on every
camera's frame, then ``track.multicam.MultiCamOCSort.update_all``, in a
closed loop.

Set-up builds the detector as the NVR does (the stem kernel's library is
built or loaded in its constructor), with weights made from the seed, and
warms up the traffic's shape groups with one whole tick. The window runs
whole ticks until ``seconds`` have passed. The check runs the plain
reference (``reference/yolov9.py``) on the frames of ticks drawn from the
seed and compares the rows the window returned for them
(``compare.detect_gaps``).
"""
from __future__ import annotations

import importlib
import resource
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import compare, weights
from ..counts import yolov9 as counts
from ..reference import yolov9 as ref


class Cell:
    def __init__(self, cell, seed: int, device, spans, log):
        self.cell, self.seed, self.device, self.spans, self.log = cell, seed, device, spans, log
        self.cfg = cell.config

    def setup(self) -> None:
        from clearcam_tpu_torch.runtime.nvr import BatchDetector
        from clearcam_tpu_torch.track.multicam import MultiCamOCSort

        cfg = self.cfg
        gen = importlib.import_module(f"bench_h100.traffic.{self.cell.traffic['generator']}")
        self.traffic = gen.make(self.cell.traffic, self.seed, self.device)
        self.weights = weights.yolov9(cfg, self.seed, self.device, self.traffic.frames[0][0])
        self.detector = BatchDetector(size=cfg["size"], res=cfg["input_size"],
                                      params=self.weights,
                                      dtype=getattr(torch, cfg["compute_dtype"]),
                                      device=self.device)
        self.tracker = MultiCamOCSort(max_age=cfg["tracker"]["max_age"])
        self.detector.detect_many(self.traffic.frames_at(0))    # every shape group once
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_window(self, seconds: float, tracer) -> SimpleNamespace:
        spans, tr, thr = self.spans, self.traffic, self.cfg["tracker"]["det_thresh"]
        self.outputs: list = []
        faults0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        t_start = time.perf_counter()
        tick = 0
        while time.perf_counter() - t_start < seconds:
            tracer.poll(time.perf_counter(), t_start, seconds)
            frames = tr.frames_at(tick)
            t0 = time.perf_counter()
            rows = self.detector.detect_many(frames)
            t1 = time.perf_counter()
            self.tracker.update_all(tr.tracks_at(tick), thr)
            t2 = time.perf_counter()
            spans.add("detect_many", t0, t1)
            spans.add("track", t1, t2)
            spans.add("tick", t0, t2)
            self.outputs.append(rows)
            tick += 1
        tracer.stop()
        t_end = time.perf_counter()
        window_s = t_end - t_start
        faults = resource.getrusage(resource.RUSAGE_SELF).ru_minflt - faults0
        ticks_ms = np.array([b - a for a, b in spans.data["tick"]]) * 1e3
        det_ms = np.array([b - a for a, b in spans.data["detect_many"]]) * 1e3
        n = tr.n_cams * tick
        self.log(f"window: {tick} ticks, {n / window_s / 30.0!r} streams at 30 fps, tick ms "
                 f"p50 {np.percentile(ticks_ms, 50):.1f} p95 {np.percentile(ticks_ms, 95):.1f} "
                 f"max {ticks_ms.max():.1f}; detect_many ms p50 {np.percentile(det_ms, 50):.1f}; "
                 f"host page faults a tick {faults / max(tick, 1):.0f}")
        groups = self._groups()
        return SimpleNamespace(
            attempted=n, failed=0, window_s=window_s, t_start=t_start, t_end=t_end,
            metrics={"streams_30fps": n / window_s / 30.0,
                     "tick_p95_ms": float(np.percentile(ticks_ms, 95))},
            ticks=tick, n_cams=tr.n_cams, groups=groups,
            flops_per_tick=sum(g["frames"] * counts.frame_flops(
                self.cfg, g["src_h"], g["src_w"], self.cfg["input_size"]) for g in groups),
            stem_per_tick=[counts.stem_cost(self.cfg, g["bucket"], g["h"], g["w"])
                           for g in groups])

    def _groups(self) -> list[dict]:
        """The device calls a tick makes: one a source shape, its frames
        padded to the detector's bucket."""
        shapes: dict = {}
        for f in self.traffic.frames_at(0):
            shapes[f.shape[:2]] = shapes.get(f.shape[:2], 0) + 1
        out = []
        for (h, w), n in shapes.items():
            _, _, _, _, lh, lw = ref.letterbox_geometry(h, w, self.cfg["input_size"])
            out.append({"src_h": h, "src_w": w, "frames": n, "bucket": self.detector._bucket(n),
                        "h": lh, "w": lw})
        return out

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        self.detector = self.tracker = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list[tuple[str, float, float]]:
        worst, n_frames = self._gaps(self.outputs)
        self.log(f"check: {n_frames} frames, {worst['live']} live rows against the "
                 f"reference's {worst['ref_kept']}; kept_diff {worst['kept_diff']!r} (not compared)")
        return [(name, worst[name], float(limit))
                for name, limit in self.cell.cell["limits"].items()]

    def controls(self) -> dict:
        """The check's numbers with the reference in the program's place,
        each a reading the limits must fail: ``float8``, the reference in
        float8 (e4m3, one scale a tensor, every convolution's input and
        filter); ``no_suppression``, the float32 reference with NMS left
        out (no overlap suppresses a row)."""
        ticks, ids = self._sample()
        pool, n = self.traffic.pool, self.traffic.n_cams
        out = {}
        for name, kw in (("float8", {"cast": ref.fp8}), ("no_suppression", {"iou": 2.0})):
            low = reference_outputs(self.cfg, self.weights, self.traffic, ids, self.device, **kw)
            out[name] = self._gaps([[low[(c, t % pool)][0].cpu().numpy() for c in range(n)]
                                    if t in ticks else None
                                    for t in range(len(self.outputs))])[0]
        return out

    def _sample(self) -> tuple[list, list]:
        """The ticks drawn from the seed and the frames they handed over."""
        ticks = sampled_ticks(len(self.outputs), self.cell.cell["check"]["ticks"], self.seed)
        ids = sorted({(c, t % self.traffic.pool) for t in ticks
                      for c in range(self.traffic.n_cams)})
        return ticks, ids

    def _gaps(self, outputs: list) -> tuple[dict, int]:
        """``compare.detect_gaps`` of ``outputs`` (rows by tick) over the
        sampled ticks' frames: the widest box and score gaps and the count
        gap of all those frames' rows (compared), and the kept anchors that
        differ over those the reference kept (``kept_diff``, not compared);
        and how many frames were read."""
        ticks, ids = self._sample()
        refs = reference_outputs(self.cfg, self.weights, self.traffic, ids, self.device)
        worst = {"box_gap_px": 0.0, "score_gap": 0.0}
        diff = kept = live = 0
        for t in ticks:
            for c, rows in enumerate(outputs[t]):
                _, ref_kept, boxes, probs = refs[(c, t % self.traffic.pool)]
                g = compare.detect_gaps(rows, ref_kept, boxes, probs,
                                        self.traffic.frames[c][0].shape[:2])
                worst = {k: max(v, g[k]) for k, v in worst.items()}
                diff, kept, live = diff + g["kept_diff"], kept + g["ref_kept"], live + g["live"]
        return (dict(worst, count_gap=compare.count_gap(live, kept), kept_diff=diff / max(kept, 1),
                     live=live, ref_kept=kept), len(ids))


def sampled_ticks(n_ticks: int, k: int, seed: int) -> list[int]:
    """k ticks drawn from the seed, the last tick always among them."""
    rng = np.random.default_rng([int(seed), 4])
    pick = set(rng.choice(n_ticks, size=min(k, n_ticks), replace=False).tolist())
    pick.add(n_ticks - 1)
    return sorted(pick)


@torch.no_grad()
def reference_outputs(cfg, weights_, traffic, frame_ids, device, cast=None, iou=None,
                      block: int = 16):
    """{(camera, pool index): (rows, kept anchors, anchor boxes, probs)} of
    the plain reference, float32 with TF32 off (``cast`` and ``iou`` for
    the controls)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ref.Model(cfg, weights_, device, cast=cast)
    by_shape: dict = {}
    for fid in frame_ids:
        by_shape.setdefault(traffic.frames[fid[0]][fid[1]].shape, []).append(fid)
    out = {}
    for ids in by_shape.values():
        for i in range(0, len(ids), block):
            chunk = ids[i:i + block]
            x = torch.from_numpy(np.stack([traffic.frames[c][j] for c, j in chunk])).to(device)
            r, kept, boxes, probs = ref.detect(model, x, cfg["input_size"], cfg["max_det"],
                                               cfg["conf_threshold"],
                                               cfg["iou_threshold"] if iou is None else iou)
            for n, fid in enumerate(chunk):
                out[fid] = (r[n], kept[n], boxes[n], probs[n])
    return out
