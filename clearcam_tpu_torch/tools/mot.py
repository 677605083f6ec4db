"""MOT evaluation: video -> batched detect -> OC-SORT -> unique-track count,
the counterpart of ``clearcam_tpu.tools.mot`` with its flags.

Equivalent of the reference's test/run_mot.py: replay a clip through the
detector and tracker, apply the standard filters (tracklet_len>=1,
speed>=2.5) and report the number of unique person track ids (its
regression invariant is 156 unique persons on MOT16-03 with YOLOv9-t @960).
Optionally writes an annotated mp4.

Also runs the RF-DETR detector (``--detector rfdetr``, reference
run_mot.py:36-51: detr_to_yolo-remapped, invariant 157 unique persons).

Usage:
    python -m clearcam_tpu_torch.tools.mot video.mp4 --size t --res 960 \\
        [--detector yolo|rfdetr] [--out annotated.mp4] [--weights weights/] \\
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def accumulate_people(people: set, tracks, person_class: int = 0):
    """Apply the reference's MOT filters (run_mot.py:20-23: tracklet_len>=1
    and speed>=2.5) and add the surviving person track ids to ``people``.
    Returns the filtered live tracks (run_mot.py:25 counts uniques this
    way)."""
    live = [t for t in tracks if t.tracklet_len >= 1 and t.speed >= 2.5]
    for t in live:
        if int(t.class_id) == person_class:
            people.add(int(t.track_id))
    return live


def run_mot(video: str, detector=None, size: str = "t", res: int = 960,
            det_thresh: float = 0.25, out_path: str | None = None,
            weights_dir: str = "weights", max_frames: int | None = None,
            person_class: int = 0, detector_kind: str = "yolo", device="cuda"):
    """-> (unique person count, per-frame track lists). Without
    ``detector``, builds the port's RF-DETR nano (``detector_kind="rfdetr"``,
    ``rf-detr-nano.pth`` under ``weights_dir`` when present) or its
    BatchDetector on ``device``."""
    import cv2
    from ..track.ocsort import OCSort

    if detector is None and detector_kind == "rfdetr":
        from ..models.rfdetr import RFDETR
        path = Path(weights_dir) / "rf-detr-nano.pth"
        detector = (RFDETR.from_checkpoint(str(path), device=device)
                    if path.exists() else RFDETR("nano", device=device))
        if not path.exists():
            print(f"weights not found at {path} — random init "
                  "(counts will be meaningless)")
    elif detector is None:
        from ..io import safetensors as st
        from ..models import yolov9
        from ..runtime.nvr import BatchDetector
        path = Path(weights_dir) / f"yolov9-{size}.safetensors"
        params = yolov9.convert_state_dict(st.load(path)) if path.exists() else None
        detector = BatchDetector(size, res, params=params, device=device)

    cap = cv2.VideoCapture(video)
    writer = None
    if out_path:
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 30, (w, h))
    tracker = OCSort(max_age=60)
    people: set[int] = set()
    frames_out = []
    n = 0
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames is not None and n >= max_frames):
            break
        preds = detector.detect_many([frame])[0]
        tracks = tracker.update(np.asarray(preds), det_thresh)
        live = accumulate_people(people, tracks, person_class)
        frames_out.append(live)
        if writer is not None:
            from ..utils.annotate import draw_predictions
            rows = [[*t.tlbr, t.score, t.class_id, t.track_id] for t in live]
            writer.write(draw_predictions(frame, rows))
        n += 1
    cap.release()
    if writer is not None:
        writer.release()
    return len(people), frames_out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("video")
    ap.add_argument("--size", default="t")
    ap.add_argument("--res", type=int, default=960)
    ap.add_argument("--out")
    ap.add_argument("--weights", default="weights")
    ap.add_argument("--detector", default="yolo", choices=["yolo", "rfdetr"])
    ap.add_argument("--expect", type=int,
                    help="assert unique person count equals this")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    count, _ = run_mot(args.video, size=args.size, res=args.res,
                       out_path=args.out, weights_dir=args.weights,
                       detector_kind=args.detector, device=args.device)
    print(f"unique persons: {count}")
    if args.expect is not None:
        assert count == args.expect, f"expected {args.expect}, got {count}"
    return count


if __name__ == "__main__":
    main()
