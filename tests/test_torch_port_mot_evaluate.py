"""The port's MOT and evaluation tools (clearcam_tpu_torch.tools.mot,
clearcam_tpu_torch.tools.evaluate) against the JAX tools: tests/
test_mot_tool.py's synthetic clip and tests/test_evaluate.py's constructed
cases, each run through both tools with the same fake detector, which must
give the same unique count and the same AP dict; then both detector routes
(the port's BatchDetector and RF-DETR) on the CPU through each tool's main."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from clearcam_tpu.tools import evaluate as jeval  # noqa: E402
from clearcam_tpu.tools import mot as jmot  # noqa: E402
from clearcam_tpu_torch.models.rfdetr import RFDETR, RFDETRConfig  # noqa: E402
from clearcam_tpu_torch.testing import torch_threads  # noqa: E402
from clearcam_tpu_torch.tools import evaluate as teval  # noqa: E402
from clearcam_tpu_torch.tools import mot as tmot  # noqa: E402

from test_finetune import make_dataset  # noqa: E402
from test_mot_tool import MultiColorDetector, write_clip  # noqa: E402
from test_rfdetr import TINY  # noqa: E402

TINY_T = RFDETRConfig(**TINY.__dict__)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


# ---------------------------------------------------------------------------
# mot
# ---------------------------------------------------------------------------

def test_unique_person_invariant_matches_jax(tmp_path):
    """tests/test_mot_tool.py's clip: three persons, overlapping presence
    tracked, the same count and per-frame tracks as the JAX tool."""
    clip = tmp_path / "clip.mp4"
    write_clip(clip)
    count, frames = tmot.run_mot(str(clip), detector=MultiColorDetector())
    ref_count, ref_frames = jmot.run_mot(str(clip), detector=MultiColorDetector())
    assert count == ref_count == 3
    assert any(len(f) >= 2 for f in frames)
    assert [[int(t.track_id) for t in f] for f in frames] == \
        [[int(t.track_id) for t in f] for f in ref_frames]


def test_accumulate_people_filters_like_jax():
    class Tr:
        def __init__(self, tid, cls, length, speed):
            self.track_id, self.class_id = tid, cls
            self.tracklet_len, self.speed = length, speed

    tracks = [Tr(1, 0, 1, 3.0), Tr(2, 0, 0, 3.0), Tr(3, 0, 2, 1.0), Tr(4, 2, 5, 9.0),
              Tr(5, 0, 5, 2.5)]
    a, b = set(), set()
    live = tmot.accumulate_people(a, tracks)
    ref = jmot.accumulate_people(b, tracks)
    assert a == b == {1, 5} and live == ref


def test_rfdetr_tiny_route_runs_clip(tmp_path):
    """The port's RF-DETR plugs into run_mot end to end (reference
    run_mot.py:36-51 runs both detectors on one clip)."""
    clip = tmp_path / "clip.mp4"
    write_clip(clip, n_frames=6)
    count, frames = tmot.run_mot(str(clip), detector=RFDETR(TINY_T, device="cpu"),
                                 max_frames=6)
    assert isinstance(count, int) and len(frames) == 6


def test_annotated_output(tmp_path):
    clip = tmp_path / "clip.mp4"
    out = tmp_path / "out.mp4"
    write_clip(clip, n_frames=30)
    tmot.run_mot(str(clip), detector=MultiColorDetector(), out_path=str(out))
    cap = cv2.VideoCapture(str(out))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 30
    ok, frame = cap.read()
    assert ok and frame.shape == (240, 480, 3)
    cap.release()


@pytest.mark.parametrize("detector", ["yolo", "rfdetr"])
def test_mot_main_both_detector_routes(tmp_path, detector, capsys):
    """main on the CPU with each detector built by the tool (random weights:
    the count means nothing, every frame must come out)."""
    clip = tmp_path / "clip.mp4"
    write_clip(clip, n_frames=4)
    count = tmot.main([str(clip), "--detector", detector, "--res", "128",
                       "--weights", str(tmp_path / "none"), "--device", "cpu"])
    assert isinstance(count, int) and count >= 0
    assert f"unique persons: {count}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

EVAL_CASES = {
    # (gts, preds, check on the port's dict) from tests/test_evaluate.py
    "perfect": (
        [(np.array([[10, 10, 50, 50], [60, 60, 90, 90]]), np.array([0.0, 1.0]))],
        [np.array([[10, 10, 50, 50, 0.9, 0.0], [60, 60, 90, 90, 0.8, 1.0]])],
        lambda o: o["mAP50"] == 1.0 and o["mAP50-95"] == 1.0),
    "miss_and_false_positive": (
        [(np.array([[10, 10, 50, 50], [100, 100, 150, 150]]), np.array([0.0, 0.0]))],
        [np.array([[10, 10, 50, 50, 0.9, 0.0], [300, 300, 340, 340, 0.8, 0.0]])],
        lambda o: 0.45 <= o["mAP50"] <= 0.55),
    "loose_box": (
        [(np.array([[0, 0, 100, 100]]), np.array([0.0]))],
        [np.array([[0, 0, 100, 72, 0.9, 0.0]])],
        lambda o: o["mAP50"] == 1.0 and o["mAP50-95"] < 0.6),
    "duplicate": (
        [(np.array([[0, 0, 100, 100]]), np.array([0.0]))],
        [np.array([[0, 0, 100, 100, 0.9, 0.0], [1, 1, 99, 99, 0.85, 0.0]])],
        lambda o: o["mAP50"] == 1.0),
    "two_images_zero_rows": (
        [(np.array([[5, 5, 40, 40]]), np.array([2.0])),
         (np.array([[0, 0, 30, 30], [50, 50, 90, 90]]), np.array([2.0, 7.0]))],
        [np.array([[5, 5, 40, 41, 0.7, 2.0], [0, 0, 0, 0, 0.0, 0.0]]),
         np.array([[50, 50, 88, 90, 0.6, 7.0], [0, 0, 30, 30, 0.2, 2.0],
                    [200, 200, 230, 230, 0.9, 2.0]])],
        lambda o: set(o["classes"]) == {2, 7}),
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_evaluate_matches_jax(case):
    gts, preds, check = EVAL_CASES[case]
    got = teval.evaluate(preds, gts)
    assert got == jeval.evaluate(preds, gts)
    assert check(got), got


def test_iou_and_average_precision_match_jax():
    a = np.array([[0, 0, 10, 10]])
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]])
    np.testing.assert_allclose(teval.iou_matrix(a, b)[0], [1.0, 25 / 175, 0.0], atol=1e-6)
    np.testing.assert_array_equal(teval.iou_matrix(b, a), jeval.iou_matrix(b, a))
    assert teval.iou_matrix(a, np.zeros((0, 4))).shape == (1, 0)
    assert np.isnan(teval.average_precision([], [], 0))
    assert teval.average_precision([], [], 3) == 0.0
    assert teval.average_precision([0.9], [1.0], 1) == 1.0
    rng = np.random.default_rng(0)
    s, m = rng.uniform(size=20), rng.integers(0, 2, 20).astype(float)
    assert teval.average_precision(s, m, 12) == jeval.average_precision(s, m, 12)
    assert (teval.IOU_THRESHOLDS == jeval.IOU_THRESHOLDS).all()


def test_end_to_end_with_fake_detector(tmp_path):
    root = make_dataset(tmp_path, n=3, size=96)
    paths, gts = teval.load_gt(root)
    ref_paths, ref_gts = jeval.load_gt(root)
    assert paths == ref_paths and len(paths) == 3 and gts[0][0].shape == (1, 4)
    for (gb, gc), (rb, rc) in zip(gts, ref_gts):
        np.testing.assert_array_equal(gb, rb)
        np.testing.assert_array_equal(gc, rc)
    preds = [np.concatenate([g[0], np.full((1, 1), 0.9), np.zeros((1, 1))], 1) for g in gts]
    assert teval.evaluate(preds, gts)["mAP50-95"] == 1.0


@pytest.mark.parametrize("detector", ["yolo", "rfdetr"])
def test_evaluate_main_both_detector_routes(tmp_path, detector, capsys):
    """main on the CPU over a synthetic YOLO-format dataset with each
    detector (random weights: the AP values mean nothing)."""
    root = make_dataset(tmp_path / "ds", n=3, size=96)
    out = teval.main([str(root), "--detector", detector, "--res", "128",
                      "--weights", str(tmp_path / "none"), "--device", "cpu"])
    assert out.keys() == {"mAP50", "mAP50-95", "classes"}
    assert set(out["classes"]) == {0}
    assert 0.0 <= out["mAP50-95"] <= out["mAP50"] <= 1.0
    assert str(out) in capsys.readouterr().out
