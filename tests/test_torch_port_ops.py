"""Parity of the port's plain ops (clearcam_tpu_torch.nn.functional, ops.image,
ops.boxes, ops.nms) with the JAX package's, on the CPU in float32. Every
input is made with numpy from a seed and fed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.nn import functional as jF
from clearcam_tpu.ops import boxes as jboxes
from clearcam_tpu.ops import image as jimage
from clearcam_tpu.ops import nms as jnms
from clearcam_tpu_torch.nn import functional as tF
from clearcam_tpu_torch.ops import boxes as tboxes
from clearcam_tpu_torch.ops import image as timage
from clearcam_tpu_torch.ops import nms as tnms
from clearcam_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _boxes(rng, shape, span=100.0):
    xy = rng.uniform(0, span, shape + (2,)).astype(np.float32)
    wh = rng.uniform(1, span / 2, shape + (2,)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


# ---------------------------------------------------------------------------
# nn.functional
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,groups", [(1, 1, 1), (2, 1, 1),
                                                   (1, 0, 4), (2, 1, 4)])
def test_conv2d_matches_jax(stride, padding, groups):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 13, 11, 8)).astype(np.float32)
    w = rng.normal(size=(3, 3, 8 // groups, 12)).astype(np.float32) * 0.2
    b = rng.normal(size=(12,)).astype(np.float32)
    ref = np.asarray(jF.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               stride=stride, padding=padding, groups=groups))
    got = tF.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=padding,
                    groups=groups).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("op,args", [
    ("max_pool2d", (3, 2, 1)), ("max_pool2d", (5, 1, 2)),
    ("avg_pool2d", (2, 1, 0)), ("upsample_nearest", (2,))])
def test_pool_and_upsample_match_jax(op, args):
    x = np.random.default_rng(1).normal(size=(2, 9, 7, 5)).astype(np.float32)
    ref = np.asarray(getattr(jF, op)(jnp.asarray(x), *args))
    got = getattr(tF, op)(_t(x), *args).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_filter_layout_roundtrip():
    w = np.random.default_rng(2).normal(size=(3, 3, 4, 8)).astype(np.float32)
    np.testing.assert_array_equal(tF.oihw_to_hwio(tF.hwio_to_oihw(w)), w)
    np.testing.assert_array_equal(jF.oihw_to_hwio(tF.hwio_to_oihw(w)), w)
    np.testing.assert_array_equal(
        tF.oihw_to_hwio(tF.hwio_to_oihw(_t(w))).numpy(), w)


# ---------------------------------------------------------------------------
# letterbox
# ---------------------------------------------------------------------------

# (src_hw, res): odd k (1080p->640, k=3), even k (720p->640, k=2), a
# non-integer downscale and upscale (bilinear), and the identity
LETTERBOX_CASES = [((1080, 1920), 640), ((720, 1280), 640), ((1080, 1920), 416),
                   ((150, 200), 320), ((384, 640), 640)]


@pytest.mark.parametrize("src_hw,res", LETTERBOX_CASES)
def test_letterbox_matches_jax(src_hw, res):
    frames = np.random.default_rng(3).integers(0, 256, (2, *src_hw, 3), np.uint8)
    ref = np.asarray(jimage.letterbox(jnp.asarray(frames), res))
    got = timage.letterbox(_t(frames), res)
    assert got.is_contiguous()          # the stem kernel takes it as is
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_letterbox_1080p_at_640_is_384x640():
    frames = torch.zeros((1, 1080, 1920, 3), dtype=torch.uint8)
    assert tuple(timage.letterbox(frames, 640).shape) == (1, 384, 640, 3)


@pytest.mark.parametrize("src_hw", [(1080, 1920), (720, 1280), (480, 640),
                                    (1920, 1080), (100, 68), (333, 777)])
@pytest.mark.parametrize("res", [64, 128, 640, 960])
@pytest.mark.parametrize("auto", [True, False])
def test_letterbox_geometry_equals_jax(src_hw, res, auto):
    assert timage.letterbox_plan(src_hw, res, auto=auto) == \
        jimage.letterbox_plan(src_hw, res, auto=auto)
    assert timage.scale_boxes_params(src_hw, res, auto=auto) == \
        jimage.scale_boxes_params(src_hw, res, auto=auto)


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

def test_iou_matrix_matches_jax():
    b = _boxes(np.random.default_rng(4), (2, 40))
    np.testing.assert_allclose(tboxes.iou_matrix(_t(b)).numpy(),
                               np.asarray(jboxes.iou_matrix(jnp.asarray(b))),
                               atol=1e-6)


@pytest.mark.parametrize("xywh", [True, False])
def test_dist2bbox_matches_jax(xywh):
    rng = np.random.default_rng(5)
    d = rng.uniform(0, 8, (2, 30, 4)).astype(np.float32)
    a = rng.uniform(0, 40, (30, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tboxes.dist2bbox(_t(d), _t(a), xywh=xywh).numpy(),
        np.asarray(jboxes.dist2bbox(jnp.asarray(d), jnp.asarray(a), xywh=xywh)),
        atol=1e-6)


def test_scale_boxes_and_xywh_match_jax():
    rng = np.random.default_rng(6)
    b = _boxes(rng, (2, 30), span=640)
    gain, px, py = jimage.scale_boxes_params((1080, 1920), 640)
    np.testing.assert_allclose(
        tboxes.scale_boxes(_t(b), gain, px, py, (1080, 1920)).numpy(),
        np.asarray(jboxes.scale_boxes(jnp.asarray(b), gain, px, py, (1080, 1920))),
        atol=1e-6)
    np.testing.assert_allclose(tboxes.xywh_to_xyxy(_t(b)).numpy(),
                               np.asarray(jboxes.xywh_to_xyxy(jnp.asarray(b))),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _nms_inputs(seed, n=400, ncls=3):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (2, n), span=200)
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    scores[scores < 0.3] = 0.0
    cls = rng.integers(0, ncls, (2, n)).astype(np.int32)
    return boxes, scores, cls


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_nms_matches_jax(seed, class_aware):
    boxes, scores, cls = _nms_inputs(seed)
    ref = np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(cls), class_aware=class_aware))
    got = tnms.batched_nms(_t(boxes), _t(scores), _t(cls).long(),
                           class_aware=class_aware).numpy()
    np.testing.assert_array_equal(got, ref)


def test_batched_nms_ties_keep_lower_index_first():
    """Equal scores rank by index, as jax.lax.top_k does."""
    boxes = _boxes(np.random.default_rng(7), (1, 20), span=1000)
    scores = np.full((1, 20), 0.5, np.float32)
    cls = np.arange(20, dtype=np.int32)[None]
    ref = np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(cls), max_det=10))
    got = tnms.batched_nms(_t(boxes), _t(scores), _t(cls).long(), max_det=10)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[0, :, 5].numpy(), np.arange(10))


def test_nms_chain_suppression():
    """A suppresses B, B overlaps C (not A): C goes too, although B was
    itself dropped — the reference's rule, not greedy NMS (which keeps C)."""
    boxes = np.array([[[0, 0, 10, 10],      # A
                       [2, 0, 12, 10],      # B: IoU(A,B) = 0.67
                       [5, 0, 15, 10]]],    # C: IoU(B,C) = 0.54, IoU(A,C) = 0.33
                     np.float32)
    scores = np.array([[0.9, 0.8, 0.7]], np.float32)
    cls = np.zeros((1, 3), np.int32)
    got = tnms.batched_nms(_t(boxes), _t(scores), _t(cls).long()).numpy()
    ref = np.asarray(jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(cls)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, :, 4], np.float32([0.9, 0.0, 0.0]))


@pytest.mark.parametrize("conf", [0.25, 0.6])
def test_yolo_postprocess_matches_jax(conf):
    rng = np.random.default_rng(8)
    xy = rng.uniform(0, 200, (2, 500, 2))
    wh = rng.uniform(2, 60, (2, 500, 2))
    cls = rng.uniform(0, 1, (2, 500, 80)) ** 3
    raw = np.concatenate([xy, wh, cls], -1).astype(np.float32)
    ref = np.asarray(jnms.yolo_postprocess(jnp.asarray(raw), 300, conf))
    got = tnms.yolo_postprocess(_t(raw), 300, conf).numpy()
    np.testing.assert_array_equal(got, ref)
