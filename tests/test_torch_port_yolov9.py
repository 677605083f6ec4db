"""The port's YOLOv9 (clearcam_tpu_torch.models.yolov9) against the JAX
package's, on the CPU in float32: the same numpy weights from init_params,
the same numpy inputs, through forward_raw and the whole detect."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import yolov9 as J
from clearcam_tpu_torch.models import yolov9 as T
from clearcam_tpu_torch.nn import functional as tF
from clearcam_tpu_torch.testing import compared_rows, detection_mismatches, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("size", ["t", "dryrun"])
def test_init_params_equal_jax(size):
    ref, got = J.init_params(size, seed=3), T.init_params(size, seed=3)
    assert list(ref) == list(got)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("size", ["t", "s", "m", "c", "e"])
def test_layer_graphs_equal_jax(size):
    ref, got = J.layer_graph(size), T.layer_graph(size)
    assert [(l.kind, l.f, l.args) for l in ref] == [(l.kind, l.f, l.args) for l in got]
    assert T.uses_stem_kernel(size) == (size == "t")


def test_params_from_jax_roundtrip():
    params = T.init_params("dryrun", seed=1)
    tp = T.params_from_jax(params, "cpu", torch.float32)
    assert tp.keys() == params.keys() | T.STEM_KEYS.keys()
    for k, src in T.STEM_KEYS.items():      # the stem kernel's operands
        assert tp[k].dtype == torch.float32 and tp[k].is_contiguous()
        np.testing.assert_array_equal(tp[k].numpy(), params[src], err_msg=k)
    for k, v in params.items():
        t = tp[k]
        if v.ndim == 4:     # OIHW, channels_last storage
            assert tuple(t.shape) == (v.shape[3], v.shape[2], v.shape[0], v.shape[1])
            assert t.is_contiguous(memory_format=torch.channels_last)
            t = tF.oihw_to_hwio(t)
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    # jax arrays go through the same path; bf16 rounds as torch does
    tb = T.params_from_jax({k: jnp.asarray(v) for k, v in params.items()},
                           "cpu", torch.bfloat16)
    for k, v in params.items():
        ref = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
        got = tb[k].float()
        got = tF.oihw_to_hwio(got) if v.ndim == 4 else got
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=k)
    # the kernel's f32 operands hold the bf16-rounded values
    for k, src in T.STEM_KEYS.items():
        assert tb[k].dtype == torch.float32
        ref = torch.from_numpy(params[src]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(tb[k].numpy(), ref, err_msg=k)
    # a stem of other widths (size s: 3->32->64) gets no kernel operands
    assert not T.params_from_jax(T.init_params("s")).keys() & T.STEM_KEYS.keys()


def test_convert_state_dict_equals_jax():
    """Published checkpoint names (tinygrad's `.list.`, OIHW filters, the
    DFL conv, anchors) convert as in the JAX package."""
    rng = np.random.default_rng(2)
    sd = {"model.0.conv.weight": rng.normal(size=(16, 3, 3, 3)).astype(np.float32),
          "model.0.conv.bias": rng.normal(size=(16,)).astype(np.float32),
          "model.22.cv2.list.0.list.2.weight": rng.normal(size=(64, 16, 1, 1)).astype(np.float32),
          "model.22.dfl.conv.weight": np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1),
          "model.22.anchors": np.zeros((2, 10), np.float32),
          "model.22.strides": np.zeros((1, 10), np.float32)}
    ref, got = J.convert_state_dict(sd), T.convert_state_dict(sd)
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def _forward_pair(size, res, seed=3):
    params = J.init_params(size, seed=7)
    img = np.random.default_rng(seed).uniform(0, 1, (2, res, res, 3)).astype(np.float32)
    ref = np.asarray(J.forward_raw(params, jnp.asarray(img), size))
    with torch.inference_mode():
        got = T.forward_raw(T.params_from_jax(params), torch.from_numpy(img), size)
    return ref, got.numpy()


@pytest.mark.parametrize("size,res", [("dryrun", 128), ("t", 128)])
def test_forward_raw_matches_jax(size, res):
    ref, got = _forward_pair(size, res)
    assert got.shape == ref.shape
    # the tolerance of tests/test_torch_parity.py's YOLOv9-t check
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.slow
@pytest.mark.parametrize("size", ["s", "m", "c", "e"])
def test_forward_raw_matches_jax_other_sizes(size):
    ref, got = _forward_pair(size, 64)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("size", ["t", "dryrun"])
def test_detect_matches_jax(size):
    """Whole detect: 216x384 uint8 BGR frames, letterbox to 128 (72x128
    resized by the bilinear branch, padded to 96x128), YOLOv9, DFL, NMS,
    rescale."""
    params = J.init_params(size, seed=0)
    frames = np.random.default_rng(1).integers(0, 256, (2, 216, 384, 3), np.uint8)
    ref = np.asarray(jax.jit(lambda p, f: J.detect(p, f, size=size, res=128))(
        params, jnp.asarray(frames)))
    with torch.inference_mode():
        got = T.detect(T.params_from_jax(params), torch.from_numpy(frames),
                       size=size, res=128).numpy()
    assert got.shape == ref.shape == (2, 252, 6)    # 12x16 + 6x8 + 3x4 anchors
    assert detection_mismatches(ref, got) == []
    assert compared_rows(ref) > 0       # the rule compared something


def test_module_matches_functional_detect():
    frames = np.random.default_rng(4).integers(0, 256, (2, 96, 128, 3), np.uint8)
    model = T.YOLOv9("dryrun", res=64, device="cpu")
    params = model.flat_params()
    assert params.keys() == T.init_params("dryrun").keys() | T.STEM_KEYS.keys()
    ref = T.detect(params, torch.from_numpy(frames), size="dryrun", res=64)
    np.testing.assert_array_equal(model(frames).numpy(), ref.numpy())
    np.testing.assert_array_equal(model(frames[0]).numpy(), ref[0].numpy())
