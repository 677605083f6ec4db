"""The port on an NVIDIA GPU: the CUDA stem kernel against its plain
version, and the model and detector running through it. Every test needs
the card and skips without one. The file imports no jax, so on a GPU
machine without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import yolov9
from clearcam_tpu_torch.ops import stem as tstem
from clearcam_tpu_torch.runtime.nvr import BatchDetector

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # full f32 in the plain versions, so f32 comparisons can be tight
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, np.float32),
            (rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32),
            (rng.standard_normal(16) * 0.1).astype(np.float32),
            (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32),
            (rng.standard_normal(32) * 0.1).astype(np.float32))


# bf16 bound: the two round conv1 at different points (tests/test_stem.py's
# bound); f32 bound: summation order only
@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 64, 64, 3), torch.bfloat16, 0.05), ((1, 384, 640, 3), torch.bfloat16, 0.05),
    ((2, 100, 68, 3), torch.float32, 1e-4), ((1, 17, 23, 3), torch.float32, 1e-4),
    ((3, 1, 2, 3), torch.float32, 1e-4)])
def test_stem_kernel_matches_plain(cuda, shape, dtype, tol):
    args = [torch.from_numpy(a).to(cuda) for a in _inputs(shape, seed=2)]
    args[0], args[1], args[3] = (args[i].to(dtype) for i in (0, 1, 3))
    before = tstem.stem.launches
    got = tstem.stem(*args)
    ref = tstem.stem_reference(*args)
    torch.cuda.synchronize()
    assert tstem.stem.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() < tol


def test_stem_kernel_raises_on_bad_input(cuda):
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to(cuda) for a in _inputs((1, 16, 16, 3)))
    with pytest.raises(TypeError):
        tstem.stem(x.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        tstem.stem(x.transpose(1, 2), w1, b1, w2, b2)
    with pytest.raises(ValueError, match="w2"):
        tstem.stem(x, w1, b1, w2[..., :16], b2)
    with pytest.raises(ValueError, match="on cpu"):
        tstem.stem(x, w1.cpu(), b1, w2, b2)


@pytest.mark.parametrize("size", ["dryrun", "t"])
def test_forward_raw_gpu_matches_cpu(cuda, size):
    """The model through the kernel (GPU) vs through the plain stem (CPU),
    on a rectangular letterbox-shaped input (sides multiples of 32)."""
    params = yolov9.init_params(size, seed=1)
    x = np.random.default_rng(3).uniform(0, 1, (2, 96, 160, 3)).astype(np.float32)
    before = tstem.stem.launches
    with torch.inference_mode():
        got = yolov9.forward_raw(yolov9.params_from_jax(params, cuda),
                                 torch.from_numpy(x).to(cuda), size).cpu().numpy()
        ref = yolov9.forward_raw(yolov9.params_from_jax(params, "cpu"),
                                 torch.from_numpy(x), size).numpy()
    assert tstem.stem.launches == before + 1
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)


def test_batch_detector_bf16_on_gpu(cuda):
    det = BatchDetector("t", res=320, device="cuda")
    assert det.kernel_library and det.params["stem.w1"].dtype == torch.float32
    frames = list(np.random.default_rng(4).integers(0, 256, (3, 360, 640, 3), np.uint8))
    before = tstem.stem.launches
    rows = det.detect_many(frames)
    assert tstem.stem.launches == before + 1          # one bucket of 4
    assert all(r.shape == (300, 6) and np.isfinite(r).all() for r in rows)
