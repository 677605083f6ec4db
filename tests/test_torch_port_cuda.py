"""The port on an NVIDIA GPU: the CUDA stem and ViT attention kernels
against their plain versions, and the models, the detector and the CLIP
image tower running through them. Every test needs
the card and skips without one. The file imports no jax, so on a GPU
machine without jax it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from clearcam_tpu_torch.models import clip, yolov9
from clearcam_tpu_torch.ops import stem as tstem
from clearcam_tpu_torch.ops import vit_attention as tattn
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


# f32 bound: summation order and exp2 vs exp only (TF32 off); bf16 bound:
# the plain version rounds the probabilities to bf16 before the PV product
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _qkv(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda().to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(16, 16, 257, 64), (1, 16, 257, 64)]
                         + [(2, 16, t, 64) for t in (1, 7, 128, 129, 784, 1600)])
def test_vit_attention_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, seed=shape[2])
    before = tattn.mha_flash.launches
    got = tattn.mha_flash(q, k, v)
    ref = tattn.mha_reference(q, k, v)
    torch.cuda.synchronize()
    assert tattn.mha_flash.launches == before + 1
    assert got.shape == ref.shape and got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() < ATTN_TOL[dtype]


def test_vit_attention_kernel_reads_strided_heads(cuda):
    """The heads of a fused qkv projection, read in place, with a scale."""
    qkv = _qkv((2, 257, 3 * 1024), torch.float32, seed=5)[0]
    q, k, v = (t.view(2, 257, 16, 64).transpose(1, 2) for t in qkv.chunk(3, -1))
    got = tattn.mha_flash(q, k, v, sm_scale=0.1)
    ref = tattn.mha_reference(q, k, v, sm_scale=0.1)
    assert (got - ref).abs().max().item() < ATTN_TOL[torch.float32]


def test_vit_attention_kernel_raises_on_bad_input(cuda):
    q, k, v = _qkv((1, 2, 9, 64), torch.float32, seed=1)
    with pytest.raises(TypeError):
        tattn.mha_flash(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        tattn.mha_flash(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        tattn.mha_flash(*(t[..., :32] for t in (q, k, v)))
    with pytest.raises(ValueError, match="on cpu"):
        tattn.mha_flash(q, k.cpu(), v)
    with pytest.raises(ValueError, match="strides"):
        tattn.mha_flash(q, k.transpose(-1, -2).contiguous().transpose(-1, -2), v)


def test_clip_image_tower_gpu_matches_cpu(cuda):
    """Two full-width blocks: the tower through the kernel (GPU) against the
    plain tower on the CPU."""
    params = clip.init_params(seed=0, img_blocks=2, txt_blocks=1)
    px = np.random.default_rng(6).integers(0, 256, (3, 224, 224, 3), np.uint8)
    before = tattn.mha_flash.launches
    with torch.inference_mode():
        got = clip.encode_image(clip.params_from_jax(params, cuda),
                                torch.from_numpy(px).to(cuda)).cpu().numpy()
        ref = clip.encode_image(clip.params_from_jax(params, "cpu"),
                                torch.from_numpy(px)).numpy()
    assert tattn.mha_flash.launches == before + 2
    cos = (got * ref).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert cos.min() > 1 - 1e-5, cos
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_object_finder_on_gpu(cuda, tmp_path):
    """CLIP on through the port's ObjectFinder: init_clip sets the kernel
    up, a batch of crops goes through it (one launch per block), and the
    embeddings match the CPU finder's."""
    from clearcam_tpu_torch.models.objects import ObjectFinder
    params = clip.init_params(seed=2, img_blocks=1, txt_blocks=1)
    gpu = ObjectFinder(weights_dir=tmp_path, device="cuda")
    gpu.init_clip(params=params)
    assert gpu.kernel_library and gpu.clip_dtype == torch.float32
    cpu = ObjectFinder(weights_dir=tmp_path, device="cpu")
    cpu.init_clip(params=params)
    crops = list(np.random.default_rng(7).integers(0, 256, (3, 150, 100, 3), np.uint8))
    before = tattn.mha_flash.launches
    got = gpu.embed_images(crops)
    assert tattn.mha_flash.launches == before + 1
    np.testing.assert_allclose(got, cpu.embed_images(crops), rtol=0, atol=1e-4)
