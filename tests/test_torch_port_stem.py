"""The port's YOLOv9 stem (clearcam_tpu_torch.ops.stem) against the JAX
package's: the plain version against the XLA conv pair in float32, the bf16
contract against the Pallas kernel in interpret mode, and the bf16
kernel's GEMM formulation (pack, gemm_reference) against both. The CUDA
kernel against the plain version is in test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.nn import functional as jF
from clearcam_tpu.ops import stem as jstem
from clearcam_tpu_torch.ops import stem as tstem
from clearcam_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, np.float32)
    w1 = (rng.standard_normal((3, 3, 3, 16)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _jax_pair(x, w1, b1, w2, b2):
    """The XLA conv pair the stem replaces, in float32."""
    y = jF.silu(jF.conv2d(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1),
                          stride=2, padding=1))
    return np.asarray(jF.silu(jF.conv2d(y, jnp.asarray(w2), jnp.asarray(b2),
                                        stride=2, padding=1)))


# square, rectangular (1080p letterboxes to 384x640, here scaled down), and
# sides that are not multiples of 4 (odd, from letterbox_plan(auto=True))
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 24, 40, 3),
                                   (1, 30, 22, 3), (1, 17, 23, 3)])
def test_stem_reference_matches_xla_pair_f32(shape):
    args = _inputs(shape)
    got = tstem.stem(*map(torch.from_numpy, args))        # CPU -> reference
    ref = _jax_pair(*args)
    assert tuple(got.shape) == ref.shape == (
        shape[0], *tstem.out_hw(shape[1], shape[2]), 32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("res", [16, 32, 64])
def test_stem_bf16_matches_pallas_kernel(res):
    """bf16 contract: the port's plain version vs the TPU kernel run in
    Pallas interpret mode; both round conv1 to bf16, so they differ by
    bf16 rounding only (the bound of tests/test_stem.py)."""
    x, w1, b1, w2, b2 = _inputs((2, res, res, 3), seed=1)
    ref = np.asarray(jstem.stem(jnp.asarray(x), w1, b1, w2, b2, interpret=True),
                     np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tstem.stem(xt, torch.from_numpy(w1).to(torch.bfloat16),
                     torch.from_numpy(b1), torch.from_numpy(w2).to(torch.bfloat16),
                     torch.from_numpy(b2))
    assert got.dtype == torch.bfloat16
    assert got.shape == ref.shape == (2, res // 4, res // 4, 32)
    assert np.max(np.abs(got.float().numpy() - ref)) < 0.05


def test_stem_cpu_path_never_counts_a_launch():
    before = tstem.stem.launches
    tstem.stem(*map(torch.from_numpy, _inputs((1, 8, 8, 3))))
    assert tstem.stem.launches == before


def test_stem_rejects_other_devices():
    x, w1, b1, w2, b2 = (torch.from_numpy(a).to("meta")
                         for a in _inputs((1, 8, 8, 3)))
    with pytest.raises(ValueError, match="unsupported device"):
        tstem.stem(x, w1, b1, w2, b2)


# --- the bf16 kernel's GEMM formulation (ops.stem.pack, gemm_reference) ---

def _bf16_weights(args):
    """x as float32 and the operands rounded to bf16 values, held as float32:
    pack's bf16 operands are then exact."""
    x, *w = map(torch.from_numpy, args)
    return x, [t.to(torch.bfloat16).float() for t in w]


def test_pack_layout():
    """The f32 HWIO operands as given; K-major rows, conv1's K = 16*dy +
    4*dx + c with zero weights at dx = 3 and c = 3, conv2's K = 16*(3*dy +
    dx) + ci, bf16."""
    _, w = _bf16_weights(_inputs((1, 8, 8, 3)))
    p = tstem.pack(*w)
    assert all(t.is_contiguous() for t in p)
    for got, want in zip(p[:4], w):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert p.w1k.shape == (16, tstem.K1) and p.w2k.shape == (32, tstem.K2)
    assert p.w1k.dtype == p.w2k.dtype == torch.bfloat16
    k1 = p.w1k.float().numpy().reshape(16, 3, 4, 4)            # n, dy, dx, c
    np.testing.assert_array_equal(k1[:, :, :3, :3], w[0].numpy().transpose(3, 0, 1, 2))
    assert not k1[:, :, 3].any() and not k1[..., 3].any()
    np.testing.assert_array_equal(p.w2k.float().numpy().reshape(32, 3, 3, 16),
                                  w[2].numpy().transpose(3, 0, 1, 2))


@pytest.mark.parametrize("shape", [(2, 24, 40, 3), (1, 30, 22, 3), (1, 17, 23, 3),
                                   (3, 1, 2, 3)])
def test_gemm_reference_matches_stem_reference_f32(shape):
    """The patch order, the K padding and conv1's zeroed border, in f32 on
    bf16-representable weights: the GEMM and the conv pair differ by
    summation order only."""
    x, w = _bf16_weights(_inputs(shape, seed=5))
    got = tstem.gemm_reference(x, tstem.pack(*w))
    ref = tstem.stem_reference(x, *w)
    assert got.shape == ref.shape == (shape[0], *tstem.out_hw(*shape[1:3]), 32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("res", [16, 32, 64])
def test_gemm_reference_bf16_matches_pallas_kernel(res):
    """The kernel's bf16 arithmetic against the TPU kernel in Pallas
    interpret mode, within tests/test_stem.py's bf16 bound."""
    args = _inputs((2, res, res, 3), seed=1)
    ref = np.asarray(jstem.stem(jnp.asarray(args[0]), *args[1:], interpret=True),
                     np.float32)
    x = torch.from_numpy(args[0]).to(torch.bfloat16)
    got = tstem.gemm_reference(x, tstem.pack(*map(torch.from_numpy, args[1:])))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert np.max(np.abs(got.float().numpy() - ref)) < 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem_packed_cpu_route_equals_stem(dtype):
    """On the CPU the packed operands go to stem_reference on their f32
    HWIO ones: the same result as the HWIO call, and no launch."""
    x, w = _bf16_weights(_inputs((2, 20, 28, 3), seed=3))
    x = x.to(dtype)
    before = tstem.stem.launches
    got = tstem.stem_packed(x, tstem.pack(*w))
    torch.testing.assert_close(got, tstem.stem(x, *w), rtol=0, atol=0)
    assert tstem.stem.launches == before


def test_stem_packed_rejects_bad_operands():
    _, w1, b1, w2, b2 = map(torch.from_numpy, _inputs((1, 8, 8, 3)))
    x = torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tstem.stem_packed(x, tstem.pack(w1, b1, w2, b2))
    with pytest.raises(ValueError, match="w2"):
        tstem.pack(w1, b1, w2[..., :16], b2)


@pytest.mark.parametrize("size", ["t", "dryrun", "s", "m", "c", "e"])
def test_params_from_jax_packs_the_stem_once(size, monkeypatch):
    """The packed operands are made once, in params_from_jax, for the
    sizes whose stem the kernel runs (t, dryrun) and no other; a bf16
    forward reads them and packs nothing."""
    from clearcam_tpu_torch.models import yolov9 as T
    calls = []
    real = tstem.pack
    monkeypatch.setattr(tstem, "pack", lambda *a, **k: calls.append(1) or real(*a, **k))
    params = T.init_params(size, seed=0)
    if size not in ("t", "dryrun"):     # the stem layers decide; skip the rest
        params = {k: v for k, v in params.items() if k.startswith(("model.0.", "model.1."))}
    tp = T.params_from_jax(params, "cpu", torch.bfloat16)
    kernel = size in ("t", "dryrun")
    assert T.uses_stem_kernel(size) == kernel
    assert len(calls) == int(kernel)
    assert bool(tp.keys() & set(T.STEM_PACKED_KEYS)) == kernel
    if not kernel:
        return
    ref = real(*(torch.from_numpy(params[src]).to(torch.bfloat16).float()
                 for src in T.STEM_KEYS.values()))
    for k, want in zip(T.STEM_PACKED_KEYS, ref):
        torch.testing.assert_close(tp[k], want, rtol=0, atol=0)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 64, 64, 3), np.float32))
    with torch.inference_mode():
        T.forward_raw(tp, x.to(torch.bfloat16), size)
    assert len(calls) == 1
