"""The port's YOLOv9 stem (clearcam_tpu_torch.ops.stem) against the JAX
package's: the plain version against the XLA conv pair in float32, the bf16
contract against the Pallas kernel in interpret mode. The CUDA kernel
against the plain version is in test_torch_port_cuda.py."""
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
