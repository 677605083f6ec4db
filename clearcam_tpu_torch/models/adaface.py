"""AdaFace IR-50 face embedder over torch, the counterpart of
``clearcam_tpu.models.adaface``: 112x112 RGB faces -> 512-d unit identity
embeddings. Stem conv64 + bn + prelu, 24 BasicBlockIR units (bn -> conv ->
bn -> prelu -> strided conv -> bn, with a 1x1 stride-s max-pool or conv+bn
shortcut), output bn -> channel-major flatten -> 512 linear -> affine-free
batch norm -> normalize. NHWC activations.

``init_params`` and ``convert_state_dict`` return numpy arrays in the JAX
layout (HWIO), equal to the JAX package's; ``params_from_jax`` turns them
into torch tensors once (OIHW filters, ``channels_last``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..nn import functional as F

# (in, depth, stride) per block
BLOCKS = ([(64, 64, 2)] + [(64, 64, 1)] * 2
          + [(64, 128, 2)] + [(128, 128, 1)] * 3
          + [(128, 256, 2)] + [(256, 256, 1)] * 13
          + [(256, 512, 2)] + [(512, 512, 1)] * 2)

# reduced stack for tests: the four strided transitions only
BLOCKS_MINI = [(64, 64, 2), (64, 128, 2), (128, 256, 2), (256, 512, 2)]


def _block(p, pre, x, cin, depth, stride):
    if depth == cin:
        # max pool with a 1x1 window: a stride-s subsample
        shortcut = F.max_pool2d(x, 1, stride) if stride > 1 else x
    else:
        shortcut = F.conv2d_p(p, pre + ".shortcut_layer0", x, stride=stride)
        shortcut = F.batch_norm_p(p, pre + ".shortcut_layer1", shortcut)
    h = F.batch_norm_p(p, pre + ".res_layer0", x)
    h = F.conv2d_p(p, pre + ".conv_layer0", h, padding=1)
    h = F.batch_norm_p(p, pre + ".res_layer1", h)
    h = F.prelu(h, p[pre + ".prelu_weight"])
    h = F.conv2d_p(p, pre + ".conv_layer1", h, stride=stride, padding=1)
    h = F.batch_norm_p(p, pre + ".res_layer2", h)
    return h + shortcut


def embed(p: dict, faces, blocks=None):
    """uint8/float RGB [B,112,112,3] -> L2-normalized [B,512]; the
    normalization (x/255 - 0.5)/0.5 is fused here. ``blocks`` defaults to
    IR-50 or BLOCKS_MINI by the number of body blocks in ``p``."""
    if blocks is None:
        n = 1 + max(int(k.split(".")[1]) for k in p if k.startswith("body."))
        blocks = BLOCKS if n == len(BLOCKS) else BLOCKS_MINI
    x = faces.float()
    x = (x / 255.0 - 0.5) / 0.5
    x = F.conv2d_p(p, "conv0", x, padding=1)
    x = F.batch_norm_p(p, "bn0", x)
    x = F.prelu(x, p["prelu_weight"])
    for i, (cin, depth, stride) in enumerate(blocks):
        x = _block(p, f"body.{i}", x, cin, depth, stride)
    x = F.batch_norm_p(p, "bn", x)                      # [B,7,7,512]
    # flatten channel-major, as the reference's NCHW view(b, -1)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
    x = F.linear(x, p["linear.weight"], p["linear.bias"])
    # affine-free 1-D batch norm (running statistics only)
    x = (x - p["bn2.running_mean"]) / torch.sqrt(p["bn2.running_var"] + 1e-5)
    return x / torch.sqrt((x ** 2).sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# parameters: numpy in the JAX layout (HWIO), then torch once
# ---------------------------------------------------------------------------

def convert_state_dict(sd: dict[str, np.ndarray], dtype=np.float32) -> dict:
    """Published adaface_ir50_ms1mv2.safetensors (tinygrad names, OIHW)
    -> flat HWIO numpy params, as the JAX package converts it."""
    out = {}
    for k, arr in sd.items():
        k = k.replace(".list.", ".").replace(".list", "")
        arr = np.asarray(arr, np.float32)
        if k.endswith(".weight") and arr.ndim == 4:
            arr = F.oihw_to_hwio(arr)
        out[k] = arr.astype(dtype)
    return out


def init_params(seed: int = 0, dtype=np.float32, blocks=None) -> dict:
    """Random HWIO numpy params, equal to the JAX package's for the same
    seed and blocks."""
    blocks = BLOCKS if blocks is None else blocks
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def conv(pre, cin, cout, k):
        p[pre + ".weight"] = np.asarray(
            rng.normal(0, (2 / (cin * k * k)) ** 0.5, (k, k, cin, cout)), dtype)

    def bn(pre, c):
        p[pre + ".weight"] = np.ones((c,), dtype)
        p[pre + ".bias"] = np.zeros((c,), dtype)
        p[pre + ".running_mean"] = np.zeros((c,), dtype)
        p[pre + ".running_var"] = np.ones((c,), dtype)

    conv("conv0", 3, 64, 3)
    bn("bn0", 64)
    p["prelu_weight"] = np.full((64,), 0.25, dtype)
    for i, (cin, depth, stride) in enumerate(blocks):
        pre = f"body.{i}"
        bn(pre + ".res_layer0", cin)
        conv(pre + ".conv_layer0", cin, depth, 3)
        bn(pre + ".res_layer1", depth)
        p[pre + ".prelu_weight"] = np.full((depth,), 0.25, dtype)
        conv(pre + ".conv_layer1", depth, depth, 3)
        bn(pre + ".res_layer2", depth)
        if depth != cin:
            conv(pre + ".shortcut_layer0", cin, depth, 1)
            bn(pre + ".shortcut_layer1", depth)
    bn("bn", 512)
    p["linear.weight"] = np.asarray(rng.normal(0, 0.01, (512, 512 * 7 * 7)), dtype)
    p["linear.bias"] = np.zeros((512,), dtype)
    p["bn2.running_mean"] = np.zeros((512,), dtype)
    p["bn2.running_var"] = np.ones((512,), dtype)
    return p


def params_from_jax(params: dict, device="cpu", dtype=torch.float32) -> dict:
    """Flat HWIO params (numpy or JAX arrays) -> torch tensors on
    ``device`` in ``dtype`` (filters OIHW, ``channels_last``)."""
    return F.tensors_from_numpy(params, resolve_device(device), dtype)
