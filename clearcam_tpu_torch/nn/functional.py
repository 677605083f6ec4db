"""Functional NHWC primitives over torch, the counterpart of
``clearcam_tpu.nn.functional`` for what YOLOv9 detect uses.

Public functions keep the JAX package's layout: NHWC activations and HWIO
filters, so tests compare like with like. Internally ``x.permute(0, 3, 1, 2)``
of a contiguous NHWC tensor is already a ``channels_last`` NCHW view, so
cuDNN receives it without a copy and returns ``channels_last`` output, which
permutes back to contiguous NHWC for free. The model converts its filters
to OIHW once, stored ``channels_last`` (``models.yolov9.params_from_jax``),
and calls ``conv2d_oihw``.

These convolutions ran in XLA outside any Pallas kernel in the JAX package,
so torch's own convolution (cuDNN on the GPU) serves them.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_oihw(x, w, b=None, *, stride=1, padding=0, groups=1):
    """NHWC conv with an OIHW (torch layout) filter; symmetric padding."""
    return _nhwc(tF.conv2d(_nchw(x), w, b, stride=stride, padding=padding,
                           groups=groups))


def conv2d(x, w, b=None, *, stride=1, padding=0, groups=1):
    """NHWC conv with an HWIO filter (the JAX package's signature)."""
    return conv2d_oihw(x, hwio_to_oihw(w), b, stride=stride, padding=padding,
                       groups=groups)


def max_pool2d(x, window, stride=None, padding=0):
    """Max pool; the implicit padding is -inf, as in the JAX package."""
    stride = window if stride is None else stride
    return _nhwc(tF.max_pool2d(_nchw(x), window, stride, padding))


def avg_pool2d(x, window, stride=None, padding=0, count_include_pad=True):
    """Average pool with the reference's count_include_pad semantics
    (ADown, clearcam_tpu/nn/functional.py:84-97)."""
    stride = window if stride is None else stride
    return _nhwc(tF.avg_pool2d(_nchw(x), window, stride, padding,
                               count_include_pad=count_include_pad))


def upsample_nearest(x, scale=2):
    """Nearest-neighbour integer upsample."""
    return _nhwc(tF.interpolate(_nchw(x), scale_factor=scale, mode="nearest"))


silu = tF.silu


def oihw_to_hwio(w):
    """(O,I,H,W) -> (H,W,I,O), for numpy arrays or torch tensors."""
    if isinstance(w, torch.Tensor):
        return w.permute(2, 3, 1, 0).contiguous()
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def hwio_to_oihw(w):
    """(H,W,I,O) -> (O,I,H,W), for numpy arrays or torch tensors."""
    if isinstance(w, torch.Tensor):
        return w.permute(3, 2, 0, 1).contiguous()
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))
