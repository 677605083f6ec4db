"""The port's detector for the shared NVR (``clearcam_tpu.runtime.nvr.NVR``).

Only ``BatchDetector`` is ported: the NVR loop, ingest, tracking, alerts and
storage import no jax and are reused unchanged, with this detector plugged
into the ``NVR(detector=...)`` seam.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models import yolov9
from ..ops import stem as stem_ops


class BatchDetector:
    """Shape-bucketed batched detection with the JAX ``BatchDetector``'s
    ``detect_many`` contract: frames of one shape share one device call,
    mixed resolutions are grouped by shape, and batches are padded to powers
    of two. ``size`` and ``res`` are read by the settings hook.

    On a CUDA device with the stem kernel on the model's path, the kernel
    is built and set up here (``kernel_library`` is its path), so a failed
    build stops the detector's construction instead of every detect step."""

    def __init__(self, size: str = "t", res: int = 960, params=None,
                 dtype=torch.bfloat16, device="cuda"):
        self.size, self.res, self.dtype = size, res, dtype
        self.device = resolve_device(device)
        self.kernel_library = None
        if self.device.type == "cuda" and yolov9.uses_stem_kernel(size):
            self.kernel_library = stem_ops.prepare(self.device)
        self.params = yolov9.params_from_jax(
            params if params is not None else yolov9.init_params(size),
            self.device, dtype)

    @staticmethod
    def _bucket(n: int) -> int:
        """Smallest power of two >= n: bounds the set of batch shapes."""
        b = 1
        while b < n:
            b *= 2
        return b

    @torch.inference_mode()
    def detect_many(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """uint8 BGR frames, mixed shapes allowed -> one float32 [300, 6]
        array of rows per frame (x1,y1,x2,y2,score,class; zero rows for
        suppressed slots)."""
        out: list[np.ndarray | None] = [None] * len(frames)
        groups: dict[tuple, list[int]] = {}
        for i, f in enumerate(frames):
            groups.setdefault(f.shape, []).append(i)
        for shape, idxs in groups.items():
            # only the real frames cross to the device; the bucket's padding
            # is zeroed there
            n = len(idxs)
            batch = torch.empty((self._bucket(n), *shape), dtype=torch.uint8,
                                device=self.device)
            batch[:n].copy_(torch.from_numpy(np.stack([frames[i] for i in idxs])))
            batch[n:].zero_()
            preds = yolov9.detect(self.params, batch, size=self.size,
                                  res=self.res, compute_dtype=self.dtype)
            preds = preds.cpu().numpy()
            for j, i in enumerate(idxs):
                out[i] = preds[j]
        return out  # type: ignore[return-value]
