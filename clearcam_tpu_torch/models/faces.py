"""The port's face pipeline: BlazeFace detect and AdaFace embed on a torch
device, with the JAX package's host alignment.

``FacePipeline`` subclasses ``clearcam_tpu.models.faces.FacePipeline``:
the weights, the device call in ``detect_256``, ``embed`` and
``embed_batch`` are the port's; ``extract_face`` (pad to 640, detect, turn
and scale so the eyes land on (38,51)/(73,51), crop 112x112) is reused
unchanged.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from clearcam_tpu.models import faces as _faces

from ..device import resolve_device
from . import adaface, blazeface


def _load(path: Path, convert):
    from clearcam_tpu.io import safetensors as st
    return convert(st.load(path))


class FacePipeline(_faces.FacePipeline):
    def __init__(self, weights_dir: Path | str = "weights",
                 blaze_params=None, ada_params=None, device="cuda"):
        self.device = resolve_device(device)
        weights_dir = Path(weights_dir)
        if blaze_params is None:
            bp = weights_dir / "blazeface.safetensors"
            if not bp.exists():
                # the reference distributes this checkpoint with its code
                from clearcam_tpu.tools.parity import resolve_fixture
                found = resolve_fixture("blazeface.safetensors", weights_dir)
                if found is not None:
                    print(f"blazeface: {bp} absent, using {found}")
                    bp = found
            if bp.exists():
                blaze_params = _load(bp, blazeface.convert_state_dict)
            else:
                print(f"blazeface weights not found at {bp} — random init")
                blaze_params = blazeface.init_params()
        if ada_params is None:
            ap = weights_dir / "adaface_ir50_ms1mv2.safetensors"
            if ap.exists():
                ada_params = _load(ap, adaface.convert_state_dict)
            else:
                print(f"adaface weights not found at {ap} — random init")
                ada_params = adaface.init_params()
        self.blaze_params = blazeface.params_from_jax(blaze_params, self.device)
        self.ada_params = adaface.params_from_jax(ada_params, self.device)

    @torch.inference_mode()
    def detect_256(self, img_rgb: np.ndarray):
        """Resize and letterbox to 256 on the host, detect on the device,
        map the first live detection back to source pixels
        -> ((ymin,xmin,ymax,xmax), left eye xy, right eye xy) or None."""
        import cv2
        h0, w0 = img_rgb.shape[:2]
        scale = min(256 / w0, 256 / h0)
        nw, nh = int(w0 * scale), int(h0 * scale)
        resized = cv2.resize(img_rgb, (nw, nh))
        top = (256 - nh) // 2
        left = (256 - nw) // 2
        canvas = np.zeros((256, 256, 3), np.uint8)
        canvas[top:top + nh, left:left + nw] = resized
        rows = blazeface.detect(self.blaze_params, torch.from_numpy(canvas).to(
            self.device)).cpu().numpy()
        live = rows[rows[:, 16] > 0]
        if not len(live):
            return None
        d = live[0]
        y1, x1, y2, x2 = d[0] - top, d[1] - left, d[2] - top, d[3] - left
        le = np.array([d[4] - left, d[5] - top])
        re = np.array([d[6] - left, d[7] - top])
        return (np.array([y1, x1, y2, x2]) / scale, le / scale, re / scale)

    @torch.inference_mode()
    def embed(self, face_rgb: np.ndarray) -> np.ndarray:
        return self.embed_batch([face_rgb])[0]

    @torch.inference_mode()
    def embed_batch(self, faces_rgb: list[np.ndarray]) -> np.ndarray:
        x = torch.from_numpy(np.stack(faces_rgb)).to(self.device)
        return adaface.embed(self.ada_params, x).cpu().numpy()
