"""Face pipeline on a torch device: BlazeFace detect -> eye-keypoint
alignment -> AdaFace embed.

Detection (``detect_256``) and embedding (``embed``, ``embed_batch``) run
the port's BlazeFace and AdaFace; the geometric alignment (rotate/scale to
the 112x112 canonical eye positions) is the JAX package's host code
(clearcam_tpu/models/faces.py), a couple of cv2 warps on a small crop.
Behavior mirrors ObjectFinder.img_to_face (reference
models/objects.py:263-354): letterbox to 640, first detection only,
eye-distance/angle canonicalization to TARGET eyes (38,51)/(73,51), minimum
face width 50px.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import adaface, blazeface

TARGET_LEFT_EYE = np.array([38.0, 51.0])
TARGET_RIGHT_EYE = np.array([73.0, 51.0])
MIN_FACE_W = 50
DETECT_RES = 640


def _load(path: Path, convert):
    from ..io import safetensors as st
    return convert(st.load(path))


class FacePipeline:
    def __init__(self, weights_dir: Path | str = "weights",
                 blaze_params=None, ada_params=None, device="cuda"):
        self.device = resolve_device(device)
        weights_dir = Path(weights_dir)
        if blaze_params is None:
            bp = weights_dir / "blazeface.safetensors"
            if not bp.exists():
                # the reference distributes this checkpoint with its code
                from ..tools.parity import resolve_fixture
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

    def extract_face(self, img_rgb: np.ndarray) -> np.ndarray | None:
        """Full alignment pipeline (objects.py:263-354): pad to 640, detect,
        rotate/scale so eyes land on the canonical positions, crop 112x112.
        Returns an RGB face or None."""
        import cv2
        h, w = img_rgb.shape[:2]
        scale = DETECT_RES / max(h, w)
        resized = cv2.resize(img_rgb, (int(w * scale), int(h * scale)))
        dh, dw = DETECT_RES - resized.shape[0], DETECT_RES - resized.shape[1]
        top, left = dh // 2, dw // 2
        padded = cv2.copyMakeBorder(resized, top, dh - top, left, dw - left,
                                    cv2.BORDER_CONSTANT, value=[0, 0, 0])
        det = self.detect_256(padded)
        if det is None:
            return None
        box, le, re = det
        # detections are in padded-640 space: unpad + unscale to source pixels
        y1, x1, y2, x2 = box
        x1, x2 = (x1 - left) / scale, (x2 - left) / scale
        y1, y2 = (y1 - top) / scale, (y2 - top) / scale
        le = (le - [left, top]) / scale
        re = (re - [left, top]) / scale
        if (x2 - x1) < MIN_FACE_W:
            return None

        eye_center = (le + re) / 2
        target_dist = np.linalg.norm(TARGET_RIGHT_EYE - TARGET_LEFT_EYE)
        angle = np.degrees(np.arctan2(re[1] - le[1], re[0] - le[0]))
        crop_size = max(x2 - x1, y2 - y1) * 2.0
        cx1 = max(0, int(eye_center[0] - crop_size / 2))
        cy1 = max(0, int(eye_center[1] - crop_size / 2))
        cx2 = min(w, int(eye_center[0] + crop_size / 2))
        cy2 = min(h, int(eye_center[1] + crop_size / 2))
        if cx2 <= cx1 or cy2 <= cy1:
            return None
        crop = img_rgb[cy1:cy2, cx1:cx2]
        ch, cw = crop.shape[:2]
        if not ch or not cw:
            return None
        le_c = le - [cx1, cy1]
        re_c = re - [cx1, cy1]

        rot = cv2.getRotationMatrix2D((cw / 2, ch / 2), angle, 1.0)
        cos_a, sin_a = abs(rot[0, 0]), abs(rot[0, 1])
        nw2 = int(ch * sin_a + cw * cos_a)
        nh2 = int(ch * cos_a + cw * sin_a)
        rot[0, 2] += nw2 / 2 - cw / 2
        rot[1, 2] += nh2 / 2 - ch / 2
        rotated = cv2.warpAffine(crop, rot, (nw2, nh2))
        le_r = rot[:, :2] @ le_c + rot[:, 2]
        re_r = rot[:, :2] @ re_c + rot[:, 2]
        dist = np.linalg.norm(re_r - le_r)
        if dist < 1e-6:
            return None
        s = target_dist / dist
        tx = TARGET_LEFT_EYE[0] - le_r[0] * s
        ty = TARGET_LEFT_EYE[1] - le_r[1] * s
        m = np.array([[s, 0, tx], [0, s, ty]], np.float32)
        return cv2.warpAffine(rotated, m, (112, 112))

    @torch.inference_mode()
    def embed(self, face_rgb: np.ndarray) -> np.ndarray:
        return self.embed_batch([face_rgb])[0]

    @torch.inference_mode()
    def embed_batch(self, faces_rgb: list[np.ndarray]) -> np.ndarray:
        x = torch.from_numpy(np.stack(faces_rgb)).to(self.device)
        return adaface.embed(self.ada_params, x).cpu().numpy()
