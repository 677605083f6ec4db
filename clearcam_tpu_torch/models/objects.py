"""The port's ObjectFinder: CLIP crop and text embedding and face search on
a torch device, plugged into the shared NVR and HTTP server through the
``NVR(object_finder=)`` and ``AppContext(object_finder=)`` seams.

It subclasses ``clearcam_tpu.models.objects.ObjectFinder``, whose jax
imports sit inside the methods overridden here. The embedding index, the
per-day ``embeddings.pkl`` caches, the searches, the crop ingest, the
description alerts and the host preprocess (cubic resize to 224) are
reused unchanged; only the device calls are the port's.
"""
from __future__ import annotations

import numpy as np
import torch

from clearcam_tpu.models import objects as _objects

from ..device import resolve_device
from ..ops import vit_attention
from . import clip as clip_model

CLIP_WEIGHTS = "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors"


def _bucket(n: int) -> int:
    """Smallest power of two >= n: bounds the set of batch shapes."""
    return 1 << max(0, n - 1).bit_length()


class ObjectFinder(_objects.ObjectFinder):
    """``device``: the torch device of the towers; ``cuda`` (default)
    raises when no GPU is usable, the CPU runs only when asked for.

    On CUDA, ``init_clip`` builds and sets up the attention kernel library
    before it returns (``kernel_library`` is its path), so a failed build
    raises there, not on the first crop."""

    def __init__(self, base_dir="data/cameras", weights_dir="weights", db=None,
                 bpe_path=None, device="cuda"):
        super().__init__(base_dir, weights_dir, db, bpe_path)
        self.device = resolve_device(device)
        self.kernel_library = None

    # -- model lifecycle ---------------------------------------------------

    def init_clip(self, params=None):
        if self.clip_enabled:
            return
        from clearcam_tpu.utils.tokenizer import CLIPTokenizer, find_vocab
        if params is None:
            path = self.weights_dir / CLIP_WEIGHTS
            if path.exists():
                from clearcam_tpu.io import safetensors as st
                params = clip_model.convert_state_dict(st.load(path))
            else:
                print(f"CLIP weights not found at {path} — random init")
                params = clip_model.init_params()
        if self.device.type == "cuda":
            self.kernel_library = vit_attention.prepare(self.device)
        self._clip_params = clip_model.params_from_jax(
            params, self.device, clip_model.weights_dtype(params))
        vocab = find_vocab(self.bpe_path or
                           self.weights_dir / "bpe_simple_vocab_16e6.txt.gz")
        self._tok = CLIPTokenizer(vocab) if vocab else None
        self.clip_enabled = True

    @property
    def clip_dtype(self) -> torch.dtype | None:
        return None if self._clip_params is None \
            else self._clip_params[clip_model.PATCH_KEY].dtype

    def turn_off_clip(self):
        self.clip_enabled = False
        self._clip_params = None

    def init_face(self, blaze_params=None, ada_params=None):
        if self.face_enabled:
            return
        from .faces import FacePipeline
        self._face = FacePipeline(self.weights_dir, blaze_params, ada_params,
                                  device=self.device)
        self.face_enabled = True

    # -- embedding computation ----------------------------------------------

    @torch.inference_mode()
    def embed_images(self, imgs_rgb: list[np.ndarray]) -> np.ndarray:
        """Batch of RGB crops -> [N,768] normalized embeddings. The host
        resizes each crop to 224 (cubic); the batch is zero-padded to a
        power of two, as the JAX package does, so the batch shapes stay
        few; only the real crops cross to the device."""
        n = len(imgs_rgb)
        if n == 0:
            return np.zeros((0, clip_model.EMBED_DIM), np.float32)
        batch = torch.zeros((_bucket(n), 224, 224, 3), dtype=torch.uint8,
                            device=self.device)
        batch[:n].copy_(torch.from_numpy(
            np.stack([self.preprocess(img) for img in imgs_rgb])))
        out = clip_model.encode_image(self._clip_params, batch)
        return out[:n].float().cpu().numpy()

    @torch.inference_mode()
    def embed_texts(self, texts) -> np.ndarray:
        """Batch text-tower embed ([N,768] unit-norm) in one device call;
        the batch pads to a power of two with copies of the first row."""
        if self._tok is None:
            raise RuntimeError("CLIP BPE vocab unavailable — text search disabled")
        n = len(texts)
        rows = [self._tok.encode_padded(t) for t in texts]
        rows += [rows[0]] * (_bucket(n) - n)
        ids = torch.tensor(rows, dtype=torch.int64, device=self.device)
        out = clip_model.encode_text(self._clip_params, ids)
        return out[:n].float().cpu().numpy()
