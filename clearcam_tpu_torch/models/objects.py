"""Object/face embedding index + semantic search on a torch device: CLIP
crop and text embedding and face search.

The host side is the JAX package's (clearcam_tpu/models/objects.py, which
re-implements the reference ObjectFinder, models/objects.py:188-422):
per-day ``embeddings.pkl`` caches of {crop_path: 768-d embedding}, merged
into one stacked [N,768] matrix with parallel metadata arrays, so a search
is one matmul and vectorized masks, deduped to the best hit per track id,
top-k; the crop ingest, the description alerts and the host preprocess
(cubic resize to 224). The device calls are the port's: the CLIP towers
(``models.clip``, attention through the ``vit_attention`` kernel on CUDA)
and the face pipeline (``models.faces``).
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops import vit_attention
from . import clip as clip_model

CLIP_WEIGHTS = "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors"


def _bucket(n: int) -> int:
    """Smallest power of two >= n: bounds the set of batch shapes."""
    return 1 << max(0, n - 1).bit_length()


class EmbeddingIndex:
    """Stacked embedding matrix + path metadata with vectorized search."""

    def __init__(self):
        self.paths: list[str] = []
        self.matrix = np.zeros((0, 0), np.float32)
        self.cams = np.zeros(0, object)
        self.days = np.zeros(0, object)
        self.object_ids = np.zeros(0, np.int64)      # -1 = none

    @staticmethod
    def _meta(path: str):
        parts = Path(path).parts
        cam = day = ""
        try:
            i = parts.index("cameras")
            cam = parts[i + 1]
        except ValueError:
            pass
        if len(parts) >= 2:
            day = parts[-2]
        stem = Path(path).stem
        bits = stem.split("_")
        obj = int(bits[1]) if len(bits) >= 2 and bits[1].lstrip("-").isdigit() else -1
        return cam, day, obj

    def rebuild(self, embeddings: dict[str, np.ndarray]):
        self.paths = list(embeddings.keys())
        if not self.paths:
            self.matrix = np.zeros((0, 0), np.float32)
            self.cams = self.days = np.zeros(0, object)
            self.object_ids = np.zeros(0, np.int64)
            return
        self.matrix = np.stack([np.asarray(embeddings[p], np.float32).reshape(-1)
                                for p in self.paths])
        meta = [self._meta(p) for p in self.paths]
        self.cams = np.array([m[0] for m in meta], object)
        self.days = np.array([m[1] for m in meta], object)
        self.object_ids = np.array([m[2] for m in meta], np.int64)

    def search(self, query: np.ndarray, top_k: int = 10, cam: str | None = None,
               day: str | None = None) -> list[tuple[str, float]]:
        """Cosine scores (embeddings are pre-normalized) with best-per-track
        dedup (objects.py:356-390); `day` also admits the VOD "video" folder."""
        if not self.paths:
            return []
        q = np.asarray(query, np.float32).reshape(-1)
        scores = self.matrix @ q
        mask = np.ones(len(scores), bool)
        if cam:
            mask &= self.cams == cam
        if day:
            mask &= (self.days == day) | (self.days == "video")
        idx = np.where(mask)[0]
        if not len(idx):
            return []
        # dedup: keep the best-scoring crop per object id (id -1 rows all kept)
        sel_scores = scores[idx]
        order = idx[np.argsort(-sel_scores, kind="stable")]
        results, seen = [], set()
        for i in order:
            oid = self.object_ids[i]
            if oid >= 0:
                if oid in seen:
                    continue
                seen.add(oid)
            results.append((self.paths[i], float(scores[i])))
            if len(results) >= top_k:
                break
        return results


def read_day_cache(path: Path) -> dict[str, np.ndarray]:
    """Read one `embeddings.pkl` ({"embeddings": {path: emb}})."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f).get("embeddings", {})
    except Exception:
        return {}


def append_day_cache(path: Path, key: str, emb: np.ndarray):
    data = {"embeddings": read_day_cache(path)} if path.exists() else {"embeddings": {}}
    data["embeddings"][key] = np.asarray(emb)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


class ObjectFinder:
    """CLIP + face search service (reference objects.py:188-422 surface:
    init_clip/init_face, search, _load_all_embeddings, img_to_face —
    renamed to load_all_embeddings / search_text / search_image here).

    ``device``: the torch device of the towers; ``cuda`` (default) raises
    when no GPU is usable, the CPU runs only when asked for. On CUDA,
    ``init_clip`` builds and sets up the attention kernel library before it
    returns (``kernel_library`` is its path), so a failed build raises
    there, not on the first crop."""

    def __init__(self, base_dir: str | Path = "data/cameras",
                 weights_dir: str | Path = "weights", db=None,
                 bpe_path: str | Path | None = None, device="cuda"):
        self.base_dir = Path(base_dir)
        self.weights_dir = Path(weights_dir)
        self.bpe_path = bpe_path
        self.db = db
        self.clip_enabled = False
        self.face_enabled = False
        self.index = EmbeddingIndex()
        self.face_index = EmbeddingIndex()
        self._file_cache: dict[str, tuple] = {}       # pkl path -> (mtime, embs)
        self._face_file_cache: dict[str, tuple] = {}
        self._clip_params = None
        self._tok = None
        self._face = None      # faces.FacePipeline
        self.device = resolve_device(device)
        self.kernel_library = None

    # -- model lifecycle ---------------------------------------------------

    def init_clip(self, params=None):
        if self.clip_enabled:
            return
        from ..utils.tokenizer import CLIPTokenizer, find_vocab
        if params is None:
            path = self.weights_dir / CLIP_WEIGHTS
            if path.exists():
                from ..io import safetensors as st
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

    def turn_off_face(self):
        self.face_enabled = False
        self._face = None

    # -- embedding computation ----------------------------------------------

    @staticmethod
    def preprocess(img_rgb: np.ndarray) -> np.ndarray:
        """Crop -> 224x224 cubic (host); normalization happens on device
        (objects.py:237-242)."""
        import cv2
        return cv2.resize(img_rgb, (224, 224), interpolation=cv2.INTER_CUBIC)

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

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]

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

    # -- index management ------------------------------------------------------

    def load_all_embeddings(self, face: bool = False):
        """Scan data/cameras/*/{objects|faces}/*/embeddings.pkl into the
        stacked index (objects.py:392-422 re-reads every pkl per search; we
        cache per-file contents keyed by mtime and only reload changed days).
        """
        sub = "faces" if face else "objects"
        file_cache = self._face_file_cache if face else self._file_cache
        seen = set()
        changed = False
        if self.base_dir.exists():
            for cam_dir in self.base_dir.iterdir():
                root = cam_dir / sub
                if not root.is_dir():
                    continue
                for day_dir in root.iterdir():
                    cache = day_dir / "embeddings.pkl"
                    if not cache.exists():
                        continue
                    key = str(cache)
                    seen.add(key)
                    mtime = cache.stat().st_mtime_ns
                    entry = file_cache.get(key)
                    if entry is None or entry[0] != mtime:
                        file_cache[key] = (mtime, read_day_cache(cache))
                        changed = True
        for key in list(file_cache):
            if key not in seen:
                del file_cache[key]   # deleted day (storage cleanup)
                changed = True
        merged: dict[str, np.ndarray] = {}
        for _, embs in file_cache.values():
            merged.update(embs)
        if changed or not (self.face_index if face else self.index).paths:
            (self.face_index if face else self.index).rebuild(merged)
        return len(merged)

    # -- searches ---------------------------------------------------------------

    def search_text(self, text: str, top_k: int = 10, cam: str | None = None,
                    day: str | None = None):
        emb = self.embed_text(text)
        return self.index.search(emb, top_k, cam, day)

    def search_image(self, img, top_k: int = 10, cam: str | None = None,
                     day: str | None = None, is_face: bool = False):
        """img: raw bytes (upload) or a site-relative crop path ("similar")."""
        import cv2
        if isinstance(img, (bytes, bytearray)):
            arr = cv2.imdecode(np.frombuffer(img, np.uint8), cv2.IMREAD_COLOR)
        else:
            p = str(img).lstrip("/")
            arr = cv2.imread(str(self.base_dir / p)) if not os.path.isabs(p) else cv2.imread(p)
        if arr is None:
            return []
        rgb = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        if is_face:
            if not self.face_enabled:
                return []
            face = rgb if rgb.shape == (112, 112, 3) else self._face.extract_face(rgb)
            if face is None:
                return []
            emb = self._face.embed(face)
            return self.face_index.search(emb, top_k, cam, day)
        emb = self.embed_images([rgb])[0]
        return self.index.search(emb, top_k, cam, day)

    # -- crop ingestion (NVR object queue) ----------------------------------------

    def ingest_crop(self, path: Path, img_rgb: np.ndarray, nvr=None):
        self.ingest_crops([path], [img_rgb], nvr=nvr)

    def ingest_crops(self, paths: list[Path], imgs_rgb: list[np.ndarray],
                     nvr=None):
        """New saved crops: ONE batched CLIP embed call for the whole set,
        per-day cache appends, description alerts, and face extraction for
        person crops (clearcam.py:1228-1241,1278-1307 embed one at a time)."""
        paths = [Path(p) for p in paths]
        if self.clip_enabled and paths:
            embs = self.embed_images(imgs_rgb)
            for path, emb in zip(paths, embs):
                append_day_cache(path.parent / "embeddings.pkl", str(path), emb)
                if nvr is not None and nvr.settings.userID:
                    self._check_desc_alerts(path, emb, nvr)
        if self.face_enabled:
            # extract faces host-side, then ONE batched embed call
            found: list[tuple[Path, np.ndarray]] = []
            for path, img in zip(paths, imgs_rgb):
                if not path.stem.endswith("_0"):   # person class only
                    continue
                face = self._face.extract_face(img)
                if face is not None:
                    found.append((path, face))
            if not found:
                return
            import cv2
            if hasattr(self._face, "embed_batch") and len(found) > 1:
                embs = self._face.embed_batch([f for _, f in found])
            else:
                embs = [self._face.embed(f) for _, f in found]
            for (path, face), emb in zip(found, embs):
                face_path = Path(str(path).replace(
                    f"{os.sep}objects{os.sep}", f"{os.sep}faces{os.sep}"))
                face_path.parent.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(face_path), face[..., ::-1])
                append_day_cache(face_path.parent / "embeddings.pkl",
                                 str(path), emb)

    def _ingest_face(self, path: Path, img_rgb: np.ndarray):
        face = self._face.extract_face(img_rgb)
        if face is None:
            return
        import cv2
        face_path = Path(str(path).replace(f"{os.sep}objects{os.sep}",
                                           f"{os.sep}faces{os.sep}"))
        face_path.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(face_path), face[..., ::-1])
        emb = self._face.embed(face)
        append_day_cache(face_path.parent / "embeddings.pkl", str(path), emb)

    def _check_desc_alerts(self, path: Path, emb: np.ndarray, nvr):
        """CLIP-description alerts: crop embedding vs alert.desc embedding
        (clearcam.py:1289-1307)."""
        import time
        import threading
        parts = path.parts
        try:
            cam_name = parts[parts.index("cameras") + 1]
        except ValueError:
            return
        alerts = nvr.db.run_get("alerts", cam_name)
        if not isinstance(alerts, dict):
            return
        for aid, alert in alerts.items():
            if alert is None or alert.desc is None:
                continue
            if time.time() - alert.last_det < 60 or not alert.is_active():
                continue
            if getattr(alert, "desc_emb", None) is None:
                alert.desc_emb = self.embed_text(alert.desc)
                nvr.db.run_put("alerts", cam_name, alert, id=aid)
            sim = float(np.dot(np.asarray(alert.desc_emb).reshape(-1), emb))
            if sim > alert.threshold:
                from ..cloud.relay import send_notif, export_and_upload
                send_notif(nvr.settings.userID,
                           f"Event Detected ({cam_name}: {alert.desc})")
                alert.last_det = time.time()
                nvr.db.run_put("alerts", cam_name, alert, id=aid)
                seen = int(float(path.stem.split("_")[0]))
                threading.Thread(target=export_and_upload, kwargs=dict(
                    cam_name=cam_name, thumbnail=path,
                    userID=nvr.settings.userID, key=nvr.settings.key,
                    base_dir=nvr.base_dir, start=seen, length=20, wait=True),
                    daemon=True).start()
                break
