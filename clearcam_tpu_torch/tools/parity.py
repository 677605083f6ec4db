"""Published-weight parity harness over torch, the counterpart of
``clearcam_tpu.tools.parity``.

The reference pins numeric invariants that only real checkpoints can
reproduce; these checks activate once the files they name are present
(nothing here fetches them):

  clip   cos("ferrari f40", f40.jpg) == 0.330654 +- 1e-6
         (the reference's test/test_clip.py:6-12)
  mot    156 unique persons on MOT16-03.mp4, YOLOv9-t @ res 960
         (the reference's test/run_mot.py:24-26)
  mot-rfdetr  157 unique persons, RF-DETR nano (run_mot.py:36-51)
  yolo   detection rows match a recorded golden npz {image, rows, size,
         res} (``record-golden``; a golden from either package's tool
         passes the other's check)

Usage:
    python -m clearcam_tpu_torch.tools.parity [run] [--weights weights/] \\
        [--fixtures fixtures/] [--checks clip mot yolo] [--strict] [--device cuda]
    python -m clearcam_tpu_torch.tools.parity record-golden img.jpg out.npz \\
        [--size t --res 960 --device cuda]

Each check reports the files it lacks as SKIP; --strict turns skips into
failures (CI-with-weights mode). The models run on ``--device`` (default
cuda; it raises without a GPU, ``--device cpu`` runs on the CPU), with
TF32 off while the checks run: a parity check compares full float32.
``resolve_fixture`` also finds the BlazeFace checkpoint for
``models.faces``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from pathlib import Path

import numpy as np

CLIP_SIM_EXPECTED = 0.330654          # test_clip.py:12
MOT_YOLO_EXPECTED = 156               # run_mot.py:24-26
MOT_RFDETR_EXPECTED = 157             # run_mot.py:51
# cos(f40.jpg, micra.jpg) of the reference-PRODUCED ViT-L/14 embeddings
# shipped in test/clip_images/embeddings.pkl (both vectors unit-norm f32).
CLIP_PKL_COS_EXPECTED = 0.5501478314399719


def _snapshot() -> Path | None:
    """The read-only reference snapshot root named by
    ``CLEARCAM_REF_SNAPSHOT`` (public data artifacts live there), or None."""
    root = os.environ.get("CLEARCAM_REF_SNAPSHOT")
    return Path(root) if root else None


def resolve_fixture(name: str, weights: Path | str = "weights",
                    fixtures: Path | str = "fixtures") -> Path | None:
    """Find a public data artifact: local fixtures/ and weights/ first, then
    the reference snapshot's known data locations."""
    cands = [Path(fixtures) / name, Path(weights) / name]
    snap = _snapshot()
    if snap is not None:
        cands += [snap / "test" / "clip_images" / name, snap / "utils" / name,
                  snap / "test" / name, snap / "test" / "videos" / name,
                  snap / "models" / name]
    for cand in cands:
        if cand.exists():
            return cand
    return None


def _missing(paths) -> list[str]:
    return [str(p) for p in paths if not Path(p).exists()]


def check_clip(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """cos(f40.jpg, "ferrari f40") against the pinned scalar."""
    vocab = resolve_fixture("bpe_simple_vocab_16e6.txt.gz", weights, fixtures)
    f40 = resolve_fixture("f40.jpg", weights, fixtures)
    need = [weights / "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors",
            vocab or weights / "bpe_simple_vocab_16e6.txt.gz",
            f40 or fixtures / "f40.jpg"]
    if m := _missing(need):
        return None, f"missing: {', '.join(m)}"
    import cv2
    from ..models.objects import ObjectFinder

    finder = ObjectFinder(weights_dir=str(weights), bpe_path=str(vocab), device=device)
    finder.init_clip()
    img = cv2.imread(str(f40))[:, :, ::-1]  # BGR->RGB
    img_emb = finder.embed_images([img])[0]
    txt_emb = finder.embed_text("ferrari f40")
    sim = float(img_emb @ txt_emb)
    ok = abs(sim - CLIP_SIM_EXPECTED) < 1e-6
    return ok, f"cos = {sim:.6f} (expect {CLIP_SIM_EXPECTED:.6f})"


def check_clip_pkl(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """Read the REAL reference-produced embeddings.pkl through our store
    read path and verify (a) both vectors are unit-norm 768-d, (b) their
    cosine equals the recorded golden, (c) the search index ranks each
    image's own vector first at score ~1. With image-tower weights present,
    additionally require tower(f40/micra) to match the stored vectors
    (cos > 0.999 each) — a two-vector golden stronger than the one scalar.

    The pkl is the reference's test/clip_images/embeddings.pkl (produced
    by its OpenCLIP ViT-L/14 image tower, objects.py:94-133)."""
    pkl = resolve_fixture("embeddings.pkl", weights, fixtures)
    if pkl is None:
        return None, "missing: embeddings.pkl (fixtures/ or snapshot)"
    from ..models.objects import EmbeddingIndex, read_day_cache

    embs = read_day_cache(pkl)
    keys = {Path(k).name: k for k in embs}
    if not {"f40.jpg", "micra.jpg"} <= set(keys):
        return False, f"pkl lacks f40/micra entries: {list(keys)}"
    f40 = np.asarray(embs[keys["f40.jpg"]], np.float32).reshape(-1)
    micra = np.asarray(embs[keys["micra.jpg"]], np.float32).reshape(-1)
    if f40.shape != (768,) or micra.shape != (768,):
        return False, f"bad shapes {f40.shape} {micra.shape}"
    norms_ok = (abs(np.linalg.norm(f40) - 1) < 1e-3
                and abs(np.linalg.norm(micra) - 1) < 1e-3)
    cos = float(f40 @ micra)
    cos_ok = abs(cos - CLIP_PKL_COS_EXPECTED) < 1e-6
    index = EmbeddingIndex()
    index.rebuild(embs)
    top = index.search(f40, top_k=2)
    rank_ok = (len(top) == 2 and Path(top[0][0]).name == "f40.jpg"
               and abs(top[0][1] - 1.0) < 1e-5 and abs(top[1][1] - cos) < 1e-6)
    ok = bool(norms_ok and cos_ok and rank_ok)
    msg = (f"cos(f40,micra) = {cos:.7f} (expect {CLIP_PKL_COS_EXPECTED:.7f}), "
           f"norms {'ok' if norms_ok else 'BAD'}, ranking {'ok' if rank_ok else 'BAD'}")
    ckpt = weights / "CLIP-ViT-L-14-laion2B-s32B-b82K.safetensors"
    if ok and ckpt.exists():
        import cv2
        from ..models.objects import ObjectFinder
        finder = ObjectFinder(weights_dir=str(weights), device=device)
        finder.init_clip()
        for name in ("f40.jpg", "micra.jpg"):
            img_path = resolve_fixture(name, weights, fixtures)
            if img_path is None:
                return None, f"missing image {name} for tower check"
            img = cv2.imread(str(img_path))[:, :, ::-1]
            ours = finder.embed_images([img])[0]
            ref = f40 if name == "f40.jpg" else micra
            c = float(np.asarray(ours, np.float32).reshape(-1) @ ref)
            if c <= 0.999:
                return False, msg + f"; tower({name}) cos vs stored = {c:.4f} <= 0.999"
        msg += "; tower embeddings match stored vectors (cos > 0.999)"
    elif ok:
        msg += "; tower check pending weights"
    return ok, msg


def check_tokenizer(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """Clean-room BPE vs reference-recorded token ids under the REAL vocab
    (tests/make_tokenizer_fixture.py replays utils/clip_tokenizer.py once)."""
    import json
    vocab = resolve_fixture("bpe_simple_vocab_16e6.txt.gz", weights, fixtures)
    golden_path = Path(__file__).parents[2] / "tests" / "fixtures" / "clip_tokens_golden.json"
    if vocab is None or not golden_path.exists():
        return None, "missing: bpe vocab gz and/or clip_tokens_golden.json"
    from ..utils.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer(vocab_path=vocab)
    golden = json.loads(golden_path.read_text())
    bad = sum(tok.encode(c["text"]) != c["ids"] for c in golden["cases"])
    ok = bad == 0 and len(tok.encoder) == golden["vocab_size"]
    return ok, f"{len(golden['cases'])} cases, {bad} mismatches, vocab {len(tok.encoder)}"


def synthetic_face() -> np.ndarray:
    """Deterministic rendered face for real-weight behavioral checks. The
    published BlazeFace scores it 0.90 on CPU / ~0.84 on the v5e (bf16 conv
    deltas) vs ~0.01 on a blank frame — above the reference's 0.85 save
    threshold on CPU, so the full detect->align pipeline runs on it in the
    (CPU-forced) test suite."""
    import cv2
    img = np.full((300, 300, 3), 120, np.uint8)
    C = 150
    cv2.ellipse(img, (C, C - 52), (58, 40), 0, 0, 360, (70, 50, 40), -1)
    cv2.ellipse(img, (C, C - 5), (55, 70), 0, 0, 360, (225, 190, 160), -1)
    cv2.ellipse(img, (C, C - 62), (56, 28), 0, 180, 360, (70, 50, 40), -1)
    for ex, ey in ((C - 24, C - 18), (C + 24, C - 18)):
        cv2.ellipse(img, (ex, ey), (12, 6), 0, 0, 360, (250, 250, 250), -1)
        cv2.circle(img, (ex, ey), 5, (90, 60, 40), -1)
        cv2.circle(img, (ex, ey), 2, (20, 20, 20), -1)
        cv2.ellipse(img, (ex, ey - 12), (14, 4), 0, 180, 360, (70, 50, 40), 3)
    cv2.line(img, (C, C - 10), (C - 4, C + 18), (190, 150, 120), 3)
    cv2.ellipse(img, (C - 2, C + 20), (8, 4), 0, 0, 180, (170, 120, 100), 2)
    cv2.ellipse(img, (C, C + 42), (20, 8), 0, 0, 180, (160, 80, 80), -1)
    cv2.line(img, (C - 20, C + 42), (C + 20, C + 42), (120, 50, 50), 2)
    img = cv2.GaussianBlur(img, (5, 5), 1.5)
    r = cv2.resize(img, None, fx=0.85, fy=0.85)
    canvas = np.full((256, 256, 3), 120, np.uint8)
    h, w = r.shape[:2]
    t, l = (256 - h) // 2, (256 - w) // 2
    canvas[t:t + h, l:l + w] = r
    return canvas


def check_blazeface(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """Real-weight BlazeFace checks against the PUBLISHED checkpoint the
    reference distributes with its code (models/blazeface.safetensors,
    loaded at the reference's models/blazeface.py:137):

      1. loader exactness: converted key set + shapes == our param structure
         (139 tensors; `.list.` stripping + OIHW->HWIO);
      2. anchor parity: the checkpoint's `anchors` tensor must equal our
         derived 16x16x2 + 8x8x6 grid EXACTLY (blazeface.default_anchors);
      3. behavior: the real weights are face-selective through our forward
         (synthetic face prob > 0.3, blank frame < 0.05)."""
    ckpt = resolve_fixture("blazeface.safetensors", weights, fixtures)
    if ckpt is None:
        return None, "missing: blazeface.safetensors (weights/ or snapshot models/)"
    import torch
    from ..device import resolve_device
    from ..io import safetensors as st
    from ..models import blazeface

    p = blazeface.convert_state_dict(st.load(ckpt))
    ref = blazeface.init_params(seed=0)
    if set(p) != set(ref):
        extra, miss = set(p) - set(ref), set(ref) - set(p)
        return False, f"key mismatch: +{sorted(extra)[:3]} -{sorted(miss)[:3]}"
    bad = [k for k in p if np.asarray(p[k]).shape != np.asarray(ref[k]).shape]
    if bad:
        return False, f"shape mismatch: {bad[:5]}"
    if not np.array_equal(np.asarray(p["anchors"]), blazeface.default_anchors()):
        return False, "published anchors != derived grid"
    dev = resolve_device(device)
    tp = blazeface.params_from_jax(p, dev)

    def max_prob(img):
        x = torch.as_tensor(img, dtype=torch.float32, device=dev) / 127.5 - 1.0
        with torch.no_grad():
            _, sc = blazeface.forward(tp, x[None])
        logits = np.clip(sc.cpu().numpy()[0, :, 0], -50, 50)
        return float((1.0 / (1.0 + np.exp(-logits))).max())

    face_p = max_prob(synthetic_face())
    blank_p = max_prob(np.zeros((256, 256, 3), np.uint8))
    ok = face_p > 0.3 and blank_p < 0.05
    return ok, (f"139 keys+shapes ok, anchors exact; face prob {face_p:.3f} "
                f"(>0.3), blank {blank_p:.3f} (<0.05)")


def check_adaface_arch(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """Architecture-level checks against the PUBLISHED AdaFace checkpoint
    (the reference's models/adaface.py:79: adaface_ir50_ms1mv2.safetensors;
    active once that file is present):

      1. loader exactness: converted key set + shapes == our full IR-50
         param structure (24 BasicBlockIR units, `.list.` stripping,
         OIHW->HWIO);
      2. cross-implementation numerics: an independent NCHW IR-50 forward
         (torch.nn.functional on the CPU) on the REAL weights must match
         our embedding to 1e-4;
      3. behavior: unit-norm embeddings that separate a face from a blank
         frame (cos < 0.99)."""
    ckpt = resolve_fixture("adaface_ir50_ms1mv2.safetensors", weights, fixtures)
    if ckpt is None:
        return None, "missing: adaface_ir50_ms1mv2.safetensors (weights/)"
    import cv2
    import torch
    import torch.nn.functional as tF
    from ..device import resolve_device
    from ..io import safetensors as st
    from ..models import adaface

    p = adaface.convert_state_dict(st.load(ckpt))
    ref = adaface.init_params(seed=0)
    if set(p) != set(ref):
        extra, miss = set(p) - set(ref), set(ref) - set(p)
        return False, f"key mismatch: +{sorted(extra)[:3]} -{sorted(miss)[:3]}"
    bad = [k for k in p if np.asarray(p[k]).shape != np.asarray(ref[k]).shape]
    if bad:
        return False, f"shape mismatch: {bad[:5]}"

    face = cv2.resize(synthetic_face(), (112, 112))[..., ::-1]  # RGB
    blank = np.zeros((112, 112, 3), np.uint8)
    dev = resolve_device(device)
    with torch.no_grad():
        emb = adaface.embed(adaface.params_from_jax(p, dev), torch.as_tensor(
            np.stack([face, blank]), device=dev)).cpu().numpy()
    norms = np.linalg.norm(emb, axis=-1)
    if not np.allclose(norms, 1.0, rtol=1e-4):
        return False, f"embeddings not unit-norm: {norms}"
    cos = float(emb[0] @ emb[1])
    if cos > 0.99:
        return False, f"face/blank embeddings indistinct (cos {cos:.4f})"

    # independent NCHW forward on the real weights
    pn = {k: np.asarray(v) for k, v in p.items()}
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731

    def bn(pre, x):
        return tF.batch_norm(x, tt(pn[pre + ".running_mean"]),
                             tt(pn[pre + ".running_var"]),
                             tt(pn[pre + ".weight"]), tt(pn[pre + ".bias"]),
                             False, 0.0, 1e-5)

    def cv(pre, x, stride=1, padding=0):
        w = tt(np.transpose(pn[pre + ".weight"], (3, 2, 0, 1)))
        return tF.conv2d(x, w, stride=stride, padding=padding)

    with torch.no_grad():
        x = (tt(np.stack([face, blank]).astype(np.float32)
                ).permute(0, 3, 1, 2) / 255 - 0.5) / 0.5
        x = tF.prelu(bn("bn0", cv("conv0", x, padding=1)),
                     tt(pn["prelu_weight"]))
        for i, (cin, depth, stride) in enumerate(adaface.BLOCKS):
            pre = f"body.{i}"
            if depth == cin:
                sc = tF.max_pool2d(x, 1, stride) if stride > 1 else x
            else:
                sc = bn(pre + ".shortcut_layer1",
                        cv(pre + ".shortcut_layer0", x, stride=stride))
            h = cv(pre + ".conv_layer0", bn(pre + ".res_layer0", x), padding=1)
            h = tF.prelu(bn(pre + ".res_layer1", h), tt(pn[pre + ".prelu_weight"]))
            x = bn(pre + ".res_layer2",
                   cv(pre + ".conv_layer1", h, stride=stride, padding=1)) + sc
        x = bn("bn", x).flatten(1)
        x = tF.linear(x, tt(pn["linear.weight"]), tt(pn["linear.bias"]))
        x = (x - tt(pn["bn2.running_mean"])) / torch.sqrt(
            tt(pn["bn2.running_var"]) + 1e-5)
        ref_emb = (x / x.norm(dim=-1, keepdim=True)).numpy()
    err = float(np.abs(emb - ref_emb).max())
    ok = err < 1e-4
    return ok, (f"keys+shapes ok, unit-norm, cos(face,blank) {cos:.3f}, "
                f"NCHW cross-implementation max err {err:.2e} (<1e-4)")


def check_mot(weights: Path, fixtures: Path, detector_kind: str = "yolo",
              device="cuda") -> tuple[bool | None, str]:
    """Unique-person count on MOT16-03 (the reference regression invariant)."""
    video = fixtures / "MOT16-03.mp4"
    need = [video]
    if detector_kind == "yolo":
        need.append(weights / "yolov9-t.safetensors")
        expected = MOT_YOLO_EXPECTED
    else:
        need.append(weights / "rf-detr-nano.pth")
        expected = MOT_RFDETR_EXPECTED
    if m := _missing(need):
        return None, f"missing: {', '.join(m)}"
    from .mot import run_mot

    count, _ = run_mot(str(video), size="t", res=960, weights_dir=str(weights),
                       detector_kind=detector_kind, device=device)
    return count == expected, f"unique persons = {count} (expect {expected})"


def check_yolo_golden(weights: Path, fixtures: Path, device="cuda") -> tuple[bool | None, str]:
    """Detection rows vs a recorded golden npz {image, rows, size, res}."""
    golden = fixtures / "yolo_golden.npz"
    need = [golden, weights / "yolov9-t.safetensors"]
    if m := _missing(need):
        return None, f"missing: {', '.join(m)}"
    from ..models.yolov9 import YOLOv9

    with np.load(golden) as z:
        img, rows = z["image"], z["rows"]
        size = str(z["size"]) if "size" in z else "t"
        res = int(z["res"]) if "res" in z else 960
    model = YOLOv9.from_safetensors(
        weights / f"yolov9-{size}.safetensors", size=size, res=res, device=device)
    got = model(img).cpu().numpy()
    got = got[got[:, 4] > 0]
    rows = rows[rows[:, 4] > 0]
    if len(got) != len(rows):
        return False, f"{len(got)} rows vs golden {len(rows)}"
    # order by score desc on both sides before comparing
    got = got[np.argsort(-got[:, 4])]
    rows = rows[np.argsort(-rows[:, 4])]
    box_err = np.abs(got[:, :4] - rows[:, :4]).max() if len(rows) else 0.0
    cls_ok = (got[:, 5] == rows[:, 5]).all() if len(rows) else True
    ok = bool(box_err < 1.0 and cls_ok)
    return ok, f"{len(rows)} rows, max box err {box_err:.3f}px, classes {'ok' if cls_ok else 'MISMATCH'}"


CHECKS = {
    "clip": check_clip,
    "clip-pkl": check_clip_pkl,
    "tokenizer": check_tokenizer,
    "blazeface": check_blazeface,
    "adaface-arch": check_adaface_arch,
    "mot": lambda w, f, d: check_mot(w, f, "yolo", d),
    "mot-rfdetr": lambda w, f, d: check_mot(w, f, "rfdetr", d),
    "yolo": check_yolo_golden,
}


def record_golden(image_path: str, out_path: str, size: str = "t",
                  res: int = 960, weights_dir: str = "weights", device="cuda"):
    """Record a golden npz from the current implementation + real weights
    (run once on a machine where outputs are verified against the reference)."""
    import cv2
    from ..models.yolov9 import YOLOv9
    img = cv2.imread(image_path)
    model = YOLOv9.from_safetensors(
        Path(weights_dir) / f"yolov9-{size}.safetensors", size=size, res=res,
        device=device)
    rows = model(img).cpu().numpy()
    np.savez(out_path, image=img, rows=rows, size=size, res=res)
    print(f"recorded {int((rows[:, 4] > 0).sum())} rows -> {out_path}")


@contextlib.contextmanager
def _full_f32():
    """TF32 off for cuDNN and matmul while the checks run, then restored."""
    import torch
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def run(weights="weights", fixtures="fixtures", checks=None,
        strict=False, device="cuda") -> int:
    weights, fixtures = Path(weights), Path(fixtures)
    failures = skips = 0
    with _full_f32():
        for name in (checks or list(CHECKS)):
            ok, msg = CHECKS[name](weights, fixtures, device)
            status = "SKIP" if ok is None else ("PASS" if ok else "FAIL")
            print(f"{name:12s} {status}  {msg}")
            failures += status == "FAIL"
            skips += status == "SKIP"
    if strict and skips:
        print(f"--strict: {skips} skipped check(s) count as failures")
        failures += skips
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd")
    runp = sub.add_parser("run")
    for p in (ap, runp):
        p.add_argument("--weights", default="weights")
        p.add_argument("--fixtures", default="fixtures")
        p.add_argument("--checks", nargs="*", choices=list(CHECKS))
        p.add_argument("--strict", action="store_true")
        p.add_argument("--device", default="cuda")
    rec = sub.add_parser("record-golden")
    rec.add_argument("image")
    rec.add_argument("out")
    rec.add_argument("--size", default="t")
    rec.add_argument("--res", type=int, default=960)
    rec.add_argument("--weights", default="weights")
    rec.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "record-golden":
        record_golden(args.image, args.out, args.size, args.res, args.weights,
                      args.device)
        return 0
    return run(args.weights, args.fixtures, args.checks, args.strict, args.device)


if __name__ == "__main__":
    sys.exit(main())
