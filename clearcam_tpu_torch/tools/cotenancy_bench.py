"""Co-tenancy ladder: the full NVR workload sharing ONE device, the
counterpart of ``clearcam_tpu.tools.cotenancy_bench`` with its flags and
JSON keys.

The reference blocks its detect loop for a whole generation
(clearcam.py:494-496). The NVR interleaves at chunk
granularity instead (runtime/nvr.py: up to 4 serving-engine scheduler steps
per tick, one thread feeding the device). This bench measures that policy
with the real models at the flagship config ("full 16-stream NVR + Qwen3-VL
summaries"):

  detect-only  : batched YOLOv9-t@640 (bf16) on N 1080p streams + host
                 OC-SORT, per-tick latency sampled
  full         : the same tick PLUS, in the NVR tick's order, CLIP crop
                 embeds (ViT-L/14 bf16, every 3rd tick: the object-queue
                 drain), BlazeFace face detect (f32, every 5th tick), and
                 <= --steps-per-tick VLMServingEngine steps a tick with a
                 2B-class Qwen3-VL (random weights; vision prefill +
                 temperature-0.7 decode) kept continuously busy

Reported: the detect tick's p50/p90/p99 and streams@30fps for both, plus
the summary tokens/s achieved WHILE detection holds its rate. Every tick
reads its boxes back to the host (the NVR must, to track), so the
co-tenancy cost is the DELTA between the ladders. A closing ``#`` line gives
the hand-written kernels' launches over both ladders (the stem, ViT
attention, and the quant matmul under ``--quant int8``).

Usage:
    python -m clearcam_tpu_torch.tools.cotenancy_bench --streams 16 \\
        --ticks 80 --quant int8
``--device cpu`` runs on the CPU (small ``--blocks``/``--ctx``; host numbers).
"""
from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from ..device import resolve_device


def synth_tracks(n_cams: int, n_ticks: int, n_obj: int = 8, seed: int = 0):
    """Moving-box detection streams (bouncing, so tracks persist instead of
    degenerating into constant respawn churn), [n_obj, 6] rows per camera
    per tick."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(200, 1500, (n_cams, n_obj, 2))
    vel = rng.normal(0, 5, (n_cams, n_obj, 2))
    wh = rng.uniform(60, 200, (n_cams, n_obj, 2))
    out = []
    for _ in range(n_ticks):
        pos = pos + vel
        for d, lim in ((0, 1920), (1, 1080)):
            hit = (pos[..., d] < 60) | (pos[..., d] > lim - 60)
            vel[..., d][hit] *= -1
            pos[..., d] = np.clip(pos[..., d], 60, lim - 60)
        conf = np.full((n_cams, n_obj, 1), 0.8)
        cls = np.zeros((n_cams, n_obj, 1))          # person
        out.append(np.concatenate([pos - wh / 2, pos + wh / 2, conf, cls], -1))
    return out


def build_vlm(blocks: int, ctx: int, slots: int, res: int,
              quant: str = "none", device="cuda"):
    """2B-class Qwen3-VL with random weights (``llm.qwen3_2b_cfg``'s
    language widths, bf16, drawn on the device; a mid-size vision tower:
    language compute dominates co-tenancy, and CLIP ViT-L in the tick
    supplies the big-ViT load). quant="int8": weight-only int8 serving
    through the quant-matmul kernel (CLEARCAM_LLM_QUANT=int8's production
    config), which halves each engine step's weight bytes, the per-tick
    device cost the detector pays for."""
    from ..models import llm
    from ..models.qwen3vl import Qwen3VL, VisionTower
    from ..serving.vlm import VLMServingEngine
    from ..utils.llm_tokenizer import LLMTokenizer
    from ..utils.tokenizer import byte_encoder

    dev = resolve_device(device)
    cfg = llm.qwen3_2b_cfg(blocks, ctx)
    params = llm.init_params(cfg, dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(0))
    lang = llm.Transformer(params, cfg, seed=0)
    if quant == "int8":
        lang.quantize_int8()
    kv, vp = VisionTower.init_random(n_blocks=8, width=256, heads=4,
                                     merge_dim=1024, lang_dim=cfg.dim,
                                     grid_side=res // 32, deepstack=(2, 5))
    be = byte_encoder()
    normal = {be[b]: b for b in range(256)}
    specials = {"<|im_start|>": 151644, "<|im_end|>": 151645,
                "<|vision_start|>": 151652, "<|vision_end|>": 151653}
    tok = LLMTokenizer(normal, specials, preset="qwen2", bos_id=None,
                       eos_id=151645)
    qwen = Qwen3VL(res=(res, res), lang=lang, tok=tok,
                   vision=VisionTower(kv, vp, device=dev), device=dev)
    return VLMServingEngine(qwen, n_slots=slots, state_dtype=torch.bfloat16)


def tick_loop(det, dparams, x, dets, tracker, n_ticks, *, clip_fn=None,
              clip_x=None, face_fn=None, face_x=None, engine=None,
              frames=None, prompt="Describe the scene.", steps_per_tick=4):
    """One NVR-tick-shaped loop; returns (per-tick seconds, summary tokens,
    summaries completed). The co-tenant work is issued mid-tick where the
    NVR issues it (detect -> host tracking -> object-queue drain -> summary
    engine steps -> boxes read back)."""
    lat = []
    toks = done = 0
    inflight: list = []
    for tick in range(n_ticks):
        t0 = time.perf_counter()
        out = det(dparams, x)                       # queued on the device
        tracker.update_all({c: dets[tick][c] for c in range(x.shape[0])}, 0.3)
        if clip_fn is not None and tick % 3 == 0:
            clip_fn(clip_x)                         # crop embeds (queued)
        if face_fn is not None and tick % 5 == 0:
            face_fn(face_x)                         # face detect (queued)
        if engine is not None:
            while len([r for r in inflight if not r.done]) < engine.engine.n_slots:
                inflight.append(engine.submit(frames, prompt, max_new=48))
            for _ in range(steps_per_tick):
                if not engine.step():
                    break
        out.cpu()                                   # tick sync: boxes -> host
        lat.append(time.perf_counter() - t0)
        for r in [r for r in inflight if r.done]:
            inflight.remove(r)
            toks += len(r.tokens)
            done += 1
    # don't leave half-generated summaries for the next phase
    if engine is not None:
        deadline = time.time() + 120
        while engine.has_work() and time.time() < deadline:
            engine.step()
        for r in inflight:
            if r.done:
                toks += len(r.tokens)
                done += 1
    return lat, toks, done


def pct(xs, q):
    return sorted(xs)[min(len(xs) - 1, int(len(xs) * q))] * 1e3


def _launches() -> dict:
    from ..ops import quant_matmul, stem, vit_attention
    return {"stem": stem.stem.launches,
            "vit_attention": vit_attention.mha_flash.launches,
            "quant_matmul": quant_matmul.quant_linear.launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=28)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--vlm-res", type=int, default=448)
    ap.add_argument("--crops", type=int, default=16,
                    help="CLIP crop batch per object-queue drain")
    ap.add_argument("--quant", default="none", choices=["none", "int8"],
                    help="LLM weight quant for the summary engine")
    ap.add_argument("--steps-per-tick", type=int, default=4,
                    dest="steps_per_tick",
                    help="engine scheduler steps per NVR tick (the NVR's "
                         "_advance_summary_engine default is 4; lower = "
                         "tighter detect ticks, slower summaries)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..models import blazeface, clip, yolov9
    from ..track.multicam import MultiCamOCSort

    rng = np.random.default_rng(0)
    n = args.streams

    # detect: the NVR's graph at batch = streams, bf16
    dparams = yolov9.params_from_jax(yolov9.init_params("t", seed=0), dev,
                                     torch.bfloat16)
    det = torch.inference_mode()(functools.partial(
        yolov9.detect, size="t", res=640, compute_dtype=torch.bfloat16))
    x = torch.from_numpy(rng.integers(0, 255, (n, 1080, 1920, 3), np.uint8)).to(dev)

    # co-tenants
    cparams = clip.params_from_jax(clip.init_params(seed=0), dev, torch.bfloat16)
    clip_x = torch.from_numpy(rng.integers(
        0, 255, (args.crops, clip.IMG_RES, clip.IMG_RES, 3), np.uint8)).to(dev)
    clip_fn = torch.inference_mode()(
        lambda cx: clip.encode_image(cparams, cx, normalize=True))
    fparams = blazeface.params_from_jax(blazeface.init_params(seed=0), dev,
                                        torch.float32)
    face_x = torch.from_numpy(rng.integers(0, 255, (256, 256, 3), np.uint8)).to(
        dev, torch.float32)
    face_fn = torch.inference_mode()(lambda fx: blazeface.detect(fparams, fx))

    engine = build_vlm(args.blocks, args.ctx, args.slots, args.vlm_res,
                       quant=args.quant, device=dev)
    frames = [rng.integers(0, 255, (1080, 1920, 3), np.uint8) for _ in range(2)]

    dets = synth_tracks(n, args.ticks + 8)

    def run(label, **kw):
        tracker = MultiCamOCSort(det_thresh=0.3)
        for w in range(5):
            tracker.update_all({c: dets[w][c] for c in range(n)}, 0.3)
        lat, toks, ndone = tick_loop(det, dparams, x, dets[5:], tracker,
                                     args.ticks, **kw)
        # warmup: drop the first 10 ticks (caches warm, engine fill)
        lat = lat[10:]
        dt = sum(lat)
        res = {"p50_ms": round(pct(lat, 0.50), 2),
               "p90_ms": round(pct(lat, 0.90), 2),
               "p99_ms": round(pct(lat, 0.99), 2),
               "streams_at_30fps": round(n * len(lat) / dt / 30.0, 1)}
        if kw.get("engine") is not None:
            res["summary_tok_s"] = round(toks / dt, 1)
            res["summaries_done"] = ndone
        print(json.dumps({label: res}), flush=True)
        return res

    # build the kernels and warm every stage before timing
    print("# warming up...", flush=True)
    det(dparams, x).cpu()
    clip_fn(clip_x).cpu()
    face_fn(face_x).cpu()
    r0 = engine.submit(frames, "warm", max_new=4)
    while not r0.done:
        engine.step()
    print("# warm", flush=True)

    n0 = _launches()
    a = run("detect_only")
    b = run("full_cotenancy", clip_fn=clip_fn, clip_x=clip_x,
            face_fn=face_fn, face_x=face_x, engine=engine, frames=frames,
            steps_per_tick=args.steps_per_tick)
    launches = {k: v - n0[k] for k, v in _launches().items()}
    final = {
        "metric": "cotenancy_detect_p50_overhead_ms",
        "value": round(b["p50_ms"] - a["p50_ms"], 2),
        "detect_only": a, "full": b,
        "config": {"streams": n, "slots": args.slots,
                   "llm_blocks": args.blocks, "vlm_res": args.vlm_res,
                   "quant": args.quant,
                   "steps_per_tick": args.steps_per_tick}}
    print(json.dumps(final))
    print(f"# launches {json.dumps(launches)}", flush=True)
    engine.close()
    return final, launches


if __name__ == "__main__":
    main()
