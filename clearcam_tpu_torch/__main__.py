"""NVR server entry point on the GPU:
`python -m clearcam_tpu_torch [--port 8080] [--data DIR] [--device cuda]`.

The same CLI and wiring as ``python -m clearcam_tpu``: persisted settings,
the detector, the object finder (CLIP object search and face search), the
HTTP API + web UI, the storage manager, the daily restart and the NVR loop.
The NVR, server, storage and restart helpers are the JAX package's jax-free
host code, reused unchanged; the detector and the object finder's towers
are the port's. Qwen summaries are not ported yet: settings that enable
them are reported and ignored.

``--device`` defaults to ``cuda`` and fails when no GPU is usable; the CPU
runs only with ``--device cpu``. ``CLEARCAM_DTYPE=f32|bf16`` picks the
detector's compute dtype (default bf16); the CLIP towers compute in their
weights' dtype (f32 for the published checkpoint and for random init). On
CUDA, turning CLIP on builds the attention kernel library, and a failed
build stops the server.
"""
from __future__ import annotations

import argparse
import os
import threading
from pathlib import Path

from clearcam_tpu.__main__ import daily_restart, lan_ip

NOT_PORTED = (("use_qwen", "Qwen summaries"),)


def report_not_ported(settings) -> None:
    for attr, what in NOT_PORTED:
        if getattr(settings, attr, False):
            print(f"{what} is not ported to clearcam_tpu_torch yet: "
                  f"{attr}=True is ignored")


def build_detector(settings, weights_dir: Path, device: str):
    """YOLOv9 with published weights when present, random otherwise."""
    import torch

    from .models import yolov9
    from .runtime.nvr import BatchDetector
    path = weights_dir / f"yolov9-{settings.model_size}.safetensors"
    params = None
    if path.exists():
        from clearcam_tpu.io import safetensors as st
        params = yolov9.convert_state_dict(st.load(path))
        print(f"loaded {path}")
    else:
        print(f"weights not found at {path} — using random init (detections "
              "will be meaningless; drop the published safetensors there)")
    dtype = torch.float32 if os.environ.get("CLEARCAM_DTYPE") == "f32" \
        else torch.bfloat16
    det = BatchDetector(settings.model_size, int(settings.model_res),
                        params=params, dtype=dtype, device=device)
    stem_on = yolov9.uses_stem_kernel(settings.model_size)
    route = f"CUDA, {det.kernel_library}" if det.kernel_library else "plain"
    print(f"detector: YOLOv9-{settings.model_size} res {det.res} {dtype} on "
          f"{det.device}; stem kernel {'on' if stem_on else 'off'} ({route})",
          flush=True)
    return det


def apply_finder_settings(finder, settings) -> None:
    """Load or drop the CLIP and face towers as the settings say; print the
    CLIP line when CLIP comes on."""
    if settings.use_clip and not finder.clip_enabled:
        finder.init_clip()
        route = f"CUDA, {finder.kernel_library}" if finder.kernel_library \
            else "plain"
        print(f"clip: ViT-L/14 {finder.clip_dtype} on {finder.device}; "
              f"attention kernel {route}", flush=True)
    elif not settings.use_clip:
        finder.turn_off_clip()
    (finder.init_face if settings.use_face else finder.turn_off_face)()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m clearcam_tpu_torch")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--data", type=Path, default=Path("data"))
    ap.add_argument("--weights", type=Path, default=Path("weights"))
    ap.add_argument("--cam_name", default="my_camera")
    ap.add_argument("--api-token", default=os.environ.get("CLEARCAM_API_TOKEN"),
                    help="require this token (x-api-token header or ?token=) "
                         "on every HTTP request")
    ap.add_argument("--no-detector", action="store_true",
                    help="run the server without a detector (UI/API only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the detector and the object finder: "
                         "cuda (default, fails without a GPU), cuda:N, or cpu")
    args = ap.parse_args(argv)

    from clearcam_tpu.runtime.nvr import NVR
    from clearcam_tpu.runtime.settings import GlobalSettings
    from clearcam_tpu.runtime.storage import StorageManager
    from clearcam_tpu.server.http import AppContext, serve
    from clearcam_tpu.utils.db import KVStore

    from .models.objects import ObjectFinder
    from .ops.stem import stem
    from .ops.vit_attention import mha_flash

    db = KVStore(args.data / "cc_cache.db")
    stored = db.run_get("global_settings", "all")
    settings = stored if isinstance(stored, GlobalSettings) else GlobalSettings()
    if not isinstance(stored, GlobalSettings):
        db.run_put("global_settings", "all", settings)
    report_not_ported(settings)

    detector = None if args.no_detector else build_detector(
        settings, args.weights, args.device)

    # always constructed (the towers load on init_*), so CLIP or faces can
    # be turned on later through /edit_settings without a restart
    object_finder = ObjectFinder(base_dir=args.data / "cameras",
                                 weights_dir=args.weights, device=args.device)
    apply_finder_settings(object_finder, settings)

    nvr = NVR(db, args.data, settings, detector=detector,
              object_finder=object_finder, qwen=None)
    storage = StorageManager(args.data / "cameras")
    nvr.storage = storage

    def offload_detect(img_rgb):
        """Serve the iOS /yolo + /diff offload protocol with the NVR's model."""
        if detector is None:
            import numpy as np
            return np.zeros((0, 6), np.float32)
        return detector.detect_many([img_rgb[..., ::-1]])[0]  # expects BGR

    def offload_detect_many(imgs_rgb):
        """Batched offload: concurrent edge clients share ONE device call."""
        if detector is None:
            import numpy as np
            return [np.zeros((0, 6), np.float32) for _ in imgs_rgb]
        return detector.detect_many([im[..., ::-1] for im in imgs_rgb])

    def on_settings_change(new):
        """/edit_settings: CLIP and face toggles, and the detector rebuilt on
        a size/res change."""
        nonlocal detector
        nvr.settings = new
        report_not_ported(new)
        apply_finder_settings(object_finder, new)
        if detector is not None and (new.model_size != detector.size
                                     or int(new.model_res) != detector.res):
            detector = build_detector(new, args.weights, args.device)
            nvr.detector = detector

    ctx = AppContext(db, args.data, nvr=nvr, object_finder=object_finder,
                     settings=settings, offload_detect=offload_detect,
                     offload_detect_many=offload_detect_many,
                     on_settings_change=on_settings_change,
                     api_token=args.api_token)
    storage.max_gb = ctx.max_gb
    storage.start()
    server = serve(ctx, port=args.port)
    if server:
        print(f"Serving at http://{lan_ip()}:{args.port}", flush=True)
    threading.Thread(target=daily_restart, args=(nvr,), daemon=True).start()

    import signal

    def _graceful(signum, frame):
        print(f"signal {signum}: shutting down", flush=True)
        nvr.running = False
        # a tick parked in a long device call must not ignore the signal
        t = threading.Timer(20.0, lambda: os._exit(1))
        t.daemon = True
        t.start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    try:
        nvr.run()
    except KeyboardInterrupt:
        pass
    finally:
        nvr.stop()
        storage.stop()
        if server:
            server.shutdown()
        print(f"stem.launches={stem.launches}", flush=True)
        print(f"vit_attention.launches={mha_flash.launches}", flush=True)


if __name__ == "__main__":
    main()
