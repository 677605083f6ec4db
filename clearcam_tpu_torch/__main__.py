"""NVR server entry point on the GPU:
`python -m clearcam_tpu_torch [--port 8080] [--data DIR] [--device cuda]`.

The same CLI and wiring as ``python -m clearcam_tpu``: persisted settings,
the detector, the object finder (CLIP object search and face search), the
Qwen3-VL alert summaries (``use_qwen`` with a ``key``; the GGUF pair
``Qwen3VL-{2,4,8}B-Instruct-F16.gguf`` and its mmproj in ``--weights``),
the HTTP API + web UI (POST /generate shares the summary engine's slots
when ``CLEARCAM_SUMMARY_SLOTS`` > 0), the storage manager, the daily restart
and the NVR loop. The host code (NVR, server, storage) is the port's copy
of the JAX package's; the models run on ``--device``.

``--device`` defaults to ``cuda`` and fails when no GPU is usable; the CPU
runs only with ``--device cpu``. ``--mesh N`` (or ``CLEARCAM_MESH``) runs N
ranks, one a card over NCCL (gloo with ``--device cpu``): this process is rank 0 and starts the others
(under ``torchrun`` it joins that group). The NVR, ingest and HTTP run on
rank 0; detect batches shard over all N ranks' ``data`` axis
(``BatchDetector(mesh=)``) and the summary engine's language model over
their ``model`` axis (``NVR(llm_mesh=)``), the other ranks following each
step (``parallel.mesh``). ``CLEARCAM_DTYPE=f32|bf16`` picks the
detector's compute dtype (default bf16); the CLIP towers compute in their
weights' dtype (f32 for the published checkpoint and for random init). On
CUDA, turning CLIP on builds the attention kernel library, and a failed
build stops the server.
"""
from __future__ import annotations

import argparse
import os
import socket
import threading
import time
from datetime import datetime
from pathlib import Path


def lan_ip() -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except Exception:
        return "127.0.0.1"
    finally:
        s.close()


def restart_all_cams(nvr) -> None:
    """Re-open every stream so recordings roll into a new day folder."""
    for name in list(nvr.cams):
        cam = nvr.cams[name]
        src = cam.src
        nvr.remove_cam(name)
        try:
            nvr.init_cam(name, src)
        except Exception as e:  # noqa: BLE001
            print(f"daily restart {name}: {e}")


def daily_restart(nvr, at=(0, 0)):
    """Re-open every stream at midnight so recordings roll into a new day
    folder (reference schedule_daily_restart, clearcam.py:1162-1176)."""
    while True:
        now = datetime.now()
        target = now.replace(hour=at[0], minute=at[1], second=0, microsecond=0)
        delta = (target - now).total_seconds()
        if delta <= 0:
            delta += 24 * 3600
        time.sleep(delta)
        restart_all_cams(nvr)


def build_meshes(n: int, device: str = "cuda"):
    """(detect_mesh, llm_mesh) over the process group's n ranks, or (None,
    None) for n <= 1: the same ranks, two layouts. Detection is
    activation-dominated, so its batch data-parallels over all n
    ("data"=n); the Qwen summary model is weight/KV-dominated, so it
    tensor/expert-parallels over all n ("model"=n). Every rank calls it."""
    if n <= 1:
        return None, None
    from .parallel import mesh as pmesh
    return pmesh.make_mesh(n, data=n), pmesh.make_mesh(n, data=1)


def build_detector(settings, weights_dir: Path, device: str, mesh=None):
    """YOLOv9 with published weights when present, random otherwise. Under
    ``mesh`` rank 0 first tells the other ranks to build theirs."""
    import torch

    from .models import yolov9
    from .runtime.nvr import BatchDetector
    if mesh is not None and mesh.is_leader:
        with mesh.channel.lock:
            mesh.channel.send("main", "build_detector", settings, str(weights_dir))
    path = weights_dir / f"yolov9-{settings.model_size}.safetensors"
    params = None
    if path.exists():
        from .io import safetensors as st
        params = yolov9.convert_state_dict(st.load(path))
        print(f"loaded {path}")
    elif mesh is None or mesh.is_leader:
        print(f"weights not found at {path} — using random init (detections "
              "will be meaningless; drop the published safetensors there)")
    dtype = torch.float32 if os.environ.get("CLEARCAM_DTYPE") == "f32" \
        else torch.bfloat16
    det = BatchDetector(settings.model_size, int(settings.model_res),
                        params=params, dtype=dtype, device=device, mesh=mesh)
    if mesh is not None and not mesh.is_leader:
        return det
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


def _qwen(size: str, weights_dir: Path, device: str):
    """Qwen3-VL at the NVR's frame size from the GGUF pair in
    ``weights_dir``; without it, "qwen unavailable" and None."""
    try:
        from .models.qwen3vl import Qwen3VL
        q = Qwen3VL(size=f"{size}B", res=(544, 960), weights_dir=weights_dir,
                    device=device)
        q.prewarm()
        return q
    except Exception as e:  # noqa: BLE001
        print(f"qwen unavailable: {e}", flush=True)
        return None


class _Follower:
    """A follower rank of ``--mesh N`` (registered as "main" and "nvr" on
    the command channel): builds the detector and the summary model when
    rank 0 does, and the tensor-parallel summary engine when rank 0's NVR
    does; ``Channel.follow`` runs their steps."""

    def __init__(self, detect_mesh, llm_mesh, device):
        self.detect_mesh, self.llm_mesh, self.device = detect_mesh, llm_mesh, device
        self.qwen = None

    def build_detector(self, settings, weights_dir):
        build_detector(settings, Path(weights_dir), self.device, mesh=self.detect_mesh)

    def build_qwen(self, size, weights_dir):
        self.qwen = _qwen(size, Path(weights_dir), self.device)

    def summary_engine(self, n_slots):
        import torch
        from .serving.vlm import VLMServingEngine
        VLMServingEngine(self.qwen, n_slots=n_slots, state_dtype=torch.bfloat16,
                         mesh=self.llm_mesh)


def _follow(argv):
    """Ranks 1..N-1 of ``--mesh N``: follow rank 0's detect and summary
    steps until it stops."""
    args = _parser().parse_args(argv)
    detect_mesh, llm_mesh = build_meshes(args.mesh, args.device)
    f = _Follower(detect_mesh, llm_mesh, args.device)
    detect_mesh.channel.register_as("main", f)
    detect_mesh.channel.register_as("nvr", f)
    detect_mesh.follow()


def _parser():
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
    ap.add_argument("--mesh", type=int,
                    default=int(os.environ.get("CLEARCAM_MESH", "0") or 0),
                    help="scale over N ranks, one a card: detect batches "
                         "data-parallel, the Qwen summary engine tensor-parallel "
                         "(0/1 = one device); this process starts ranks 1..N-1 "
                         "itself, or joins torchrun's group")
    return ap


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    detect_mesh = llm_mesh = ranks = None
    if args.mesh > 1:
        import torch
        from .parallel import comm
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if comm.default_backend(args.device) == "nccl" and avail < args.mesh:
            raise SystemExit(f"--mesh {args.mesh}: only {avail} card(s) visible")
        _, _, ranks = comm.start_ranks(args.mesh, _follow, (argv,), args.device)
        detect_mesh, llm_mesh = build_meshes(args.mesh, args.device)
        print(f"mesh: detect {detect_mesh}, summaries {llm_mesh}", flush=True)

    from .models.objects import ObjectFinder
    from .ops.stem import stem
    from .ops.vit_attention import mha_flash
    from .runtime.nvr import NVR
    from .runtime.settings import GlobalSettings
    from .runtime.storage import StorageManager
    from .server.http import AppContext, serve
    from .utils.db import KVStore

    db = KVStore(args.data / "cc_cache.db")
    stored = db.run_get("global_settings", "all")
    settings = stored if isinstance(stored, GlobalSettings) else GlobalSettings()
    if not isinstance(stored, GlobalSettings):
        db.run_put("global_settings", "all", settings)

    detector = None if args.no_detector else build_detector(
        settings, args.weights, args.device, detect_mesh)

    # always constructed (the towers load on init_*), so CLIP or faces can
    # be turned on later through /edit_settings without a restart
    object_finder = ObjectFinder(base_dir=args.data / "cameras",
                                 weights_dir=args.weights, device=args.device)
    apply_finder_settings(object_finder, settings)

    def build_qwen(s):
        """Qwen3-VL at the NVR's frame size from the GGUF pair in
        --weights; without it, "qwen unavailable" and no summaries. Under
        --mesh every rank loads it."""
        if llm_mesh is not None:
            with llm_mesh.channel.lock:
                llm_mesh.channel.send("main", "build_qwen", s.qwen_size, str(args.weights))
        print("loading and prewarming Qwen", flush=True)
        return _qwen(s.qwen_size, args.weights, args.device)

    qwen = build_qwen(settings) if settings.use_qwen and settings.key else None

    nvr = NVR(db, args.data, settings, detector=detector,
              object_finder=object_finder, qwen=qwen, llm_mesh=llm_mesh)
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
        """/edit_settings: CLIP and face toggles, the detector rebuilt on a
        size/res change, and the Qwen summary model on/off or size change."""
        nonlocal detector
        old = nvr.settings
        nvr.settings = new
        apply_finder_settings(object_finder, new)
        if detector is not None and (new.model_size != detector.size
                                     or int(new.model_res) != detector.res):
            detector = build_detector(new, args.weights, args.device, detect_mesh)
            nvr.detector = detector
        want_qwen = new.use_qwen and new.key
        if want_qwen and (nvr.qwen is None or new.qwen_size != old.qwen_size):
            nvr.qwen = build_qwen(new)
        elif not want_qwen:
            nvr.qwen = None

    def make_gen():
        """POST /generate backend: text requests share the Qwen summary
        engine's slots (needs CLEARCAM_SUMMARY_SLOTS>0 and use_qwen)."""
        if nvr.qwen is None or nvr.summary_slots <= 0:
            return None
        from .serving import TextServing
        return TextServing(nvr.summary_engine(), nvr.qwen.tok)

    ctx = AppContext(db, args.data, nvr=nvr, object_finder=object_finder,
                     settings=settings, offload_detect=offload_detect,
                     offload_detect_many=offload_detect_many,
                     on_settings_change=on_settings_change,
                     api_token=args.api_token, gen=make_gen)
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
        if ranks is not None:
            detect_mesh.stop_followers()
            ranks.close()
        print(f"stem.launches={stem.launches}", flush=True)
        print(f"vit_attention.launches={mha_flash.launches}", flush=True)


if __name__ == "__main__":
    main()
