"""Export/replay the detector program over torch, the counterpart of
``clearcam_tpu.tools.export``.

The reference ships a frozen tinygrad kernel schedule to edge devices (the
iOS app replays `yolov9t`, ios/clearcam/Yolo.m:26-196). The port's
equivalent artifact is a ``torch.export`` program of the whole detect graph
(letterbox, YOLOv9, DFL, NMS, rescale) with the weights inside, replayable
without the model code: ``Replayer`` imports only ``ops.stem``, which
registers the stem kernel's custom op (``torch.ops.clearcam.stem_packed``)
the program calls by name.

Bundle format: a zip with
    program.pt2   torch.export.save of the program (weights as its state)
    meta.json     {version, size, res, input_shape, output, device}

The bundle is not interchangeable with the JAX tool's (StableHLO,
``program.stablehlo`` + ``program.mlir``), and ``native/replayer`` (a PJRT
client) cannot run it. The program is traced on ``--device`` (default
cuda; it raises without a GPU); the replayer moves it to the device it is
asked for.

Usage:
    python -m clearcam_tpu_torch.tools.export detector out.ccprog \\
        --size t --res 640 --height 1080 --width 1920 [--weights weights/] [--device cuda]
    python -m clearcam_tpu_torch.tools.export run out.ccprog [--device cuda]   # replay check
"""
from __future__ import annotations

import argparse
import io
import json
import zipfile
from pathlib import Path

import numpy as np

FORMAT_VERSION = 1


def export_detector(out_path: str | Path, size: str = "t", res: int = 640,
                    frame_hw=(1080, 1920), batch: int = 1,
                    weights_dir: str = "weights", params=None,
                    compute_dtype=None, device="cuda"):
    """Trace ``detect`` for uint8 [batch, *frame_hw, 3] frames with the
    weights of ``params`` (flat HWIO numpy), else ``weights_dir``'s
    yolov9-{size}.safetensors, else the seed-0 random ones; write the
    bundle; -> its meta."""
    import torch
    from ..models import yolov9

    if params is None:
        path = Path(weights_dir) / f"yolov9-{size}.safetensors"
        if path.exists():
            from ..io import safetensors as st
            params = yolov9.convert_state_dict(st.load(path))
        else:
            params = yolov9.init_params(size)
    model = yolov9.YOLOv9(size, res, params, dtype=compute_dtype or torch.float32,
                          device=device)
    dev = next(iter(model.params.values())).device

    class Detect(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, frames):
            return yolov9.detect(self.model.flat_params(), frames, size=size, res=res,
                                 compute_dtype=model.dtype)

    spec = torch.zeros((batch, *frame_hw, 3), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        program = torch.export.export(Detect().eval(), (spec,))
    blob = io.BytesIO()
    torch.export.save(program, blob)
    meta = {"version": FORMAT_VERSION, "size": size, "res": res,
            "input_shape": [batch, *frame_hw, 3],
            "output": "x1,y1,x2,y2,score,class rows", "device": str(dev)}
    with zipfile.ZipFile(out_path, "w") as z:
        z.writestr("program.pt2", blob.getvalue())
        z.writestr("meta.json", json.dumps(meta))
    return meta


class Replayer:
    """Load and run a .ccprog bundle (no model code needed) on ``device``."""

    def __init__(self, path: str | Path, device="cuda"):
        import torch
        from torch.export.passes import move_to_device_pass
        from ..device import resolve_device
        from ..ops import stem  # noqa: F401  (registers clearcam::stem_packed)

        self.device = resolve_device(device)
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read("meta.json"))
            program = torch.export.load(io.BytesIO(z.read("program.pt2")))
        if torch.device(self.meta["device"]) != self.device:
            program = move_to_device_pass(program, self.device)
        self.module = program.module()

    def __call__(self, frames) -> np.ndarray:
        import torch
        with torch.no_grad():
            out = self.module(torch.as_tensor(np.asarray(frames, np.uint8),
                                              device=self.device))
        return out.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("detector")
    e.add_argument("out")
    e.add_argument("--size", default="t")
    e.add_argument("--res", type=int, default=640)
    e.add_argument("--height", type=int, default=1080)
    e.add_argument("--width", type=int, default=1920)
    e.add_argument("--batch", type=int, default=1)
    e.add_argument("--weights", default="weights")
    e.add_argument("--device", default="cuda")
    r = sub.add_parser("run")
    r.add_argument("bundle")
    r.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cmd == "detector":
        meta = export_detector(args.out, args.size, args.res,
                               (args.height, args.width), args.batch,
                               args.weights, device=args.device)
        print(json.dumps(meta))
    else:
        rep = Replayer(args.bundle, args.device)
        shape = rep.meta["input_shape"]
        out = rep(np.zeros(shape, np.uint8))
        print(f"replayed {rep.meta}: output {out.shape}")


if __name__ == "__main__":
    main()
