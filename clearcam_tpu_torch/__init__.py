"""clearcam_tpu_torch — the PyTorch/CUDA port of clearcam_tpu.

The JAX package ``clearcam_tpu`` stays the reference; this package runs the
same NVR on an NVIDIA GPU (Hopper, sm_90a). Module names mirror the JAX
package so each counterpart is easy to find:

  nn/functional.py   NHWC/HWIO conv, pooling, upsample, SiLU over torch
  ops/image.py       letterbox (uint8 frames -> normalized model input)
  ops/boxes.py       box geometry
  ops/nms.py         dense triu-IoU NMS and the YOLO head postprocess
  ops/stem.py        YOLOv9 blocks 0-1 as one hand-written CUDA kernel
                     (csrc/stem.cu, built by ops/_build.py)
  models/yolov9.py   YOLOv9 t/s/m/c/e forward and detect
  runtime/nvr.py     BatchDetector, plugged into the shared NVR
  __main__.py        `python -m clearcam_tpu_torch`
  testing.py         the detect-row comparison rule of the parity checks

Host code that imports no jax (NVR loop, HTTP server, ingest, tracking,
storage, safetensors) is shared with ``clearcam_tpu``, not copied. This
package never imports jax.
"""

__version__ = "0.1.0"
