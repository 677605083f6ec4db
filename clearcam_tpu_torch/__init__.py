"""clearcam_tpu_torch — the PyTorch/CUDA port of clearcam_tpu.

The JAX package ``clearcam_tpu`` stays the reference; this package runs the
same NVR on an NVIDIA GPU (Hopper, sm_90a). Module names mirror the JAX
package so each counterpart is easy to find:

  nn/functional.py   NHWC conv and pooling, linear, norms, activations,
                     attention over torch
  ops/image.py       letterbox (uint8 frames -> normalized model input)
  ops/boxes.py       box geometry
  ops/nms.py         dense triu-IoU NMS and the YOLO head postprocess
  ops/stem.py        YOLOv9 blocks 0-1 as one hand-written CUDA kernel
                     (csrc/stem.cu)
  ops/vit_attention.py  non-causal ViT attention as one hand-written CUDA
                     kernel (csrc/vit_attention.cu)
  ops/_build.py      builds csrc/*.cu with nvcc and loads them with ctypes
  models/yolov9.py   YOLOv9 t/s/m/c/e forward and detect
  models/yolo_loss.py  the fine-tuning loss (TAL, CIoU, BCE) and step
  models/clip.py     CLIP ViT-L/14 image and text towers
  models/blazeface.py, models/adaface.py   face detect and embed
  models/objects.py  ObjectFinder (CLIP and face search), plugged into the
                     shared NVR and HTTP server
  models/faces.py    FacePipeline (BlazeFace -> alignment -> AdaFace)
  runtime/nvr.py     BatchDetector, plugged into the shared NVR
  __main__.py        `python -m clearcam_tpu_torch`
  tools/             the JAX package's tools (finetune, export, parity,
                     serve_llm, the benchmarks and probes), each with --device
  testing.py         the detect-row comparison rule of the parity checks

Host code that imports no jax (NVR loop, HTTP server, ingest, tracking,
storage, safetensors, the tokenizer, the embedding index and search, the
face alignment) is a copy of ``clearcam_tpu``'s at the same path. This
package never imports jax or ``clearcam_tpu``.
"""

__version__ = "0.1.0"
