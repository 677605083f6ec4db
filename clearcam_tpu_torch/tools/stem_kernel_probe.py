"""The hand-written stem kernel (csrc/stem.cu) against the plain cuDNN
pair on the card: the counterpart of ``clearcam_tpu.tools.stem_kernel_probe``,
with its flags, for the card.

The kernel is called as detect calls it: ``ops.stem.stem_packed`` on
operands that ``ops.stem.pack`` made once, reading the letterboxed NHWC
bf16 tensor itself. The plain pair is ``tools.stem_probe``'s (cuDNN,
bf16, channels-last). The inputs and seed-0 weights are the JAX tool's
draws; the weights are rounded to bf16 once, so both sides read the same
values. Keys, with the JAX tool's names they replace:

  cudnn_stem_ms           (xla_stem_ms) the plain pair, ms a call
  kernel_stem_ms          (pallas_stem_ms) the kernel, ms a call
  s2d_layout_ms_unfused   null: the JAX kernel reads 4x4 space-to-depth
                          planes that a separate pass builds, and that pass
                          was timed here; this kernel reads the NHWC tensor
                          itself, so there is no such pass to time
  speedup_vs_cudnn        (speedup_vs_xla) cudnn_stem_ms / kernel_stem_ms
  max_abs_diff            max |kernel - plain pair| over the whole output
                          (the stem's bf16 bound is 0.05)

Timing is ``tools.stem_probe``'s: CUDA events around ``--steps`` calls on
a resident input after a warm-up. ``#`` lines give the card's name and
power limit and the kernel's launches in this process
(``ops.stem.stem.launches``). ``--device cpu`` runs the wrapper's plain
route on the CPU (no kernel, no launch), timed on the host clock.

    python -m clearcam_tpu_torch.tools.stem_kernel_probe [--batch 128]
        [--res 640] [--steps 30] [--device cuda]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import card_line, resolve_device
from ..ops import stem as S
from .stem_probe import device_ms, normal, plain_convs, weights


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--res", type=int, default=640)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (host numbers)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    b, r = args.batch, args.res

    rng = np.random.default_rng(0)
    # the values both sides read: bf16-representable
    w = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
         for k, v in weights(rng).items()}
    x = normal(rng, (b, r, r, 3), dev)
    conv1, conv2 = plain_convs(w, dev)
    ops = S.pack(*(torch.from_numpy(w[k]).to(dev) for k in ("w0", "b0", "w1", "b1")))

    def cudnn():
        return conv2(conv1(x))

    def kernel():
        return S.stem_packed(x, ops)

    diff = (kernel().float() - cudnn().float()).abs().max().item()
    cudnn_ms = device_ms(cudnn, args.steps, dev)
    kernel_ms = device_ms(kernel, args.steps, dev)
    res = {"batch": b, "cudnn_stem_ms": cudnn_ms, "kernel_stem_ms": kernel_ms,
           "s2d_layout_ms_unfused": None, "speedup_vs_cudnn": cudnn_ms / kernel_ms,
           "max_abs_diff": diff,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(f"# {card_line(dev)}", flush=True)
    print(f"# launches {json.dumps({'stem': S.stem.launches})}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
