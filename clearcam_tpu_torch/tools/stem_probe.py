"""The YOLOv9-t stem's device cost without the kernel: the counterpart of
``clearcam_tpu.tools.stem_probe``, with its flags and JSON keys, for the
card.

The stem is conv 3->16 3x3 s2 + SiLU, then conv 16->32 3x3 s2 + SiLU (the
first two layers of the t graph). This probe times the plain pair the port
runs without its kernel (``ops.stem.stem_reference``, and the s/m/c/e
graphs): ``nn.functional.conv2d_oihw`` + SiLU twice, bf16, channels-last,
i.e. cuDNN, on OIHW weights converted once. Keys (milliseconds a call):

  stem_ms                 the pair, whole
  stem_split_ms           conv1 + SiLU, then conv2 + SiLU, as two calls. Eager
                          PyTorch fuses nothing, so this is the same schedule
                          as ``stem_ms``, timed again (the JAX tool compares
                          XLA's fusion with a forced split)
  conv1_ms, conv2_ms      each conv + SiLU alone (conv2 on a resident
                          [B,H/2,W/2,16] input)
  conv1_s2d_2x2s1_ms      conv1 recast over a 2x2 space-to-depth input
                          [B,H/2,W/2,12]: a 2x2 stride-1 conv, its asymmetric
                          (1,0),(1,0) padding made by ``F.pad`` inside the
                          timed call (the split itself is not timed)
  roofline_ms_min_traffic         input read + output written once (bf16)
                                  over the card's 3.35 TB/s
  roofline_ms_with_mid_roundtrip  the same plus the [B,H/2,W/2,16]
                                  intermediate written and read back
  stem_gflop              the pair's operations (2 a multiply-add)
  tensor_core_ms_at_peak  those operations over 989 TFLOP/s, the dense bf16
                          tensor-core peak: the operations bound. It replaces
                          the JAX tool's ``mxu_ms_at_2.6pct_util`` (the
                          TPU's MXU at the share the stem's shapes fill)

Peaks: the NVIDIA H100 SXM data sheet at its 700 W limit; the card's name
and power limit come on a ``#`` line. On the card each time is CUDA events
around ``--steps`` calls on resident inputs after a warm-up; the JAX tool's
reduction to a scalar (an escape from its host link's readback) is not
needed. ``--device cpu`` runs the same calls on the CPU, timed on the host
clock: the CPU's numbers, not the card's.

    python -m clearcam_tpu_torch.tools.stem_probe [--batch 128] [--res 640]
        [--steps 30] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as tF

from ..device import card_line, resolve_device
from ..nn import functional as F

HBM_BYTES_S = 3.35e12           # H100 SXM HBM3 (data sheet)
BF16_FLOP_S = 989e12            # H100 SXM dense bf16 tensor cores (data sheet)


def weights(rng) -> dict:
    """The JAX tool's seed-0 draws, in its order: HWIO w0 [3,3,3,16] and
    w1 [3,3,16,32] of standard normals x 0.1, zero biases (float32)."""
    w0 = (rng.standard_normal((3, 3, 3, 16)) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 16, 32)) * 0.1).astype(np.float32)
    return {"w0": w0, "b0": np.zeros(16, np.float32),
            "w1": w1, "b1": np.zeros(32, np.float32)}


def normal(rng, shape, dev) -> torch.Tensor:
    """A resident bf16 tensor of standard normals (drawn in float32)."""
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev, torch.bfloat16)


def plain_convs(w: dict, dev):
    """(conv1, conv2): each conv + SiLU of the plain pair on NHWC bf16, its
    OIHW channels-last weights and bf16 bias made once here."""
    cl = torch.channels_last
    packed = [(F.hwio_to_oihw(torch.from_numpy(w[k])).to(dev, torch.bfloat16)
               .contiguous(memory_format=cl), torch.from_numpy(w[b]).to(dev, torch.bfloat16))
              for k, b in (("w0", "b0"), ("w1", "b1"))]

    def conv(i):
        wt, bias = packed[i]
        return lambda x: F.silu(F.conv2d_oihw(x, wt, bias, stride=2, padding=1))
    return conv(0), conv(1)


def device_ms(fn, steps: int, dev, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn()``: CUDA events around ``steps`` calls
    after ``warmup`` on the card; the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / steps


def bounds(b: int, r: int) -> dict:
    """The stem's bytes and operations at [b, r, r, 3] bf16, and the card's
    times for them."""
    bytes_min = b * (r * r * 3 + (r // 4) * (r // 4) * 32) * 2
    bytes_mid = b * (r // 2) * (r // 2) * 16 * 2
    flops = b * ((r // 2) ** 2 * 16 * 27 + (r // 4) ** 2 * 32 * 16 * 9) * 2
    return {"roofline_ms_min_traffic": bytes_min / HBM_BYTES_S * 1e3,
            "roofline_ms_with_mid_roundtrip": (bytes_min + 2 * bytes_mid) / HBM_BYTES_S * 1e3,
            "stem_gflop": flops / 1e9,
            "tensor_core_ms_at_peak": flops / BF16_FLOP_S * 1e3}


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
    b, r, steps = args.batch, args.res, args.steps

    rng = np.random.default_rng(0)
    conv1, conv2 = plain_convs(weights(rng), dev)
    x = normal(rng, (b, r, r, 3), dev)
    mid_in = normal(rng, (b, r // 2, r // 2, 16), dev)
    x_s2d = normal(rng, (b, r // 2, r // 2, 12), dev)
    # the taps scattered over 2x2x12 (zeros: the same operations)
    w0_s2d = torch.zeros((16, 12, 2, 2), dtype=torch.bfloat16, device=dev
                         ).contiguous(memory_format=torch.channels_last)

    def split():
        mid = conv1(x)
        return conv2(mid)

    res = {"batch": b,
           "stem_ms": device_ms(lambda: conv2(conv1(x)), steps, dev),
           "stem_split_ms": device_ms(split, steps, dev),
           "conv1_ms": device_ms(lambda: conv1(x), steps, dev),
           "conv2_ms": device_ms(lambda: conv2(mid_in), steps, dev),
           "conv1_s2d_2x2s1_ms": device_ms(lambda: F.silu(F.conv2d_oihw(
               tF.pad(x_s2d, (0, 0, 1, 0, 1, 0)), w0_s2d)), steps, dev),
           **bounds(b, r),
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(f"# {card_line(dev)}", flush=True)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
