"""Measure the card's CUDA-core multiply-add rate with a hand-written
kernel (csrc/vpu_probe.cu), the counterpart of
``clearcam_tpu.tools.vpu_probe``: the ceiling a direct CUDA-core kernel,
such as the YOLOv9 stem's, is held to.

The kernel runs ITERS scalar-broadcast multiply-adds over a [ROWS, 128]
f32 or bf16 tile in 8 independent chains (``acc_j = acc_j * c_j + x``),
folds the chains in the tile's type and writes the tile. One call is
ROWS * 128 * ITERS = 2.147 G multiply-adds, as on the TPU.

    python -m clearcam_tpu_torch.tools.vpu_probe [--device cuda] [--steps 30]

prints one JSON line with the JAX tool's keys (``vpu_f32_tmacs``,
``vpu_bf16_tmacs``, ``conv1_ms_at_measured_bf16_rate``) and the device it
measured. On the card each rate is timed with CUDA events over ``steps``
back-to-back launches after a warm-up, so the launch cost is left out.
``--device cpu`` times the plain version (``probe_reference``) instead.

``probe`` is the wrapper: a CPU tensor goes to ``probe_reference``, a CUDA
tensor launches the kernel or raises (dtype, shape, contiguity, a failed
build or launch). ``probe.launches`` counts kernel launches.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from ..device import resolve_device
from ..ops import _build

ROWS = 512
ITERS = 32768       # multiply-adds per chain and element over one call
UNROLL = 8          # independent chains
CONV1_MACS = 5.66e9     # YOLOv9-t conv1 (3->16 s2) at batch 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _consts(dtype) -> list:
    """c_j = 0.875 + 0.01 j, rounded from the double to the tile's type."""
    return [torch.tensor(0.875 + 0.01 * j, dtype=torch.float64).to(dtype)
            for j in range(UNROLL)]


def probe_reference(x, iters: int | None = None):
    """The plain version: the probe's recurrence in torch, in x's dtype.
    bf16 rounds the product and the sum apart (the JAX package's bf16
    body); f32 rounds the multiply-add once, as XLA contracts the f32 body
    into an FMA (the product of two f32 values is exact in f64, so the f64
    sum rounds once to f32). The chains fold left to right in the dtype."""
    iters = ITERS if iters is None else iters
    if iters % UNROLL:
        raise ValueError(f"iters must be a multiple of {UNROLL}, got {iters}")
    dt = x.dtype
    cs = [c.to(x.device) for c in _consts(dt)]
    accs = [torch.zeros_like(x) + j for j in range(UNROLL)]
    if dt == torch.float32:
        xd = x.double()
        cd = [c.double() for c in cs]
        for _ in range(iters // UNROLL):
            accs = [(a.double() * c + xd).float() for a, c in zip(accs, cd)]
    else:
        for _ in range(iters // UNROLL):
            accs = [a * c + x for a, c in zip(accs, cs)]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def probe(x, iters: int | None = None):
    """The probe tile for x ([N, 128], f32 or bf16): the kernel on a CUDA
    tensor, the plain version on a CPU one."""
    iters = ITERS if iters is None else iters
    if x.device.type == "cpu":
        return probe_reference(x, iters)
    if x.device.type != "cuda":
        raise ValueError(f"vpu_probe: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"vpu_probe: dtype {x.dtype} not in {list(_DTYPES)}")
    if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] < 1:
        raise ValueError(f"vpu_probe: x must be [N, 128], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("vpu_probe: x must be contiguous")
    if iters < 0 or iters % UNROLL:
        raise ValueError(f"vpu_probe: iters must be a non-negative multiple of {UNROLL}")
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vpu_probe_forward(x.data_ptr(), out.data_ptr(), x.numel(), iters,
                                    _DTYPES[x.dtype], stream)
    _build.check(err, "vpu_probe kernel launch")
    probe.launches += 1
    return out


probe.launches = 0


def macs_per_call(rows: int = ROWS, iters: int | None = None) -> int:
    """Multiply-adds of one call: one per element per chain step."""
    return rows * 128 * (ITERS if iters is None else iters)


def measure(dtype, steps: int = 30, device="cuda", iters: int | None = None) -> float:
    """Multiply-adds per second of the probe at [ROWS, 128] in ``dtype``:
    on the card, CUDA events around ``steps`` back-to-back launches after
    one warm-up launch; on the CPU (asked for by name), the plain version
    on the host clock."""
    dev = resolve_device(device)
    x = torch.ones((ROWS, 128), dtype=dtype, device=dev)
    probe(x, iters)                                # build, launch once
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(steps):
            out = probe(x, iters)
        end.record()
        torch.cuda.synchronize(dev)
        dt = start.elapsed_time(end) / 1e3 / steps
    else:
        t0 = time.perf_counter()
        for _ in range(steps):
            out = probe(x, iters)
        dt = (time.perf_counter() - t0) / steps
    if not torch.isfinite(out.float()).all():
        raise AssertionError("vpu_probe: non-finite output")
    return macs_per_call(ROWS, iters) / dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu (the plain version)")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res[f"vpu_{name}_tmacs"] = measure(dt, args.steps, dev) / 1e12
    # what that rate means for the YOLOv9-t conv1 at batch 128 (5.66 G MACs)
    res["conv1_ms_at_measured_bf16_rate"] = CONV1_MACS / (res["vpu_bf16_tmacs"] * 1e12) * 1e3
    res["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    res["launches"] = probe.launches
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
