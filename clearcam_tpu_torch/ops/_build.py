"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, and loaded with ``ctypes``
(no PyTorch headers, which would make nvcc far slower). The library goes to
``clearcam_tpu_torch/build/`` (gitignored), named by a hash of the sources,
the flags and ``nvcc --version``, so neither an edited source nor another
toolkit is shadowed by an old build, even in a build directory shared or
carried across machines. A failed build raises; nothing falls back to the
plain versions.

Override the toolkit with ``CUDA_HOME``; ``nvcc`` on ``PATH`` wins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..runtime import metrics

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> (argtypes, restype). Pointers and the stream are
# c_void_p: a bare Python int would be passed as a 32-bit int.
SIGNATURES = {
    # x, w1, b1, w2, b2, out, B, H, W, dtype, stream -> cudaError_t
    "stem_forward": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    # once per device, before its first stem_forward -> cudaError_t
    "stem_prepare": ([], _I),
    # q, k, v, out, B, H, T, int64[12] strides, scale, dtype, warps, stages,
    # stream
    "vit_attention_forward": ([_P, _P, _P, _P, _I, _I, _I,
                               ctypes.POINTER(ctypes.c_longlong), _F, _I, _I, _I, _P], _I),
    # once per device, before its first vit_attention_forward
    "vit_attention_prepare": ([], _I),
    # x, q, s, bias, out, the splits' scratch, their counters, N, K, K_pad,
    # O, O_pad, splits, int4, dtype, stream
    "quant_matmul_forward": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _P], _I),
    # once per device, before its first quant_matmul_forward
    "quant_matmul_prepare": ([], _I),
    # q, k, v, k scales, v scales (null unless int8), out, pos, pads (null:
    # the two ints that follow, for every row), the partials' scratch (acc,
    # then m and l), the merge's counters, B, H, KvH, S, D, chunk, splits,
    # heads a block, tensor cores, scale, q/out dtype, cache dtype, stream
    "decode_attention_forward": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P], _I),
    # once per device, before its first decode_attention_forward
    "decode_attention_prepare": ([], _I),
    # x, out, elements, FMAs per chain, dtype, stream
    "vpu_probe_forward": ([_P, _P, _I, _I, _I, _P], _I),
    "cuda_error_string": ([_I], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_prepared: set[tuple[str, int]] = set()     # (set-up entry point, device index)
# what the last load did: {"path", "seconds", "cached", "log"}
last_build: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}: the CUDA "
                           "kernels of clearcam_tpu_torch cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def nvcc_version() -> str:
    """What ``nvcc --version`` prints: the toolkit's release and build."""
    return subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclearcam_kernels-{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise with the log of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        text = p.communicate(timeout=900)[0]
        logs.append(text)
        if p.returncode != 0:
            failed.append(f"nvcc failed (rc {p.returncode}):\n{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _compile(out: Path) -> str:
    """One nvcc per source, all at once, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    cu = [s for s in sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = _run([[nvcc_path(), *compile_flags, "-c", "-o", str(o), str(s)]
                    for s, o in zip(cu, objs)])
        log += _run([[nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]])
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)    # atomic: a concurrent process never loads half a file
    out.with_suffix(".log").write_text(log)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process;
    the span ``ops.library`` (``runtime.metrics``; attribute: whether a
    build was found) times the build or load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with metrics.timer("ops.library") as span:
            out = library_path()
            t0 = time.perf_counter()
            span.attr = cached = out.exists()
            log = out.with_suffix(".log").read_text() \
                if cached and out.with_suffix(".log").exists() else ""
            if not cached:
                log = _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        last_build.update(path=str(out), seconds=time.perf_counter() - t0,
                          cached=cached, log=log)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err:
        raise RuntimeError(f"{what} failed: cudaError {err} "
                           f"({load().cuda_error_string(err).decode()})")


def prepare(entry: str, device) -> str:
    """Build and load the library, and run the set-up entry point ``entry``
    (e.g. ``"stem_prepare"``) once on the CUDA ``device``; returns the
    library's path. Raises when nvcc, the build or the device refuses."""
    import torch
    device = torch.device(device)
    lib = load()
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (entry, index) not in _prepared:
        with torch.cuda.device(index):
            check(getattr(lib, entry)(), f"{entry} on cuda:{index}")
        _prepared.add((entry, index))
    return last_build["path"]
