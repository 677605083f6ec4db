"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, and loaded with ``ctypes``
(no PyTorch headers, which would make nvcc far slower). The library goes to
``clearcam_tpu_torch/build/`` (gitignored), named by a hash of the sources
and flags, so an edited source is never shadowed by an old build. A failed
build raises; nothing falls back to the plain versions.

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
    # q, k, v, out, B, H, T, int64[12] strides, scale, dtype, stream
    "vit_attention_forward": ([_P, _P, _P, _P, _I, _I, _I,
                               ctypes.POINTER(ctypes.c_longlong), _F, _I, _P], _I),
    # once per device, before its first vit_attention_forward
    "vit_attention_prepare": ([], _I),
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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclearcam_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)    # atomic: a concurrent process never loads half a file
    out.with_suffix(".log").write_text(log)
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        t0 = time.perf_counter()
        cached = out.exists()
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
