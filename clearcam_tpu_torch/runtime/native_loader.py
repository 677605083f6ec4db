"""ctypes bindings for the native runtime components (native/).

Auto-builds with `make -C native` on first use when a toolchain exists;
everything has a pure-Python fallback so the framework runs without a
compiler (the native paths are the production-performance ones).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).parent.parent.parent / "native"
BUILD_DIR = NATIVE_DIR / "build"

_libs: dict[str, ctypes.CDLL | None] = {}


def _stale(path: Path) -> bool:
    """A built .so older than any native source is stale: rebuild before
    loading (binaries are gitignored — they only exist as local build
    products, and a silently outdated one must never shadow edited C/C++)."""
    if not path.exists():
        return True
    built = path.stat().st_mtime
    for src in NATIVE_DIR.rglob("*.c*"):
        if "build" not in src.parts and src.stat().st_mtime > built:
            return True
    return False


def load_lib(name: str) -> ctypes.CDLL | None:
    if name in _libs:
        return _libs[name]
    path = BUILD_DIR / f"lib{name}.so"
    if _stale(path):
        try:
            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            if not path.exists():
                _libs[name] = None
                return None
    try:
        _libs[name] = ctypes.CDLL(str(path))
    except OSError:
        _libs[name] = None
    return _libs[name]


# ---------------------------------------------------------------------------
# AES (native/aes/aesni.c)
# ---------------------------------------------------------------------------

def aes_lib() -> ctypes.CDLL | None:
    lib = load_lib("ccaes")
    if lib is not None and not hasattr(lib, "_cc_ready"):
        lib.cc_aes_cbc.restype = ctypes.c_int
        lib.cc_aes_cbc.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_int]
        lib.cc_aes_selftest.restype = ctypes.c_int
        if lib.cc_aes_selftest() != 0:
            _libs["ccaes"] = None
            return None
        lib._cc_ready = True
    return lib


def aes_cbc(key32: bytes, iv16: bytes, data: bytes, encrypt: bool) -> bytes | None:
    """Native AES-256-CBC; None when the library is unavailable."""
    lib = aes_lib()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(len(data))
    rc = lib.cc_aes_cbc(key32, iv16, data, len(data), out, int(encrypt))
    return out.raw if rc == 0 else None


# ---------------------------------------------------------------------------
# tracker association (native/track/assoc.c)
# ---------------------------------------------------------------------------

def track_lib() -> ctypes.CDLL | None:
    lib = load_lib("cctrack")
    if lib is not None and not hasattr(lib, "_cc_ready"):
        lib.cc_greedy_scan.restype = ctypes.c_int
        lib.cc_greedy_scan.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_void_p]
        lib._cc_ready = True
    return lib


def greedy_scan(order: np.ndarray, rows: int, cols: int) -> np.ndarray | None:
    """Greedy matching scan over pre-sorted flat indices; None when the
    native library is unavailable (caller falls back to the Python loop)."""
    lib = track_lib()
    if lib is None:
        return None
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty((min(rows, cols), 2), np.int32)
    n = lib.cc_greedy_scan(order.ctypes.data_as(ctypes.c_void_p),
                           len(order), rows, cols,
                           out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    return out[:n].astype(int)


# ---------------------------------------------------------------------------
# frame batcher (native/ingest/batcher.cc)
# ---------------------------------------------------------------------------

class NativeBatcher:
    """Seqlock'd latest-frame slots + one-call batch snapshot.

    Use push() from Python sources or add_fd() to hand a pipe fd (e.g. an
    ffmpeg rawvideo stdout) to a native reader thread.
    """

    def __init__(self, n_streams: int, frame_shape: tuple[int, int, int],
                 downsample: int = 1):
        """downsample k (odd): readers consume full frames but publish
        [H/k, W/k, C] center-tap decimated frames (the exact odd-integer
        bilinear fast path) — k^2 less host memcpy and PCIe traffic."""
        lib = load_lib("ccingest")
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        self.lib = lib
        lib.cc_batcher_create.restype = ctypes.c_void_p
        lib.cc_batcher_create.argtypes = [ctypes.c_int, ctypes.c_long]
        lib.cc_batcher_create2.restype = ctypes.c_void_p
        lib.cc_batcher_create2.argtypes = [ctypes.c_int] * 5
        lib.cc_batcher_add_fd.restype = ctypes.c_int
        lib.cc_batcher_add_fd.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.cc_batcher_push.restype = ctypes.c_int
        lib.cc_batcher_push.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.cc_batcher_snapshot.restype = ctypes.c_long
        lib.cc_batcher_snapshot.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_void_p]
        lib.cc_batcher_remove.restype = ctypes.c_int
        lib.cc_batcher_remove.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.cc_batcher_stop.argtypes = [ctypes.c_void_p]
        lib.cc_batcher_destroy.argtypes = [ctypes.c_void_p]
        self.n = n_streams
        self.downsample = downsample
        fh, fw, fc = frame_shape
        if downsample > 1:
            if downsample % 2 == 0 or fh % downsample or fw % downsample:
                raise ValueError(
                    f"downsample {downsample} must be odd and divide "
                    f"{fh}x{fw}")
            self.shape = (fh // downsample, fw // downsample, fc)
            self.h = lib.cc_batcher_create2(n_streams, fh, fw, fc, downsample)
        else:
            self.shape = frame_shape
            self.h = lib.cc_batcher_create(n_streams, int(np.prod(frame_shape)))
        if not self.h:
            raise RuntimeError("cc_batcher_create failed")
        self.frame_bytes = int(np.prod(frame_shape))  # input (full-res) bytes
        self.batch = np.zeros((n_streams, *self.shape), np.uint8)
        self.seqs = np.zeros(n_streams, np.int64)

    def add_fd(self, stream: int, fd: int):
        rc = self.lib.cc_batcher_add_fd(self.h, stream, fd)
        if rc:
            raise RuntimeError(f"add_fd failed ({rc})")

    def remove(self, stream: int):
        """Stop the slot's reader and reset its seq so the slot can be reused
        by a different camera (close the pipe's write side first)."""
        self.lib.cc_batcher_remove(self.h, stream)

    def push(self, stream: int, frame: np.ndarray):
        frame = np.ascontiguousarray(frame, np.uint8)
        assert frame.nbytes == self.frame_bytes
        self.lib.cc_batcher_push(self.h, stream,
                                 frame.ctypes.data_as(ctypes.c_char_p))

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (batch [N,H,W,3] view, per-stream seq numbers; -1 = empty)."""
        self.lib.cc_batcher_snapshot(
            self.h, self.batch.ctypes.data_as(ctypes.c_void_p),
            self.seqs.ctypes.data_as(ctypes.c_void_p))
        return self.batch, self.seqs.copy()

    def close(self):
        if self.h:
            self.lib.cc_batcher_destroy(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
