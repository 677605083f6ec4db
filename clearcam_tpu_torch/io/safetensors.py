"""Minimal safetensors reader/writer (no torch dependency).

The reference loads model weights with tinygrad's `safe_load`
(detection/yolov9.py:372, models/objects.py:91, models/adaface.py:76). We read
the same files with numpy memory-mapping so weights go straight to device via
jnp.asarray without an intermediate framework.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    # BF16 has no numpy dtype; we widen to float32 on read.
    "BF16": None,
}


def _bf16_to_f32(raw: np.ndarray) -> np.ndarray:
    """Widen little-endian bfloat16 bytes to float32."""
    u16 = raw.view(np.uint16).astype(np.uint32) << 16
    return u16.view(np.float32)


def read_header(path: str | Path) -> dict:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def load(path: str | Path) -> dict[str, np.ndarray]:
    """Load a safetensors file into a dict of numpy arrays (zero-copy mmap)."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
    out: dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = np.asarray(data[start:end])
        if info["dtype"] == "BF16":
            arr = _bf16_to_f32(raw).reshape(info["shape"])
        else:
            dt = _DTYPES[info["dtype"]]
            if dt is None:
                raise ValueError(f"unsupported dtype {info['dtype']}")
            arr = raw.view(dt).reshape(info["shape"])
        out[name] = arr
    return out


def save(tensors: dict[str, np.ndarray], path: str | Path) -> None:
    """Write a dict of numpy arrays as a safetensors file."""
    inv = {np.dtype(v): k for k, v in _DTYPES.items() if v is not None}
    header: dict[str, dict] = {}
    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        code = inv[arr.dtype]
        nbytes = arr.nbytes
        header[name] = {
            "dtype": code,
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + nbytes],
        }
        blobs.append(arr.tobytes())
        offset += nbytes
    hjson = json.dumps(header).encode()
    # pad header to 8-byte alignment like the upstream writer
    pad = (8 - len(hjson) % 8) % 8
    hjson += b" " * pad
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for b in blobs:
            f.write(b)
