"""GGUF reader: header/KV parse + block dequantization to numpy.

Format/behavior parity with the reference loader (utils/gguf.py): GGUF v2/v3,
typed KV metadata, tensor infos, alignment, multi-part splits, and ggml block
dequant for the common quant families. Dequant here happens at load time into
numpy (memory-mapped input, vectorized kernels) and the result is shipped to
the TPU once — the reference instead lazily dequantizes with tensor ops.

Supported ggml types: F32(0) F16(1) Q4_0(2) Q4_1(3) Q5_0(6) Q5_1(7) Q8_0(8)
Q4_K(12) Q5_K(13) Q6_K(14) IQ3_XXS(18) IQ3_S(21) IQ2_S(22) IQ4_XS(23)
I8/I16/I32/I64(24-27) F64(28) BF16(30) MXFP4(39) Q1_0(41).
The IQ3/IQ2 types additionally need the ggml lattice codebooks — see
ggml_grids.py (pure data; extracted once with tools/extract_ggml_grids.py).
"""
from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np

_SIMPLE = {0: "B", 1: "b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f",
           7: "?", 10: "<Q", 11: "<q", 12: "<d"}

GGML_NATIVE = {0: np.float32, 1: np.float16, 24: np.int8, 25: np.int16,
               26: np.int32, 27: np.int64, 28: np.float64}
# quant id -> (elements/block, bytes/block)
GGML_QUANT = {2: (32, 18), 3: (32, 20), 6: (32, 22), 7: (32, 24), 8: (32, 34),
              12: (256, 144), 13: (256, 176), 14: (256, 210),
              18: (256, 98), 21: (256, 110), 22: (256, 82), 23: (256, 136),
              39: (32, 17), 41: (128, 18)}


class _Reader:
    def __init__(self, data: memoryview):
        self.d = data
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out

    def scalar(self, typ: int):
        fmt = _SIMPLE[typ]
        size = struct.calcsize(fmt)
        (v,) = struct.unpack(fmt, self.take(size))
        return v

    def string(self) -> str:
        n = self.scalar(10)
        return str(bytes(self.take(n)), "utf-8")

    def value(self, typ: int):
        if typ == 8:
            return self.string()
        if typ == 9:
            item_t = self.scalar(5)
            n = self.scalar(10)
            return [self.value(item_t) for _ in range(n)]
        return self.scalar(typ)


def _half(b: np.ndarray) -> np.ndarray:
    return b.view(np.float16).astype(np.float32)


def _nibbles(b: np.ndarray) -> np.ndarray:
    """uint8 [..., n] -> [..., 2n] low-nibbles-first within each group
    (ggml layout: element i and i+16 share byte i)."""
    return np.concatenate([b & 0xF, b >> 4], axis=-1)


def _bits(b: np.ndarray) -> np.ndarray:
    """uint8 [..., n] -> [..., 8n] bit expansion, LSB-first per ggml qh order
    (bit index == element index for Q5_0/Q5_1's 32-bit qh word)."""
    return np.unpackbits(b, axis=-1, bitorder="little")


def _bits_planes(b: np.ndarray) -> np.ndarray:
    """uint8 [..., n] -> [..., 8, n] where [k, l] = bit k of byte l (the
    k-quant qh layout: plane k feeds the k-th 32-element sub-group)."""
    planes = np.unpackbits(b[..., None], axis=-1, bitorder="little")
    return np.moveaxis(planes, -1, -2)


def dequant(raw: np.ndarray, n: int, ggml_type: int) -> np.ndarray:
    """Dequantize `n` elements of ggml data into float32/float16 numpy."""
    if ggml_type in GGML_NATIVE:
        dt = GGML_NATIVE[ggml_type]
        return raw[: np.dtype(dt).itemsize * n].view(dt)
    if ggml_type == 30:  # bf16
        u = raw[: 2 * n].view(np.uint16).astype(np.uint32) << 16
        return u.view(np.float32)
    if ggml_type not in GGML_QUANT:
        raise ValueError(f"unsupported ggml type {ggml_type}")
    per, nbytes = GGML_QUANT[ggml_type]
    blocks = raw[: (n // per) * nbytes].reshape(-1, nbytes)

    if ggml_type == 2:  # Q4_0: d, 16B nibbles, value = (q-8)*d
        d = _half(blocks[:, :2])
        q = _nibbles(blocks[:, 2:18]).astype(np.int8) - 8
        return (q * d).astype(np.float32).reshape(-1)
    if ggml_type == 3:  # Q4_1: d, m, nibbles: q*d + m
        d, m = _half(blocks[:, :2]), _half(blocks[:, 2:4])
        q = _nibbles(blocks[:, 4:20]).astype(np.float32)
        return (q * d + m).astype(np.float32).reshape(-1)
    if ggml_type in (6, 7):  # Q5_0 / Q5_1
        d = _half(blocks[:, :2])
        off = 2 if ggml_type == 6 else 4
        qh = _bits(blocks[:, off:off + 4]).astype(np.int8)       # 32 high bits
        q = _nibbles(blocks[:, off + 4:off + 20]).astype(np.int8) + qh * 16
        if ggml_type == 6:
            return ((q - 16) * d).astype(np.float32).reshape(-1)
        m = _half(blocks[:, 2:4])
        return (q * d + m).astype(np.float32).reshape(-1)
    if ggml_type == 8:  # Q8_0
        d = _half(blocks[:, :2])
        q = blocks[:, 2:34].view(np.int8).astype(np.float32)
        return (q * d).astype(np.float32).reshape(-1)
    if ggml_type in (12, 13):  # Q4_K / Q5_K: 8 sub-blocks of 32
        d = _half(blocks[:, 0:2])[:, None]
        dmin = _half(blocks[:, 2:4])[:, None]
        s = blocks[:, 4:16]
        sc = np.concatenate([s[:, 0:4] & 63,
                             (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)], -1)
        mn = np.concatenate([s[:, 4:8] & 63,
                             (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)], -1)
        qs_off = 48 if ggml_type == 13 else 16
        qs = blocks[:, qs_off:qs_off + 128].reshape(-1, 4, 32)
        q = np.stack([qs & 0xF, qs >> 4], axis=2).reshape(-1, 8, 32).astype(np.float32)
        if ggml_type == 13:
            qh = _bits_planes(blocks[:, 16:48])     # [-1, 8, 32] = [plane, byte]
            q = q + qh * 16
        vals = d * sc.astype(np.float32)[:, :, None] * q \
            - dmin * mn.astype(np.float32)[:, :, None]
        return vals.astype(np.float32).reshape(-1)
    if ggml_type == 14:  # Q6_K
        ql = blocks[:, :128].reshape(-1, 2, 64)
        qh = blocks[:, 128:192].reshape(-1, 2, 32)
        xl = _nibbles(ql)                                  # [-1,2,128] 4-bit
        xh = np.concatenate([(qh >> s) & 0x3 for s in (0, 2, 4, 6)],
                            axis=-1) << 4                  # [-1,2,128]
        q = (xl | xh).astype(np.int8) - 32
        scales = blocks[:, 192:208].view(np.int8).astype(np.float32)
        scales = np.repeat(scales, 16, axis=-1)            # [-1,256]
        d = _half(blocks[:, 208:210])
        return (d * q.reshape(-1, 256).astype(np.float32) * scales) \
            .astype(np.float32).reshape(-1)
    if ggml_type == 18:  # IQ3_XXS: d + 64 grid bytes + 8 scale/sign words
        # layout: d f16 | qs[64] (grid indices, 4 values each) | 8 uint32
        # words, one per 32-elem sub-block: bits 28-31 scale, bits 0-27 =
        # 4x 7-bit sign indices completed to 8 bits by even parity
        # (behavior parity: reference gguf.py:73-82)
        from .ggml_grids import KSIGNS, load_grids
        grid = load_grids()["iq3xxs_grid"]                 # uint8 [256,4]
        d = _half(blocks[:, :2])                           # [B,1]
        sw = blocks[:, 66:98].copy().view("<u4")           # [B,8]
        db = d * ((sw >> 28).astype(np.float32) + 0.5) * 0.5
        sidx = (sw[..., None] >> np.array([0, 7, 14, 21], np.uint32)) & 0x7F
        sbits = _bits(KSIGNS[sidx.astype(np.intp)][..., None])  # [B,8,4,8]
        signs = 1.0 - 2.0 * sbits
        vals = grid[blocks[:, 2:66].astype(np.intp)]       # [B,64,4]
        vals = vals.reshape(-1, 8, 4, 8).astype(np.float32)
        return (db[:, :, None, None] * vals * signs).astype(np.float32).reshape(-1)
    if ggml_type == 21:  # IQ3_S: 9-bit grid indices, raw sign bytes
        # layout: d f16 | qs[64] | qh[8] (9th index bits) | signs[32] |
        # scales[4] (nibbles: sub-block scale = 1+2*nib)  (gguf.py:83-89)
        from .ggml_grids import load_grids
        grid = load_grids()["iq3s_grid"]                   # uint8 [512,4]
        d = _half(blocks[:, :2])
        sl = blocks[:, 106:110]
        scales = 1.0 + 2.0 * np.stack([sl & 0xF, sl >> 4], -1) \
            .reshape(-1, 8).astype(np.float32)
        qh = _bits(blocks[:, 66:74]).astype(np.uint16)     # [B,64]
        q = blocks[:, 2:66].astype(np.uint16) | (qh << 8)
        signs = 1.0 - 2.0 * _bits(blocks[:, 74:106][..., None]) \
            .reshape(-1, 8, 4, 8)
        vals = grid[q.astype(np.intp)].reshape(-1, 8, 4, 8).astype(np.float32)
        return (d[:, :, None, None] * scales[:, :, None, None] * vals * signs) \
            .astype(np.float32).reshape(-1)
    if ggml_type == 22:  # IQ2_S: 10-bit grid indices into the 8-lane grid
        # layout: d f16 | qs[32] | signs[32] | qh[8] (2 high bits per index,
        # LSB-first crumbs) | scales[8] (nibbles; 16 sub-scales of 16 elems)
        # (gguf.py:90-96)
        from .ggml_grids import load_grids
        grid = load_grids()["iq2s_grid"]                   # uint8 [1024,8]
        d = _half(blocks[:, :2])
        sc = blocks[:, 74:82]
        db = d * (np.stack([sc & 0xF, sc >> 4], -1).reshape(-1, 16)
                  .astype(np.float32) + 0.5) * 0.25        # [B,16]
        qh = blocks[:, 66:74]
        crumbs = np.stack([qh & 3, (qh >> 2) & 3, (qh >> 4) & 3, qh >> 6], -1) \
            .reshape(-1, 32).astype(np.uint16)
        q = blocks[:, 2:34].astype(np.uint16) | (crumbs << 8)
        signs = 1.0 - 2.0 * _bits(blocks[:, 34:66][..., None]) \
            .reshape(-1, 16, 2, 8)
        vals = grid[q.astype(np.intp)].reshape(-1, 16, 2, 8).astype(np.float32)
        return (db[:, :, None, None] * vals * signs).astype(np.float32).reshape(-1)
    if ggml_type == 23:  # IQ4_XS: 6-bit sub-scales + non-linear 4-bit codebook
        # layout: d f16 | scales_h u16 (2 bits/sub-block) | scales_l[4]
        # (nibbles) | qs[128]; value = d*(scale-32)*kvalues[q] (gguf.py:97-105)
        from .ggml_grids import KVALUES_IQ4NL
        d = _half(blocks[:, :2])                           # [B,1]
        sh = blocks[:, 2:4].copy().view("<u2")             # [B,1]
        sl = blocks[:, 4:8]
        lo = np.stack([sl & 0xF, sl >> 4], -1).reshape(-1, 8).astype(np.int16)
        hi = ((sh >> np.arange(0, 16, 2, dtype=np.uint16)[None, :]) & 0x3) \
            .astype(np.int16)                              # [B,8]
        scale = (lo | (hi << 4)).astype(np.float32) - 32.0
        qs = blocks[:, 8:136].reshape(-1, 8, 16)
        q = np.concatenate([qs & 0xF, qs >> 4], -1)        # [B,8,32]
        vals = KVALUES_IQ4NL[q]
        return (d[:, :, None] * scale[:, :, None] * vals) \
            .astype(np.float32).reshape(-1)
    if ggml_type == 41:  # Q1_0: binary +-d, 128 LSB-first bits (gguf.py:116-119)
        d = _half(blocks[:, :2])
        bits = _bits(blocks[:, 2:18]).astype(np.float32)   # [B,128]
        return (d * (bits * 2.0 - 1.0)).astype(np.float32).reshape(-1)
    if ggml_type == 39:  # MXFP4: e8 scale + 32 fp4 codes
        e = blocks[:, 0].astype(np.uint32)
        small = np.array([0x00200000, 0x00400000], np.uint32)[np.minimum(e, 1)]
        d = np.where(e < 2, small, (e - 1) * 0x00800000).astype(np.uint32) \
            .view(np.float32)
        lut = np.array([0, 1, 2, 3, 4, 6, 8, 12,
                        -0, -1, -2, -3, -4, -6, -8, -12], np.float32)
        codes = _nibbles(blocks[:, 1:17])
        return (lut[codes] * d[:, None]).astype(np.float32).reshape(-1)[:n]
    raise ValueError(f"unsupported ggml type {ggml_type}")


def load(path: str | Path, tensor_filter=None) -> tuple[dict, dict[str, np.ndarray]]:
    """-> (kv metadata, {name: array}) with torch-layout shapes (GGUF dims
    reversed). Multi-part splits auto-merge."""
    path = Path(path)
    data = np.memmap(path, np.uint8, "r")
    r = _Reader(memoryview(data))
    magic = bytes(r.take(4))
    if magic != b"GGUF":
        raise ValueError("not a GGUF file")
    version = r.scalar(5)
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.scalar(11)
    n_kv = r.scalar(11)
    kv = {}
    for _ in range(n_kv):
        key = r.string()
        typ = r.scalar(5)
        kv[key] = r.value(typ)
    infos = []
    for _ in range(n_tensors):
        name = r.string()
        ndim = r.scalar(4)
        dims = tuple(r.scalar(10) for _ in range(ndim))
        typ = r.scalar(5)
        off = r.scalar(10)
        infos.append((name, dims, typ, off))
    align = kv.get("general.alignment", 32)
    start = (r.pos + align - 1) // align * align

    tensors = {}
    for name, dims, typ, off in infos:
        if tensor_filter is not None and not tensor_filter(name):
            continue
        n = int(np.prod(dims))
        arr = dequant(np.asarray(data[start + off:]), n, typ)
        tensors[name] = arr[:n].reshape(tuple(reversed(dims)))

    if kv.get("split.count", 1) > 1 and "split.no" in kv and kv["split.no"] == 0:
        m = re.match(r"^(.*)-00001-of-(\d{5})\.gguf$", str(path))
        if not m:
            raise ValueError("multi-part GGUF must be loaded from part 00001")
        for i in range(2, kv["split.count"] + 1):
            part = Path(f"{m.group(1)}-{i:05d}-of-{m.group(2)}.gguf")
            _, more = load(part, tensor_filter)
            tensors.update(more)
    return kv, tensors


# ---------------------------------------------------------------------------
# writer (tests + export): v3, F32/F16 tensors only
# ---------------------------------------------------------------------------

_KV_CODES = {bool: 7, int: 5, float: 6, str: 8}


def _write_value(out: bytearray, v):
    import struct as _s
    if isinstance(v, bool):
        out += _s.pack("<i", 7) + _s.pack("?", v)
    elif isinstance(v, int):
        out += _s.pack("<i", 5) + _s.pack("<i", v)
    elif isinstance(v, float):
        out += _s.pack("<i", 6) + _s.pack("<f", v)
    elif isinstance(v, str):
        b = v.encode()
        out += _s.pack("<i", 8) + _s.pack("<Q", len(b)) + b
    elif isinstance(v, (list, tuple)):
        out += _s.pack("<i", 9)
        item_t = _KV_CODES[type(v[0])] if v else 5
        out += _s.pack("<i", item_t) + _s.pack("<Q", len(v))
        for item in v:
            if item_t == 8:
                b = str(item).encode()
                out += _s.pack("<Q", len(b)) + b
            elif item_t == 7:
                out += _s.pack("?", item)
            elif item_t == 6:
                out += _s.pack("<f", item)
            else:
                out += _s.pack("<i", int(item))
    else:
        raise TypeError(type(v))


def save(path: str | Path, kv: dict, tensors: dict[str, np.ndarray],
         alignment: int = 32):
    """Minimal GGUF v3 writer (F32/F16) for fixtures and model export."""
    import struct as _s
    if alignment != 32 and "general.alignment" not in kv:
        # readers default to 32 (load() here, reference gguf.py:169): a
        # non-default alignment MUST ride in the KV or every tensor is
        # read at a silently-wrong offset
        kv = {**kv, "general.alignment": int(alignment)}
    out = bytearray()
    out += b"GGUF" + _s.pack("<i", 3)
    out += _s.pack("<q", len(tensors)) + _s.pack("<q", len(kv))
    for k, v in kv.items():
        kb = k.encode()
        out += _s.pack("<Q", len(kb)) + kb
        _write_value(out, v)
    blobs, off = [], 0
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        typ = 1 if arr.dtype == np.float16 else 0
        arr = arr.astype(np.float16 if typ else np.float32)
        nb = name.encode()
        out += _s.pack("<Q", len(nb)) + nb
        out += _s.pack("<I", arr.ndim)
        for d in reversed(arr.shape):
            out += _s.pack("<Q", d)
        out += _s.pack("<i", typ) + _s.pack("<Q", off)
        blob = arr.tobytes()
        pad = (-len(blob)) % alignment
        blobs.append(blob + b"\0" * pad)
        off += len(blob) + pad
    pad = (-len(out)) % alignment
    out += b"\0" * pad
    with open(path, "wb") as f:
        f.write(out)
        for b in blobs:
            f.write(b)
