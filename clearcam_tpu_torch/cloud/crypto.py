"""Encrypted event-clip file format (AES-256-CBC).

Wire format shared with the clearcam mobile apps (reference
utils/helpers.py:310-355, utils/aes.py; Android VideoHelper.kt:311 decrypt):

    file = IV (16B) || AES-256-CBC( pack('<Q', MAGIC) || plaintext, PKCS7 )
    key  = utf-8 bytes of the passphrase, truncated/zero-padded to 32 bytes
    MAGIC = 0x4D41474943  ("MAGIC\x00\x00\x00" little-endian check on decrypt)

Re-design: the reference ships a pure-Python AES (utils/aes.py, ~200 LoC,
~100 KB/s); we use OpenSSL via `cryptography` (AES-NI, GB/s) with a tiny
pure-Python CBC fallback for environments without it.
"""
from __future__ import annotations

import os
import struct
from pathlib import Path

MAGIC_NUMBER = 0x4D41474943
HEADER_SIZE = 8
BLOCK = 16
KEY_SIZE = 32

try:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    _HAVE_OPENSSL = True
except Exception:  # pragma: no cover
    _HAVE_OPENSSL = False


def prepare_key(key: str) -> bytes:
    kb = key.encode("utf-8")[:KEY_SIZE]
    return kb.ljust(KEY_SIZE, b"\0")


def pkcs7_pad(data: bytes) -> bytes:
    n = BLOCK - (len(data) % BLOCK)
    return data + bytes([n] * n)


def pkcs7_unpad(data: bytes) -> bytes:
    if not data:
        # truncated .aes (e.g. IV-only upload): keep the documented
        # ValueError taxonomy rather than IndexError on data[-1]
        raise ValueError("bad PKCS7 padding")
    n = data[-1]
    if not 1 <= n <= BLOCK or data[-n:] != bytes([n]) * n:
        raise ValueError("bad PKCS7 padding")
    return data[:-n]


def _cbc(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    # backend order: native AES-NI (native/aes) -> OpenSSL -> pure Python
    try:
        from ..runtime.native_loader import aes_cbc as native_cbc
        out = native_cbc(key, iv, data, encrypt)
        if out is not None:
            return out
    except Exception:
        pass
    if _HAVE_OPENSSL:
        c = Cipher(algorithms.AES(key), modes.CBC(iv))
        op = c.encryptor() if encrypt else c.decryptor()
        return op.update(data) + op.finalize()
    return _cbc_pure(key, iv, data, encrypt)


def _cbc_pure(key: bytes, iv: bytes, data: bytes, encrypt: bool) -> bytes:
    aes = _PureAES(key)
    out = bytearray()
    prev = iv
    for i in range(0, len(data), BLOCK):
        blk = data[i:i + BLOCK]
        if encrypt:
            x = bytes(a ^ b for a, b in zip(blk, prev))
            prev = aes.encrypt_block(x)
            out += prev
        else:
            dec = aes.decrypt_block(blk)
            out += bytes(a ^ b for a, b in zip(dec, prev))
            prev = blk
    return bytes(out)


def encrypt_bytes(plaintext: bytes, key: str, iv: bytes | None = None) -> bytes:
    iv = os.urandom(BLOCK) if iv is None else iv
    payload = pkcs7_pad(struct.pack("<Q", MAGIC_NUMBER) + plaintext)
    return iv + _cbc(prepare_key(key), iv, payload, encrypt=True)


def decrypt_bytes(blob: bytes, key: str) -> bytes:
    iv, ct = blob[:BLOCK], blob[BLOCK:]
    padded = _cbc(prepare_key(key), iv, ct, encrypt=False)
    data = pkcs7_unpad(padded)
    (magic,) = struct.unpack("<Q", data[:HEADER_SIZE])
    if magic != MAGIC_NUMBER:
        raise ValueError("magic check failed: wrong key or corrupt file")
    return data[HEADER_SIZE:]


def encrypt_file(src: Path, dst: Path, key: str) -> bool:
    try:
        dst.write_bytes(encrypt_bytes(Path(src).read_bytes(), key))
        return True
    except Exception as e:  # noqa: BLE001
        print(f"ENCRYPTION FAILED: {e}")
        return False


def decrypt_file(src: Path, dst: Path, key: str) -> bool:
    try:
        dst.write_bytes(decrypt_bytes(Path(src).read_bytes(), key))
        return True
    except Exception as e:  # noqa: BLE001
        print(f"DECRYPTION FAILED: {e}")
        return False


# ---------------------------------------------------------------------------
# minimal pure-Python AES-256 block cipher (fallback only)
# ---------------------------------------------------------------------------

_SBOX = None
_INV_SBOX = None


def _build_sbox():
    global _SBOX, _INV_SBOX
    if _SBOX is not None:
        return
    # standard AES S-box via GF(2^8) inverse + affine transform
    def xtime(a):
        return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1

    def gmul(a, b):
        r = 0
        for _ in range(8):
            if b & 1:
                r ^= a
            a = xtime(a)
            b >>= 1
        return r

    inv = [0] * 256
    for i in range(1, 256):
        for j in range(1, 256):
            if gmul(i, j) == 1:
                inv[i] = j
                break
    sbox = []
    for i in range(256):
        x = inv[i] if i else 0
        y = x
        for _ in range(4):
            y = ((y << 1) | (y >> 7)) & 0xFF
            x ^= y
        sbox.append(x ^ 0x63)
    _SBOX = sbox
    _INV_SBOX = [0] * 256
    for i, v in enumerate(sbox):
        _INV_SBOX[v] = i


class _PureAES:
    """AES-256 ECB block primitive (key schedule + rounds), fallback path."""

    def __init__(self, key: bytes):
        _build_sbox()
        assert len(key) == 32
        self.rounds = 14
        self.rk = self._expand(key)

    def _expand(self, key):
        nk, nr = 8, 14
        w = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
        rcon = 1
        for i in range(nk, 4 * (nr + 1)):
            t = list(w[i - 1])
            if i % nk == 0:
                t = t[1:] + t[:1]
                t = [_SBOX[b] for b in t]
                t[0] ^= rcon
                rcon = ((rcon << 1) ^ 0x1B) & 0xFF if rcon & 0x80 else rcon << 1
            elif i % nk == 4:
                t = [_SBOX[b] for b in t]
            w.append([a ^ b for a, b in zip(w[i - nk], t)])
        return [sum((w[4 * r + c] for c in range(4)), []) for r in range(nr + 1)]

    @staticmethod
    def _xt(a):
        return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1

    def _mix(self, s, inv=False):
        out = [0] * 16
        for c in range(4):
            col = s[4 * c:4 * c + 4]
            if not inv:
                out[4 * c + 0] = self._xt(col[0]) ^ (self._xt(col[1]) ^ col[1]) ^ col[2] ^ col[3]
                out[4 * c + 1] = col[0] ^ self._xt(col[1]) ^ (self._xt(col[2]) ^ col[2]) ^ col[3]
                out[4 * c + 2] = col[0] ^ col[1] ^ self._xt(col[2]) ^ (self._xt(col[3]) ^ col[3])
                out[4 * c + 3] = (self._xt(col[0]) ^ col[0]) ^ col[1] ^ col[2] ^ self._xt(col[3])
            else:
                def g(a, b):
                    r = 0
                    for _ in range(8):
                        if b & 1:
                            r ^= a
                        a = self._xt(a)
                        b >>= 1
                    return r
                out[4 * c + 0] = g(col[0], 14) ^ g(col[1], 11) ^ g(col[2], 13) ^ g(col[3], 9)
                out[4 * c + 1] = g(col[0], 9) ^ g(col[1], 14) ^ g(col[2], 11) ^ g(col[3], 13)
                out[4 * c + 2] = g(col[0], 13) ^ g(col[1], 9) ^ g(col[2], 14) ^ g(col[3], 11)
                out[4 * c + 3] = g(col[0], 11) ^ g(col[1], 13) ^ g(col[2], 9) ^ g(col[3], 14)
        return out

    @staticmethod
    def _shift(s, inv=False):
        out = [0] * 16
        for r in range(4):
            for c in range(4):
                src = (c + r) % 4 if not inv else (c - r) % 4
                out[4 * c + r] = s[4 * src + r]
        return out

    def encrypt_block(self, block: bytes) -> bytes:
        s = [b ^ k for b, k in zip(block, self.rk[0])]
        for rnd in range(1, self.rounds):
            s = [_SBOX[b] for b in s]
            s = self._shift(s)
            s = self._mix(s)
            s = [b ^ k for b, k in zip(s, self.rk[rnd])]
        s = [_SBOX[b] for b in s]
        s = self._shift(s)
        return bytes(b ^ k for b, k in zip(s, self.rk[self.rounds]))

    def decrypt_block(self, block: bytes) -> bytes:
        s = [b ^ k for b, k in zip(block, self.rk[self.rounds])]
        s = self._shift(s, inv=True)
        s = [_INV_SBOX[b] for b in s]
        for rnd in range(self.rounds - 1, 0, -1):
            s = [b ^ k for b, k in zip(s, self.rk[rnd])]
            s = self._mix(s, inv=True)
            s = self._shift(s, inv=True)
            s = [_INV_SBOX[b] for b in s]
        return bytes(b ^ k for b, k in zip(s, self.rk[0]))
