"""Minimal H.264 (AVC) bitstream helpers for the TS->fMP4 remuxer.

Only what remuxing a *copy* stream needs (no decoding): Annex-B NAL
splitting, SPS parsing for the sample-entry geometry (width/height,
profile/level), and Annex-B -> AVCC (length-prefixed) access-unit
conversion. The reference leans on ffmpeg for every remux
(utils/helpers.py:133-200); this keeps day playback and clip export alive
on an air-gapped host with no ffmpeg.
"""
from __future__ import annotations

import struct

# NAL unit types (ISO 14496-10 table 7-1)
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9


def split_annexb(buf: bytes) -> list[bytes]:
    """Split an Annex-B byte stream into NAL units (start codes stripped).

    Handles both 3- and 4-byte start codes; bytes before the first start
    code are ignored (they can only be a truncated unit from a previous
    packetization layer).
    """
    nals = []
    i = buf.find(b"\x00\x00\x01")
    while i != -1:
        start = i + 3
        j = buf.find(b"\x00\x00\x01", start)
        end = len(buf) if j == -1 else j
        # rbsp_stop_one_bit guarantees a NAL's last byte is nonzero, so any
        # trailing zeros belong to the next start code / trailing_zero_8bits
        nals.append(buf[start:end].rstrip(b"\x00"))
        i = j
    return [n for n in nals if n]


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F if nal else 0


def _unescape_rbsp(data: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    i = 0
    while i < len(data):
        if i + 2 < len(data) and data[i] == 0 and data[i + 1] == 0 \
                and data[i + 2] == 3:
            out += b"\x00\x00"
            i += 3
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        """Exp-Golomb unsigned."""
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 31:
                raise ValueError("bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)


def parse_sps(sps: bytes) -> dict:
    """Geometry + profile info from a seq_parameter_set NAL (with header
    byte). Returns {profile, compat, level, width, height}."""
    r = _BitReader(_unescape_rbsp(sps[1:]))
    profile = r.u(8)
    compat = r.u(8)
    level = r.u(8)
    r.ue()  # seq_parameter_set_id
    chroma_format = 1
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134):
        chroma_format = r.ue()
        if chroma_format == 3:
            r.u(1)  # separate_colour_plane
        r.ue()      # bit_depth_luma_minus8
        r.ue()      # bit_depth_chroma_minus8
        r.u(1)      # qpprime_y_zero_transform_bypass
        if r.u(1):  # seq_scaling_matrix_present
            for i in range(8 if chroma_format != 3 else 12):
                if r.u(1):
                    # skip scaling list
                    size = 16 if i < 6 else 64
                    last, nxt = 8, 8
                    for _ in range(size):
                        if nxt:
                            nxt = (last + r.se() + 256) % 256
                        last = nxt or last
    r.ue()  # log2_max_frame_num_minus4
    poc_type = r.ue()
    if poc_type == 0:
        r.ue()
    elif poc_type == 1:
        r.u(1)
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    r.ue()  # max_num_ref_frames
    r.u(1)  # gaps_in_frame_num_value_allowed
    pic_w_mbs = r.ue() + 1
    pic_h_map = r.ue() + 1
    frame_mbs_only = r.u(1)
    if not frame_mbs_only:
        r.u(1)  # mb_adaptive_frame_field
    r.u(1)      # direct_8x8_inference
    crop_l = crop_r = crop_t = crop_b = 0
    if r.u(1):  # frame_cropping
        crop_l, crop_r, crop_t, crop_b = r.ue(), r.ue(), r.ue(), r.ue()
    # crop unit sizes (14496-10 7-19..7-22): chroma 4:2:0/4:2:2 halve width,
    # 4:2:0 halves height; field coding doubles the vertical crop unit
    sub_w = 1 if chroma_format in (0, 3) else 2
    sub_h = 2 if chroma_format == 1 else 1
    width = pic_w_mbs * 16 - sub_w * (crop_l + crop_r)
    height = (2 - frame_mbs_only) * pic_h_map * 16 \
        - sub_h * (2 - frame_mbs_only) * (crop_t + crop_b)
    return {"profile": profile, "compat": compat, "level": level,
            "width": width, "height": height}


def annexb_to_avcc(nals: list[bytes]) -> bytes:
    """Length-prefixed (4-byte) sample payload for mdat; parameter sets and
    AUDs are carried out-of-band in avcC / implied, so they are dropped."""
    out = bytearray()
    for nal in nals:
        if nal_type(nal) in (NAL_SPS, NAL_PPS, NAL_AUD):
            continue
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def is_idr(nals: list[bytes]) -> bool:
    return any(nal_type(n) == NAL_IDR for n in nals)
