"""Pure-Python MPEG-TS demuxer (video elementary stream only).

Reads the H.264 `.ts` HLS segments the NVR's own recorder writes
(runtime/ingest.hls_record_cmd: `-c copy -an -f hls`) and yields access
units with timestamps — the input side of the TS->fMP4 remuxer that serves
`GET /day.mp4` and the ffmpeg-free clip export (the reference requires
ffmpeg for all remuxing, utils/helpers.py:133-200).

Scope: PAT/PMT parse to find the first H.264 video PID, PES reassembly,
PTS/DTS extraction. No PCR handling (timestamps come from PES), no audio
(the recorder strips it with -an), no scrambling.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from . import h264

PKT = 188
H264_STREAM_TYPES = {0x1B}          # AVC video (ISO 13818-1 table 2-34)


@dataclass
class AccessUnit:
    pts: int                # 90 kHz
    dts: int                # 90 kHz
    key: bool               # contains an IDR slice
    nals: list              # Annex-B NAL units (start codes stripped)


def _pes_timestamp(b: bytes, off: int) -> int:
    """33-bit timestamp from the 5-byte PES marker encoding."""
    return (((b[off] >> 1) & 0x07) << 30) | (b[off + 1] << 22) \
        | ((b[off + 2] >> 1) << 15) | (b[off + 3] << 7) | (b[off + 4] >> 1)


class TSDemuxer:
    """Feed 188-byte-aligned TS data; collect video access units.

    One PES packet per access unit (how ffmpeg's mpegts muxer packetizes a
    copied H.264 stream); the PES payload is an Annex-B byte stream.
    """

    def __init__(self):
        self.pmt_pid: int | None = None
        self.video_pid: int | None = None
        self._pes = bytearray()
        self._have_pes = False
        self.units: list[AccessUnit] = []
        self.sps: bytes | None = None
        self.pps: bytes | None = None

    def feed(self, data: bytes) -> None:
        for i in range(0, len(data) - PKT + 1, PKT):
            pkt = data[i:i + PKT]
            if pkt[0] != 0x47:
                continue            # lost sync: skip (HLS segments are clean)
            pusi = (pkt[1] >> 6) & 1
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            afc = (pkt[3] >> 4) & 3
            off = 4
            if afc in (2, 3):
                off += 1 + pkt[4]   # adaptation field
            if afc in (2, 0) or off >= PKT:
                continue            # no payload
            payload = pkt[off:]
            if pid == 0:
                self._parse_pat(payload, pusi)
            elif pid == self.pmt_pid:
                self._parse_pmt(payload, pusi)
            elif pid == self.video_pid:
                self._video_payload(payload, pusi)

    def _psi(self, payload: bytes, pusi: int) -> bytes:
        """Skip the pointer_field on section starts."""
        return payload[1 + payload[0]:] if pusi else payload

    def _parse_pat(self, payload: bytes, pusi: int) -> None:
        if not pusi or self.pmt_pid is not None:
            return
        s = self._psi(payload, pusi)
        if not s or s[0] != 0x00:
            return
        section_len = ((s[1] & 0x0F) << 8) | s[2]
        # programs run from byte 8 to section end minus CRC32
        for j in range(8, 3 + section_len - 4, 4):
            prog = (s[j] << 8) | s[j + 1]
            pid = ((s[j + 2] & 0x1F) << 8) | s[j + 3]
            if prog != 0:           # 0 = network PID
                self.pmt_pid = pid
                return

    def _parse_pmt(self, payload: bytes, pusi: int) -> None:
        if not pusi or self.video_pid is not None:
            return
        s = self._psi(payload, pusi)
        if not s or s[0] != 0x02:
            return
        section_len = ((s[1] & 0x0F) << 8) | s[2]
        program_info_len = ((s[10] & 0x0F) << 8) | s[11]
        j = 12 + program_info_len
        end = 3 + section_len - 4   # minus CRC32
        while j + 5 <= end:
            stype = s[j]
            pid = ((s[j + 1] & 0x1F) << 8) | s[j + 2]
            es_info_len = ((s[j + 3] & 0x0F) << 8) | s[j + 4]
            if stype in H264_STREAM_TYPES:
                self.video_pid = pid
                return
            j += 5 + es_info_len

    def _video_payload(self, payload: bytes, pusi: int) -> None:
        if pusi:
            self._flush_pes()
            self._have_pes = True
            self._pes = bytearray(payload)
        elif self._have_pes:
            self._pes += payload

    def _flush_pes(self) -> None:
        if not self._have_pes or len(self._pes) < 9:
            self._have_pes = False
            return
        b = bytes(self._pes)
        self._have_pes = False
        if b[:3] != b"\x00\x00\x01":
            return
        flags = b[7]
        header_len = b[8]
        pts = dts = 0
        if flags & 0x80:
            pts = _pes_timestamp(b, 9)
            dts = _pes_timestamp(b, 14) if flags & 0x40 else pts
        es = b[9 + header_len:]
        nals = h264.split_annexb(es)
        if not nals:
            return
        for n in nals:
            t = h264.nal_type(n)
            if t == h264.NAL_SPS:
                self.sps = n
            elif t == h264.NAL_PPS:
                self.pps = n
        self.units.append(AccessUnit(pts=pts, dts=dts,
                                     key=h264.is_idr(nals), nals=nals))

    def finish(self) -> list[AccessUnit]:
        self._flush_pes()
        return self.units


def read_segment(path: str | Path) -> TSDemuxer:
    d = TSDemuxer()
    d.feed(Path(path).read_bytes())
    d.finish()
    return d
