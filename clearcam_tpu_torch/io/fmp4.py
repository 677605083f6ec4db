"""Pure-Python fragmented-MP4 muxer + TS->fMP4 remux driver.

Box-structure rewriting only — no transcode: the H.264 access units from
the NVR's own `.ts` HLS segments (io/mpegts.py) are length-prefixed into
mdat and described by moof/trun. Output plays in a plain ``<video>`` tag
(progressive fMP4), which is what makes day playback work air-gapped with
neither hls.js (CDN) nor ffmpeg present. The reference depends on ffmpeg
for every remux of this kind (utils/helpers.py:133-200) and on hls.js for
day playback (mainview.html:2678,2841).

Layout: one moof+mdat fragment per source TS segment, 90 kHz media
timescale (native TS units, no rescale losses), version-1 trun so negative
composition offsets from B-frames survive.
"""
from __future__ import annotations

import struct
from pathlib import Path

from . import h264, mpegts

TIMESCALE = 90000
DEFAULT_DUR = 3000                       # 30 fps fallback for lone samples
FLAG_KEY = 0x02000000                    # sample_depends_on = no others
FLAG_NONKEY = 0x01010000                 # depends + non-sync


def box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _avcc(sps: bytes, pps: bytes) -> bytes:
    """AVCDecoderConfigurationRecord (ISO 14496-15 5.2.4.1)."""
    return box(b"avcC",
               bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]),
               struct.pack(">H", len(sps)), sps,
               bytes([1]), struct.pack(">H", len(pps)), pps)


def init_segment(sps: bytes, pps: bytes) -> bytes:
    geo = h264.parse_sps(sps)
    w, h = geo["width"], geo["height"]
    avc1 = box(
        b"avc1",
        bytes(6), struct.pack(">H", 1),               # reserved + dref idx
        bytes(16),                                     # predef/reserved
        struct.pack(">HH", w, h),
        struct.pack(">II", 0x480000, 0x480000),        # 72 dpi
        bytes(4), struct.pack(">H", 1),                # frame count 1
        bytes(32),                                     # compressor name
        struct.pack(">Hh", 0x18, -1),                  # depth, color table
        _avcc(sps, pps))
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1), avc1)
    stbl = box(b"stbl", stsd,
               full_box(b"stts", 0, 0, struct.pack(">I", 0)),
               full_box(b"stsc", 0, 0, struct.pack(">I", 0)),
               full_box(b"stsz", 0, 0, struct.pack(">II", 0, 0)),
               full_box(b"stco", 0, 0, struct.pack(">I", 0)))
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                 full_box(b"url ", 0, 1)))
    vmhd = full_box(b"vmhd", 0, 1, bytes(8))
    minf = box(b"minf", vmhd, dinf, stbl)
    hdlr = full_box(b"hdlr", 0, 0, bytes(4), b"vide", bytes(12),
                    b"clearcam_tpu video\x00")
    mdhd = full_box(b"mdhd", 0, 0,
                    struct.pack(">IIIIHH", 0, 0, TIMESCALE, 0, 0x55C4, 0))
    mdia = box(b"mdia", mdhd, hdlr, minf)
    tkhd = full_box(b"tkhd", 0, 3,
                    struct.pack(">IIII", 0, 0, 1, 0),      # times, track 1
                    struct.pack(">I", 0),                  # duration
                    bytes(8), struct.pack(">hhhh", 0, 0, 1 << 8, 0),
                    # unity matrix
                    struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                0x40000000),
                    struct.pack(">II", w << 16, h << 16))
    trak = box(b"trak", tkhd, mdia)
    mvhd = full_box(b"mvhd", 0, 0,
                    struct.pack(">IIII", 0, 0, TIMESCALE, 0),
                    struct.pack(">IH", 0x00010000, 0x0100), bytes(10),
                    struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                                0x40000000),
                    bytes(24), struct.pack(">I", 2))       # next track id
    trex = full_box(b"trex", 0, 0,
                    struct.pack(">IIIII", 1, 1, 0, 0, FLAG_NONKEY))
    moov = box(b"moov", mvhd, trak, box(b"mvex", trex))
    ftyp = box(b"ftyp", b"iso5", struct.pack(">I", 512),
               b"iso5isomavc1mp41")
    return ftyp + moov


def fragment(seq: int, samples: list[dict], base_dts: int) -> bytes:
    """samples: [{data, dur, key, cts}] -> moof+mdat bytes."""
    mfhd = full_box(b"mfhd", 0, 0, struct.pack(">I", seq))
    tfhd = full_box(b"tfhd", 0, 0x020000, struct.pack(">I", 1))
    tfdt = full_box(b"tfdt", 1, 0, struct.pack(">Q", base_dts))
    rows = b"".join(
        struct.pack(">IIIi", s["dur"], len(s["data"]),
                    FLAG_KEY if s["key"] else FLAG_NONKEY, s["cts"])
        for s in samples)
    # trun flags: data-offset | per-sample duration+size+flags+cts
    trun_wo_offset = full_box(b"trun", 1, 0xF01,
                              struct.pack(">Ii", len(samples), 0), rows)
    moof_len = 8 + len(mfhd) + 8 + len(tfhd) + len(tfdt) + len(trun_wo_offset)
    data_offset = moof_len + 8                     # into mdat payload
    trun = full_box(b"trun", 1, 0xF01,
                    struct.pack(">Ii", len(samples), data_offset), rows)
    moof = box(b"moof", mfhd, box(b"traf", tfhd, tfdt, trun))
    mdat = box(b"mdat", b"".join(s["data"] for s in samples))
    return moof + mdat


class Remuxer:
    """Streaming TS->fMP4: feed whole segments, write() gets called with
    init bytes first, then one fragment per segment. Timestamps are rebased
    to a continuous line across recorder restarts (each ffmpeg respawn
    starts near 0 again via -avoid_negative_ts make_zero) and across 33-bit
    PTS wrap."""

    MAX_GAP = 10 * TIMESCALE

    def __init__(self, write):
        self.write = write
        self.seq = 0
        self.offset = 0
        self.last_end = 0
        self.inited = False
        self.geometry: tuple | None = None
        self.skipped = 0

    def add_segment(self, path: str | Path) -> None:
        try:
            d = mpegts.read_segment(path)
            units = d.units
            if not units or d.sps is None or d.pps is None:
                self.skipped += 1
                return
            geo = h264.parse_sps(d.sps)
        except Exception:  # noqa: BLE001 — truncated/corrupt segment: the
            self.skipped += 1  # skip contract must hold for THROWING parses
            return             # too, or one bad .ts 500s /day.mp4 forever
            # (bit-flipped SPS -> parse_sps IndexError, short PMT, ...)
        if not self.inited:
            self.write(init_segment(d.sps, d.pps))
            self.geometry = (geo["width"], geo["height"])
            self.inited = True
        elif (geo["width"], geo["height"]) != self.geometry:
            self.skipped += 1              # resolution changed mid-day: a
            return                         # single avc1 track can't carry it
        first = units[0].dts
        if not (self.last_end <= first + self.offset
                <= self.last_end + self.MAX_GAP):
            self.offset = self.last_end - first
        samples = []
        for i, u in enumerate(units):
            dur = (units[i + 1].dts - u.dts) if i + 1 < len(units) else 0
            if dur <= 0 or dur > self.MAX_GAP:
                dur = samples[-1]["dur"] if samples else DEFAULT_DUR
            # cts through the 33-bit PTS wrap: pts can wrap while dts has
            # not (B-frame reorder at the 26.5 h boundary) — interpret the
            # difference mod 2^33 as a small signed offset, or the >IIIi
            # pack below overflows with struct.error mid-stream
            cts = int(u.pts - u.dts) & ((1 << 33) - 1)
            if cts >= 1 << 32:
                cts -= 1 << 33
            cts = max(-(1 << 31), min((1 << 31) - 1, cts))  # garbage ts clamp
            samples.append({"data": h264.annexb_to_avcc(u.nals), "dur": dur,
                            "key": u.key, "cts": cts})
        base = units[0].dts + self.offset
        self.seq += 1
        self.write(fragment(self.seq, samples, base))
        self.last_end = base + sum(s["dur"] for s in samples)


def remux_segments(ts_paths, out_path: str | Path) -> int:
    """Remux an ordered list of .ts segments into one fMP4 file; returns
    the count of segments skipped (unparseable / resolution changed)."""
    with open(out_path, "wb") as f:
        r = Remuxer(f.write)
        for p in ts_paths:
            r.add_segment(p)
        if not r.inited:
            raise ValueError("no decodable video in any segment")
    return r.skipped
