"""Cloud relay clients: push notifications, encrypted event-clip upload,
low-res live-segment relay.

Protocol parity with clearcam.org clients in the reference:
  * send_notif — multipart POST to /send (helpers.py:18-57)
  * upload_file — GET /upload?filename&session_token&size for a presigned URL,
    then PUT with 10 retries/backoff (helpers.py:237-307)
  * upload_to_r2 — bare presigned PUT (clearcam.py:1195-1212)
  * check_upload_link — poll /get_stream_upload_link, which also returns the
    remote alerts_on toggle (clearcam.py:556-572)
  * export_clip / export_and_upload — HLS .ts concat -> mp4 (<=10MB re-encode
    loop), thumbnail muxed as attached_pic, AES-CBC encrypt, upload
    (helpers.py:133-211)

All network calls are daemon-thread friendly and fail soft (log + False).
"""
from __future__ import annotations

import http.client
import json
import os
import subprocess
import time
import urllib.parse
import urllib.request
import uuid
from collections import deque
from pathlib import Path

from .crypto import encrypt_file
from ..runtime.ingest import find_ffmpeg

NOTIF_URL = "https://www.clearcam.org/send"
API = "https://clearcam.org"
MAX_CLIP_BYTES = 10 * 1024 * 1024


def send_notif(session_token: str, text: str | None = None,
               body_text: str | None = None) -> bool:
    """Multipart push-notification POST (helpers.py:18-57)."""
    boundary = f"Boundary-{uuid.uuid4()}"
    parts = [f"--{boundary}",
             'Content-Disposition: form-data; name="session_token"', "",
             session_token, f"--{boundary}--", ""]
    if text is not None:
        parts.extend([f"--{boundary}",
                      'Content-Disposition: form-data; name="text"', "", text])
    if body_text is not None:
        parts.extend([f"--{boundary}",
                      'Content-Disposition: form-data; name="body_text"', "",
                      body_text])
    body = "\r\n".join(parts).encode("utf-8")
    try:
        req = urllib.request.Request(NOTIF_URL, data=body, headers={
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=15) as resp:
            resp.read()
            return 200 <= resp.status < 300
    except Exception as e:  # noqa: BLE001
        print(f"send_notif error: {e}")
        return False


def put_presigned(file_path: Path, signed_url: str) -> bool:
    """PUT a file body to a presigned URL (clearcam.py:1195-1212)."""
    file_path = Path(file_path)
    try:
        u = urllib.parse.urlparse(signed_url)
        conn_cls = http.client.HTTPSConnection if u.scheme == "https" else http.client.HTTPConnection
        conn = conn_cls(u.netloc, timeout=30)
        with open(file_path, "rb") as f:
            # explicit Content-Length: py3.12 http.client otherwise streams
            # file bodies chunked, which presigned S3/R2 PUTs reject
            conn.request("PUT", u.path + "?" + u.query, body=f, headers={
                "Content-Type": "application/octet-stream",
                "Content-Length": str(file_path.stat().st_size)})
            resp = conn.getresponse()
        conn.close()
        return 200 <= resp.status < 300
    except Exception as e:  # noqa: BLE001
        print(f"presigned PUT error: {e}")
        return False


def upload_file(file_path: Path, session_token: str, retries: int = 10) -> bool:
    """Presigned-URL upload with retry/backoff; deletes the local file after
    (helpers.py:237-307)."""
    file_path = Path(file_path)
    if not file_path.exists():
        return False
    size = file_path.stat().st_size
    try:
        q = urllib.parse.urlencode({"filename": file_path.name,
                                    "session_token": session_token,
                                    "size": str(size)})
        with urllib.request.urlopen(f"{API}/upload?{q}", timeout=10) as resp:
            presigned = json.loads(resp.read().decode()).get("url")
        if not presigned:
            return False
    except Exception as e:  # noqa: BLE001
        print(f"upload link error: {e}")
        return False
    ok = False
    for attempt in range(retries):
        if put_presigned(file_path, presigned):
            ok = True
            break
        if attempt < 3:
            time.sleep(10 * attempt)
    try:
        file_path.unlink()
    except OSError:
        pass
    return ok


def check_upload_link(cam_name: str, session_token: str):
    """-> (upload_link | None, alerts_on | None) from the relay
    (clearcam.py:556-572)."""
    try:
        q = urllib.parse.urlencode({"name": urllib.parse.quote(cam_name),
                                    "session_token": session_token})
        with urllib.request.urlopen(f"{API}/get_stream_upload_link?{q}",
                                    timeout=10) as resp:
            if resp.status != 200:
                return None, None
            data = json.loads(resp.read().decode())
            return data.get("upload_link"), data.get("alerts_on") == 1
    except Exception:  # noqa: BLE001
        return None, None


# ---------------------------------------------------------------------------
# clip export (ffmpeg)
# ---------------------------------------------------------------------------

def export_clip(stream_dir: Path, output_path: Path, live: bool = False,
                length: float = 5, end: float = 0, start: float | None = None) -> bool:
    """Concat recent HLS segments into an mp4. live=True produces the 240p
    CRF32 relay segment; otherwise re-encode until <=10MB (helpers.py:133-200)."""
    ff = find_ffmpeg()
    segments = sorted(Path(stream_dir).glob("*.ts"), key=os.path.getmtime)
    if not segments:
        return False
    cutoff = (os.path.getmtime(segments[0]) + start) if start is not None else time.time() - length
    stop = (os.path.getmtime(segments[0]) + start + length) if start is not None else time.time() - end
    recent = deque(f for f in segments if cutoff <= os.path.getmtime(f) <= stop)
    if ff is None:
        if live:
            # the 240p relay segment is a re-encode — no ffmpeg, no clip
            print("export_clip: ffmpeg unavailable for the 240p relay")
            return False
        # air-gapped fallback: pure-Python TS->fMP4 remux (io/fmp4.py) —
        # stream copy, so the <=10MB re-encode ladder doesn't apply; the
        # uploader tolerates bigger clips, the reference would just fail
        if not recent:
            return False
        from ..io import fmp4
        output_path.parent.mkdir(parents=True, exist_ok=True)
        try:
            fmp4.remux_segments(list(recent), output_path)
            return True
        except Exception as e:  # noqa: BLE001
            print(f"export_clip: remux failed: {e}")
            output_path.unlink(missing_ok=True)
            return False
    # unique per-export work file: the 4 s live-relay thread and event-clip
    # exports run concurrently against the SAME stream_dir — a shared
    # concat_list.txt let one overwrite the other's segment list mid-export
    # (silently wrong clip contents)
    import uuid as _uuid
    concat = Path(stream_dir) / f"concat_{_uuid.uuid4().hex[:12]}.txt"
    concat.write_text("".join(f"file '{s.resolve()}'\n" for s in recent))
    output_path.parent.mkdir(parents=True, exist_ok=True)
    base = [ff, "-y", "-f", "concat", "-safe", "0", "-i", str(concat),
            "-loglevel", "quiet", "-an", "-pix_fmt", "yuv420p", "-c:v", "libx264"]
    try:
        if live:
            cmd = base + ["-vf", "scale=-2:240,fps=24,format=yuv420p",
                          "-preset", "veryslow", "-crf", "32", str(output_path)]
            return subprocess.run(cmd).returncode == 0
        crf = 18
        while True:
            if subprocess.run(
                    base + ["-crf", str(crf), str(output_path)]).returncode != 0:
                return False
            if output_path.stat().st_size < MAX_CLIP_BYTES * 0.9 or crf >= 48:
                return True
            crf += 5
    finally:
        concat.unlink(missing_ok=True)


def export_and_upload(cam_name: str, thumbnail: Path, userID: str, key: str,
                      base_dir: Path, start=None, end=0, length=20,
                      wait: bool = False) -> bool:
    """Event clip pipeline: wait for segments, export, mux thumbnail
    (attached_pic), encrypt, upload (helpers.py:202-211)."""
    if wait:
        time.sleep(10)
    from datetime import datetime
    clips = base_dir / "cameras" / cam_name / "event_clips"
    clips.mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    mp4 = clips / f"{stamp}.mp4"
    day = datetime.now().strftime("%Y-%m-%d")
    if not export_clip(base_dir / "cameras" / cam_name / "streams" / day, mp4,
                       length=length, start=start, end=end):
        return False
    ff = find_ffmpeg()
    if ff is not None:
        # thumbnail mux is cosmetic: when export_clip succeeded via the
        # no-ffmpeg fMP4 fallback, upload WITHOUT the attached_pic rather
        # than TypeError-ing on ff=None and dropping the whole clip
        tmp = clips / f"{stamp}_temp.mp4"
        subprocess.run([ff, "-i", str(mp4), "-i", str(thumbnail), "-map", "0",
                        "-map", "1", "-c", "copy", "-disposition:v:1",
                        "attached_pic", "-y", str(tmp)])
        if tmp.exists():
            os.replace(tmp, mp4)
    aes = Path(f"{mp4}.aes")
    if not encrypt_file(mp4, aes, key):
        return False
    ok = upload_file(aes, userID)
    try:
        mp4.unlink()
    except OSError:
        pass
    return ok


def upload_live_segment(stream_dir: Path, signed_url: str, key: str) -> bool:
    """4-second low-res relay segment: export, encrypt, presigned PUT
    (clearcam.py:548-554). Work files live under the camera's own stream_dir
    (the reference uses fixed CWD paths, clearcam.py:549 — with one relay
    thread per camera every 4 s that cross-contaminates uploads between
    cameras; per-camera paths fix that). The name is unique per call: a
    veryslow encode taking >4 s overlaps the next relay thread, and a
    shared file let one thread's cleanup unlink the other's upload."""
    import uuid as _uuid
    mp4 = Path(stream_dir) / f"live_segment_{_uuid.uuid4().hex[:12]}.mp4"
    if not export_clip(stream_dir, mp4, live=True):
        return False
    aes = Path(f"{mp4}.aes")
    try:
        if not encrypt_file(mp4, aes, key):
            return False
        return put_presigned(aes, signed_url)
    finally:
        for p in (mp4, aes):
            try:
                p.unlink()
            except OSError:
                pass
