"""Edge viewer client for the clearcam.org relay.

Python equivalent of the mobile viewer protocol (Android VideoHelper.kt /
HomeScreen.kt; iOS LiveViewController.m / DeviceStreamViewController.m):

  validate_user      GET /validate_user?session_token=           (MainActivity.kt:228)
  ping               GET /ping                                    (HomeScreen.kt:241)
  list_devices       GET /get_live_devicesv2?session_token=       (VideoHelper.kt:238)
  events             GET /events?session_token=&newest_creation_time= (VideoHelper.kt:258)
  live stream link   GET /get_stream_download_link?session_token=&name= (VideoHelper.kt:191)
  release stream     GET /delete_stream_download_link?...          (VideoHelper.kt:220)
  toggle alerts      GET /toggle_alerts                            (HomeScreen.kt:1131)
  register device    POST /add_device                              (SettingsScreen.kt:289)

Event clips and live segments arrive as `.aes` blobs — AES-256-CBC with the
shared magic-checked format (cloud/crypto.py) — and decrypt to mp4. `base_url`
is injectable so a self-hosted relay (or the tests' mock) works unchanged.
"""
from __future__ import annotations

import json
import urllib.parse
import urllib.request
from pathlib import Path

from .crypto import decrypt_bytes

DEFAULT_BASE = "https://clearcam.org"


class ViewerClient:
    def __init__(self, session_token: str, base_url: str = DEFAULT_BASE,
                 timeout: float = 15.0):
        self.token = session_token
        self.base = base_url.rstrip("/")
        self.timeout = timeout

    # -- plumbing -----------------------------------------------------------
    def _get(self, path: str, **params):
        params = {k: v for k, v in params.items() if v is not None}
        q = urllib.parse.urlencode(params)
        url = f"{self.base}{path}" + (f"?{q}" if q else "")
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            body = r.read()
        try:
            return json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return body

    def _get_raw(self, url: str) -> bytes:
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            return r.read()

    # -- account ------------------------------------------------------------
    def validate_user(self) -> bool:
        try:
            self._get("/validate_user", session_token=self.token)
            return True
        except Exception:
            return False

    def ping(self) -> bool:
        try:
            self._get("/ping")
            return True
        except Exception:
            return False

    def register_device(self, device_token: str, platform: str = "android") -> bool:
        data = urllib.parse.urlencode({
            "session_token": self.token, "device_token": device_token,
            "platform": platform}).encode()
        req = urllib.request.Request(f"{self.base}/add_device", data=data)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return 200 <= r.status < 300
        except Exception:
            return False

    # -- devices / live -----------------------------------------------------
    def list_devices(self) -> list:
        out = self._get("/get_live_devicesv2", session_token=self.token)
        if isinstance(out, list):
            return out
        # non-JSON 200 body (relay HTML error page) -> empty, not a crash
        return out.get("devices", []) if isinstance(out, dict) else []

    def get_stream_link(self, name: str):
        out = self._get("/get_stream_download_link", session_token=self.token,
                        name=name)
        return out.get("download_link") if isinstance(out, dict) else None

    def release_stream(self, name: str):
        try:
            self._get("/delete_stream_download_link", session_token=self.token,
                      name=name)
        except Exception:
            pass

    def toggle_alerts(self, name: str, on: bool) -> bool:
        try:
            self._get("/toggle_alerts", session_token=self.token, name=name,
                      alerts_on=int(on))
            return True
        except Exception:
            return False

    def fetch_live_segment(self, name: str, key: str) -> bytes | None:
        """Poll the device's relay segment and decrypt it to mp4 bytes
        (VideoHelper.kt:187-232)."""
        link = self.get_stream_link(name)
        if not link:
            return None
        try:
            return decrypt_bytes(self._get_raw(link), key)
        except Exception:
            return None

    # -- events --------------------------------------------------------------
    def list_events(self, newest_creation_time: int | float = 0) -> list:
        out = self._get("/events", session_token=self.token,
                        newest_creation_time=newest_creation_time)
        if isinstance(out, list):
            return out
        return out.get("events", []) if isinstance(out, dict) else []

    def download_event(self, event: dict, key: str, dst: Path | None = None) -> bytes:
        """Download + decrypt one event clip (VideoHelper.kt:285-340).
        `event` carries a presigned 'url' (or 'download_url')."""
        url = event.get("url") or event.get("download_url")
        clip = decrypt_bytes(self._get_raw(url), key)
        if dst is not None:
            Path(dst).write_bytes(clip)
        return clip
