"""Service-level NVR federation over HTTP (DCN between hosts).

Multiple NVR hosts, one pane of glass: every peer periodically registers its
camera list with a primary; the primary serves a merged inventory with
absolute URLs so browsers/apps reach each host's HLS and event media
directly (frames never proxy through the primary). Stale peers age out.

Device-level scale-out (shared jax.distributed mesh across the same hosts)
lives in parallel/federation.py — the two compose but don't require each
other.

Endpoints (server/http.py):
    POST /federation/register   {"host": "http://10.0.0.2:8080",
                                 "cameras": ["gate", ...]}
    GET  /federation/cameras    [{"host": ..., "cam": ..., "url": ...}, ...]
                                incl. this host's own cameras
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

STALE_S = 30.0


class FederationPeer:
    """Background registration loop run on every non-primary host."""

    def __init__(self, primary_url: str, self_url: str, list_cameras,
                 interval: float = 10.0):
        self.primary_url = primary_url.rstrip("/")
        self.self_url = self_url
        self.list_cameras = list_cameras      # callable -> [cam names]
        self.interval = interval
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def stop(self):
        self._stop.set()

    def register_once(self) -> bool:
        body = json.dumps({"host": self.self_url,
                           "cameras": list(self.list_cameras())}).encode()
        req = urllib.request.Request(
            f"{self.primary_url}/federation/register", data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=5) as r:
                return r.status == 200
        except Exception as e:  # noqa: BLE001
            print(f"federation register failed: {e}")
            return False

    def _loop(self):
        while True:
            self.register_once()
            if self._stop.wait(self.interval):
                return


class FederationRegistry:
    """Primary-side peer table (held on AppContext). Bounded: stale peers are
    evicted on read, and registration evicts the oldest peer at the cap so a
    hostile/looping client can't grow the table without bound."""

    MAX_PEERS = 256

    def __init__(self, stale_s: float = STALE_S):
        self.peers: dict[str, dict] = {}
        self.stale_s = stale_s
        self.lock = threading.Lock()

    def register(self, host: str, cameras: list[str]):
        with self.lock:
            self.peers[host] = {"cameras": list(cameras[:512]),
                                "last_seen": time.time()}
            while len(self.peers) > self.MAX_PEERS:
                oldest = min(self.peers, key=lambda h: self.peers[h]["last_seen"])
                del self.peers[oldest]

    def cameras(self) -> list[dict]:
        now = time.time()
        out = []
        with self.lock:
            for host in [h for h, p in self.peers.items()
                         if now - p["last_seen"] > self.stale_s]:
                del self.peers[host]
            for host, p in self.peers.items():
                for cam in p["cameras"]:
                    out.append({"host": host, "cam": cam,
                                "url": f"{host.rstrip('/')}/?cam={cam}"})
        return out
