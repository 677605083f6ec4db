"""The web UI's JavaScript run by the port's copy of the JS engine
(clearcam_tpu_torch.jsengine) against the port's live server: the port's
NVR, server.http and utils.db behind the pages, as tests/test_ui_exec.py
runs them against the JAX package's, and the port's tools.uicheck offline
and live. One case runs the port's CPU BatchDetector on the dryrun graph in
the NVR loop, so that /get_preds carries tracked rows and the camera page's
overlay tick draws them."""
import json
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from chip_smoke import overlay_tick
from clearcam_tpu_torch.jsengine.dom import Browser, live_fetch
from clearcam_tpu_torch.jsengine.interp import to_py
from clearcam_tpu_torch.runtime.nvr import NVR, BatchDetector
from clearcam_tpu_torch.runtime.settings import GlobalSettings
from clearcam_tpu_torch.server.http import AppContext, serve
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.tools import uicheck
from clearcam_tpu_torch.utils.db import KVStore

WEB = Path(__file__).resolve().parent.parent / "clearcam_tpu_torch" / "server" / "web"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=10).read()


def _serve(tmp: Path, nvr: NVR):
    server = serve(AppContext(nvr.db, tmp / "data", nvr=nvr, settings=nvr.settings),
                   port=0, host="127.0.0.1")
    return server, f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture
def live(tmp_path):
    """The port's server over its NVR with no detector."""
    db = KVStore(tmp_path / "kv.db")
    nvr = NVR(db, tmp_path / "data", GlobalSettings(), detector=None,
              use_native_ingest=False)
    server, base = _serve(tmp_path, nvr)
    try:
        yield base
    finally:
        server.shutdown()
        nvr.stop()


def test_mainview_runs_against_the_ports_server(live):
    """tests/test_ui_exec.py's mainview drive: the camera grid, the alerts
    dialog, an alert made through the form and a zone saved by clicks, each
    read back from the server."""
    _get(f"{live}/add_camera?cam_name=ui_cam&src=synthetic://64x48")
    _get(f"{live}/edit_alert?cam=ui_cam&max=3&class_ids=0&window=30")
    b = Browser(_get(f"{live}/").decode(), fetch=live_fetch(live), hls=False)
    assert [el.text() for el in b.document.root.select("#cams .name")] == ["ui_cam"]
    b.call("openAlerts", "ui_cam")
    rows = b.el("alertsTable").js_get("querySelector")("tbody").js_get("children").items
    assert len(rows) == 1 and rows[0].js_get("children").items[2].text() == "3"
    b.call("resetAlertForm")
    b.el("alertClasses").js_get("options").items[2].js_set("selected", True)   # car
    b.el("alertMax").js_set("value", "5")
    b.call("createAlert")
    alerts = json.loads(_get(f"{live}/get_alerts?cam=ui_cam"))
    assert any(a["max"] == 5 and a["classes"] == [2] for a in alerts)
    b.call("openZone", "ui_cam")
    cv = b.el("zoneCanvas")
    cv.rect = (0.0, 0.0, 100.0, 100.0)
    b.run_script("zonePoints=[]")
    for x, y in [(10, 10), (90, 10), (50, 90)]:
        cv.dispatch("click", clientX=float(x), clientY=float(y))
    b.call("saveZone")
    s = json.loads(_get(f"{live}/get_settings?cam=ui_cam"))
    assert s["coords"] == [[0.1, 0.1], [0.9, 0.1], [0.5, 0.9]]


def test_cameraview_runs_against_the_ports_server(live):
    """The camera page as the port's server templates it: its title, camera,
    start time, the day's video and the 80 COCO labels."""
    _get(f"{live}/add_camera?cam_name=ui_cam&src=synthetic://64x48")
    html = _get(f"{live}/?cam=ui_cam&folder=2026-08-10&start=12").decode()
    b = Browser(html, fetch=live_fetch(live), hls=False)
    assert b.document.root.select("title")[0].text().endswith("ui_cam")
    assert to_py(b.get("CAM")) == "ui_cam" and to_py(b.get("START_TIME")) == 12
    assert b.document.get_element_by_id("player").js_get("src") == \
        "/day.mp4?cam=ui_cam&day=2026-08-10"
    labels = to_py(b.get("CLASS_LABELS"))
    assert labels[0] == "person" and len(labels) == 80


def test_uicheck_offline_clean_and_catches_injected_typo(tmp_path, monkeypatch):
    """The port's uicheck reads the port's pages; a typo'd identifier in a
    handler is reported."""
    assert uicheck.WEB == WEB
    assert uicheck.check_offline() == []
    assert uicheck.main(["--offline"]) == 0
    text = (WEB / "mainview.html").read_text().replace("searchByText()", "searchByTxet()", 1)
    (tmp_path / "mainview.html").write_text(text)
    monkeypatch.setattr(uicheck, "WEB", tmp_path)
    probs = uicheck.check_offline()
    assert probs and "searchByTxet" in probs[0]
    assert uicheck.main(["--offline"]) == 1


def test_uicheck_live_against_the_ports_server(live, capsys):
    _get(f"{live}/add_camera?cam_name=ui_cam&src=synthetic://64x48")
    assert uicheck.check_live(live) == []
    assert uicheck.main(["--url", live, "--json"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"ok": True,
                                                                     "problems": []}


def test_overlay_draws_the_cpu_detectors_tracked_rows(tmp_path):
    """The port's NVR loop with a CPU BatchDetector (the dryrun graph, seed-0
    weights, every COCO class tracked) on a synthetic camera: /get_preds
    carries tracked rows, the camera page's overlay tick (chip_smoke.py's
    phase 4 helper) draws one box per row, and uicheck's live check finds no
    problem."""
    db = KVStore(tmp_path / "kv.db")
    db.run_put("links", "gate", "synthetic://640x360")
    det = BatchDetector("dryrun", res=320, dtype=torch.float32, device="cpu")
    nvr = NVR(db, tmp_path / "data", GlobalSettings(), detector=det,
              classes={str(c) for c in range(80)}, use_native_ingest=False)
    loop = threading.Thread(target=nvr.run, kwargs={"tick_sleep": 0.02}, daemon=True)
    loop.start()
    server, base = _serve(tmp_path, nvr)
    try:
        deadline = time.time() + 60
        rows, drawn = overlay_tick(base, "gate")
        while rows == 0:
            assert time.time() < deadline, "no tracked rows within 60 s"
            time.sleep(0.1)
            rows, drawn = overlay_tick(base, "gate")
        assert drawn == rows
        assert uicheck.check_live(base) == []
    finally:
        server.shutdown()
        nvr.stop()
        loop.join(timeout=30)
    assert not loop.is_alive()
