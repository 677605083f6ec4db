"""Deployment UI verifier: execute the served web UI with the in-repo JS
engine — no browser required on the host.

    python -m clearcam_tpu.tools.uicheck --url http://nvr-host:8080
    python -m clearcam_tpu.tools.uicheck --offline     # repo files only

Checks, all read-only (GETs plus the /event_thumbs listing POST):
  1. every inline <script> and on* handler on the served pages PARSES and
     every identifier it references resolves (typo net);
  2. mainview boots against the live API: the camera grid renders exactly
     /list_cameras, the day dropdown is populated, feature flags from
     /get_global_settings are applied;
  3. each camera's page (/?cam=) boots and the /get_preds overlay tick
     runs without throwing (the reference never had any frontend check —
     SURVEY.md §4; this is the air-gapped stand-in for a browser smoke).

Exit code 0 = all good; 1 = problems (listed on stdout, or --json).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.parse
import urllib.request
from pathlib import Path

from ..jsengine.check import page_problems
from ..jsengine.dom import Browser, live_fetch
from ..jsengine.interp import JSThrow, to_py

WEB = Path(__file__).resolve().parent.parent / "server" / "web"


def check_offline():
    problems = []
    for page in sorted(WEB.glob("*.html")):
        text = page.read_text()
        if "{cam_name}" in text:  # mirror server templating (http.py _page)
            for k, v in {"{selected_dir}": "2026-01-01", "{class_labels}": "[]",
                         "{start_time}": "null", "{cam_name}": "cam"}.items():
                text = text.replace(k, v)
        problems += [f"{page.name}: {p}" for p in page_problems(text)]
    return problems


def check_live(base_url: str, max_cams: int = 4):
    problems = []
    now_ms = time.time() * 1000

    def get(path):
        with urllib.request.urlopen(base_url + path, timeout=30) as r:
            return r.read().decode()

    main_html = get("/")
    problems += [f"mainview: {p}" for p in page_problems(main_html)]
    try:
        b = Browser(main_html, fetch=live_fetch(base_url), hls=False,
                    now_ms=now_ms)
    except JSThrow as exc:
        return problems + [f"mainview boot threw: {exc}"]
    cams = json.loads(get("/list_cameras")) or {}
    rendered = [el.text() for el in b.document.root.select("#cams .name")]
    if sorted(rendered) != sorted(cams):
        problems.append(f"mainview grid {rendered} != /list_cameras {sorted(cams)}")
    days = json.loads(get("/list_days")) or []
    opts = [to_py(o.js_get("value")) for o in b.el("daySelect").js_get("options").items]
    missing = [d for d in days if d not in opts]
    if missing:
        problems.append(f"daySelect missing days {missing}")
    gs = json.loads(get("/get_global_settings")) or {}
    want = "" if gs.get("use_clip") else "none"
    got = to_py(b.el("searchText").js_get("style").js_get("display"))
    if got != want:
        problems.append(f"use_clip={gs.get('use_clip')} but searchText display={got!r}")

    for cam in list(cams)[:max_cams]:
        page = get(f"/?cam={urllib.parse.quote(cam)}")
        probs = page_problems(page)
        problems += [f"cameraview[{cam}]: {p}" for p in probs]
        if probs:
            continue
        try:
            cb = Browser(page, fetch=live_fetch(base_url), hls=False,
                         now_ms=now_ms)
            cb.call("drawPreds")  # live overlay tick against real /get_preds
            cb.call("refreshCounts")
        except JSThrow as exc:
            problems.append(f"cameraview[{cam}] threw: {exc}")
    return problems


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", help="deployed server base URL, e.g. http://host:8080")
    ap.add_argument("--offline", action="store_true",
                    help="check the repo's page files without a server")
    ap.add_argument("--max-cams", type=int, default=4,
                    help="per-camera pages to drive (live mode)")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)
    if not args.url and not args.offline:
        ap.error("need --url or --offline")
    problems = check_offline() if args.offline else check_live(args.url, args.max_cams)
    if args.as_json:
        print(json.dumps({"ok": not problems, "problems": problems}))
    else:
        for p in problems:
            print("PROBLEM:", p)
        print("ui-check:", "OK" if not problems else f"{len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
