"""The harness: one cell of ``BENCHMARK.json`` run once.

Everything is found by name, under the checkout the run starts in (the
current directory). The cell's entry in ``BENCHMARK.json`` names
its configuration (a file under ``configs/``, whose ``driver`` key names the
module under ``drivers/`` that sets it up and drives it) and its traffic
mix (``traffic/<traffic>.json``, whose ``generator`` key names the module
under ``traffic/`` that reads it). ``workloads/<cell>.json`` holds what the
cell's correctness check compares and the limits. Each per-layer metric is
read by ``metrics/<metric>.py``, or by the reader of its name up to the
first dot where it has none of its own. So a configuration, a mix, a cell or a
metric is added as new files and entries, with no edit here.

A run: set-up (the driver builds the program's objects, makes the weights
and inputs from the seed, warms up every shape the traffic uses and, where
it has a ``lead_in``, brings its load to a steady state), the
measured window of ``seconds`` (profiled whole where an end-to-end metric
is read from the card's trace), the peak device memory, then the readers
(``trace=1``: the per-layer ones; else those of the end-to-end metrics
whose source is ``device_trace``), then the program's state is freed and the check
compares what the window produced with the plain reference. The result is
one JSON line; the numbers compared are printed beside their limits last on
standard error and last in the line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded: JAX, its libraries, the
# JAX package and the root bench script that drives it
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "clearcam_tpu", "bench"})
_T_IMPORT = time.monotonic()


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; the time since
    this module was imported where that cannot be read)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Forbidden top-level names among the loaded modules, compared whole
    (``clearcam_tpu_torch`` is not ``clearcam_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_module(path: Path, name: str | None = None):
    """A module from a file, by path (metric files have dots in their
    names)."""
    name = name or "bench_h100_metric_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell's entries and files, by name, from the checkout at
    ``root`` (its ``BENCHMARK.json`` and the data files and metric readers
    under its copy of this folder)."""
    here = root / HERE.name
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(cells)})")
    entry = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
    cellfile = json.loads((here / "workloads" / f"{workload}.json").read_text())

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]
    return SimpleNamespace(
        name=workload, entry=entry, dir=here, config_name=entry["config"], config=config,
        traffic_name=entry["traffic"], traffic=traffic, cell=cellfile,
        chips=int(entry["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


class Spans:
    """Host spans the harness records around its calls into the program:
    name -> [(start, end)] on ``time.perf_counter``."""

    def __init__(self):
        self.data: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.data.setdefault(name, []).append((t0, time.perf_counter()))

    def add(self, name: str, t0: float, t1: float) -> None:
        self.data.setdefault(name, []).append((t0, t1))

    def within(self, name: str, t0: float, t1: float) -> list:
        return [s for s in self.data.get(name, []) if s[0] >= t0 and s[1] <= t1]


def reader_path(metrics_dir: Path, name: str) -> Path:
    """A per-layer metric's reader: ``metrics/<name>.py`` where there is
    one, else the reader of its name up to the first dot, which the split
    metrics share (``idle_pct.decode`` and ``idle_pct.prefill`` are both
    read by ``metrics/idle_pct.py``)."""
    own = metrics_dir / f"{name}.py"
    return own if own.exists() else metrics_dir / f"{name.split('.')[0]}.py"


def read_metrics(cell, ctx) -> dict:
    """Each per-layer metric's reader (``reader_path``, ``read(ctx)``); a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value = load_module(reader_path(cell.dir / "metrics", m["name"])).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: list) -> bool:
    """True where there is something compared and every number compared
    (name, value, limit) is within its limit."""
    return bool(checks) and all(v <= lim for _, v, lim in checks)


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        root: Path | None = None, patch=None, log=None) -> dict:
    """Run one cell once and return the result line's dict. ``device="cpu"``
    and ``patch`` (called with the driver's cell object after set-up) are
    for the tests: the benchmark's command runs on the card only."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root) if root is not None else Path.cwd()
    cell = load_cell(root, workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench_h100: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"bench_h100: {cell.name} needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} present")
    driver = importlib.import_module(f"bench_h100.drivers.{cell.config['driver']}")
    spans = Spans()
    obj = driver.Cell(cell, int(seed), torch.device(device), spans, log)
    obj.setup()
    if patch is not None:
        patch(obj)
    # an end-to-end metric read from the card's trace covers the whole
    # window, so an untraced run of such a cell profiles all of it
    device_e2e = [m for m in cell.end_to_end if m["source"] == "device_trace"]
    tracer = Tracer(cell.cell.get("trace_seconds", 2.0) if trace else float(seconds),
                    enabled=(bool(trace) or bool(device_e2e)) and device == "cuda", log=log)
    lead_in = getattr(obj, "lead_in", None)
    if lead_in is not None:
        lead_in()
    setup_s = process_age_s()
    log(f"{cell.name}: set-up {setup_s:.3f} s; window {seconds} s, seed {seed}, "
        f"trace {int(bool(trace))}")
    win = obj.run_window(float(seconds), tracer)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    result = {"correct": False, "attempted": int(win.attempted), "failed": int(win.failed)}
    if trace:
        ctx = SimpleNamespace(cell=cell, window=win, spans=spans, trace=tracer.result)
        result["metrics"] = read_metrics(cell, ctx)
    else:
        e2e = dict(win.metrics, setup_s=setup_s)
        ctx = SimpleNamespace(cell=cell, window=win, spans=spans, trace=tracer.result)
        for m in device_e2e:
            value = load_module(reader_path(cell.dir / "metrics", m["name"])).read(ctx)
            if value is not None:
                e2e[m["name"]] = value
            elif device == "cuda":
                raise SystemExit(f"bench_h100: {m['name']}: no device trace to read")
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                             for m in cell.end_to_end if m["name"] in e2e}
    result["device"] = device_info(torch, device, cell.chips, peak)
    if trace and tracer.result is not None:
        result["device"]["busy_s"] = tracer.result.busy_s
        result["device"]["window_s"] = tracer.result.window_s
        result["breakdown"] = tracer.result.breakdown(spans)
    obj.release()
    checks = obj.check()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"bench_h100: forbidden modules loaded: {', '.join(bad)}")
    result["correct"] = judge(checks) and win.failed == 0
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    for name, v, lim in checks:
        log(f"check {name} {v!r} limit {lim!r}")
    return result


def device_info(torch, device: str, chips: int, peak: int) -> dict:
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


class Tracer:
    """``torch.profiler`` over the last ``seconds`` of the window (device
    activity only). The profiler is set up here, before the window, and
    stopped once the window has closed, since both hold the host for
    seconds; drivers call ``poll(now)`` between steps and ``stop()`` when
    the window closes."""

    def __init__(self, seconds: float, enabled: bool, log=None):
        self.seconds, self.enabled = seconds, enabled
        self.log = log or (lambda msg: None)
        self.prof = None
        self.t0 = self.t1 = None
        self.result = None
        self.done = not enabled
        if enabled:
            from torch.profiler import ProfilerActivity, profile
            t = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.prepare_trace()
            self.log(f"profiler set up in {time.perf_counter() - t:.3f} s")

    def poll(self, now: float, window_start: float, window_s: float) -> None:
        if self.done:
            return
        if self.t0 is None and now >= window_start + window_s - self.seconds:
            t = time.perf_counter()
            self.prof.start_trace()
            self.t0 = time.perf_counter()
            self.wall0_ns = time.time_ns()
            self.log(f"profiler started in {self.t0 - t:.3f} s")

    def stop(self) -> None:
        if self.done:
            return
        import torch
        self.done = True
        if self.t0 is None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop_trace()
        self.log(f"profiler stopped in {time.perf_counter() - self.t1:.3f} s")
        from .trace import Trace
        self.result = Trace.from_profile(self.prof, self.t0, self.t1, self.wall0_ns)
        self.prof = None
