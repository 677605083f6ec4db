"""The readings the correctness limits are set from, in one process:

    python -m bench_h100.calibrate --workload NAME --seeds 1,2,3 \\
        --seconds 5 --control-seeds 1,2,3

For each of ``--seeds`` a short run of the cell (set-up, a window of
``--seconds`` at the cell's own load, the check) gives the program's
readings; for each of ``--control-seeds`` the driver's ``controls()`` give
the readings of what a limit must fail, in the program's place: the
reference in float8 and without NMS for detect, the program's int4 weights
for serving. Each control's readings are judged against the cell's limits
as a run's are (``harness.judge``). One JSON line a run, then the largest
program reading and the smallest control reading of each number. Exits 1
where a control passes every limit (a control with no reading, as where a
short window finished no request, neither passes nor sets a reading). The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_h100.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cache = Path.cwd() / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    from bench_h100 import harness

    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    program, control, passed = {}, {}, []
    for seed in sorted(set(seeds) | controls):
        held = []
        res = harness.run(args.workload, seed, args.seconds, False, device=args.device,
                          patch=held.append)
        line = {"seed": seed, "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], "metrics": res["metrics"], "check": res["check"]}
        if seed in seeds:
            for k, v in res["check"].items():
                program[k] = max(program.get(k, 0.0), v["value"])
        if seed in controls:
            limits = {k: v["limit"] for k, v in res["check"].items()}
            line["controls"] = {}
            for name, readings in held[0].controls().items():
                checks = [(k, readings[k], lim) for k, lim in limits.items()]
                ok = harness.judge(checks)
                line["controls"][name] = {"correct": ok, "readings": readings}
                if ok:
                    passed.append((seed, name))
                for k, v in readings.items():
                    key = f"{name}.{k}"
                    control[key] = min(control.get(key, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": program,
                      "control_min": control, "controls_passing": passed, "seeds": seeds,
                      "control_seeds": sorted(controls)}), flush=True)
    if passed:
        print(f"calibrate: controls that pass every limit: {passed}", file=sys.stderr)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
