"""Run one cell of the benchmark once:

    python -m bench_h100 --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (the directory that holds ``BENCHMARK.json``),
on a machine with the cards the cell asks for. The last line of standard
output is the result's JSON object; the numbers the correctness check
compared, each beside its limit, are the last lines of standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m bench_h100", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    # kernel caches at fixed paths inside the checkout, so a second run
    # finds what the first one built (the program's own library goes to
    # clearcam_tpu_torch/build/)
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    from bench_h100 import harness
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), root=root)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
