"""The benchmark's own tests run from the repository's root:

    python -m pytest -q -p no:cacheprovider bench_h100/tests

CPU tests run anywhere; the ``cuda`` tests skip without a card."""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("OMP_NUM_THREADS", "4")
