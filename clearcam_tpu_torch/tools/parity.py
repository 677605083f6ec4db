"""Where the port finds public data artifacts (the BlazeFace checkpoint the
reference distributes with its code): ``resolve_fixture``, as in the JAX
package's clearcam_tpu/tools/parity.py:43-61."""
from __future__ import annotations

import os
from pathlib import Path


def _snapshot() -> Path | None:
    """The read-only reference snapshot root named by
    ``CLEARCAM_REF_SNAPSHOT`` (public data artifacts live there), or None."""
    root = os.environ.get("CLEARCAM_REF_SNAPSHOT")
    return Path(root) if root else None


def resolve_fixture(name: str, weights: Path | str = "weights",
                    fixtures: Path | str = "fixtures") -> Path | None:
    """Find a public data artifact: local fixtures/ and weights/ first, then
    the reference snapshot's known data locations."""
    cands = [Path(fixtures) / name, Path(weights) / name]
    snap = _snapshot()
    if snap is not None:
        cands += [snap / "test" / "clip_images" / name, snap / "utils" / name,
                  snap / "test" / name, snap / "test" / "videos" / name,
                  snap / "models" / name]
    for cand in cands:
        if cand.exists():
            return cand
    return None
