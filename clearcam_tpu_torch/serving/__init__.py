"""Continuous-batching LLM serving on the port's model (the counterpart of
``clearcam_tpu.serving``): ``engine`` (ServingEngine, Request, QueueFull),
``text`` (TextServing, strings in and out) and ``constrain`` (grammar
tables for constrained decoding).

``text`` and ``constrain`` are the JAX package's own files, run under the
port's module names (``_load_shared``): ``constrain`` is numpy only, and
``text``'s one relative import (``.engine``) then resolves to the port's
engine. They are not imported through ``clearcam_tpu.serving``, whose
``__init__`` imports its engine, and with it jax.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def _load_shared(name: str):
    """Execute ``clearcam_tpu/serving/<name>.py`` as ``<this package>.<name>``
    and register it in ``sys.modules`` (before it runs, as its dataclasses
    need)."""
    full = f"{__name__}.{name}"
    root = importlib.util.find_spec("clearcam_tpu").submodule_search_locations[0]
    spec = importlib.util.spec_from_file_location(full, Path(root) / "serving" / f"{name}.py")
    mod = sys.modules[full] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


constrain = _load_shared("constrain")
from . import engine  # noqa: E402
text = _load_shared("text")

from .engine import QueueFull, Request, ServingEngine  # noqa: E402,F401

TextServing = text.TextServing

# the shared server's lazy imports (clearcam_tpu/server/http.py:262, 1061,
# 1173, 1264, 1570), each answered by the port's module
_SHARED_NAMES = {
    "clearcam_tpu.serving": __name__,
    "clearcam_tpu.serving.engine": f"{__name__}.engine",
    "clearcam_tpu.serving.constrain": f"{__name__}.constrain",
    "clearcam_tpu.models.llm": "clearcam_tpu_torch.models.llm",
}


def bind_shared_server() -> None:
    """The seam through which the shared HTTP server reaches the port.

    ``clearcam_tpu.server.http`` is jax-free when imported, but its
    /generate and OpenAI handlers import ``clearcam_tpu.serving``
    (constrain, engine.QueueFull) and ``clearcam_tpu.models.llm`` (LP_K)
    on first use. Those are the JAX package's modules: they would load jax
    into the port's server, and the handlers' ``except QueueFull`` would
    not catch the port's class (backpressure would become HTTP 500). This
    registers the port's modules under those four names in
    ``sys.modules``, so the handlers find the port's. Call it before
    ``serve()``; it raises if the JAX modules are already loaded (then
    the process already holds jax's versions, and binding would mix the
    two)."""
    import importlib
    import clearcam_tpu.models  # noqa: F401  (jax-free package; the parent must exist)
    for shared, ours in _SHARED_NAMES.items():
        mod = importlib.import_module(ours)
        have = sys.modules.get(shared)
        if have is not None and have is not mod:
            raise RuntimeError(
                f"{shared} is already loaded from {getattr(have, '__file__', have)}; "
                "bind_shared_server() must run before the JAX package's serving "
                "modules are imported")
        sys.modules[shared] = mod
