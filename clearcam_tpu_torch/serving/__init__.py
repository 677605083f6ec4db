"""Continuous-batching LLM serving on the port's model (the counterpart of
``clearcam_tpu.serving``): ``engine`` (ServingEngine, Request, QueueFull),
``text`` (TextServing, strings in and out), ``constrain`` (grammar tables
for constrained decoding) and ``vlm`` (Qwen3-VL summaries through the
engine).

``text`` and ``constrain`` are copies of the JAX package's files; their
relative imports resolve to the port's modules.
"""
from __future__ import annotations

from . import constrain, engine, text  # noqa: F401
from .engine import QueueFull, Request, ServingEngine  # noqa: F401
from .text import TextServing  # noqa: F401
