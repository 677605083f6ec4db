"""Qwen3-VL summaries through the continuous-batching engine, the
counterpart of ``clearcam_tpu.serving.vlm``.

Many cameras' summaries are served concurrently from one language-model
cache: each image rides as a "custom" prompt segment that the vision-tower
image prefill writes into one slot (``llm.make_slot_transform`` over
``Qwen3VL._image_prefill_impl``; on the port's in-place state the slot is a
view, so nothing is scattered back), the chat-template text follows as
ordinary token segments, and decode interleaves all cameras' answers.
"""
from __future__ import annotations

import os

from ..models import llm
from .engine import Request, ServingEngine

# CLEARCAM_SUMMARY_JSON=1: alert summaries come back as machine-parseable
# JSON enforced by grammar masking on the card (serving/constrain.py);
# the reference's summaries are free text (clearcam.py:494-499)
ALERT_SCHEMA = {
    "type": "object",
    "properties": {
        "summary": {"type": "string"},
        "objects": {"type": "array", "items": {"type": "string"},
                    "maxItems": 8},
        "risk": {"enum": ["none", "low", "medium", "high"]},
    },
}
ALERT_JSON_PROMPT = (
    ' Respond ONLY with a JSON object {"summary": <one sentence>, '
    '"objects": [<visible object names>], "risk": "none|low|medium|high"}.')


class VLMServingEngine:
    """Wraps ServingEngine with Qwen3-VL image segments + chat template.
    The engine's decode attention takes the route of ``qwen.lang``
    (``use_pallas_decode``: the batched decode kernel, its int8 form when
    the engine is given ``kv_quant``). ``CLEARCAM_SPEC_LOOKUP=G`` > 0 serves with speculative
    verify windows (greedy summaries gain; sampled ones emit a token a
    window), on the plain attention route, since the decode kernels take
    one query, and without ``CLEARCAM_SUMMARY_JSON``.

    ``mesh`` (a ("data", "model") ``parallel.mesh.Mesh``): the language
    model runs tensor/expert-parallel over ``model`` (the
    ``parallel.mesh.serving_engine_tp`` layout). Every rank builds this
    engine from its own Qwen3VL; rank 0 serves and the others run
    ``mesh.follow()``. The vision tower is replicated: each rank runs it on
    the image rank 0 sends with the image prefill, which writes the rank's
    KV-head slice of the cache."""

    def __init__(self, qwen, n_slots: int = 2, mesh=None, **engine_kw):
        self.qwen = qwen
        params = qwen.lang.params
        if mesh is not None:
            from ..parallel import mesh as pmesh
            params = pmesh.shard_llm_params(mesh, params, qwen.lang.cfg)
            engine_kw.setdefault("spec_lookup", 0)
        impl = qwen._image_prefill_impl
        slotted = llm.make_slot_transform(
            lambda st_b, p, vp, img, sp: impl(p, vp, st_b, img, sp))

        def custom_prefill(state, slot, start_pos, img):
            return slotted(state, slot, params, qwen.vision.p, img, start_pos)

        # summaries lead with an image segment, so text-prefix reuse never
        # fires: off, so retired slots park at 0 (the shortest kernel window)
        engine_kw.setdefault("prefix_cache", False)
        # CLEARCAM_SPEC_LOOKUP=G: speculative verify windows (greedy requests
        # only; Qwen summaries default to TEMP > 0, so this gains where a
        # deployment pins temperature 0 for deterministic alerts)
        engine_kw.setdefault("spec_lookup", int(
            os.environ.get("CLEARCAM_SPEC_LOOKUP", "0") or 0))
        # decode attention on the route the language model was built for
        # (the batched decode kernel where its Transformer runs the
        # kernels), except under spec: a window has G+1 queries
        engine_kw.setdefault("use_pallas_decode", qwen.lang.use_pallas_decode
                             and not engine_kw["spec_lookup"])
        self.json_summaries = bool(int(
            os.environ.get("CLEARCAM_SUMMARY_JSON", "0") or 0))
        if self.json_summaries and (engine_kw.get("spec_lookup")
                                    or "constraints" in engine_kw):
            print("CLEARCAM_SUMMARY_JSON ignored (spec_lookup or explicit "
                  "constraints set)")
            self.json_summaries = False
        if self.json_summaries:
            from .constrain import schema_token_constraint
            engine_kw["constraints"] = {"alert": schema_token_constraint(
                qwen.tok, qwen.lang.cfg.vocab_size, ALERT_SCHEMA)}
        self.engine = ServingEngine(params, qwen.lang.cfg, n_slots=n_slots,
                                    custom_prefill=custom_prefill, mesh=mesh, **engine_kw)
        self.n_img = qwen.toks_per_img + len(qwen._prefix) + len(qwen._suffix)

    def submit(self, images, prompt: str, max_new: int = 256,
               temperature: float | None = None) -> Request:
        """images: list of RGB uint8 frames (any size; letterboxed like
        Qwen3VL.feed_image); returns the engine Request. Decode the answer
        with ``self.text(request)`` once done."""
        from ..models.qwen3vl import TEMP
        q = self.qwen
        if self.json_summaries:
            prompt = prompt + ALERT_JSON_PROMPT
        segs = [("custom", q.image_tensor(img), self.n_img) for img in images]
        toks = q.tok.encode("<|im_start|>user\n" + prompt
                            + "<|im_end|>\n<|im_start|>assistant\n")
        segs.append(("text", toks))
        stop = {q.tok.eos_id}
        if q.tok.eot_id is not None:
            stop.add(q.tok.eot_id)
        return self.engine.submit(
            segments=segs, max_new=max_new, eos_id=stop,
            temperature=TEMP if temperature is None else temperature,
            constraint="alert" if self.json_summaries else None)

    def text(self, request: Request) -> str:
        toks = [t for t in request.tokens if not self.qwen.tok.is_end(t)]
        return self.qwen.tok.decode(toks)

    # engine passthroughs
    def has_work(self):
        return self.engine.has_work()

    def step(self):
        return self.engine.step()

    def run_until_idle(self):
        return self.engine.run_until_idle()

    def start(self):
        self.engine.start()
        return self

    def close(self):
        self.engine.close()
