"""The port's Qwen3-VL slice against the JAX package, on the CPU at tiny
widths (2 blocks, dim 32, vision width 64): ``Transformer.generate`` on the
plain and decode-kernel routes with f32, bf16 and int8 caches and with
prompt-lookup speculation, ``generate_batch``, the vision tower, ``Qwen3VL``
image-then-prompt, the cache format across resets, ``VLMServingEngine``,
and both NVR summary modes. The JAX side runs its Pallas decode kernels in
interpret mode. Inputs and weights come from numpy seeds shared by both.
"""
import time
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.models import qwen3vl as jvl
from clearcam_tpu.utils.llm_tokenizer import LLMTokenizer as JTok
from clearcam_tpu.utils.tokenizer import byte_encoder
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.models import qwen3vl as tvl
from clearcam_tpu_torch.ops import decode_attention as tdec
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.utils.llm_tokenizer import LLMTokenizer as TTok

# the vision tower, f32 on both sides: summation order only
VISION_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _cfgs(**kw):
    """A tiny config for both packages. head_dim 128 where the decode
    kernels run (the JAX kernels' tests use it too); max_context 256, a
    multiple of the TPU kernels' chunk."""
    base = dict(num_blocks=2, dim=32, hidden_dim=64, n_heads=4, n_kv_heads=2,
                norm_eps=1e-5, vocab_size=260, head_dim=128, rope_theta=10000.0,
                rope_dim=128, v_head_dim=128, max_context=256)
    base.update(kw)
    jc = jllm.TransformerConfig(**base)
    d = asdict(jc)
    d.pop("ssm")
    return jc, tllm.TransformerConfig(**d)


def _params(jc, seed):
    jp = jllm.init_params(jc, seed=seed)
    return jp, tllm.params_from_jax(jp)


KV = {"f32": (jnp.float32, torch.float32, False),
      "bf16": (jnp.bfloat16, torch.bfloat16, False),
      "int8": (jnp.float32, torch.float32, True)}


def _jax_lm(jp, jc, kv, pallas, spec=0):
    jdt, _, q8 = KV[kv]
    m = jllm.Transformer(jp, jc, seed=0, state_dtype=jdt, kv_quant=q8, spec_lookup=spec)
    if pallas:
        m.prefill_fn, m.decode_fn = jllm.make_step_fns(
            jc, use_pallas_decode=True, interpret=True, kv_quant=q8)
    return m


def _port_lm(tp, tc, kv, pallas, spec=0):
    _, tdt, q8 = KV[kv]
    return tllm.Transformer(tp, tc, seed=0, state_dtype=tdt, kv_quant=q8,
                            use_pallas_decode=pallas, spec_lookup=spec)


def _greedy(m, prompt, n, **kw):
    return list(m.generate(list(prompt), temperature=0.0, max_new=n, **kw))


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("kv", list(KV))
def test_generate_matches_jax(kv, pallas):
    """Greedy tokens of a two-chunk prompt, then a longer prompt that
    reuses the cached prefix, equal the JAX package's; the port's decode
    route reaches the single-stream plain version (no kernel on the CPU)."""
    jc, tc = _cfgs()
    jp, tp = _params(jc, seed=5)
    prompt = list(np.random.default_rng(1).integers(1, 250, 40))
    jm, tm = _jax_lm(jp, jc, kv, pallas), _port_lm(tp, tc, kv, pallas)
    counts = (tdec.decode_attention.launches, tdec.decode_attention_q8.launches)
    for p in (prompt, prompt + [7, 8, 9]):
        assert _greedy(tm, p, 6) == _greedy(jm, p, 6)
    assert (tdec.decode_attention.launches, tdec.decode_attention_q8.launches) == counts
    st = tm.state[0]
    assert st["k"].dtype == (torch.int8 if kv == "int8" else KV[kv][1])
    assert ("k_s" in st) == (kv == "int8")


def test_generate_spec_lookup_matches_jax():
    """Prompt-lookup speculative decoding: the port's tokens equal the JAX
    package's speculative and plain greedy tokens."""
    jc, tc = _cfgs(head_dim=8, rope_dim=8, v_head_dim=8)
    jp, tp = _params(jc, seed=2)
    prompt = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
    want = _greedy(_jax_lm(jp, jc, "f32", False, spec=4), prompt, 12)
    assert want == _greedy(_jax_lm(jp, jc, "f32", False), prompt, 12)
    tm = _port_lm(tp, tc, "f32", False, spec=4)
    calls = []
    verify = tm.verify_fn
    tm.verify_fn = lambda *a: calls.append(1) or verify(*a)
    assert _greedy(tm, prompt, 12) == want
    assert calls                                  # the verify path ran


@pytest.mark.parametrize("kv,pallas", [("f32", False), ("bf16", True), ("int8", True)])
def test_generate_batch_matches_jax(kv, pallas):
    """Right-aligned ragged prompts (distinct left pads), greedy: token-exact
    against the JAX package's generate_batch on the same route."""
    jc, tc = _cfgs(max_context=512)
    jp, tp = _params(jc, seed=9)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [5, 5], list(range(10, 50))]
    jdt, tdt, q8 = KV[kv]
    ref = jllm.generate_batch(jp, jc, prompts, max_new=5, state_dtype=jdt, kv_quant=q8,
                              use_pallas_decode=pallas, interpret=pallas)
    before = tdec.decode_attention_batch_q8.launches
    got = tllm.generate_batch(tp, tc, prompts, max_new=5, state_dtype=tdt, kv_quant=q8,
                              use_pallas_decode=pallas)
    assert got == ref
    assert tdec.decode_attention_batch_q8.launches == before     # CPU: plain version


def test_generate_batch_seeded_rows_equal_engine_requests():
    """Sampled rows (temperature 0.8) with per-row seeds equal the port
    engine's requests submitted with the same seeds at the same width."""
    from clearcam_tpu_torch.serving import ServingEngine
    jc, tc = _cfgs(head_dim=8, rope_dim=8, v_head_dim=8)
    _, tp = _params(jc, seed=4)
    prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]]
    got = tllm.generate_batch(tp, tc, prompts, max_new=8, temperature=0.8, seed=7,
                              seeds=[11, 12])
    eng = ServingEngine(tp, tc, n_slots=2, seed=7)
    reqs = [eng.submit(p, max_new=8, temperature=0.8, seed=s)
            for p, s in zip(prompts, (11, 12))]
    eng.run_until_idle()
    assert got == [r.wait(1) for r in reqs]
    assert got[0] != tllm.generate_batch(tp, tc, prompts, max_new=8, temperature=0.8,
                                         seed=7, seeds=[13, 12])[0]


def test_make_slot_transform_writes_one_slot_in_place():
    jc, tc = _cfgs(head_dim=8, rope_dim=8, v_head_dim=8)
    st = tllm.init_state(tc, 3)
    before = [{k: v.clone() for k, v in s.items()} for s in st]

    def fill(st_b, value):
        for s in st_b:
            for v in s.values():
                v.fill_(value)
        return st_b
    out = tllm.make_slot_transform(fill)(st, 1, 2.5)
    assert out is st
    for s, b in zip(st, before):
        for k in s:
            assert torch.equal(s[k][0], b[k][0]) and torch.equal(s[k][2], b[k][2])
            assert (s[k][1] == 2.5).all()


# ---------------------------------------------------------------------------
# the vision tower and Qwen3-VL

def _tok(pkg):
    be = byte_encoder()
    normal = {be[b]: b for b in range(256)}
    specials = {"<|im_start|>": 256, "<|im_end|>": 257,
                "<|vision_start|>": 258, "<|vision_end|>": 259}
    return pkg(normal, specials, preset="qwen2", bos_id=None, eos_id=257)


def _vlms(kv="f32", pallas=False, deepstack=(0,), n_vis=2):
    """The same tiny Qwen3-VL in both packages: 2 language blocks (dim 32),
    a 2-block vision tower of width 64 with deepstack at ``deepstack``."""
    jc, tc = _cfgs(max_context=1024)
    jp, tp = _params(jc, seed=0)
    vkv, vp = tvl.VisionTower.init_random(n_blocks=n_vis, lang_dim=32, deepstack=deepstack)
    j = jvl.Qwen3VL(res=(64, 96), lang=_jax_lm(jp, jc, kv, pallas), tok=_tok(JTok),
                    vision=jvl.VisionTower(vkv, vp))
    t = tvl.Qwen3VL(res=(64, 96), lang=_port_lm(tp, tc, kv, pallas), tok=_tok(TTok),
                    vision=tvl.VisionTower(vkv, vp, device="cpu"))
    return j, t


def test_init_random_equals_jax_draws():
    jkv, jp = jvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(1,), seed=3)
    tkv, tp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(1,), seed=3)
    assert jkv == tkv and list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(jp[k], tp[k])


@pytest.mark.parametrize("deepstack", [(0,), (1,), (0, 1)])
def test_vision_tower_matches_jax(deepstack):
    kv, vp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=deepstack, seed=1)
    img = np.random.default_rng(2).uniform(0, 255, (64, 96, 3)).astype(np.float32)
    j_emb, j_deep = jvl.VisionTower(kv, vp)(jnp.asarray(img))
    t_emb, t_deep = tvl.VisionTower(kv, vp, device="cpu")(torch.from_numpy(img))
    assert t_emb.shape == (6, 32) and len(t_deep) == len(deepstack)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=VISION_TOL)
    for a, b in zip(t_deep, j_deep):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=VISION_TOL)


@pytest.mark.parametrize("kv,pallas", [("f32", False), ("f32", True), ("bf16", True)])
def test_qwen3vl_image_then_prompt_matches_jax(kv, pallas):
    """Temperature 0: an image, a prompt, then a second image and prompt on
    the same context, and a reset; the port's text equals the JAX
    package's. The deepstack feature of vision block 1 lands after language
    block 1 in both."""
    j, t = _vlms(kv, pallas, deepstack=(1,))
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (48, 80, 3), np.uint8) for _ in range(3)]
    for img, reset in ((frames[0], True), (frames[1], False), (frames[2], True)):
        want = j.generate("what is there?", image=img, reset=reset, temperature=0.0,
                          max_new=8)
        assert t.generate("what is there?", image=img, reset=reset, temperature=0.0,
                          max_new=8) == want
        assert t.start_pos == j.start_pos


def test_deepstack_reaches_the_language_model():
    """Without the deepstack add the prefill state differs: the feature is
    spliced into the residual, not dropped."""
    _, t = _vlms(deepstack=(0,))
    img = np.random.default_rng(4).integers(0, 256, (64, 96, 3), np.uint8)
    t.feed_image(img, reset=True)
    with_ds = t.lang.state[1]["k"].clone()
    t.vision.deepstack_idx = []
    t.feed_image(img, reset=True)
    assert not torch.allclose(t.lang.state[1]["k"], with_ds)


def test_reset_keeps_the_cache_format():
    """The JAX package's feed_image(reset=True) rebuilds an f32 cache
    without scales whatever its Transformer was built with; the port's
    keeps the int8 cache and its scales (and a bf16 cache stays bf16)."""
    j, t = _vlms("int8")
    img = np.zeros((64, 96, 3), np.uint8)
    assert "k_s" in j.lang.state[0]
    j.feed_image(img, reset=True)
    assert "k_s" not in j.lang.state[0] and j.lang.state[0]["k"].dtype == jnp.float32
    t.feed_image(img, reset=True)
    assert "k_s" in t.lang.state[0] and t.lang.state[0]["k"].dtype == torch.int8
    t.prewarm()
    assert t.lang.state[0]["k"].dtype == torch.int8 and not t.lang.state[0]["k"].any()
    _, tb = _vlms("bf16")
    tb.generate("x", image=img, reset=True, temperature=0.0, max_new=2)
    tb.generate(reset=True)
    assert tb.lang.state[0]["k"].dtype == torch.bfloat16


def test_vlm_engine_concurrent_summaries_equal_solo():
    """Two cameras' summaries decoded concurrently through the engine equal
    each one served alone, and Qwen3VL.generate's tokens (temperature 0)."""
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    _, t = _vlms()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]
    eng = VLMServingEngine(t, n_slots=2)
    reqs = [eng.submit([f], "describe", max_new=6, temperature=0.0) for f in frames]
    eng.run_until_idle()
    together = [eng.text(r) for r in reqs]
    solo = []
    for f in frames:
        e = VLMServingEngine(t, n_slots=2)
        r = e.submit([f], "describe", max_new=6, temperature=0.0)
        e.run_until_idle()
        solo.append(e.text(r))
    assert together == solo
    assert together == [t.generate("describe", image=f, reset=True, temperature=0.0,
                                   max_new=6) for f in frames]


def test_vlm_engine_spec_lookup_serves(monkeypatch):
    """CLEARCAM_SPEC_LOOKUP=3: the port's VLM engine serves speculative
    windows on the plain attention route (its language model was built for
    the decode kernel), and its greedy summaries equal the JAX VLM engine's
    under the same setting and the port's non-speculative engine's."""
    from clearcam_tpu.serving.vlm import VLMServingEngine as JaxVLM
    from clearcam_tpu_torch.serving.vlm import VLMServingEngine
    j, t = _vlms(pallas=True)
    assert t.lang.use_pallas_decode
    rng = np.random.default_rng(6)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]

    def run(eng):
        reqs = [eng.submit([f], "describe", max_new=10, temperature=0.0) for f in frames]
        eng.run_until_idle()
        return [r.wait(1) for r in reqs]

    plain = run(VLMServingEngine(t, n_slots=2))
    monkeypatch.setenv("CLEARCAM_SPEC_LOOKUP", "3")
    monkeypatch.setenv("CLEARCAM_SUMMARY_JSON", "1")         # ignored under spec
    eng = VLMServingEngine(t, n_slots=2)
    assert eng.engine.spec == 3 and not eng.json_summaries
    assert eng.engine.stats["decode_steps"] == 0
    got = run(eng)
    assert got == plain == run(JaxVLM(j, n_slots=2))
    assert eng.engine.stats["spec_emitted"] >= sum(len(x) for x in got) - len(got)


class ColorKeyDetector:
    """Finds the synthetic source's (40,180,240) box by colour and emits one
    class-0 detection per frame (tests/test_nvr.py's stand-in)."""

    def detect_many(self, frames):
        out = []
        for f in frames:
            mask = np.abs(f.astype(int) - np.array([40, 180, 240])).sum(-1) < 30
            ys, xs = np.where(mask)
            out.append(np.zeros((0, 6)) if len(xs) == 0 else np.array(
                [[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1, 0.9, 0.0]]))
        return out


@pytest.mark.parametrize("slots", [0, 2])
def test_nvr_summary_delivers_a_notification(tmp_path, slots):
    """The port's NVR with the port's Qwen3-VL: an alert on a synthetic
    camera gives an "AI Summary" notification, cooperatively (slots 0) and
    through the VLM engine (slots 2)."""
    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.runtime.settings import GlobalSettings
    from clearcam_tpu_torch.utils.db import KVStore
    _, t = _vlms()
    db = KVStore(tmp_path / "kv.db")
    db.run_put("links", "cam1", "synthetic://640x360")
    notes = []
    nvr = NVR(db, tmp_path / "data", GlobalSettings(userID="uid", key="k", use_qwen=True),
              detector=ColorKeyDetector(), qwen=t, notifier=lambda *a: notes.append(a),
              uploader=lambda **kw: True, summary_slots=slots)
    nvr.init_cam("cam1", "synthetic://640x360")
    deadline = time.time() + 120
    try:
        while not any(n[1].startswith("AI Summary") for n in notes) \
                and time.time() < deadline:
            nvr.tick()
            time.sleep(0.01)
    finally:
        nvr.stop()
    summaries = [n for n in notes if n[1].startswith("AI Summary")]
    assert summaries and isinstance(summaries[0][2], str), [n[1] for n in notes]
    assert (nvr._summary_engine is not None) == (slots > 0)


def test_nvr_summary_under_spec_lookup(tmp_path, monkeypatch):
    """With CLEARCAM_SPEC_LOOKUP set and summary slots, the NVR's first
    alert gets its "AI Summary" through the speculative engine (the port
    raised there before)."""
    from clearcam_tpu_torch.runtime.nvr import NVR
    from clearcam_tpu_torch.runtime.settings import GlobalSettings
    from clearcam_tpu_torch.utils.db import KVStore
    monkeypatch.setenv("CLEARCAM_SPEC_LOOKUP", "4")
    _, t = _vlms()
    db = KVStore(tmp_path / "kv.db")
    db.run_put("links", "cam1", "synthetic://640x360")
    notes = []
    nvr = NVR(db, tmp_path / "data", GlobalSettings(userID="uid", key="k", use_qwen=True),
              detector=ColorKeyDetector(), qwen=t, notifier=lambda *a: notes.append(a),
              uploader=lambda **kw: True, summary_slots=2)
    nvr.init_cam("cam1", "synthetic://640x360")
    deadline = time.time() + 120
    try:
        while not any(n[1].startswith("AI Summary") for n in notes) \
                and time.time() < deadline:
            nvr.tick()
            time.sleep(0.01)
    finally:
        nvr.stop()
    assert any(n[1].startswith("AI Summary") for n in notes), [n[1] for n in notes]
    assert nvr._summary_engine.engine.spec == 4
    assert nvr._summary_engine.engine.stats["spec_emitted"] > 0


def test_qwen3vl_loads_a_gguf_pair(tmp_path, monkeypatch):
    """Qwen3VL(size=) on a tiny synthetic GGUF pair (the language model and
    its mmproj): the checkpoint's config (the 2000-token budget rounded to
    1984 positions), its tokenizer, CLEARCAM_KV_QUANT=int8, and the same
    text as the port's model built from the same tensors directly."""
    from clearcam_tpu_torch.io import gguf
    jc, tc = _cfgs(head_dim=8, rope_dim=8, v_head_dim=8, qk_norm=8)
    params = {k: np.asarray(v) for k, v in jllm.init_params(jc, seed=3).items()}
    be = byte_encoder()
    specials = ["<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>"]
    kv = {"general.architecture": "qwen3", "qwen3.block_count": jc.num_blocks,
          "qwen3.context_length": 4096, "qwen3.embedding_length": jc.dim,
          "qwen3.feed_forward_length": jc.hidden_dim,
          "qwen3.attention.head_count": jc.n_heads,
          "qwen3.attention.head_count_kv": jc.n_kv_heads,
          "qwen3.attention.key_length": jc.head_dim,
          "qwen3.attention.layer_norm_rms_epsilon": 1e-5, "qwen3.rope.freq_base": 10000.0,
          "tokenizer.ggml.tokens": [be[b] for b in range(256)] + specials,
          "tokenizer.ggml.token_type": [1] * 256 + [3] * 4,
          "tokenizer.ggml.pre": "qwen2", "tokenizer.ggml.eos_token_id": 257,
          "tokenizer.ggml.add_bos_token": False}
    gguf.save(tmp_path / "Qwen3VL-2B-Instruct-F16.gguf", kv, params)
    vkv, vp = tvl.VisionTower.init_random(n_blocks=2, lang_dim=32, deepstack=(1,), seed=4)
    gguf.save(tmp_path / "mmproj-Qwen3VL-2B-Instruct-F16.gguf", vkv, vp)
    monkeypatch.setenv("CLEARCAM_KV_QUANT", "int8")
    vlm = tvl.Qwen3VL(size="2B", res=(64, 96), weights_dir=tmp_path, device="cpu")
    assert vlm.lang.cfg.max_context == 1984 and vlm.lang.kv_quant
    assert not vlm.lang.use_pallas_decode                 # the CPU runs the plain route
    assert vlm.tok.eos_id == 257 and vlm.vision.deepstack_idx == [1]
    cfg, p, _ = tllm.load_gguf(tmp_path / "Qwen3VL-2B-Instruct-F16.gguf", 2000)
    ref = tvl.Qwen3VL(res=(64, 96), lang=tllm.Transformer(p, cfg, kv_quant=True),
                      tok=_tok(TTok), vision=tvl.VisionTower(vkv, vp, device="cpu"))
    img = np.random.default_rng(6).integers(0, 256, (64, 96, 3), np.uint8)
    got = vlm.generate("hi", image=img, reset=True, temperature=0.0, max_new=6)
    assert got == ref.generate("hi", image=img, reset=True, temperature=0.0, max_new=6)
    assert vlm.lang.state[0]["k"].dtype == torch.int8


def test_qwen3vl_without_weights_raises(tmp_path):
    """No GGUF pair: construction raises (``build_qwen`` prints "qwen
    unavailable" and runs without summaries)."""
    with pytest.raises(FileNotFoundError, match="Qwen3VL-2B-Instruct-F16.gguf"):
        tvl.Qwen3VL(size="2B", weights_dir=tmp_path, device="cpu")
