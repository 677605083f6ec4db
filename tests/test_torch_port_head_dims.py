"""The port's decode attention at every head dim and query-group size the
JAX package's LLM stacks take, on the CPU: the four forms of
clearcam_tpu_torch.ops.decode_attention (their plain versions here)
against the JAX package's Pallas kernels in interpret mode at head dims
64, 128 and 256 (the kernels' built widths) and 80, 96 and 120 (below
one) and rep = H / KvH of 2, 4, 7, 8 and 16; then Llama-style GGUFs at
head dims 64 and 80 served through ``tools.serve_llm``'s engine with
``--pallas`` and generated by ``Transformer`` on the decode-kernel route,
token for token against the JAX package. The CUDA kernels against these
plain versions are in test_torch_port_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearcam_tpu.models import llm as jllm
from clearcam_tpu.ops import decode_attention as jdec
from clearcam_tpu.serving import ServingEngine as JaxEngine
from clearcam_tpu_torch.io import gguf
from clearcam_tpu_torch.models import llm as tllm
from clearcam_tpu_torch.ops import decode_attention as tdec
from clearcam_tpu_torch.testing import torch_threads
from clearcam_tpu_torch.utils.tokenizer import byte_encoder

from test_llm import tiny_cfg

# f32: summation order only; bf16: both widen the same bf16 values to f32,
# and the output is rounded to q's dtype
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
Q8_TOL = 1e-5
B, S = 3, 256            # S: one chunk of the JAX kernels
# (H, KvH, D): Llama-3.2-1B's rep 4 at head dim 64, Qwen2.5-0.5B's rep 7,
# Qwen3-Next's attention blocks (rep 8 at 256), Qwen3-235B-A22B's rep 16;
# H2O-Danube2-1.8B's 32 on 8 of 80, H2O-Danube3-500M's 16 on 8 of 96 and
# H2O-Danube3-4B's 32 on 8 of 120 (head dims below the 128 width); 48 below
# the 64 width and 192 (rep 8) below the 256 width
SHAPES = [(8, 2, 64), (14, 2, 64), (16, 2, 256), (16, 1, 128), (32, 8, 80), (16, 8, 96),
          (32, 8, 120), (16, 8, 48), (16, 2, 192)]
# per-row positions; left pads with a one-column window (row 2)
CASES = {"positions": ([0, 130, 255], [0, 0, 0]), "pads": ([255, 100, 200], [0, 37, 200])}
SINGLE_POS = [17, 255]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    with torch_threads(2):
        yield


def _shape_id(shape):
    return "h{}_kvh{}_d{}".format(*shape)


def _float_inputs(shape, dtype, seed):
    h, kvh, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, d), np.float32)
    k, v = (rng.standard_normal((B, kvh, S, d), np.float32) for _ in range(2))
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jd) for a in (q, k, v)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)])


def _q8_inputs(shape, seed):
    """q f32, int8 caches and f32 per-token scales, as numpy."""
    h, kvh, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, h, d), np.float32)
    kq, vq = (rng.integers(-127, 128, (B, kvh, S, d)).astype(np.int8) for _ in range(2))
    ks, vs = (rng.uniform(0.002, 0.02, (B, kvh, S)).astype(np.float32) for _ in range(2))
    return q, kq, ks, vq, vs


@functools.cache
def _jax(name):
    """The JAX package's kernel ``name`` in interpret mode, jitted once per
    shape and dtype, positions traced: the cases of one shape share its
    compile."""
    return jax.jit(functools.partial(getattr(jdec, name), interpret=True))


def _rows(pos, pads):
    return (jnp.asarray(pos, jnp.int32), jnp.asarray(pads, jnp.int32),
            torch.tensor(pos, dtype=torch.int32), torch.tensor(pads, dtype=torch.int32))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_batch_matches_jax_kernel(shape, dtype, case):
    (jq, jk, jv), (tq, tk, tv) = _float_inputs(shape, dtype, seed=shape[0] + shape[2])
    jpos, jpads, tpos, tpads = _rows(*CASES[case])
    ref = _jax("decode_attention_batch")(jq, jk, jv, jpos, jpads)
    before = tdec.decode_attention_batch.launches
    got = tdec.decode_attention_batch(tq, tk, tv, tpos, tpads)
    assert tdec.decode_attention_batch.launches == before     # CPU: plain version
    assert got.shape == (B, shape[0], shape[2]) and got.dtype == tq.dtype
    _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_batch_q8_matches_jax_kernel(shape, case):
    arrays = _q8_inputs(shape, seed=shape[1] + shape[2])
    jpos, jpads, tpos, tpads = _rows(*CASES[case])
    ref = _jax("decode_attention_batch_q8")(*(jnp.asarray(a) for a in arrays), jpos, jpads)
    before = tdec.decode_attention_batch_q8.launches
    got = tdec.decode_attention_batch_q8(*(torch.from_numpy(a) for a in arrays), tpos, tpads)
    assert tdec.decode_attention_batch_q8.launches == before
    assert got.shape == (B, shape[0], shape[2]) and got.dtype == torch.float32
    _close(got, ref, Q8_TOL)


@pytest.mark.parametrize("pos", SINGLE_POS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_single_stream_matches_jax_kernel(shape, dtype, pos):
    (jq, jk, jv), (tq, tk, tv) = _float_inputs(shape, dtype, seed=pos + shape[2])
    ref = _jax("decode_attention")(jq[0], jk[0], jv[0], jnp.int32(pos))
    before = tdec.decode_attention.launches
    got = tdec.decode_attention(tq[0], tk[0], tv[0], pos)
    assert tdec.decode_attention.launches == before
    assert got.shape == (shape[0], shape[2]) and got.dtype == tq.dtype
    _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("pos", SINGLE_POS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_single_stream_q8_matches_jax_kernel(shape, pos):
    arrays = [a[0] for a in _q8_inputs(shape, seed=pos + shape[0])]
    ref = _jax("decode_attention_q8")(*(jnp.asarray(a) for a in arrays), jnp.int32(pos))
    before = tdec.decode_attention_q8.launches
    got = tdec.decode_attention_q8(*(torch.from_numpy(a) for a in arrays), pos)
    assert tdec.decode_attention_q8.launches == before
    assert got.shape == (shape[0], shape[2]) and got.dtype == torch.float32
    _close(got, ref, Q8_TOL)


@pytest.mark.parametrize("d", [100, 260, 12, 512])
def test_head_dims_outside_the_set_are_named(d):
    """The check a CUDA call runs before its launch: a head dim above 256
    or not a multiple of 8 raises ValueError naming what the kernel takes
    (on meta tensors here)."""
    assert d > tdec.MAX_HEAD_DIM or d % tdec.HEAD_DIM_STEP
    q = torch.empty(2, 8, d, device="meta")
    k = torch.empty(2, 2, 64, d, device="meta")
    with pytest.raises(ValueError, match=r"head dim .*multiple of 8 up to 256"):
        tdec._check("decode_attention_batch", q, k, k)


@pytest.mark.parametrize("d", [32, 48, 80, 96, 120, 200])
def test_head_dims_below_a_width_pass_the_check(d):
    """A multiple of 8 up to 256 that is not a built width passes, with
    the plan of its own D (chunks sized by its bytes) and the group size of
    the smallest width that holds it."""
    assert d not in tdec.WIDTHS
    q = torch.empty(2, 16, d, device="meta")
    k = torch.empty(2, 2, 4096, d, device="meta")
    pl = tdec._check("decode_attention_batch", q, k, k)
    assert pl == tdec.plan(2, 2, 4096, d, 4, 8)
    assert pl.heads == (4 if d > 128 else 8)          # a lane holds width / 32 dims


@pytest.mark.parametrize("h,kvh", [(16, 1), (14, 2), (40, 4), (64, 4)])
def test_any_query_group_passes_the_check(h, kvh):
    """Any rep = H / KvH passes (rep 16, 7, 10, 16); H % KvH != 0 is refused."""
    q = torch.empty(2, h, 64, device="meta")
    k = torch.empty(2, kvh, 64, 64, device="meta")
    tdec._check("decode_attention_batch", q, k, k)
    k3 = torch.empty(2, 3, 64, 64, device="meta")
    with pytest.raises(ValueError, match="H % KvH"):
        tdec._check("decode_attention_batch", q, k3, k3)


# ---------------------------------------------------------------------------
# llama GGUFs at head dims 64 and 80 through the served path

# Llama-3.2-1B's shape cut to size: head dim 64, 8 heads on 2 KV heads
# (rep 4), hidden = heads x head dim, tied embeddings (no output.weight)
LLAMA = dict(num_blocks=2, dim=512, hidden_dim=256, n_heads=8, n_kv_heads=2, head_dim=64,
             rope_dim=64, v_head_dim=64, vocab_size=384, max_context=256, norm_eps=1e-5,
             rope_theta=500000.0)
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|start_header_id|>",
            "<|end_header_id|>", "<|eot_id|>", "<|reserved_0|>", "<|reserved_1|>",
            "<|reserved_2|>"]


def llama_gguf(path, cfg, params):
    """Write ``params`` (GGUF-named numpy arrays, without output.weight) as
    an arch ``llama`` GGUF with the metadata a llama.cpp conversion carries:
    the head dim from embedding_length / head_count, a byte-level vocab
    (256 byte tokens, filler merges, the Llama-3 specials) with its
    token types."""
    be = byte_encoder()
    n_fill = cfg.vocab_size - 256 - len(SPECIALS)
    tokens = [be[b] for b in range(256)] + [be[97] + be[98] + str(i) for i in range(n_fill)]
    tokens += SPECIALS
    bos = 256 + n_fill
    kv = {"general.architecture": "llama", "llama.block_count": cfg.num_blocks,
          "llama.context_length": cfg.max_context, "llama.embedding_length": cfg.dim,
          "llama.feed_forward_length": cfg.hidden_dim,
          "llama.attention.head_count": cfg.n_heads,
          "llama.attention.head_count_kv": cfg.n_kv_heads,
          "llama.attention.layer_norm_rms_epsilon": cfg.norm_eps,
          "llama.rope.freq_base": cfg.rope_theta,
          "tokenizer.ggml.pre": "llama-bpe", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.token_type": [1] * (256 + n_fill) + [3] * len(SPECIALS),
          "tokenizer.ggml.bos_token_id": bos, "tokenizer.ggml.eos_token_id": bos + 4}
    assert "output.weight" not in params
    gguf.save(path, kv, params)
    return kv


# H2O-Danube2-1.8B's heads cut to size: head dim 80 (below the kernels'
# 128 width), 8 heads on 2 KV heads (rep 4, Danube2's 32 on 8), hidden =
# heads x head dim
DANUBE2 = dict(LLAMA, dim=640, head_dim=80, rope_dim=80, v_head_dim=80, rope_theta=10000.0)


def _llama_file(tmp_path_factory, spec, seed, name):
    cfg = tiny_cfg(**spec)
    params = {k: np.asarray(v) for k, v in jllm.init_params(cfg, seed=seed).items()
              if k != "output.weight"}
    path = tmp_path_factory.mktemp("gguf") / name
    llama_gguf(path, cfg, params)
    return path


@pytest.fixture(scope="module")
def head64_gguf(tmp_path_factory):
    return _llama_file(tmp_path_factory, LLAMA, 11, "llama-head64.gguf")


@pytest.fixture(scope="module")
def head80_gguf(tmp_path_factory):
    return _llama_file(tmp_path_factory, DANUBE2, 17, "danube2-head80.gguf")


PROMPTS = [[376, 5, 9, 100, 7], list(range(30, 75)), [376, 200, 3]]


def _staggered_requests(engine, logprobs=0):
    """Three requests joining a 2-slot engine at different times (one
    prompt of two chunks), so rows decode at different positions; each
    records its top ``logprobs`` alternatives per token."""
    r1 = engine.submit(PROMPTS[0], max_new=10, logprobs=logprobs)
    engine.step()
    engine.step()
    r2 = engine.submit(PROMPTS[1], max_new=8, logprobs=logprobs)
    engine.step()
    r3 = engine.submit(PROMPTS[2], max_new=6, logprobs=logprobs)
    engine.run_until_idle()
    for r in (r1, r2, r3):
        r.wait(1)
    return [r1, r2, r3]


def _staggered(engine):
    """The tokens of _staggered_requests."""
    return [r.tokens for r in _staggered_requests(engine)]


def _agree_up_to_near_ties(got, ref):
    """``got`` and ``ref`` (requests with 2 logprobs each) give the same
    tokens up to each request's first difference, and there only where the
    two packages' logprobs cannot tell the two tokens apart: if each
    token's logprob differs between the packages by at most ``spread``
    (the most the chosen tokens' logprobs differ at the steps that agree),
    the ranking of two tokens can flip only if the port's gap between them
    and the JAX engine's add up to at most 2 x spread. Nothing after a
    difference is compared: the prefixes differ from there."""
    firsts, spread = [], 0.0
    for a, b in zip(got, ref):
        n = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y), None)
        if n is None:
            assert a.tokens == b.tokens
        firsts.append(n)
        spread = max([spread] + [abs(x[0] - y[0]) for x, y in zip(a.lp[:n], b.lp[:n])])
    assert 0 < spread < 0.1
    for a, b, n in zip(got, ref, firsts):
        if n is None:
            continue
        (ta, la), (tb, lb) = a.lp[n][1]
        (ua, ma), (ub, mb) = b.lp[n][1]
        assert (ta, tb) == (ub, ua), "a difference that is not a swap of the top two"
        assert (la - lb) + (ma - mb) <= 2 * spread, (n, la - lb, ma - mb, spread)
    return firsts


def _served_matches_jax(path, kv_quant, monkeypatch, head_dim, near_ties=False):
    """``serve_llm --gguf FILE --pallas [--kv-quant]``'s engine on the CPU
    (bf16 weights as loaded, a bf16 or int8 cache, the decode step through
    the batched kernels' plain versions, 8 heads on 2 of ``head_dim``)
    gives the JAX engine's greedy tokens on the same file:
    ``use_pallas_decode=True, interpret=True`` with the bf16 cache. With
    the int8 cache the JAX engine's Pallas route attends over the raw int8
    values without their scales (its make_serving_fns), so the port is
    held to the JAX engine's plain int8 route there, as in
    test_torch_port_serving.py. ``near_ties``: the tokens agree up to a
    difference where the two packages cannot tell two tokens apart
    (_agree_up_to_near_ties)."""
    from clearcam_tpu_torch.tools import serve_llm
    calls = []
    name = "decode_attention_batch_q8" if kv_quant else "decode_attention_batch"
    plain = getattr(tdec, f"{name}_reference")

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return plain(*a, **kw)
    monkeypatch.setattr(tdec, f"{name}_reference", counted)
    argv = ["--gguf", str(path), "--device", "cpu", "--ctx", "256", "--slots", "2",
            "--json-depth", "0", "--pallas"] + (["--kv-quant"] if kv_quant else [])
    served = serve_llm.build_engine(serve_llm.parse_args(argv))
    cfg = served.engine.cfg
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (head_dim, 4)
    params = served.engine.params                       # the tie: output = embeddings
    assert torch.equal(params["output.weight"], params["token_embd.weight"])
    got = _staggered_requests(served.engine, 2 if near_ties else 0)
    assert calls and {c[1:] for c in calls} == {(8, head_dim)}

    model, _ = jllm.Transformer.from_gguf(path, max_context=256)
    ref = _staggered_requests(JaxEngine(model.params, model.cfg, n_slots=2,
                                        state_dtype=jnp.bfloat16, kv_quant=kv_quant,
                                        use_pallas_decode=not kv_quant, interpret=True),
                              2 if near_ties else 0)
    if near_ties:
        return _agree_up_to_near_ties(got, ref)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    return [None] * len(got)


def _single_stream_matches_jax(path, kv_quant, monkeypatch, head_dim):
    """``Transformer.generate`` with ``use_pallas_decode=True`` (the
    single-stream forms, decode_attention / decode_attention_q8) on the
    file's weights in f32 gives the JAX Transformer's greedy tokens on its
    Pallas single-stream kernels in interpret mode, with a bf16 or an int8
    cache, across a prefix-cache reuse."""
    cfg, tp, _ = tllm.load_gguf(path, max_context=256, dtype=torch.float32)
    kv, sd = gguf.load(path)
    jcfg = jllm.config_from_gguf(kv, sd, max_context=256)
    jp = jllm.convert_state_dict(sd, kv, jnp.float32)
    sdt = (jnp.bfloat16, torch.bfloat16)
    jt = jllm.Transformer(jp, jcfg, state_dtype=sdt[0], kv_quant=kv_quant)
    jt.prefill_fn, jt.decode_fn = jllm.make_step_fns(jcfg, use_pallas_decode=True,
                                                     interpret=True, kv_quant=kv_quant)
    tt = tllm.Transformer(tp, cfg, state_dtype=sdt[1], kv_quant=kv_quant,
                          use_pallas_decode=True)
    calls = []
    name = "decode_attention_q8" if kv_quant else "decode_attention"
    plain = getattr(tdec, f"{name}_reference")

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return plain(*a, **kw)
    monkeypatch.setattr(tdec, f"{name}_reference", counted)
    for prompt in (PROMPTS[0], PROMPTS[0] + [11, 12], PROMPTS[1]):
        want = list(jt.generate(list(prompt), temperature=0.0, max_new=8))
        assert list(tt.generate(list(prompt), temperature=0.0, max_new=8)) == want
    assert calls and set(calls) == {(8, head_dim)}


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_head64_gguf_served_with_pallas_matches_jax(head64_gguf, kv_quant, monkeypatch):
    """The served path at Llama-3.2-1B's head dim 64 (_served_matches_jax)."""
    _served_matches_jax(head64_gguf, kv_quant, monkeypatch, 64)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_head64_gguf_single_stream_kernel_route_matches_jax(head64_gguf, kv_quant,
                                                           monkeypatch):
    """The single-stream route at head dim 64 (_single_stream_matches_jax)."""
    _single_stream_matches_jax(head64_gguf, kv_quant, monkeypatch, 64)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_head80_gguf_served_with_pallas_matches_jax(head80_gguf, kv_quant, monkeypatch):
    """The served path at H2O-Danube2-1.8B's head dim 80, which the kernels
    run on their 128 width (_served_matches_jax). With the int8 cache the
    chosen tokens' logprobs differ between the packages by up to 0.034 at
    the steps that agree, and on this file request 2's sixth token is a
    near tie: the port ranks 122 over 301 by 0.016, the JAX engine 301 over
    122 by 0.033 (0.049 together, under 2 x 0.034). That request is
    compared up to it."""
    firsts = _served_matches_jax(head80_gguf, kv_quant, monkeypatch, 80,
                                 near_ties=kv_quant)
    assert firsts == ([None, 5, None] if kv_quant else [None] * 3)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_head80_gguf_single_stream_kernel_route_matches_jax(head80_gguf, kv_quant,
                                                           monkeypatch):
    """The single-stream route at head dim 80 (_single_stream_matches_jax)."""
    _single_stream_matches_jax(head80_gguf, kv_quant, monkeypatch, 80)


# ---------------------------------------------------------------------------
# a qwen2 GGUF at rep 7 and head dim 64 through the served path

# Qwen2.5-0.5B's heads cut to size: 14 heads on 2 KV heads of 64 (rep 7),
# q/k/v biases, tied embeddings; hidden 256 with key_length 64 (the file
# names the head dim, as for a model whose heads do not split the hidden
# size)
QWEN2 = dict(num_blocks=2, dim=256, hidden_dim=256, n_heads=14, n_kv_heads=2, head_dim=64,
             rope_dim=64, v_head_dim=64, vocab_size=384, max_context=256, norm_eps=1e-6,
             rope_theta=1000000.0, qkv_bias=True)
QWEN2_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "[PAD0]", "[PAD1]"]


def qwen2_gguf(path, cfg, params):
    """Write ``params`` (GGUF-named numpy arrays, without output.weight) as
    an arch ``qwen2`` GGUF as llama.cpp converts a Qwen2.5 model: a
    byte-level vocab with the Qwen2 specials, no BOS added."""
    be = byte_encoder()
    n_fill = cfg.vocab_size - 256 - len(QWEN2_SPECIALS)
    tokens = [be[b] for b in range(256)] + [be[97] + be[98] + str(i) for i in range(n_fill)]
    tokens += QWEN2_SPECIALS
    eot = 256 + n_fill
    a = "qwen2"
    kv = {"general.architecture": a, f"{a}.block_count": cfg.num_blocks,
          f"{a}.context_length": cfg.max_context, f"{a}.embedding_length": cfg.dim,
          f"{a}.feed_forward_length": cfg.hidden_dim,
          f"{a}.attention.head_count": cfg.n_heads,
          f"{a}.attention.head_count_kv": cfg.n_kv_heads,
          f"{a}.attention.key_length": cfg.head_dim,
          f"{a}.attention.value_length": cfg.head_dim,
          f"{a}.attention.layer_norm_rms_epsilon": cfg.norm_eps,
          f"{a}.rope.freq_base": cfg.rope_theta,
          "tokenizer.ggml.pre": "qwen2", "tokenizer.ggml.tokens": tokens,
          "tokenizer.ggml.token_type": [1] * (256 + n_fill) + [3] * len(QWEN2_SPECIALS),
          "tokenizer.ggml.bos_token_id": eot, "tokenizer.ggml.eos_token_id": eot + 2,
          "tokenizer.ggml.add_bos_token": False}
    assert "output.weight" not in params
    gguf.save(path, kv, params)
    return kv


@pytest.fixture(scope="module")
def qwen2_rep7_gguf(tmp_path_factory):
    cfg = tiny_cfg(**QWEN2)
    params = {k: np.asarray(v) for k, v in jllm.init_params(cfg, seed=13).items()
              if k != "output.weight"}
    rng = np.random.default_rng(13)
    for k in params:                                  # biases that matter
        if k.endswith(".bias"):
            params[k] = rng.normal(0.0, 0.5, params[k].shape).astype(params[k].dtype)
    path = tmp_path_factory.mktemp("gguf") / "qwen2-rep7.gguf"
    qwen2_gguf(path, cfg, params)
    return path


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16_cache", "int8_cache"])
def test_qwen2_rep7_gguf_served_with_pallas_matches_jax(qwen2_rep7_gguf, kv_quant,
                                                       monkeypatch):
    """``serve_llm --gguf FILE --pallas [--kv-quant]`` on a ``qwen2`` file
    at Qwen2.5-0.5B's rep 7 and head dim 64 (the tensor-core path of the
    decode kernels on the card; their plain versions here), bf16 or int8
    cache: the JAX engine's greedy tokens on the same file, with its Pallas
    route in interpret mode on the bf16 cache and its plain int8 route on
    the int8 one (as test_head64_gguf_served_with_pallas_matches_jax)."""
    from clearcam_tpu_torch.tools import serve_llm
    calls = []
    name = "decode_attention_batch_q8" if kv_quant else "decode_attention_batch"
    plain = getattr(tdec, f"{name}_reference")

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return plain(*a, **kw)
    monkeypatch.setattr(tdec, f"{name}_reference", counted)
    argv = ["--gguf", str(qwen2_rep7_gguf), "--device", "cpu", "--ctx", "256", "--slots",
            "2", "--json-depth", "0", "--pallas"] + (["--kv-quant"] if kv_quant else [])
    served = serve_llm.build_engine(serve_llm.parse_args(argv))
    cfg = served.engine.cfg
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads, cfg.qkv_bias) == (64, 7, True)
    params = served.engine.params
    assert torch.equal(params["output.weight"], params["token_embd.weight"])
    got = _staggered(served.engine)
    assert calls and {c[1:] for c in calls} == {(14, 64)}
    plan = tdec.plan(2, 2, 256, 64, 1 if kv_quant else 2, 7)
    assert plan.tensor_cores and plan.heads == 16

    model, _ = jllm.Transformer.from_gguf(qwen2_rep7_gguf, max_context=256)
    assert model.cfg.qkv_bias
    ref = _staggered(JaxEngine(model.params, model.cfg, n_slots=2, state_dtype=jnp.bfloat16,
                               kv_quant=kv_quant, use_pallas_decode=not kv_quant,
                               interpret=True))
    assert got == ref
