"""LLM serving micro-benchmark on the card: prefill and decode tokens/s of
the port's LLM paths, the counterpart of ``clearcam_tpu.tools.llm_bench``
with its flags and JSON keys.

The model has Qwen/Qwen3-1.7B's published widths (``models.llm.qwen3_2b_cfg``),
or with ``--ssm`` the JAX tool's Qwen3-Next-class GatedDeltaNet hybrid
(``models.llm.qwen3_next_cfg``), and random bf16 weights from seed 0
(throughput depends on the shapes, not the values; on a card they are drawn
there by a torch.Generator, on the CPU by numpy as the JAX tool's). One JSON line per
measurement:

  * ``--modes`` (``bench_mode``): chunked-prefill tokens/s up to ctx-64 and
    single-stream decode tokens/s per mode, '+'-joined flags: bf16, int8 or
    int4 weights (the quant-matmul kernel), kv16 (bf16 KV cache) or kv8
    (int8 KV cache and scales), pallas (the single-stream decode-attention
    kernel, ``decode_attention`` or ``decode_attention_q8`` with kv8);
  * ``--decode-batch 1,8`` (``bench_batched``): the batched-decode ladder
    (``generate_batch``'s step, int8 weights), aggregate tokens/s per batch,
    with ``--pallas`` through ``decode_attention_batch``;
  * ``--serving`` (``bench_serving``): the continuous-batching engine (int8
    weights) under staggered requests, with ``--spec G`` (speculative verify
    windows and their tokens per window), ``--shared-prefix``,
    ``--no-prefix-cache``, ``--loop-prompts`` and ``--json``;
  * ``--score N`` (``bench_score``): teacher-forced scoring tokens/s.

``--modes`` and ``--decode-batch`` may be given together and both run.
Every time is a host clock around work that ends in
``torch.cuda.synchronize()``, after a warm-up that builds the kernels.
``--device cpu`` runs the same paths on the CPU (a small ``--blocks`` and
``--ctx``; numbers from the host, not the card).

    python -m clearcam_tpu_torch.tools.llm_bench --blocks 28 \\
        --modes int8,int8+kv8+pallas --decode-batch 1,8 --steps 32
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models import llm


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_mode(cfg, params, mode: str, ctx: int, steps: int,
               decode_pos: int | None = None) -> dict:
    """mode: '+'-joined flags: bf16|int8|int4 (weights), kv16 (bf16 KV
    cache), kv8 (int8 KV cache with per-token scales), pallas (the
    single-stream decode-attention kernel; composes with kv8)."""
    flags = set(mode.split("+"))
    prefill, decode = llm.make_step_fns(cfg, use_pallas_decode="pallas" in flags,
                                        kv_quant="kv8" in flags)
    if "int8" in flags:
        params = llm.quantize_params_int8(params)
    elif "int4" in flags:
        params = llm.quantize_params_int4(params)
    dev = params["output_norm.weight"].device
    state = llm.init_state(cfg, dtype=torch.bfloat16 if "kv16" in flags else torch.float32,
                           kv_quant="kv8" in flags, device=dev)
    samp = llm.pack_samp(0.0).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    chunk = llm.CHUNK
    toks = torch.zeros((1, chunk), dtype=torch.int64, device=dev)

    # prefill: fill ctx-64 positions in CHUNK-wide steps
    n_chunks = max(1, (ctx - 64) // chunk)
    tok, state = prefill(params, state, toks, 0, chunk, samp, gen)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(1, n_chunks):
        tok, state = prefill(params, state, toks, i * chunk, chunk, samp, gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    prefill_tps = (n_chunks - 1) * chunk / dt if n_chunks > 1 else float("nan")

    # decode: single-token steps at the live position; decode_pos overrides
    # it (short positions are the NVR's per-event regime)
    pos = decode_pos if decode_pos is not None else n_chunks * chunk
    one = torch.zeros((1, 1), dtype=torch.int64, device=dev)
    tok, state = decode(params, state, one, pos, samp, gen)
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        tok, state = decode(params, state, one, pos + i, samp, gen)
    _sync(dev)
    dt = time.perf_counter() - t0
    return {"mode": mode, "prefill_tok_s": prefill_tps, "decode_tok_s": steps / dt}


def bench_batched(cfg, params, batches, steps: int, pos: int = 256,
                  pallas: bool = False) -> list:
    """The batched-decode ladder (generate_batch's decode step): aggregate
    tokens/s for each batch size. pallas=True runs the attention through
    ``decode_attention_batch`` (each row's own window) instead of the plain
    product over the whole cache."""
    dev = params["output_norm.weight"].device
    freqs = llm.freqs_for(cfg, dev)
    attn_impl = llm.decode_attn_impl(True, False) if pallas else None

    @torch.inference_mode()
    def decode(state, token, start_pos, pads, live):
        hidden, state = llm.forward(params, cfg, state, token, start_pos, freqs,
                                    pad_start=pads, decode_attn=attn_impl, row_live=live)
        return torch.argmax(llm.logits_at(params, cfg, hidden, 0), -1), state

    out = []
    for b in batches:
        state = llm.init_state(cfg, batch=b, dtype=torch.bfloat16, device=dev)
        tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        pads = torch.zeros((b,), dtype=torch.int32, device=dev)
        # a hybrid's recurrences step every row (no pads in the ladder)
        live = None if cfg.ssm is None else torch.ones(b, dtype=torch.bool, device=dev)
        decode(state, tok, pos, pads, live)
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(steps):
            decode(state, tok, pos + i, pads, live)
        _sync(dev)
        dt = time.perf_counter() - t0
        r = {"batch": b, "pos": pos, "pallas": pallas,
             "decode_tok_s": steps * b / dt, "per_stream": steps / dt}
        out.append(r)
        print(json.dumps(r), flush=True)
        del state
    return out


def bench_serving(cfg, params, n_slots: int, n_requests: int, prompt_len: int,
                  max_new: int, pallas: bool = False, shared_prefix: int = 0,
                  prefix_cache: bool = True, fetch_every: int = 4,
                  prefill_batch: bool = True, spec: int = 0, loop_prompts: int = 0,
                  constraint: bool = False) -> dict:
    """Continuous-batching engine throughput (serving/engine.py): n_requests
    with staggered prompt lengths (slots at different positions), the
    scheduler driven until drained; aggregate generated tokens/s, prefill
    and scheduling included. With spec, ``tokens_per_window`` = tokens
    emitted per decode dispatch (windows of retired rows in the lag count
    in the denominator)."""
    from ..serving import ServingEngine

    dev = params["output_norm.weight"].device
    rng = np.random.default_rng(0)
    cons = None
    if constraint:
        # the JSON grammar over the synthetic ASCII vocab, at the full
        # vocab width (a [B, V] int16 row gather and mask per step)
        from ..serving.constrain import json_char_dfa, token_table
        from .serve_llm import _AsciiTok
        t0 = time.perf_counter()
        tc = token_table(json_char_dfa(4), _AsciiTok(cfg.vocab_size).vocab_bytes(), [0],
                         cfg.vocab_size)
        print(json.dumps({"constraint_table": True, "states": int(tc.trans.shape[0]),
                          "mb": tc.trans.nbytes / 1e6,
                          "build_s": time.perf_counter() - t0}), flush=True)
        cons = {"json": tc}
    eng = ServingEngine(params, cfg, n_slots=n_slots, state_dtype=torch.bfloat16,
                        use_pallas_decode=pallas, prefix_cache=prefix_cache,
                        fetch_every=fetch_every, prefill_batch=prefill_batch,
                        spec_lookup=spec, constraints=cons, device=dev)
    # prompt lengths +-25%, so slots sit at different positions
    lens = [max(8, int(prompt_len * f)) for f in rng.uniform(0.75, 1.25, n_requests)]
    # shared_prefix: every request opens with the same N tokens (a system
    # prompt; the prefix cache skips it after a slot's first occupant)
    pre = rng.integers(1, cfg.vocab_size - 1, shared_prefix).tolist()
    if loop_prompts:
        # k-token patterns repeated: prompt-lookup drafting's best case
        prompts = []
        for n in lens:
            pat = rng.integers(1, cfg.vocab_size - 1, loop_prompts).tolist()
            body = max(1, n - shared_prefix)
            prompts.append(pre + (pat * (body // loop_prompts + 1))[:body])
    else:
        prompts = [pre + rng.integers(1, cfg.vocab_size - 1,
                                      max(1, n - shared_prefix)).tolist() for n in lens]

    # warm every graph outside the timed region: a solo request (prefill_slot
    # and decode), then two at once (prefill_many)
    w = eng.submit(prompts[0][:8], max_new=2)
    eng.run_until_idle()
    assert w.done
    if n_slots >= 2:
        w2 = [eng.submit([3, 1, 4, 1, 5], max_new=2), eng.submit([2, 7, 1, 8], max_new=2)]
        eng.run_until_idle()
        assert all(r.done for r in w2)
    steps0, emitted0 = eng.stats["decode_steps"], eng.stats["spec_emitted"]
    _sync(dev)

    t0 = time.perf_counter()
    kw = {"constraint": "json", "eos_id": 0, "temperature": 1.0} if constraint else {}
    reqs = [eng.submit(p, max_new=max_new, **kw) for p in prompts]
    eng.run_until_idle()
    _sync(dev)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in reqs)
    assert all(r.done for r in reqs)
    r = {"serving": True, "n_slots": n_slots, "n_requests": n_requests,
         "constraint": constraint, "prompt_len": prompt_len, "max_new": max_new,
         "pallas": pallas, "shared_prefix": shared_prefix, "fetch_every": fetch_every,
         "prefill_batch": prefill_batch, "spec": spec,
         "prefill_batched_steps": eng.stats["prefill_batched_steps"],
         "reused_tokens": eng.stats["reused_tokens"],
         "prefill_tokens": eng.stats["prefill_tokens"],
         "wall_s": dt, "generated": total, "agg_tok_s": total / dt,
         "prefill_tok_s_incl": sum(len(p) for p in prompts) / dt}
    ttfts = [q.ttft_s for q in reqs if q.ttft_s is not None]
    tpots = [q.tpot_s for q in reqs if q.tpot_s is not None]
    if ttfts:
        r["ttft_ms_mean"] = 1e3 * sum(ttfts) / len(ttfts)
    if tpots:
        r["tpot_ms_mean"] = 1e3 * sum(tpots) / len(tpots)
    if spec:
        r["tokens_per_window"] = (eng.stats["spec_emitted"] - emitted0) / max(
            1, eng.stats["decode_steps"] - steps0)
    eng.close()
    print(json.dumps(r), flush=True)
    return r


def bench_score(cfg, params, length: int) -> dict:
    """Teacher-forced scoring throughput (llm.make_score_fn, the
    /v1/completions echo surface) over one random ``length``-token
    prompt; each chunk's rows come back to the host, as the API returns
    them."""
    score = llm.make_score_fn(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size - 1, length).tolist()
    score(params, toks)                       # warm up
    t0 = time.perf_counter()
    rows = score(params, toks)
    dt = time.perf_counter() - t0
    assert len(rows) == length - 1
    r = {"score": True, "length": length, "score_tok_s": length / dt, "wall_s": dt}
    print(json.dumps(r), flush=True)
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=28)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--modes", default=None,
                    help="comma list of modes (default bf16,int8,int8+kv16 when no "
                         "other measurement is asked for)")
    ap.add_argument("--decode-pos", type=int, default=None,
                    help="decode at this live position instead of ctx-64 (short "
                         "positions = the NVR's per-event regime)")
    ap.add_argument("--decode-batch", default=None,
                    help="comma list of batch sizes: the batched-decode ladder")
    ap.add_argument("--pallas", action="store_true",
                    help="with --decode-batch/--serving: the batched decode kernel")
    ap.add_argument("--serving", action="store_true",
                    help="continuous-batching engine throughput under staggered requests")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="with --serving: every prompt opens with the same N tokens")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="with --serving: no slot prefix reuse")
    ap.add_argument("--spec", type=int, default=0,
                    help="with --serving: G-token device-drafted verify windows")
    ap.add_argument("--loop-prompts", type=int, default=0,
                    help="with --serving: k-token repeated-pattern prompts "
                         "(prompt-lookup's best case)")
    ap.add_argument("--json", action="store_true",
                    help="with --serving: every request under the JSON grammar")
    ap.add_argument("--score", type=int, default=0,
                    help="teacher-forced scoring tokens/s over an N-token prompt")
    ap.add_argument("--ssm", action="store_true",
                    help="the Qwen3-Next-class hybrid (GatedDeltaNet + every-4th-block "
                         "attention) instead of the dense config; --serving keeps its "
                         "weights bf16")
    ap.add_argument("--no-prefill-batch", action="store_true",
                    help="with --serving: one prefill_slot call per slot and chunk")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (llm.qwen3_next_cfg(args.blocks, args.ctx) if args.ssm
           else llm.qwen3_2b_cfg(args.blocks, args.ctx))
    # on a card the values are drawn there (a torch.Generator seeded 0):
    # numpy's draws of 28 blocks take about a minute on the host
    gen = torch.Generator(device=dev).manual_seed(0) if dev.type == "cuda" else None
    params = llm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev, generator=gen)
    n_params = sum(v.numel() for v in params.values())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# {args.blocks} blocks, {n_params / 1e9:.2f}B params, ctx {args.ctx}, "
          f"device {name}", flush=True)
    with torch.inference_mode():
        if args.score:
            return bench_score(cfg, params, args.score)
        if args.serving:
            # as the JAX tool: the hybrid serves its bf16 weights
            return bench_serving(cfg, params if args.ssm else
                                 llm.quantize_params_int8(params), args.slots,
                                 args.requests, args.prompt_len, args.max_new,
                                 pallas=args.pallas, shared_prefix=args.shared_prefix,
                                 prefix_cache=not args.no_prefix_cache,
                                 prefill_batch=not args.no_prefill_batch, spec=args.spec,
                                 loop_prompts=args.loop_prompts, constraint=args.json)
        results = []
        if args.decode_batch:
            results += bench_batched(cfg, llm.quantize_params_int8(params),
                                     [int(b) for b in args.decode_batch.split(",")],
                                     args.steps,
                                     pos=args.decode_pos if args.decode_pos is not None
                                     else 256, pallas=args.pallas)
        modes = args.modes or (None if args.decode_batch else "bf16,int8,int8+kv16")
        for mode in (modes.split(",") if modes else []):
            r = bench_mode(cfg, params, mode.strip(), args.ctx, args.steps,
                           decode_pos=args.decode_pos)
            results.append(r)
            print(json.dumps(r), flush=True)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        return results


if __name__ == "__main__":
    main()
