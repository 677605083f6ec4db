"""Standalone LLM serving daemon on the port: POST /generate and the
OpenAI surface (/v1/chat/completions, /v1/completions, /v1/models) over
the continuous-batching engine, with no NVR attached. The counterpart of
``python -m clearcam_tpu.tools.serve_llm``, with its flags and defaults:

    python -m clearcam_tpu_torch.tools.serve_llm --synthetic --int8 --pallas \\
        [--kv-quant] [--blocks 28] [--ctx 8192] [--slots 8] [--port 8081] [--device cuda]
    python -m clearcam_tpu_torch.tools.serve_llm --synthetic --int8 --spec 4

    curl -N -X POST localhost:8081/generate \\
        -d '{"prompt": "hello", "max_new": 64, "stream": true}'

``--synthetic`` serves random weights (seed 0; on a card drawn there by a
torch.Generator, on the CPU numpy's draws as the JAX tool's) at
Qwen/Qwen3-1.7B's published widths (``models.llm.qwen3_2b_cfg``) with a
byte-level stand-in tokenizer; ``--gguf`` loads a checkpoint with the shared GGUF reader and
tokenizer. ``--int8`` quantizes the weights (the quant-matmul kernel),
``--pallas`` runs the decode step's attention through the batched
decode-attention kernel (its int8 form with ``--kv-quant``), ``--spec G``
serves speculative verify windows of G drafted tokens (greedy requests;
not with ``--pallas``, whose kernels take one query). ``--mesh N`` serves
tensor/expert-parallel over N ranks (``parallel.mesh.serving_engine_tp``):
the process starts ranks 1..N-1 itself (or joins ``torchrun``'s group),
one rank a card over NCCL (gloo with ``--device cpu``); HTTP is served on rank 0 only. The HTTP server is
the JAX package's jax-free one, copied into the port (``server.http``).
On SIGTERM or SIGINT it stops and prints each kernel's launch count.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading
from pathlib import Path

import torch

from ..device import resolve_device


class _AsciiTok:
    """Byte-level stand-in tokenizer for --synthetic runs (random weights
    produce token ids, not language; this maps them to printable ASCII so
    the serving path is drivable end-to-end without a checkpoint)."""
    eos_id, eot_id = 0, None

    def __init__(self, vocab: int):
        self.vocab = vocab

    def encode(self, s):
        return [1 + (ord(c) % min(self.vocab - 1, 94)) for c in s]

    def decode(self, ids):
        return "".join(chr(33 + (int(i) % 94)) for i in ids)

    def is_end(self, t):
        return t == self.eos_id

    def role(self, r):
        return self.encode("<" + r + ">")

    def end_turn(self):
        return [self.eos_id]

    def prefix(self):
        return []

    def vocab_bytes(self):
        """Byte view of the synthetic vocab (id -> one printable ASCII
        byte, same mapping as decode) so grammar-constrained decoding is
        drivable on synthetic runs too (the printable range includes the
        whole JSON alphabet)."""
        return [None] + [bytes([33 + (i % 94)])
                         for i in range(1, self.vocab)]


def build_engine(args, mesh=None):
    """The engine ``args`` ask for; under ``mesh`` this rank's
    tensor-parallel engine (``parallel.mesh.serving_engine_tp``)."""
    from ..models import llm
    from ..serving import ServingEngine, TextServing

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    if args.synthetic:
        cfg = llm.qwen3_2b_cfg(args.blocks, args.ctx)
        # on a card the values are drawn there from a torch.Generator seeded
        # 0: numpy's draws of 28 blocks take about a minute on the host
        gen = torch.Generator(device=dev).manual_seed(0) if dev.type == "cuda" else None
        params = llm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev,
                                 generator=gen)
        tok = _AsciiTok(cfg.vocab_size)
    else:
        from ..utils.llm_tokenizer import LLMTokenizer
        cfg, params, kv = llm.load_gguf(args.gguf, max_context=args.ctx, device=dev)
        tok = LLMTokenizer.from_gguf_kv(kv)
    if args.int8:
        params = llm.quantize_params_int8(params)
    constraints = None
    # a follower rank samples nothing it keeps: no grammar table there
    leads = mesh is None or mesh.is_leader
    if args.json_depth > 0 and not args.spec and leads:
        # the JSON grammar (response_format json_object): one [S, V] int16
        # table on the card
        import time
        from ..serving.constrain import json_char_dfa, json_token_constraint, token_table
        t0 = time.monotonic()
        if hasattr(tok, "normal"):
            tc = json_token_constraint(tok, cfg.vocab_size, max_depth=args.json_depth)
        else:                                  # synthetic ASCII tokenizer
            tc = token_table(json_char_dfa(args.json_depth), tok.vocab_bytes(),
                             [tok.eos_id], n_vocab=cfg.vocab_size)
        constraints = {"json": tc}
        print(f"json constraint: {tc.trans.shape[0]} states x {tc.trans.shape[1]} "
              f"vocab ({tc.trans.nbytes / 1e6:.0f} MB, built in "
              f"{time.monotonic() - t0:.1f}s)", flush=True)
    engine_kw = dict(n_slots=args.slots, state_dtype=torch.bfloat16,
                     kv_quant=args.kv_quant, use_pallas_decode=args.pallas,
                     sync_lag=args.sync_lag, fetch_every=args.fetch_every,
                     max_waiting=args.max_waiting, spec_lookup=args.spec,
                     max_restarts=args.max_restarts, constraints=constraints,
                     constraint_rows=0 if args.spec or not leads else args.constraint_rows)
    if mesh is not None:
        # tensor/expert-parallel over the "model" axis: weights and KV cache
        # split, every prefill and decode mirrored by the follower ranks
        from ..parallel import mesh as pmesh
        eng = pmesh.serving_engine_tp(params, cfg, mesh, **engine_kw)
    else:
        eng = ServingEngine(params, cfg, device=dev, **engine_kw)
    return TextServing(eng, tok)


def _follow(argv):
    """A follower rank of ``--mesh N``: the same engine on this rank's
    shards, mirroring rank 0's steps until it stops."""
    from ..parallel import mesh as pmesh
    args = parse_args(argv)
    mesh = pmesh.make_mesh(args.mesh, data=1)
    build_engine(args, mesh)
    mesh.follow()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gguf", type=Path, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="serve a random-weight Qwen3-1.7B-shaped model (no GGUF "
                         "needed; ASCII stand-in tokenizer)")
    ap.add_argument("--blocks", type=int, default=28)
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--port", type=int, default=8081)
    ap.add_argument("--data", type=Path, default=Path("data"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    ap.add_argument("--int8", action="store_true",
                    help="int8 weight-only serving (the quant-matmul kernel)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (half the decode attention's bytes)")
    ap.add_argument("--pallas", action="store_true",
                    help="decode attention through the batched decode kernel")
    ap.add_argument("--spec", type=int, default=0,
                    help="speculative decoding: G-token device-drafted verify windows "
                         "(greedy requests; excludes --pallas)")
    ap.add_argument("--sync-lag", type=int, default=4, dest="sync_lag",
                    help="decode steps tokens materialize late (pipeline depth)")
    ap.add_argument("--fetch-every", type=int, default=4, dest="fetch_every",
                    help="decode steps per batched [k,B] token readback")
    ap.add_argument("--max-waiting", type=int, default=64, dest="max_waiting",
                    help="admission queue bound; overload gets HTTP 503")
    ap.add_argument("--max-restarts", type=int, dest="max_restarts",
                    default=int(os.environ.get("CLEARCAM_SERVING_RESTARTS", "3")),
                    help="scheduler crash recoveries allowed per 10-min window")
    ap.add_argument("--json-depth", type=int, default=4, dest="json_depth",
                    help="max JSON nesting for response_format json_object "
                         "(0 disables; saves the [S, V] table)")
    ap.add_argument("--constraint-rows", type=int, default=512, dest="constraint_rows",
                    help="table rows reserved for grammars registered at runtime")
    ap.add_argument("--api-token", default=None)
    ap.add_argument("--mesh", type=int,
                    default=int(os.environ.get("CLEARCAM_MESH", "0") or 0),
                    help="tensor-parallel the model over N ranks, one a card "
                         "(weights and KV cache split; 0/1 = one device); the "
                         "process starts ranks 1..N-1 itself, or joins torchrun's")
    args = ap.parse_args(argv)
    if args.gguf is None and not args.synthetic:
        ap.error("--gguf PATH or --synthetic required")
    if args.spec and args.pallas:
        ap.error("--spec excludes --pallas: a verify window has G+1 queries, the "
                 "decode kernels take one")
    return args


def main(argv=None):
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    from ..ops.decode_attention import decode_attention_batch, decode_attention_batch_q8
    from ..ops.quant_matmul import quant_linear

    mesh = ranks = None
    if args.mesh > 1:
        from ..parallel import comm
        from ..parallel import mesh as pmesh
        _, _, ranks = comm.start_ranks(args.mesh, _follow, (argv,), args.device)
        mesh = pmesh.make_mesh(args.mesh, data=1)
        print(f"mesh: {mesh}", flush=True)
    gen = build_engine(args, mesh)
    gen.engine.start()                       # own scheduler thread
    from ..server.http import AppContext, serve
    from ..utils.db import KVStore
    ctx = AppContext(KVStore(args.data / "cc_cache.db"), args.data, gen=gen,
                     api_token=args.api_token,
                     served_model=(args.gguf.stem if args.gguf else "clearcam-synthetic"))
    server = serve(ctx, port=args.port)
    if server is None:
        gen.engine.close()
        if ranks is not None:
            mesh.stop_followers()
            ranks.close()
        raise SystemExit(f"port {args.port} in use")
    print(f"LLM serving on :{args.port} ({args.slots} slots, ctx {args.ctx}, "
          f"device {gen.engine.device})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    finally:
        server.shutdown()
        gen.engine.close()
        if ranks is not None:
            mesh.stop_followers()
            ranks.close()
        print(f"quant_matmul.launches={quant_linear.launches}", flush=True)
        print(f"decode_attention.launches={decode_attention_batch.launches}", flush=True)
        print(f"decode_attention_batch_q8.launches={decode_attention_batch_q8.launches}",
              flush=True)
        print(f"spec_emitted={gen.engine.stats['spec_emitted']} "
              f"decode_steps={gen.engine.stats['decode_steps']}", flush=True)


if __name__ == "__main__":
    main()
