"""Decode-step and prefill measurements of the port's LLM serving graphs:

    python -m clearcam_tpu_torch.tools.llm_decode_profile [--out FILE.json]

The model is the one ``serve_llm --synthetic`` serves: Qwen/Qwen3-1.7B's
widths (``models.llm.qwen3_2b_cfg``, 28 blocks, ctx 8192) with random bf16
weights from seed 0, 8 slots, a bf16 KV cache; int8 and int4 weights are
quantized from the bf16 ones. For each weight format:

- ``step_ms``: wall milliseconds per ``decode_all`` call (the engine's
  decode step, every slot live at one position), back to back, in turns
  (decode-attention kernel, plain attention, plain, kernel; 30 steps
  each, averaged per side), at positions 256 and 4096;
- ``profile``: ``torch.profiler`` over 5 steps at position 4096, per
  route: device time by kernel name, counting only CUDA-device entries
  (the aten ops report their kernels' time too), the busy share (device
  time / wall time, profiler on) and kernel launches per step;
- ``ttft_ms``: submit to first token on the host (``Request.ttft_s``) of a
  512-token prompt on an idle engine, 4 prompts that share no prefix.

Prints one line per measurement and, last, one JSON object with all of
them (also written to ``--out``). Needs a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Decode:
    """``decode_all`` with every slot live at ``pos`` (greedy rows), its
    own cache and counters, fed its previous tokens."""

    def __init__(self, llm, cfg, params, slots, pallas, dev):
        self.fn = llm.make_serving_fns(cfg, use_pallas_decode=pallas)[1]
        self.params, self.dev = params, dev
        self.state = llm.init_state(cfg, slots, dtype=torch.bfloat16, device=dev)
        self.tok = torch.ones(slots, dtype=torch.int32, device=dev)
        self.cnt_o = torch.zeros((slots, cfg.vocab_size), dtype=torch.int32, device=dev)
        self.cnt_p = torch.zeros_like(self.cnt_o)
        self.bias = torch.zeros((slots, cfg.vocab_size), device=dev)
        self.samp = np.zeros((slots, llm.SAMP_W), np.float32)
        self.samp[:, 1] = self.samp[:, 6] = 1.0
        self.meta = np.zeros((5, slots), np.int32)
        self.meta[1] = 1
        self.meta[3] = np.arange(slots)

    def run(self, pos: int, steps: int) -> float:
        """Wall ms per step over ``steps`` back-to-back steps."""
        self.meta[0] = self.meta[4] = pos
        _sync(self.dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            self.tok, self.state, self.cnt_o, _ = self.fn(
                self.params, self.state, self.tok, self.tok, self.meta, self.samp, 0,
                self.cnt_o, self.cnt_p, self.bias)
        _sync(self.dev)
        return (time.perf_counter() - t0) * 1e3 / steps


def _profile(dec: _Decode, pos: int, steps: int, top: int = 12) -> dict:
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dec.dev.type == "cuda" else [])
    dec.run(pos, 2)
    with profile(activities=acts) as prof:
        wall = dec.run(pos, steps)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    kernel_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    return {"wall_ms_per_step": wall, "kernel_ms_per_step": kernel_ms,
            "busy": kernel_ms / wall,
            "launches_per_step": sum(e.count for e in rows) / steps,
            "top": [[e.key[:90], e.self_device_time_total / 1e3 / steps, e.count / steps]
                    for e in rows[:top]]}


def _ttft(llm, cfg, params, slots, prompt_len, reps, dev) -> list:
    from ..serving import ServingEngine
    eng = ServingEngine(params, cfg, n_slots=slots, state_dtype=torch.bfloat16,
                        use_pallas_decode=True, device=dev)
    rng = np.random.default_rng(7)
    out = []
    try:
        for i in range(reps + 1):                    # the first one warms up
            r = eng.submit(rng.integers(1, cfg.vocab_size, prompt_len).tolist(), max_new=1)
            eng.run_until_idle()
            if i:
                out.append(r.ttft_s * 1e3)
    finally:
        eng.close()
    return out


def measure(cfg, params, device, weights=("bf16", "int8", "int4"), positions=(256, 4096),
            slots: int = 8, steps: int = 30, profile_steps: int = 5,
            ttft_prompt: int = 512, ttft_reps: int = 4, log=print) -> dict:
    """The measurements above for bf16 ``params`` of ``cfg`` on ``device``."""
    from ..models import llm
    dev = resolve_device(device)
    res = {"card": _card() if dev.type == "cuda" else "cpu",
           "config": {"blocks": cfg.num_blocks, "ctx": cfg.max_context, "slots": slots,
                      "steps": steps, "profile_steps": profile_steps},
           "step_ms": {}, "tokens_per_s": {}, "profile": {}, "ttft_ms": {}}
    for w in weights:
        p = params if w == "bf16" else getattr(llm, f"quantize_params_{w}")(params)
        decs = {True: _Decode(llm, cfg, p, slots, True, dev),
                False: _Decode(llm, cfg, p, slots, False, dev)}
        for pos in positions:
            for d in decs.values():                  # warm up (and build the kernels)
                d.run(pos, 2)
            times = {True: [], False: []}
            for pallas in (True, False, False, True):
                times[pallas].append(decs[pallas].run(pos, steps))
            for pallas, ts in times.items():
                key = f"{w} {'kernel' if pallas else 'plain'} pos{pos}"
                res["step_ms"][key] = float(np.mean(ts))
                res["tokens_per_s"][key] = slots * 1e3 / res["step_ms"][key]
                log(f"decode step {key}: {res['step_ms'][key]:.3f} ms "
                    f"({res['tokens_per_s'][key]:.1f} tokens/s; turns {ts})")
        for pallas, d in decs.items():
            key = f"{w} {'kernel' if pallas else 'plain'} pos{positions[-1]}"
            prof = res["profile"][key] = _profile(d, positions[-1], profile_steps)
            log(f"profile {key}: wall {prof['wall_ms_per_step']:.3f} ms/step (profiler on), "
                f"kernels {prof['kernel_ms_per_step']:.3f} ms/step, busy "
                f"{100 * prof['busy']:.1f}%, {prof['launches_per_step']:.0f} launches/step")
            for name, ms, n in prof["top"]:
                log(f"  {ms:9.4f} ms {n:6.1f}x  {name}")
        del decs
        res["ttft_ms"][w] = _ttft(llm, cfg, p, slots, ttft_prompt, ttft_reps, dev)
        log(f"TTFT {ttft_prompt}-token prompt, {w}, idle engine: "
            f"{[round(t, 2) for t in res['ttft_ms'][w]]} ms")
        del p
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    from ..models import llm
    dev = resolve_device("cuda")
    cfg = llm.qwen3_2b_cfg()
    t0 = time.time()
    params = llm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    print(f"{cfg.num_blocks}-block model, bf16 weights on {dev}: {time.time() - t0:.1f} s",
          flush=True)
    res = measure(cfg, params, dev, log=lambda m: print(m, flush=True))
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
