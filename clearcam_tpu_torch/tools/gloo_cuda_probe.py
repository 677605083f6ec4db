"""Which torch.distributed ops the gloo backend takes CUDA tensors for.

Two gloo ranks share one card; each op runs in a fresh pair of processes,
since gloo may abort a process outright (``writev ... Bad address``) when
it is handed device memory it cannot read. Prints one JSON object: per op,
"ok" (ran, and the values are right), "wrong" (ran, wrong values) or the
way it failed. ``parallel.comm.GLOO_CUDA_OPS`` is set from this.

    python -m clearcam_tpu_torch.tools.gloo_cuda_probe [--timeout 60]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "scatter", "gather", "send_recv",
       "batch_isend_irecv", "all_to_all_single")


def _run(rank: int, op: str, path: str, q) -> None:
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    other = 1 - rank
    if op == "all_reduce":
        out = t.clone()
        dist.all_reduce(out)
        want = torch.arange(8.0) * 2 + 10
    elif op == "broadcast":
        out = t.clone()
        dist.broadcast(out, 0)
        want = torch.arange(8.0)
    elif op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        out, want = torch.cat(parts), torch.cat([torch.arange(8.0), torch.arange(8.0) + 10])
    elif op == "all_gather_into_tensor":
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, t)
        want = torch.cat([torch.arange(8.0), torch.arange(8.0) + 10])
    elif op == "reduce_scatter_tensor":
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, t)
        want = (torch.arange(8.0) * 2 + 10)[4 * rank:4 * rank + 4]
    elif op == "scatter":
        out = torch.empty_like(t)
        dist.scatter(out, [t.clone(), t.clone() + 1] if rank == 0 else None, 0)
        want = torch.arange(8.0) + rank
    elif op == "gather":
        parts = [torch.empty_like(t) for _ in range(2)] if rank == 0 else None
        dist.gather(t, parts, 0)
        out = torch.cat(parts) if rank == 0 else t
        want = torch.cat([torch.arange(8.0), torch.arange(8.0) + 10]) if rank == 0 \
            else torch.arange(8.0) + 10
    elif op == "send_recv":
        out = t.clone()
        if rank == 0:
            dist.send(t, 1)
        else:
            dist.recv(out, 0)
        want = torch.arange(8.0)
    elif op == "batch_isend_irecv":
        out = torch.empty_like(t)
        for r in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, other),
                                         dist.P2POp(dist.irecv, out, other)]):
            r.wait()
        want = torch.arange(8.0) + 10 * other
    else:
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
        want = torch.cat([torch.arange(4.0) + 10 * 0 + 4 * rank,
                          torch.arange(4.0) + 10 + 4 * rank])
    torch.cuda.synchronize()
    q.put((rank, "ok" if torch.equal(out.cpu(), want) else "wrong"))
    dist.barrier()
    dist.destroy_process_group()


def probe(op: str, timeout: float) -> str:
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rdv")
        procs = [ctx.Process(target=_run, args=(r, op, path, q)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        got = {}
        while not q.empty():
            r, v = q.get()
            got[r] = v
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
                codes.append("timeout")
            else:
                codes.append(p.exitcode)
    if len(got) == 2 and all(c == 0 for c in codes):
        return "ok" if set(got.values()) == {"ok"} else "wrong"
    return f"failed (exit codes {codes}, results {got})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=60.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    res = {op: probe(op, args.timeout) for op in OPS}
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0), "gloo_cuda": res}),
          flush=True)


if __name__ == "__main__":
    main()
