"""Fine-tune YOLOv9 on a YOLO-format dataset over torch, the counterpart of
``clearcam_tpu.tools.finetune`` (training is new in this framework: the
reference is inference-only).

Dataset layout (the standard YOLO txt format):
    <root>/images/*.jpg|png
    <root>/labels/<same-stem>.txt   lines: "<cls> <cx> <cy> <w> <h>" normalized

Pipeline: the host loader letterboxes images to a square res and maps boxes
into the same pixel space (padded to a fixed per-image box count, so every
step has the same shapes); the step is models/yolo_loss.make_finetune_step
(TAL assignment + CIoU + BCE, clipped AdamW), on the device ``--device``
names (default cuda; it raises without a GPU, and ``--device cpu`` runs on
the CPU). The stem runs in its CUDA kernel on the live weights
(``ops.stem.stem_train``). ``--mesh [N]`` trains dp x tp over N ranks
(``parallel.mesh``: the batch split over ``data``, conv output channels
over ``model``), one rank a card over NCCL (gloo with ``--device cpu``).

Checkpoints (``--ckpt-dir``) are the port's own format, not the JAX tool's
orbax directories: one ``torch.save`` file ``<ckpt-dir>/state`` holding the
parameters, the optimizer state and the step, written as ``state.new`` and
renamed over ``state``; a run that finds it resumes there, drawing its
batches from seed + start step as the JAX tool does.

The output is written in the PUBLISHED safetensors layout (OIHW filters,
tinygrad state-dict names), so it interchanges with released weights and
loads back through ``YOLOv9.from_safetensors`` of either package. The run
ends with a ``# finetune {...}`` line: the steps this run took, their
losses, their host ms (first, median, range; each step ends when its loss
is read back), the peak device memory, and the stem kernel's launches over
them.

Usage:
    python -m clearcam_tpu_torch.tools.finetune <dataset_root> \\
        [--size t --res 640 --batch 8 --steps 500 --lr 1e-4] \\
        [--init weights/yolov9-t.safetensors] [--out runs/ft.safetensors] \\
        [--remat] [--ckpt-dir DIR --ckpt-every 100] [--device cuda] [--mesh [N]]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np


def load_dataset(root: str | Path, res: int, max_boxes: int = 32):
    """-> (images [N,res,res,3] f32 0..1 RGB, boxes [N,max_boxes,4] xyxy px,
    cls [N,max_boxes] (-1 pad)). Letterboxed on host once; small datasets
    stay resident, the train loop samples batches from the arrays."""
    import cv2

    root = Path(root)
    img_paths = sorted(p for p in (root / "images").iterdir()
                       if p.suffix.lower() in (".jpg", ".jpeg", ".png"))
    if not img_paths:
        raise FileNotFoundError(f"no images under {root / 'images'}")
    imgs, boxes, clss = [], [], []
    for p in img_paths:
        img = cv2.imread(str(p))[:, :, ::-1]        # BGR -> RGB
        h, w = img.shape[:2]
        r = min(res / h, res / w)
        nh, nw = int(round(h * r)), int(round(w * r))
        canvas = np.zeros((res, res, 3), np.float32)
        top, left = (res - nh) // 2, (res - nw) // 2
        canvas[top:top + nh, left:left + nw] = cv2.resize(
            img, (nw, nh), interpolation=cv2.INTER_LINEAR) / 255.0
        b = np.zeros((max_boxes, 4), np.float32)
        c = np.full((max_boxes,), -1.0, np.float32)
        label = root / "labels" / (p.stem + ".txt")
        if label.exists():
            rows = np.loadtxt(label, ndmin=2, dtype=np.float32)
            for j, (cid, cx, cy, bw, bh) in enumerate(rows[:max_boxes]):
                x1 = (cx - bw / 2) * w * r + left
                y1 = (cy - bh / 2) * h * r + top
                x2 = (cx + bw / 2) * w * r + left
                y2 = (cy + bh / 2) * h * r + top
                b[j] = [x1, y1, x2, y2]
                c[j] = cid
        imgs.append(canvas)
        boxes.append(b)
        clss.append(c)
    return np.stack(imgs), np.stack(boxes), np.stack(clss)


def save_published(params: dict, path: str | Path) -> None:
    """Write params in the published layout (OIHW, flat names)."""
    from ..io import safetensors as st

    sd = {}
    for k, v in params.items():
        arr = np.asarray(v, np.float32)
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        sd[k] = arr
    st.save(sd, path)


def train_params(params: dict, device) -> dict:
    """Flat HWIO numpy params -> the leaf tensors a step trains: the model
    layout (``params_from_jax``, OIHW filters) on ``device``, float32,
    requires_grad, without the stem kernel's packed operands (the training
    forward reads the live layer weights)."""
    import torch
    from ..models import yolov9
    tensors = yolov9.params_from_jax(params, device, torch.float32)
    return {k: v.detach().clone().requires_grad_()
            for k, v in tensors.items() if k not in yolov9.STEM_PACKED_KEYS}


def hwio_params(params: dict) -> dict:
    """Trained leaf tensors -> flat HWIO numpy params (the JAX layout)."""
    from ..nn import functional as F
    return {k: (F.oihw_to_hwio(v) if v.ndim == 4 else v).detach().cpu().numpy()
            for k, v in params.items()}


def _adam_state(params: dict, opt_state, mesh) -> dict:
    """The optimizer's state dict with each tensor-parallel slice's moments
    gathered whole (a collective under ``mesh``)."""
    sd = opt_state.state_dict()
    if mesh is None:
        return sd
    from ..parallel import comm
    for i, v in enumerate(params.values()):
        g = getattr(v, "tp_group", None)
        if g is not None and i in sd["state"]:
            st = dict(sd["state"][i])
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = comm.all_gather(st[k].contiguous(), g, 0)
            sd["state"][i] = st
    return sd


def _local(full, like):
    """This rank's slice of a whole tensor, as ``like`` (a
    ``shard_params_tp`` slice, or whole) holds it."""
    g = getattr(like, "tp_group", None)
    if g is None:
        return full
    import torch.distributed as dist
    n = like.shape[0]
    return full[dist.get_rank(g) * n:(dist.get_rank(g) + 1) * n]


def train(dataset: str, size: str = "t", res: int = 640, batch: int = 8,
          steps: int = 500, lr: float = 1e-4, clip_norm: float = 1.0,
          remat: bool = False, init: str | None = None,
          out: str = "yolov9-finetuned.safetensors", use_mesh: bool = False,
          seed: int = 0, log_every: int = 20, ckpt_dir: str | None = None,
          ckpt_every: int = 100, device="cuda", mesh_n: int | None = None):
    """-> the loss of each step this run took (the JAX tool's return).

    ``use_mesh``: dp x tp over ``mesh_n`` ranks (default: every visible
    card), the JAX rule's (data, model) split (``parallel.mesh.make_mesh``;
    2 ranks give (1, 2)). This process is rank 0 and starts the others
    (or joins ``torchrun``'s group); every rank runs the same steps on its
    data rows and ``shard_params_tp`` slices, and rank 0 prints, writes the
    checkpoints and the output."""
    kw = dict(dataset=dataset, size=size, res=res, batch=batch, steps=steps, lr=lr,
              clip_norm=clip_norm, remat=remat, init=init, out=out, seed=seed,
              log_every=log_every, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
              device=device)
    if not use_mesh:
        return _train(mesh_n=None, **kw)
    import torch
    from ..parallel import comm
    n = mesh_n or torch.cuda.device_count()
    if n < 1:
        raise SystemExit("--mesh needs a rank count on the CPU (--mesh N)")
    _, _, ranks = comm.start_ranks(n, _train_rank, (n, kw), device)
    try:
        return _train(mesh_n=n, **kw)
    finally:
        ranks.close()


def _train_rank(n: int, kw: dict) -> None:
    _train(mesh_n=n, **kw)


def _train(dataset, size, res, batch, steps, lr, clip_norm, remat, init, out, seed,
           log_every, ckpt_dir, ckpt_every, device, mesh_n):
    import torch
    from ..device import resolve_device
    from ..models import yolov9
    from ..models.yolo_loss import make_finetune_step
    from ..ops.stem import stem

    mesh = None
    if mesh_n is not None:
        from ..parallel import mesh as pmesh
        mesh = pmesh.make_mesh(mesh_n)
    lead = mesh is None or mesh.is_leader
    say = print if lead else (lambda *a, **k: None)
    dev = mesh.device if mesh is not None else resolve_device(device)
    imgs, boxes, clss = load_dataset(dataset, res)
    n = len(imgs)
    say(f"dataset: {n} images, res {res}, batch {batch}, device {dev}")

    if init:
        from ..io import safetensors as st
        np_params = yolov9.convert_state_dict(st.load(init))
        say(f"initialized from {init}")
    else:
        np_params = yolov9.init_params(size, seed=seed)
    params = train_params(np_params, dev)
    if mesh is not None:
        params = pmesh.shard_params_tp(mesh, params)
        say(f"mesh: {mesh.shape}")

    step_fn, opt = make_finetune_step(size, lr=lr, clip_norm=clip_norm, remat=remat,
                                      mesh=mesh)
    opt_state = opt.init(params)

    # checkpoint/resume: params + optimizer state + step counter (whole
    # tensors, so a run under a mesh and one without share checkpoints)
    start_step = 0
    ckpt = Path(ckpt_dir).resolve() / "state" if ckpt_dir else None
    if ckpt is not None and ckpt.exists():
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, v in params.items():
                v.copy_(_local(state["params"][k], v))
        sd = state["opt_state"]
        for i, v in enumerate(params.values()):
            if i in sd["state"] and getattr(v, "tp_group", None) is not None:
                sd["state"][i] = {k: (_local(t, v) if k != "step" else t)
                                  for k, t in sd["state"][i].items()}
        opt_state.load_state_dict(sd)
        start_step = int(state["step"])
        say(f"resumed from {ckpt} at step {start_step}")

    def whole_params():
        if mesh is None:
            return params
        return pmesh.gather_params_tp(params)

    def save_ckpt(step_no):
        if ckpt is None:
            return
        full, sd = whole_params(), _adam_state(params, opt_state, mesh)
        if not lead:
            return
        ckpt.parent.mkdir(parents=True, exist_ok=True)
        tmp = ckpt.with_name("state.new")
        torch.save({"params": {k: v.detach() for k, v in full.items()},
                    "opt_state": sd, "step": step_no}, tmp)
        os.replace(tmp, ckpt)

    rng = np.random.default_rng(seed + start_step)
    losses, step_ms = [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = stem.launches

    def rows(a, dtype=None):
        t = torch.from_numpy(a)
        if mesh is not None:
            t = pmesh.shard_batch(mesh, t)
        return t.to(dev, dtype) if dtype is not None else t.to(dev)

    for it in range(start_step, steps):
        t0 = time.perf_counter()
        idx = rng.integers(0, n, batch)
        params, opt_state, loss = step_fn(
            params, opt_state, rows(imgs[idx]), rows(boxes[idx]),
            rows(clss[idx], torch.int32))
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if it % log_every == 0 or it == steps - 1:
            say(f"step {it:5d}  loss {losses[-1]:.4f}")
        if ckpt_every and ckpt is not None and (it + 1) % ckpt_every == 0:
            save_ckpt(it + 1)
    save_ckpt(steps)
    full = whole_params()
    if lead:
        save_published(hwio_params(full), out)
    say(f"saved {out}")
    summary = {"start_step": start_step, "steps": len(losses), "losses": losses,
               "remat": remat,
               "device": str(dev), "stem_launches": stem.launches - launches0,
               "mesh": mesh.shape if mesh is not None else None,
               "step_ms": ({"first": step_ms[0], "median": float(np.median(step_ms)),
                            "min": min(step_ms), "max": max(step_ms)} if step_ms else None),
               "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)}
    say(f"# finetune {json.dumps(summary)}", flush=True)
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset")
    ap.add_argument("--size", default="t")
    ap.add_argument("--res", type=int, default=640)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--clip-norm", type=float, default=1.0)
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize activations (torch.utils.checkpoint): the "
                         "backward reruns the forward instead of keeping it")
    ap.add_argument("--init", help="published safetensors to start from")
    ap.add_argument("--out", default="yolov9-finetuned.safetensors")
    ap.add_argument("--mesh", nargs="?", type=int, const=0, default=None,
                    help="dp x tp over N ranks (default: every visible card), one "
                         "a card; this process starts the others or joins torchrun's")
    ap.add_argument("--ckpt-dir",
                    help="checkpoint dir: save params+optimizer+step every "
                         "--ckpt-every steps, auto-resume if present")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    train(args.dataset, args.size, args.res, args.batch, args.steps, args.lr,
          args.clip_norm, args.remat, args.init, args.out, args.mesh is not None,
          ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, device=args.device,
          mesh_n=args.mesh or None)


if __name__ == "__main__":
    main()
