"""Multi-host scale-out for the NVR pipeline, the counterpart of
``clearcam_tpu.parallel.federation``'s device layer (the service layer,
HTTP peering, is ``cloud/federation.py``).

Every NVR host joins one process group (``init_distributed``, ``tcp://``
rendezvous at process 0); the global mesh puts the ``data`` (camera
batch) axis across hosts and keeps each ``model`` group on one host. Each
process contributes its local cameras' frames with
``host_batch_to_global`` (no frame crosses a process: only the offset of
its rows is agreed), detects them with ``global_detect_step`` and reads
back its own rows with ``fetch_local``.
"""
from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import comm
from .mesh import Mesh, _current_device


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_ids=None, device: str = "cuda") -> torch.device:
    """Join the federation's process group; call once a process before any
    device use. coordinator: "host:port" of process 0. On the card the
    process runs on ``local_device_ids[0]`` (default card 0) over NCCL;
    ``device="cpu"`` joins over gloo. -> this process's device."""
    backend = comm.default_backend(device)
    local = (local_device_ids or [0])[0]
    return comm.init_group(process_id, num_processes, f"tcp://{coordinator}",
                           device, backend, local_rank=local)


def make_global_mesh(model: int = 1, device=None) -> Mesh:
    """(data, model) mesh over every process: ``data`` spans hosts, each
    ``model`` group stays inside one host. Ranks are host-major, so model
    <= the processes a host runs keeps each model group on one host; a
    ``model`` axis that would span hosts raises."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    per_host = hosts.count(socket.gethostname())
    if model > per_host or per_host % model:
        raise ValueError(f"model={model} must divide the {per_host} process(es) on "
                         "this host (model groups must not span hosts)")
    n = dist.get_world_size()
    return Mesh({"data": n // model, "model": model}, _current_device(device))


@dataclass
class HostRows:
    """A process's rows of a global batch: ``rows`` on its device, their
    offset ``start`` in the global batch of ``total`` rows."""
    rows: torch.Tensor
    start: int
    total: int


def host_batch_to_global(mesh: Mesh, local_batch) -> HostRows:
    """This process's [B_local, ...] camera batch as its part of one global
    batch sharded over ``data``: the frames stay here; the ranks agree only
    on the row counts (one ``all_gather_object``)."""
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(local_batch.shape[0]))
    me = dist.get_rank()
    m = mesh.shape["model"]
    start = sum(c for r, c in enumerate(counts[:me]) if r % m == 0)
    total = sum(c for r, c in enumerate(counts) if r % m == 0)
    return HostRows(torch.as_tensor(np.asarray(local_batch)).to(mesh.device), start, total)


def global_detect_step(mesh: Mesh, size: str = "t", res: int = 640, **kw):
    """-> (step, host_batch_to_global). ``step(params, HostRows)`` detects
    this process's rows (params in the port's layout) and returns them as
    ``HostRows``: no detection crosses a process either."""
    from ..models import yolov9

    def step(params, batch: HostRows) -> HostRows:
        with torch.inference_mode():
            out = yolov9.detect(params, batch.rows, size=size, res=res, **kw)
        return HostRows(out, batch.start, batch.total)

    return step, (lambda x: host_batch_to_global(mesh, x))


def fetch_local(out: HostRows) -> np.ndarray:
    """This host's rows of a result (its own cameras'), as numpy."""
    return out.rows.float().cpu().numpy()
