"""The multi-process runtime for the scale-out BA — port of
``orb_slam3_ros_tpu.parallel.multihost`` over ``torch.distributed``.

Each process joins a rendezvous at ``coordinator`` (``host:port``; rank 0
listens there), drives one device, and the world forms one (obs, pt) mesh
over which the ``dist_ba`` solvers run. NCCL carries the sums between
cards; gloo between CPU processes, or between processes that share one
card (NCCL refuses two ranks on one GPU), with CUDA tensors staged through
the host.

Usage (one call per process, before building meshes):

    from orb_slam3_ros_tpu_torch.parallel import multihost
    multihost.init(coordinator="10.0.0.1:9999", num_processes=2,
                   process_id=int(os.environ["RANK"]))
    mesh = multihost.global_mesh()

There is no single-process fallback: a rendezvous that fails raises.
"""

from __future__ import annotations

import datetime
import socket

import torch
import torch.distributed as dist

from .. import resolve_device
from . import dist_ba

TIMEOUT_S = 300.0  # the rendezvous, and each collective, must finish within this
_STATE: dict = {"device": None, "mesh": None}


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now, for a coordinator on this machine."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(coordinator: str, num_processes: int, process_id: int, backend: str | None = None,
         device=None) -> None:
    """Join the process group. Call exactly once per process.

    ``device``: the device this process drives (None: the CUDA device; a
    process drives one device, so the JAX package's ``local_device_count``
    has no counterpart here). ``backend``: "nccl" on a card by default,
    "gloo" on the CPU or when named. Raises when the rendezvous fails
    within ``TIMEOUT_S`` seconds."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    _STATE.update(device=dev, mesh=None)


def global_mesh() -> dist_ba.Mesh:
    """The (obs, pt) mesh over the whole world, in rank order (so 'obs'
    stripes across processes; made once, at the first call)."""
    if _STATE["mesh"] is None:
        _STATE["mesh"] = dist_ba.make_mesh(device=_STATE["device"])
    return _STATE["mesh"]


def replicated_problem(prob: "dist_ba.ba.BAProblem") -> dist_ba.Shard:
    """This rank's shard of an identical host problem (every process builds
    the same arrays) on the global mesh."""
    return dist_ba.shard_problem(prob, global_mesh())
