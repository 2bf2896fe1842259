"""Multi-process execution on ``torch.distributed``.

Counterpart: ``icer_compression_tpu/parallel/distributed.py``
(``initialize``, ``global_mesh``).  Every process runs the same program
with one device of its own (or, under gloo, a device it may share);
``initialize`` joins them into one process group and ``global_mesh``
lays the ('data', 'seg') mesh of parallel/sharded over its ranks.  The
codec's only collectives are the ordered gathers of parallel/sharded:
``all_gather_arrays`` carries them, on the device under NCCL and through
host memory under gloo.

On a single process with no rendezvous configured all of this is a
no-op: ``initialize`` returns False and the mesh is 1 x 1.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               local_rank: int | None = None, backend: str | None = None,
               device=None, timeout_s: float = 600.0) -> bool:
    """Join this process to a process group; True when a group is up (now
    or by an earlier call), False for a single process with no rendezvous
    configured.

    Arguments default from torchrun's environment (``MASTER_ADDR`` and
    ``MASTER_PORT`` make ``init_method`` ``tcp://addr:port``;
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``).  As in the JAX package, a
    rendezvous address brings a group up even for a world of 1.
    ``device`` is this rank's device: None means ``cuda:{local_rank}``
    (raising without a card, as every entry point does); pass ``"cpu"``
    for a host world or ``"cuda:0"`` for ranks that share a card.
    ``backend`` defaults to ``nccl`` on CUDA devices and ``gloo`` on the
    CPU; an explicit one (``gloo`` on the card, say) is used as given.
    Calling it twice is safe."""
    if dist.is_available() and dist.is_initialized():
        return True
    if init_method is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    world_size = world_size if world_size is not None \
        else _env_int("WORLD_SIZE")
    if init_method is None:
        if world_size in (None, 1):
            return False
        raise ValueError("a world of several processes needs an "
                         "init_method or MASTER_ADDR/MASTER_PORT")
    world_size = world_size or 1
    rank = rank if rank is not None else (_env_int("RANK") or 0)
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
    dev = resolve_device(f"cuda:{local_rank}" if device is None else device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def rank_device(device=None) -> torch.device:
    """This rank's device: ``resolve_device(device)``, where a CUDA device
    without an index is the current one (the card ``initialize`` set)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def world() -> tuple[int, int]:
    """(world size, rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def all_gather_arrays(arr: np.ndarray, device: torch.device,
                      group=None) -> list[np.ndarray]:
    """Every rank's ``arr`` (same shape and dtype on each) in rank order
    of ``group`` (default the world).  The tensors sit on ``device`` under
    NCCL and in host memory under gloo; without a process group, [arr]."""
    if not (dist.is_available() and dist.is_initialized()):
        return [arr]
    on = device if dist.get_backend(group) == "nccl" else torch.device("cpu")
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(on)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.cpu().numpy() for o in out]


def global_mesh(data: int | None = None, device=None):
    """The ('data', 'seg') mesh over every rank of the process group (call
    after ``initialize``): parallel/sharded.make_mesh."""
    from .sharded import make_mesh
    return make_mesh(data=data, device=device)
