"""Process-group initialization, one process per GPU.

The JAX package runs one process per host over all its local devices and
initializes ``jax.distributed``; the port runs one process per GPU and
initializes ``torch.distributed``.  A launcher such as ``torchrun`` sets
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` and
``LOCAL_RANK`` in each process, so ``maybe_initialize_distributed()``
with no arguments is all a command needs; a single-process run (none of
those set) is a no-op.  Every strategy of ``parallel/`` then builds its
mesh from the process group.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_RENDEZVOUS_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def maybe_initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    timeout: Optional[float] = None,
) -> bool:
    """Initialize the default process group.

    Returns True if a process group is initialized (now or before: it is
    idempotent within a process), False for the single-process no-op: no
    ``init_method`` given and no launcher environment, or an environment
    that names no usable rendezvous (some of ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT`` set, not all).

    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    otherwise; ``timeout`` (seconds) bounds every collective.  On the
    card each process takes the GPU ``LOCAL_RANK`` (else its rank modulo
    the GPU count) as its current device."""
    if dist.is_initialized():
        return True
    if init_method is None:
        present = [k for k in _RENDEZVOUS_ENV if os.environ.get(k)]
        if len(present) < len(_RENDEZVOUS_ENV):
            return False
        init_method = "env://"
    if rank is None and init_method == "env://":
        rank = int(os.environ["RANK"])
    if world_size is None and init_method == "env://":
        world_size = int(os.environ["WORLD_SIZE"])
    if torch.cuda.is_available():
        local = os.environ.get("LOCAL_RANK")
        device = int(local) if local is not None else (rank or 0) % torch.cuda.device_count()
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kwargs)
    return True


def process_info() -> dict:
    """Topology snapshot for logs: process index and count, local and
    global device counts (one device a process)."""
    initialized = dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {
        "process_index": dist.get_rank() if initialized else 0,
        "process_count": count,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_devices": count,
    }
