"""Process-group set-up and the collectives of the data-parallel paths
(port of ``mica_tpu/parallel/distributed.py``).

The JAX package runs one process a host through ``jax.distributed`` and
lets XLA insert the collectives.  Here each card has its own process:

    from mica_tpu_torch.parallel import distributed
    distributed.initialize()          # torchrun's environment
    mesh = distributed.global_mesh()  # this rank, the world, its card
    trainer = Trainer(..., mesh=mesh)

``initialize`` reads torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``
and ``MASTER_ADDR``/``MASTER_PORT``, or takes them as arguments.  NCCL
joins ranks on cards; gloo joins ranks on the CPU, or several ranks that
share one card.  Gloo takes card tensors only in ``all_reduce`` and
``broadcast``, so the three collectives below are built on those two and
run alike under both backends: ``all_reduce_sum_`` (gradients, loss
partials, the loss normalisers), ``exchange_rows`` (the engine's computed
cores: an all-reduce into a zeroed buffer with a slot for every row) and
``broadcast_`` (initial weights, the all-zero window's outputs, volume
slabs).

The JAX ``make_global_batch`` has no counterpart: a rank simply holds
its own rows of a global batch (``local_batch_slice``).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)

_local_rank: Optional[int] = None


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: Optional[str] = None,
               local_rank: Optional[int] = None, timeout_seconds: int = 1800) -> None:
    """Join this process to its process group (idempotent).

    Arguments left out come from torchrun's environment (``env://``
    rendezvous at ``MASTER_ADDR``/``MASTER_PORT``; ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``).  ``backend`` defaults to NCCL where
    there is a card and gloo on the CPU.  The rank's card, ``cuda:{local
    rank}``, becomes the current device before the group forms, so the
    kernels, which launch on the current device, run on it.

    The timeout is far above torch's NCCL default for the JAX package's
    reason: a rank's first kernel builds and Triton compiles can take
    minutes, and its peers wait for it in their first collective."""
    global _local_rank
    if dist.is_initialized():
        return
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and not local_rank < torch.cuda.device_count():
        raise RuntimeError(f"NCCL rank {rank}: local rank {local_rank} names no card "
                           f"({torch.cuda.device_count()} here); NCCL needs a card a rank")
    if torch.cuda.is_available() and local_rank < torch.cuda.device_count():
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_seconds))
    _local_rank = local_rank
    logger.info("process group up: rank %d of %d (%s), local rank %d", rank, world_size,
                backend, local_rank)


def local_rank() -> int:
    """The local rank ``initialize`` was given, else ``LOCAL_RANK``, else 0."""
    if _local_rank is not None:
        return _local_rank
    return int(os.environ.get("LOCAL_RANK", 0))


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(device=None) -> Mesh:
    """The world of the initialized group (``mesh.make_mesh``)."""
    return make_mesh(device)


def barrier(name: str, timeout_seconds: int = 900) -> None:
    """Block until every rank reaches the barrier ``name``.  Gloo's
    monitored barrier names a rank that does not arrive in time; NCCL's
    waits up to the group's timeout."""
    if not is_multiprocess():
        return
    logger.debug("barrier %s", name)
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout_seconds))
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


def local_batch_slice(global_batch: int) -> slice:
    """The [start, stop) rows of a global batch this rank takes
    (``global_batch`` divisible by the world size)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    idx = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // world
    return slice(per * idx, per * (idx + 1))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflatten_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    ofs = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[ofs:ofs + n].view_as(t))
        ofs += n


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum ``tensors`` (one dtype, one device) over the ranks, in place,
    in one collective."""
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0])
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    _unflatten_into(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` with rank ``src``'s, in one collective."""
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.broadcast(tensors[0], src)
        return
    flat = _flat(tensors)
    dist.broadcast(flat, src)
    _unflatten_into(flat, tensors)


def exchange_rows(local: Sequence[torch.Tensor], rows: slice, total: int) -> List[torch.Tensor]:
    """Every rank's rows of each tensor, on every rank.  ``local[i]`` holds
    this rank's rows ``rows`` of a (total, ...) tensor (one dtype and
    device for all); the ranks' row ranges tile ``range(total)``.  Each
    result is a contiguous (total, ...) view of one buffer, zeroed and
    summed over the ranks: adding zeros leaves every value exact."""
    shapes = [tuple(t.shape[1:]) for t in local]
    sizes = [total * int(torch.Size(s).numel()) for s in shapes]
    buf = torch.zeros(sum(sizes), dtype=local[0].dtype, device=local[0].device)
    outs, ofs = [], 0
    for t, s, n in zip(local, shapes, sizes):
        out = buf[ofs:ofs + n].view((total,) + s)
        out[rows] = t
        outs.append(out)
        ofs += n
    dist.all_reduce(buf)
    return outs
