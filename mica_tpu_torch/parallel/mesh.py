"""The data-parallel world (port of ``mica_tpu/parallel/mesh.py``).

The JAX package runs one process a host over a 1-D ``data`` mesh: window
and training batches are sharded along the batch axis, parameters are
replicated, and XLA inserts the collectives.  Here each card has a
process of its own in a ``torch.distributed`` group, and ``Mesh`` only
describes that group: this process's rank, the world size, its local rank
and its device.  The roles of the JAX ``data_sharding`` and
``replicated`` went to ``parallel.distributed.local_batch_slice`` (each
rank takes its rows of a global batch) and to the model's parameters,
which every rank holds whole and keeps equal.
"""

from __future__ import annotations

import dataclasses

import torch

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``distributed``: a process group is initialized, so the engine and
    the trainer run their collectives (at world size 1 too); without one
    the world is this process alone and nothing is exchanged."""

    rank: int
    size: int
    local_rank: int
    device: torch.device
    distributed: bool

    @property
    def is_main(self) -> bool:
        """Rank 0 logs and writes files."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's share of ``n`` rows: ``ceil(n / size)`` a rank in
        rank order, so the last ranks may get fewer, or none."""
        per = -(-n // self.size)
        lo = min(self.rank * per, n)
        return slice(lo, min(lo + per, n))


def make_mesh(device=None) -> Mesh:
    """The world of the initialized process group, or this process alone.
    ``device`` as ``resolve_device`` reads it: None is this rank's card."""
    from ..device import resolve_device
    from .distributed import local_rank

    dev = resolve_device(device)
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return Mesh(rank=torch.distributed.get_rank(), size=torch.distributed.get_world_size(),
                    local_rank=local_rank(), device=dev, distributed=True)
    return Mesh(rank=0, size=1, local_rank=0, device=dev, distributed=False)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m
