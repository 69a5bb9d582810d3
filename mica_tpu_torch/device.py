"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means the card.  Asking for the card where there is none
    raises: an entry point never falls back to the CPU on its own.  Under
    an initialized process group the card is the rank's own,
    ``cuda:{local rank}`` (``parallel.distributed.initialize``), so the
    ranks of one host never meet on ``cuda:0``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        from .parallel.distributed import local_rank

        dev = torch.device("cuda", local_rank())
    return dev
