"""Sliding-window geometry: core start lattice, counts and core extents.

Window geometry (identical to the JAX package): core ``48``, halo ``8``,
window ``64``, start lattice at multiples of the core below the extent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CORE = 48
HALO = 8
WINDOW = CORE + 2 * HALO  # 64


def window_starts(shape: Tuple[int, int, int], core: int = CORE) -> np.ndarray:
    """(nw, 3) int array of core start positions (multiples of ``core``)."""
    axes = [np.arange(0, s, core) for s in shape]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1)


def window_counts(shape: Tuple[int, int, int], core: int = CORE) -> Tuple[int, int, int]:
    return tuple(-(-s // core) for s in shape)


def core_extents(shape: Tuple[int, int, int], core: int = CORE) -> np.ndarray:
    """(nw, 3) per-window valid core sizes (min(core, shape - start))."""
    starts = window_starts(shape, core)
    return np.minimum(core, np.asarray(shape) - starts)
