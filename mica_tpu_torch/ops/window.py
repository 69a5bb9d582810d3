"""Volume <-> sliding-window decomposition.

Window geometry (identical to the JAX package): core ``48``, halo ``8``,
window ``64``, start lattice at multiples of the core below the extent.
``window_starts``, ``window_counts`` and ``core_extents`` are numpy;
``extract_windows`` and ``stitch_windows`` (the counterparts of
``mica_tpu/ops/window.py:46-97``) are torch functions that run on their
tensor's device.  Extraction zero-pads the volume and takes the lattice's
windows as one strided view (``unfold``); stitching strips the halo and
reassembles the cores, which tile the volume exactly, by a permute and a
reshape.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def extract_windows(volume: torch.Tensor, core: int = CORE, halo: int = HALO) -> torch.Tensor:
    """Split ``volume`` (X, Y, Z) or (C, X, Y, Z) into (nw, w, w, w) or
    (nw, C, w, w, w) windows, ``w = core + 2 * halo``, in ``window_starts``
    order, on the volume's device and in its dtype.

    Window ``n`` covers original coordinates ``[start - halo, start - halo
    + w)`` per axis, zeros outside the volume: the JAX function's contents
    (and the original MICA's npz grids)."""
    window = core + 2 * halo
    shape = tuple(volume.shape[-3:])
    counts = window_counts(shape, core)
    padded = volume.new_zeros(tuple(volume.shape[:-3])
                              + tuple((n - 1) * core + window for n in counts))
    padded[..., halo:halo + shape[0], halo:halo + shape[1], halo:halo + shape[2]] = volume
    # (..., nx, ny, nz, w, w, w): the window at lattice point (i, j, k)
    # starts at (i, j, k) * core in the padded volume
    wins = padded.unfold(-3, window, core).unfold(-3, window, core).unfold(-3, window, core)
    lead = volume.dim() - 3
    wins = wins.reshape(volume.shape[:-3] + (-1, window, window, window))
    return wins.movedim(lead, 0).contiguous() if lead else wins


def stitch_windows(windows: torch.Tensor, shape: Tuple[int, int, int], core: int = CORE,
                   halo: int = HALO) -> torch.Tensor:
    """Reassemble a volume from per-window predictions: ``windows`` is
    (nw, w, w, w) or (nw, C, w, w, w) in ``window_starts`` order; the halo
    is stripped and the cores are tiled.  Returns (X, Y, Z) or
    (C, X, Y, Z)."""
    nx, ny, nz = window_counts(shape, core)
    cores = windows[..., halo:halo + core, halo:halo + core, halo:halo + core]
    if windows.dim() == 5:
        c = cores.shape[1]
        full = cores.reshape(nx, ny, nz, c, core, core, core).permute(3, 0, 4, 1, 5, 2, 6)
        full = full.reshape(c, nx * core, ny * core, nz * core)
    else:
        full = cores.reshape(nx, ny, nz, core, core, core).permute(0, 3, 1, 4, 2, 5)
        full = full.reshape(nx * core, ny * core, nz * core)
    return full[..., :shape[0], :shape[1], :shape[2]]
