"""Window gather and core scatter for the sliding-window engine.

Counterpart of ``mica_tpu/ops/window_dma.py``.  K9 ``gather_windows`` and
K10 ``scatter_cores`` (CUDA C++, ``csrc/window_copy.cu``) replace
``gather_windows_dma`` and ``scatter_cores_dma``: pure data movement, exact
to the bit, one launch per batch, with the window starts read from an int32
tensor on the device.  Both are bounded by device-memory bandwidth (see the
source's note).

Given CPU tensors a wrapper runs its plain version; given CUDA tensors it
launches its kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

launches = {"gather_windows": 0, "scatter_cores": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_GATHER_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_SCATTER_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def starts_tensor(starts: np.ndarray, extent: Sequence[int], size: int,
                  device) -> torch.Tensor:
    """(n, 3) int32 starts on ``device``, checked on the host first: every
    ``size``-cube must lie inside a volume of ``extent``."""
    starts = np.asarray(starts)
    if starts.ndim != 2 or starts.shape[1] != 3:
        raise ValueError(f"starts must be (n, 3), got {starts.shape}")
    if len(starts) and (starts.min() < 0 or
                        (starts + size > np.asarray(extent)[None]).any()):
        raise ValueError(f"a {size}-cube start leaves the volume {tuple(extent)}")
    return torch.from_numpy(np.ascontiguousarray(starts, np.int32)).to(device)


def gather_windows_plain(padded_map: torch.Tensor, padded_af: Optional[torch.Tensor],
                         starts: torch.Tensor, window: int):
    """Plain version of K9: a stack of slices."""
    w = int(window)
    rows = starts.tolist()
    wins = torch.stack([padded_map[x:x + w, y:y + w, z:z + w] for x, y, z in rows])
    if padded_af is None:
        return wins
    afs = torch.stack([padded_af[x:x + w, y:y + w, z:z + w] for x, y, z in rows])
    return wins, afs


def _check(t: torch.Tensor, dtype, shape, dev, what: str) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.device != dev or (
            shape is not None and tuple(t.shape) != tuple(shape)):
        raise TypeError(f"{what}: needs a contiguous {dtype} tensor"
                        + (f" of shape {tuple(shape)}" if shape is not None else "")
                        + f" on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def gather_windows(padded_map: torch.Tensor, padded_af: Optional[torch.Tensor],
                   starts: torch.Tensor, window: int):
    """K9.  padded_map (X, Y, Z) f32; padded_af (X, Y, Z) int32 (the uint32
    bitfields viewed as int32) or None; starts (n, 3) int32 window origins
    in the padded frame, on the same device (``starts_tensor`` checks them).
    Returns (n, w, w, w) f32 [, (n, w, w, w) int32]."""
    if padded_map.device.type == "cpu":
        return gather_windows_plain(padded_map, padded_af, starts, window)
    dev, w, n = padded_map.device, int(window), int(starts.shape[0])
    _check(padded_map, torch.float32, None, dev, "gather_windows map")
    if padded_map.dim() != 3 or n < 1 or min(padded_map.shape) < w:
        raise ValueError(f"gather_windows: map {tuple(padded_map.shape)}, {n} starts, window {w}")
    _check(starts, torch.int32, (n, 3), dev, "gather_windows starts")
    wins = torch.empty((n, w, w, w), dtype=torch.float32, device=dev)
    afs = None
    if padded_af is not None:
        _check(padded_af, torch.int32, padded_map.shape, dev, "gather_windows af")
        afs = torch.empty((n, w, w, w), dtype=torch.int32, device=dev)
    x, y, z = padded_map.shape
    err = _build.function("window_copy", "gather_windows_u32", _GATHER_ARGS)(
        padded_map.data_ptr(), None if padded_af is None else padded_af.data_ptr(),
        starts.data_ptr(), wins.data_ptr(), None if afs is None else afs.data_ptr(),
        n, x, y, z, w, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "gather_windows")
    launches["gather_windows"] += 1
    return wins if afs is None else (wins, afs)


Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def scatter_cores_plain(vols: Triple, cores: Triple, starts: torch.Tensor,
                        n_valid: int, core: int) -> Triple:
    """Plain version of K10: slice assignment of the first ``n_valid`` cores,
    in place."""
    c = int(core)
    for i, (x, y, z) in enumerate(starts[:n_valid].tolist()):
        for vol, blk in zip(vols, cores):
            vol[x:x + c, y:y + c, z:z + c] = blk[i]
    return vols


def scatter_cores(vols: Triple, cores: Triple, starts: torch.Tensor,
                  n_valid: int, core: int) -> Triple:
    """K10.  vols (bb (X, Y, Z), ca (X, Y, Z), aa (X, Y, Z, A)) f32, written
    in place and returned; cores (bb (n, c, c, c), ca, aa (n, c, c, c, A))
    f32; starts (n, 3) int32 core origins on the same device; entries at
    index >= n_valid are skipped, neither read nor written."""
    bb_v, ca_v, aa_v = vols
    bb_c, ca_c, aa_c = cores
    if bb_v.device.type == "cpu":
        return scatter_cores_plain(vols, cores, starts, n_valid, core)
    dev, c, n = bb_v.device, int(core), int(starts.shape[0])
    n_valid = int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError(f"scatter_cores: n_valid {n_valid} outside 0..{n}")
    if aa_v.dim() != 4 or bb_v.dim() != 3 or min(bb_v.shape) < c:
        raise ValueError(f"scatter_cores: volumes {tuple(bb_v.shape)}, {tuple(aa_v.shape)}, core {c}")
    a = int(aa_v.shape[-1])
    _check(bb_v, torch.float32, None, dev, "scatter_cores bb volume")
    _check(ca_v, torch.float32, bb_v.shape, dev, "scatter_cores ca volume")
    _check(aa_v, torch.float32, tuple(bb_v.shape) + (a,), dev, "scatter_cores aa volume")
    _check(bb_c, torch.float32, (n, c, c, c), dev, "scatter_cores bb cores")
    _check(ca_c, torch.float32, (n, c, c, c), dev, "scatter_cores ca cores")
    _check(aa_c, torch.float32, (n, c, c, c, a), dev, "scatter_cores aa cores")
    _check(starts, torch.int32, (n, 3), dev, "scatter_cores starts")
    if n_valid == 0:
        return vols
    x, y, z = bb_v.shape
    err = _build.function("window_copy", "scatter_cores_f32", _SCATTER_ARGS)(
        bb_c.data_ptr(), ca_c.data_ptr(), aa_c.data_ptr(), bb_v.data_ptr(), ca_v.data_ptr(),
        aa_v.data_ptr(), starts.data_ptr(), n_valid, x, y, z, c, a,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "scatter_cores")
    launches["scatter_cores"] += 1
    return vols
