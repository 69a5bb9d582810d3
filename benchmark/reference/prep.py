"""Plain reference of the prediction's input path: read the MRC map,
resample it to 1 A by cubic B-splines (the semantics of
``scipy.ndimage.zoom(order=3)``, which the tests hold it against), normalize
it, parse the docked model and rasterize its 24-channel AF3 encoding, and
cut the windows the engine computes."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

AMINO_ACIDS = ["ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
               "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR"]
BACKBONE = ["CA", "N", "C", "O"]
POLE = np.sqrt(3.0) - 2.0


def read_mrc(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(volume[x, y, z] f32, voxel size (3,), origin (3,), start (3,))
    of a little-endian mode-2 MRC file."""
    raw = Path(path).read_bytes()
    nx, ny, nz, mode = struct.unpack_from("<4i", raw, 0)
    starts = struct.unpack_from("<3i", raw, 16)
    grid = struct.unpack_from("<3i", raw, 28)
    cell = struct.unpack_from("<3f", raw, 40)
    axes = struct.unpack_from("<3i", raw, 64)
    nsymbt = struct.unpack_from("<i", raw, 92)[0]
    origin = np.asarray(struct.unpack_from("<3f", raw, 196), np.float64)
    if mode != 2:
        raise ValueError(f"{path}: MRC mode {mode}, the reference reads mode 2")
    data = np.frombuffer(raw, "<f4", nx * ny * nz, 1024 + nsymbt).reshape(nz, ny, nx)
    # data dims are (sections, rows, columns) = crystal axes (maps, mapr, mapc)
    axis_of_dim = [axes[2] - 1, axes[1] - 1, axes[0] - 1]
    order = [axis_of_dim.index(a) for a in range(3)]
    start_of_dim = [starts[2], starts[1], starts[0]]
    voxel = np.asarray(cell, np.float64) / np.asarray(grid, np.float64)
    return (np.ascontiguousarray(data.transpose(order)), voxel, origin,
            np.asarray([start_of_dim[d] for d in order], np.float64))


def _prefilter(x: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficients along axis 0, mirror boundary: a
    causal and an anticausal first-order recursion."""
    n = x.shape[0]
    z = float(POLE)
    c = x * 6.0
    k = np.arange(2 * n - 2, dtype=np.float64)
    zk = torch.as_tensor((POLE ** k) / (1.0 - POLE ** (2 * n - 2)), dtype=x.dtype,
                         device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))
    ext = torch.cat([c, torch.flip(c[1:-1], (0,))])
    cp = torch.empty_like(c)
    cp[0] = (zk * ext).sum(0)
    for i in range(1, n):
        cp[i] = c[i] + z * cp[i - 1]
    cm = torch.empty_like(c)
    cm[n - 1] = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
    for i in range(n - 2, -1, -1):
        cm[i] = z * (cm[i + 1] - cp[i])
    return cm


def _resize_axis0(x: torch.Tensor, out_n: int) -> torch.Tensor:
    n = x.shape[0]
    c = _prefilter(x)
    coords = np.arange(out_n, dtype=np.float64) * (np.float64(n - 1) / np.float64(out_n - 1))
    outside = (coords < 0) | (coords > n - 1)
    t0 = np.floor(np.clip(coords, 0, n - 1)).astype(np.int64)
    t = np.clip(coords, 0, n - 1) - t0
    w = [(1 - t) ** 3 / 6, (4 - 6 * t * t + 3 * t ** 3) / 6,
         (1 + 3 * t + 3 * t * t - 3 * t ** 3) / 6, t ** 3 / 6]
    period = 2 * n - 2
    shape = (-1,) + (1,) * (x.dim() - 1)
    out = torch.zeros((out_n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    for o in range(4):
        idx = np.abs(t0 + o - 1) % period
        idx = np.where(idx >= n, period - idx, idx)
        out += torch.as_tensor(w[o], dtype=x.dtype, device=x.device).reshape(shape) \
            * c[torch.as_tensor(idx, device=x.device)]
    if outside.any():
        out[torch.as_tensor(outside, device=x.device)] = 0
    return out


def resample(vol: torch.Tensor, voxel: np.ndarray, target: float = 1.0) -> torch.Tensor:
    """Cubic-spline zoom of ``vol`` so each axis has ``target`` A voxels
    (output size round(n * voxel / target)); unchanged axes pass."""
    for axis in range(3):
        out_n = int(round(vol.shape[axis] * float(voxel[axis]) / target))
        if out_n != vol.shape[axis]:
            vol = _resize_axis0(vol.movedim(axis, 0), out_n).movedim(0, axis).contiguous()
    return vol


def normalize(v: torch.Tensor) -> torch.Tensor:
    """nan -> 0; keep what exceeds the median, less the median; clip at the
    99.9th percentile (linear) of the positive values and divide by it."""
    v = torch.nan_to_num(v.float())
    s = torch.sort(v.reshape(-1)).values
    n = s.numel()
    median = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    t = torch.where(v > median, v - median, torch.zeros_like(v))
    pos = torch.sort(t[t > 0]).values
    if pos.numel() == 0:
        return t
    q = 0.999 * (pos.numel() - 1)
    lo = int(np.floor(q))
    hi = min(lo + 1, pos.numel() - 1)
    p = pos[lo] + (q - lo) * (pos[hi] - pos[lo])
    return torch.minimum(t, p) / p


def parse_pdb(path):
    """(names, residue names, xyz (n, 3) f64) of the ATOM records."""
    names, res, xyz = [], [], []
    for line in Path(path).read_text().splitlines():
        if line.startswith("ATOM  "):
            names.append(line[12:16].strip())
            res.append(line[17:20].strip())
            xyz.append((float(line[30:38]), float(line[38:46]), float(line[46:54])))
    return np.array(names), np.array(res), np.asarray(xyz, np.float64).reshape(-1, 3)


def encode(names, res, idx: np.ndarray, shape) -> np.ndarray:
    """(24, X, Y, Z) uint8: each atom at its voxel ``idx`` (clipped to the
    volume) in channel CA, N, C or O and in its residue type's channel (4 +
    the type's index)."""
    idx = np.clip(np.asarray(idx, np.int64), 0, np.asarray(shape) - 1)
    enc = np.zeros((24,) + tuple(shape), np.uint8)
    bb = np.array([BACKBONE.index(n) if n in BACKBONE else -1 for n in names], np.int64)
    aa = np.array([4 + AMINO_ACIDS.index(r) if r in AMINO_ACIDS else -1 for r in res],
                  np.int64)
    for ch in (bb, aa):
        m = ch >= 0
        enc[ch[m], idx[m, 0], idx[m, 1], idx[m, 2]] = 1
    return enc


def rasterize(pdb_path, shape, origin, voxel: float, start) -> np.ndarray:
    """The docked model's encoding: each atom at its nearest voxel."""
    names, res, xyz = parse_pdb(pdb_path)
    return encode(names, res, np.rint((xyz - origin) / voxel - start), shape)


def prepare(map_path, device) -> Tuple[torch.Tensor, np.ndarray, float, np.ndarray]:
    """The normalized 1 A map on ``device``, with its origin and start."""
    vol, voxel, origin, start = read_mrc(map_path)
    out = normalize(resample(torch.from_numpy(vol).to(device), voxel, 1.0))
    return out, origin, 1.0, start


def window(vol: torch.Tensor, start, core: int, halo: int) -> torch.Tensor:
    """The window whose core starts at ``start``: (..., w, w, w) from the
    volume's last three axes, zeros outside."""
    w = core + 2 * halo
    out = vol.new_zeros(vol.shape[:-3] + (w, w, w))
    src, dst = [], []
    for a, s in enumerate(start):
        lo, hi = int(s) - halo, int(s) - halo + w
        n = vol.shape[-3 + a]
        src.append(slice(max(lo, 0), min(hi, n)))
        dst.append(slice(max(lo, 0) - lo, min(hi, n) - lo))
    out[(...,) + tuple(dst)] = vol[(...,) + tuple(src)]
    return out
