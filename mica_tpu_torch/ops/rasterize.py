"""Atom -> voxel rasterization: the 24-channel AF3 encoding volume.

The port's own numpy copy of ``mica_tpu/ops/rasterize.py``.

Re-implements the reference's AF3 feature encoding
(preprocessing.py:253-298): channel layout ``[CA, N, C, O] + 20 amino-acid
types``, one binary volume per channel, nearest-voxel splat of every atom of
the combined docked AF3 structure.  Output is channels-first over the
canonical XYZ volume layout: ``(24, X, Y, Z)``.  ``rasterize_af3_bits``
writes the same splat straight into the engine's ``(X, Y, Z)`` uint32
bitfield, bit ``c`` for channel ``c``, without the 24-channel volume.

Coordinate convention: ``index = (coord - origin) / voxel - nstart`` — the
full CCP4 convention.  (The reference subtracts only the origin when
rasterizing, preprocessing.py:172-178, but adds only the nstart offset when
emitting model coordinates, modeler.py:1775-1779; this module and
the JAX package's trace module uses the combined convention consistently in both directions,
which reduces to the reference behavior in each tool's typical single-
convention map.)  The reference also clips per-component against a
wrongly-ordered shape tuple (preprocessing.py:177 clips x against the z
extent); here clipping is axis-correct.

A trilinear splat variant is provided as an upgrade (mass-conserving
8-corner weights) for training-data generation experiments.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..io.pdb import AA_INDEX, AMINO_ACIDS, BACKBONE_ATOMS

NUM_CHANNELS = len(BACKBONE_ATOMS) + len(AMINO_ACIDS)  # 24
CHANNEL_NAMES = BACKBONE_ATOMS + AMINO_ACIDS


def atoms_to_channel_indices(atoms: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-atom (backbone-channel | -1, aa-channel | -1) indices."""
    names = atoms["name"]
    bb_ch = np.full(len(atoms), -1, dtype=np.int32)
    for i, bb_name in enumerate(BACKBONE_ATOMS):
        bb_ch[names == bb_name] = i
    aa_ch = np.full(len(atoms), -1, dtype=np.int32)
    for res, idx in AA_INDEX.items():
        aa_ch[atoms["res_name"] == res] = idx + len(BACKBONE_ATOMS)
    return bb_ch, aa_ch


def world_to_voxel(
    coords: np.ndarray,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart: Sequence[float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """Angstrom coordinates -> continuous voxel indices (XYZ order)."""
    return (np.asarray(coords, np.float64) - np.asarray(origin, np.float64)) / float(
        voxel_size
    ) - np.asarray(nstart, np.float64)


def voxel_to_world(
    indices: np.ndarray,
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart: Sequence[float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """Continuous voxel indices (XYZ) -> Angstrom coordinates."""
    return (np.asarray(indices, np.float64) + np.asarray(nstart, np.float64)) * float(
        voxel_size
    ) + np.asarray(origin, np.float64)


def _nearest_splat(
    atoms: np.ndarray,
    shape: Tuple[int, int, int],
    origin: Sequence[float],
    voxel_size: float,
    nstart: Sequence[float],
) -> Tuple[np.ndarray, np.ndarray]:
    """The nearest splat's writes: (channel, (x, y, z)) index arrays, one
    entry per atom and channel it sets (its backbone channel, then its
    residue type's), at its nearest voxel clipped into ``shape``."""
    coords = np.stack([atoms["x"], atoms["y"], atoms["z"]], axis=-1)
    idx = np.rint(world_to_voxel(coords, origin, voxel_size, nstart)).astype(np.int64)
    for a in range(3):
        idx[:, a] = np.clip(idx[:, a], 0, shape[a] - 1)
    ch = np.concatenate(atoms_to_channel_indices(atoms))
    idx = np.concatenate([idx, idx])
    m = ch >= 0
    return ch[m], idx[m]


def rasterize_af3_bits(
    atoms: np.ndarray,
    shape: Tuple[int, int, int],
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart: Sequence[float] = (0.0, 0.0, 0.0),
) -> np.ndarray:
    """The nearest splat as an (X, Y, Z) uint32 bitfield: bit ``c`` is set
    where channel ``c`` of ``rasterize_af3_encoding(..., mode="nearest")``
    is 1, the words ``infer.engine.pack_af_encoding`` makes of it."""
    bits = np.zeros(tuple(shape), np.uint32)
    ch, idx = _nearest_splat(atoms, shape, origin, voxel_size, nstart)
    flat = np.ravel_multi_index(tuple(idx.T), bits.shape)
    # .at: several atoms may set bits of one voxel
    np.bitwise_or.at(bits.reshape(-1), flat, np.uint32(1) << ch.astype(np.uint32))
    return bits


def rasterize_af3_encoding(
    atoms: np.ndarray,
    shape: Tuple[int, int, int],
    origin: Sequence[float] = (0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart: Sequence[float] = (0.0, 0.0, 0.0),
    mode: str = "nearest",
    dtype=np.float32,
) -> np.ndarray:
    """Build the (24, X, Y, Z) AF3 encoding volume from a structured atom array.

    ``mode='nearest'`` reproduces the reference's binary nearest-voxel splat;
    ``mode='trilinear'`` distributes each atom over its 8 surrounding voxels
    (values then clipped to [0, 1]).
    """
    vol = np.zeros((NUM_CHANNELS,) + tuple(shape), dtype=dtype)
    if len(atoms) == 0:
        return vol

    # the reference iterates residues with a blank hetero flag; parse_pdb
    # already excludes HETATM records by default, so rasterize every atom.
    if mode == "nearest":
        ch, idx = _nearest_splat(atoms, shape, origin, voxel_size, nstart)
        vol[ch, idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    elif mode == "trilinear":
        coords = np.stack([atoms["x"], atoms["y"], atoms["z"]], axis=-1)
        idx_f = world_to_voxel(coords, origin, voxel_size, nstart)
        bb_ch, aa_ch = atoms_to_channel_indices(atoms)
        base = np.floor(idx_f).astype(np.int64)
        frac = idx_f - base
        for corner in range(8):
            off = np.array([(corner >> a) & 1 for a in range(3)])
            w = np.prod(
                np.where(off[None, :] == 1, frac, 1.0 - frac), axis=1
            ).astype(dtype)
            idx = base + off[None, :]
            ok = np.ones(len(atoms), dtype=bool)
            for a in range(3):
                ok &= (idx[:, a] >= 0) & (idx[:, a] < shape[a])
            for ch_arr in (bb_ch, aa_ch):
                m = (ch_arr >= 0) & ok & (w > 0)
                np.add.at(
                    vol, (ch_arr[m], idx[m, 0], idx[m, 1], idx[m, 2]), w[m]
                )
        np.clip(vol, 0.0, 1.0, out=vol)
    else:
        raise ValueError(f"unknown rasterization mode: {mode}")
    return vol
