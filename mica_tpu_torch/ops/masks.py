"""Training-label mask rasterization (vectorized numpy).

The port's own copy of ``mica_tpu/ops/masks.py``.  Re-implements the three
mask generators of the original MICA's
scripts_for_training_data/create_{backbone,carbon_alpha,amino_acid}_mask.py
as vectorized rasterizers over the canonical XYZ layout:

  * backbone mask:  0 background, 1 = 26-neighbor shell of any atom,
                    2 = non-backbone atom voxel, 3 = backbone (N/CA/C/O)
                    atom voxel
  * C-alpha mask:   0/1/2 as above, 3 = CA atom voxel
  * amino-acid mask: the 26-neighborhood of each CA carries the residue
                    type 1..20 (order = io.pdb.AMINO_ACIDS), lowest type
                    wins voxel collisions, and the CA voxel itself is 0
                    (create_amino_acid_mask.py:171-177)

The original resolves same-voxel collisions by file iteration order
(last atom wins for atom labels, per-CA sequential min for AA types); here,
as in the JAX package, collisions resolve deterministically: atom-class
labels take the max class per voxel (atom beats shell; backbone beats
non-backbone), AA types take the min type.  Differences affect only voxels
where several atoms collide.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from ..io.pdb import AMINO_ACIDS, BACKBONE_ATOMS
from .rasterize import world_to_voxel

_AA_TYPE = {name: i + 1 for i, name in enumerate(AMINO_ACIDS)}


def _atom_voxels(atoms, shape, origin, voxel_size, nstart):
    coords = np.stack([atoms["x"], atoms["y"], atoms["z"]], axis=-1)
    idx = np.rint(world_to_voxel(coords, origin, voxel_size, nstart)).astype(np.int64)
    for a in range(3):
        idx[:, a] = np.clip(idx[:, a], 0, shape[a] - 1)
    return idx


def _dilate26(binary: np.ndarray) -> np.ndarray:
    """26-connectivity dilation via shifted maxima (3^3 neighborhood)."""
    out = np.zeros_like(binary)
    d, h, w = binary.shape
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                src = binary[
                    max(0, -dx) : d - max(0, dx),
                    max(0, -dy) : h - max(0, dy),
                    max(0, -dz) : w - max(0, dz),
                ]
                out[
                    max(0, dx) : d - max(0, -dx),
                    max(0, dy) : h - max(0, -dy),
                    max(0, dz) : w - max(0, -dz),
                ] |= src
    return out


def atom_class_mask(
    atoms: np.ndarray,
    shape: Tuple[int, int, int],
    special_names: Sequence[str],
    origin=(0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart=(0.0, 0.0, 0.0),
) -> np.ndarray:
    """Shared builder for the backbone / C-alpha masks.

    ``special_names``: atom names that get class 3 (others get class 2);
    class 1 = 26-neighbor shell of any atom voxel; 0 = background.
    """
    mask = np.zeros(shape, dtype=np.int32)
    if len(atoms) == 0:
        return mask
    idx = _atom_voxels(atoms, shape, origin, voxel_size, nstart)
    special = np.isin(atoms["name"], list(special_names))

    atom_occupied = np.zeros(shape, dtype=bool)
    atom_occupied[idx[:, 0], idx[:, 1], idx[:, 2]] = True

    shell = _dilate26(atom_occupied) & ~atom_occupied

    mask[shell] = 1
    # non-special first, special wins collisions
    other = idx[~special]
    mask[other[:, 0], other[:, 1], other[:, 2]] = 2
    sp = idx[special]
    mask[sp[:, 0], sp[:, 1], sp[:, 2]] = 3
    return mask


def backbone_mask(atoms, shape, **kw) -> np.ndarray:
    return atom_class_mask(atoms, shape, BACKBONE_ATOMS, **kw)


def carbon_alpha_mask(atoms, shape, **kw) -> np.ndarray:
    return atom_class_mask(atoms, shape, ["CA"], **kw)


def amino_acid_mask(
    atoms: np.ndarray,
    shape: Tuple[int, int, int],
    origin=(0.0, 0.0, 0.0),
    voxel_size: float = 1.0,
    nstart=(0.0, 0.0, 0.0),
) -> np.ndarray:
    ca = atoms[(atoms["name"] == "CA") & np.isin(atoms["res_name"], AMINO_ACIDS)]
    mask = np.full(shape, np.iinfo(np.int32).max, dtype=np.int64)
    if len(ca) == 0:
        return np.zeros(shape, dtype=np.int32)
    idx = _atom_voxels(ca, shape, origin, voxel_size, nstart)
    types = np.array([_AA_TYPE[r] for r in ca["res_name"]], dtype=np.int64)

    # scatter-min of the type over each CA's 26-neighborhood
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                n = idx + np.array([dx, dy, dz])
                ok = np.all((n >= 0) & (n < np.asarray(shape)), axis=1)
                np.minimum.at(mask, (n[ok, 0], n[ok, 1], n[ok, 2]), types[ok])

    mask[mask == np.iinfo(np.int32).max] = 0
    # CA voxels themselves are background
    mask[idx[:, 0], idx[:, 1], idx[:, 2]] = 0
    return mask.astype(np.int32)
