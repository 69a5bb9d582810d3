"""Iterative AF3-domain docking into the density map (PHENIX orchestration).

The port's own copy of ``mica_tpu/prep/dock.py`` (the original's
utils/dock_in_map.py): threshold the map at the contour level, dock each
AF3 domain (or chain) with ``phenix.dock_in_map``, then mask out the docked
region -- the 40% of docked atoms nearest their median centroid, dilated to
2 A via a Euclidean distance transform -- so later dockings cannot land on
already-claimed density.  Already-docked models are skipped for an
idempotent resume; finally all docked chains are merged into
``<id>_af3_docked.pdb`` with unique chain IDs.

PHENIX is an external suite; ``mica_tpu_torch.tools.phenix`` builds its
command and only records it when PHENIX is absent.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
from scipy import ndimage

from ..io import mrc as mrc_io
from ..io import pdb as pdb_io
from ..tools import phenix

logger = logging.getLogger(__name__)


def threshold_map(map_path: str, contour_level: float, out_path: str) -> str:
    """Zero density below the contour level (dock_in_map.py:248-283)."""
    vol = mrc_io.read_mrc(map_path)
    data = vol.data.copy()
    data[data < contour_level] = 0.0
    mrc_io.write_mrc_like(out_path, data, vol)
    return out_path


def mask_docked_region(
    map_path: str,
    docked_pdb: str,
    out_path: str,
    core_fraction: float = 0.4,
    dilate_angstrom: float = 2.0,
) -> str:
    """Zero the density around the docked model's core atoms.

    Selects ``core_fraction`` of atoms nearest the median atom position and
    removes density within ``dilate_angstrom`` of their voxels via EDT
    (dock_in_map.py:285-364).
    """
    vol = mrc_io.read_mrc(map_path)
    atoms = pdb_io.parse_pdb(docked_pdb)
    coords = pdb_io.coords(atoms)
    centroid = np.median(coords, axis=0)
    d = np.linalg.norm(coords - centroid, axis=1)
    keep = coords[np.argsort(d)[: max(1, int(len(coords) * core_fraction))]]

    # operate in the canonical [x, y, z] layout: file axis order
    # (mapc/mapr/maps) is arbitrary, and indexing the raw array with a
    # naive reversal puts the mask on the wrong voxels for permuted maps
    order = vol.xyz_order()
    data_xyz, offset_xyz = vol.to_xyz()
    data_xyz = np.ascontiguousarray(data_xyz).copy()
    idx = (keep - vol.origin_xyz[None, :]) / vol.voxel_size[None, :]
    idx = np.rint(idx - offset_xyz[None, :]).astype(np.int64)
    ok = np.all((idx >= 0) & (idx < np.asarray(data_xyz.shape)), axis=1)
    idx = idx[ok]

    mask = np.ones(data_xyz.shape, bool)
    mask[idx[:, 0], idx[:, 1], idx[:, 2]] = False
    dist = ndimage.distance_transform_edt(mask, sampling=vol.voxel_size)
    data_xyz[dist <= dilate_angstrom] = 0.0
    mrc_io.write_mrc_like(
        out_path, np.transpose(data_xyz, np.argsort(order)), vol
    )
    return out_path


def merge_docked_models(docked_pdbs: List[str], out_path: str) -> str:
    """Merge docked chain PDBs with globally unique chain IDs
    (dock_in_map.py:608-731)."""
    from .af3_results import OutOfChainsError

    used = []
    parts = []
    for p in sorted(docked_pdbs):
        atoms = pdb_io.parse_pdb(p)
        if len(atoms) == 0:
            continue
        for c in pdb_io.chains(atoms):
            newc = str(c)
            # len check: substring membership would accept '' / multi-char
            if (len(newc) != 1 or newc not in pdb_io.CHAIN_IDS
                    or newc in used):
                free = [x for x in pdb_io.CHAIN_IDS if x not in used]
                if not free:
                    raise OutOfChainsError(
                        f"more than {len(pdb_io.CHAIN_IDS)} docked chains")
                newc = free[0]
            used.append(newc)
            sel = pdb_io.select(atoms, chain=c).copy()
            sel["chain"] = newc
            parts.append(sel)
    merged = np.concatenate(parts) if parts else np.zeros(0, pdb_io.ATOM_DTYPE)
    pdb_io.write_pdb(out_path, merged)
    logger.info("merged %d docked chains -> %s", len(used), out_path)
    return out_path


def dock_structures(
    map_path: str,
    model_paths: List[str],
    resolution: float,
    contour_level: float,
    work_dir: str,
    phenix_env: str = "",
    sequence_path: str = "",
    output_name: Optional[str] = None,
    dry_run: bool = False,
) -> dict:
    """Iterative docking.  Returns paths + emitted commands."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    current_map = str(work / "docking_map_0.mrc")
    threshold_map(map_path, contour_level, current_map)

    docked, commands = [], []
    for i, model in enumerate(sorted(model_paths)):
        out_pdb = work / (Path(model).stem + "_docked.pdb")
        if out_pdb.exists():
            logger.info("skipping %s (already docked)", out_pdb.name)
        else:
            cmd = phenix.dock_in_map(
                model, current_map, resolution, str(out_pdb), phenix_env,
                sequence_path=sequence_path, dry_run=dry_run,
            )
            commands.append(cmd)
        if out_pdb.exists():
            docked.append(str(out_pdb))
            # re-establish the masked-map chain on resume too: skipping a
            # docked model without masking would let the next docking land
            # on its (unmasked) density
            next_map = str(work / f"docking_map_{i + 1}.mrc")
            if not Path(next_map).exists():
                mask_docked_region(current_map, str(out_pdb), next_map)
            current_map = next_map

    merged = None
    if docked:
        name = output_name or (Path(work_dir).name + "_af3_docked.pdb")
        merged = merge_docked_models(docked, str(Path(work_dir).parent / name))
    return {"docked": docked, "merged": merged, "commands": commands}
