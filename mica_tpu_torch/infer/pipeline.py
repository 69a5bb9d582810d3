"""Map-level preprocessing + prediction pipeline.

Port of ``mica_tpu/infer/pipeline.py``: read the density map, resample to
1 Å, normalize to [0, 1], rasterize the docked AF3 structure into the
24-channel encoding, run the sliding-window predictor, and return the four
prediction volumes.  Resample and normalize run on ``device``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..io import mrc as mrc_io
from ..io import pdb as pdb_io
from ..ops.normalize import normalize_map
from ..ops.rasterize import rasterize_af3_encoding, voxel_to_world
from ..ops.resample import resample_to_voxel_size
from .engine import SlidingWindowPredictor, auto_batch_size, best_core

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class PreparedMap:
    """A normalized, 1 Å, canonical-XYZ density volume plus geometry."""

    volume: np.ndarray  # (X, Y, Z) float32 in [0, 1]
    offset: np.ndarray  # nstart offset per canonical axis (voxels)
    origin: np.ndarray  # header origin (Angstroms, XYZ)
    voxel_size: float  # target voxel size (1.0)
    source_path: Optional[str] = None

    def voxel_to_world(self, indices: np.ndarray) -> np.ndarray:
        return voxel_to_world(indices, self.origin, self.voxel_size, self.offset)


def prepare_map(map_path: str, target_voxel_size: float = 1.0,
                device=None) -> PreparedMap:
    """Read an MRC map, resample to ``target_voxel_size`` Å and normalize."""
    t0 = time.time()
    dev = resolve_device(device)
    vol = mrc_io.read_mrc(map_path)
    xyz, offset = vol.to_xyz()
    x = torch.from_numpy(np.ascontiguousarray(xyz, np.float32)).to(dev)
    resampled = resample_to_voxel_size(x, vol.voxel_size, target_voxel_size)
    normalized = normalize_map(resampled).cpu().numpy()
    logger.info("prepared map %s: %s -> %s @ %.2f A in %.2fs", Path(map_path).name,
                xyz.shape, normalized.shape, target_voxel_size, time.time() - t0)
    return PreparedMap(
        volume=normalized,
        offset=np.asarray(offset, np.float64),
        origin=vol.origin_xyz,
        voxel_size=float(target_voxel_size),
        source_path=str(map_path),
    )


def build_af3_encoding(prepared: PreparedMap, docked_pdb_path: str,
                       mode: str = "nearest") -> np.ndarray:
    """Rasterize the combined docked AF3 model onto the prepared map grid."""
    atoms = pdb_io.parse_pdb(docked_pdb_path)
    return rasterize_af3_encoding(atoms, prepared.volume.shape, origin=prepared.origin,
                                  voxel_size=prepared.voxel_size, nstart=prepared.offset,
                                  mode=mode)


def predict_map(
    map_path: str,
    params,
    docked_pdb_path: Optional[str] = None,
    batch_size: int = 0,
    dtype: Optional[torch.dtype] = None,
    base_filters: int = 64,
    core: int = 48,
    halo: int = 8,
    predictor: Optional[SlidingWindowPredictor] = None,
    device=None,
) -> Dict[str, object]:
    """End-to-end: map file (+ optional docked AF3 model) -> prediction
    volumes.  ``params``: a torch state dict, a JAX parameter tree or a
    ``MICA`` module.  ``predictor`` reuses an existing predictor (the
    returned dict carries it under ``"predictor"``).  ``batch_size=0``
    derives the batch from the card's memory; ``core=0`` picks the window
    geometry with the fewest computed voxels."""
    dev = resolve_device(device if predictor is None else predictor.device)
    prepared = prepare_map(map_path, device=dev)
    if predictor is not None:
        core, halo, batch_size = predictor.core, predictor.halo, predictor.batch_size
    else:
        batch_size = batch_size or auto_batch_size(device=dev)
        if core == 0:
            core, batch_size = best_core(prepared.volume.shape, halo, max_batch=batch_size)
    encoding = None
    if docked_pdb_path is not None:
        if not Path(docked_pdb_path).exists():
            raise FileNotFoundError(f"docked AF3 model not found: {docked_pdb_path}")
        encoding = build_af3_encoding(prepared, docked_pdb_path)

    if predictor is None:
        predictor = SlidingWindowPredictor(
            params, batch_size=batch_size,
            dtype=dtype if dtype is not None else torch.bfloat16,
            base_filters=base_filters, core=core, halo=halo, device=dev)
    out = predictor.predict_volume(prepared.volume, encoding)
    out["prepared_map"] = prepared
    out["predictor"] = predictor
    out["timing"] = dict(predictor.timing)
    return out
