"""Training data (port of ``mica_tpu/train/data.py``).

  * ``NpzGridsDataset``: the reference's on-disk ``Grids`` layout
    (``normalized_maps/<id>/grid_*.npz`` with sibling ``BB_masks``,
    ``CA_masks``, ``AA_masks`` and 24 ``<type>_encodings`` directories
    found by path substitution);
  * ``ArrayDataset``: in-memory windows, saved and loaded as one packed
    ``.npz``;
  * ``build_training_grids``: windows straight from a (map, model PDB)
    pair: prepare the map, rasterize the label masks and the AF3
    encoding, window everything on the device and keep the windows whose
    density max is >= 0.01 (the filter that defines the original MICA's
    training set); it replaces the original's shell pipeline;
  * ``train_val_split``, ``batch_iterator`` and ``synthetic_batch``;
    under a data-parallel mesh ``batch_iterator`` reads only the rank's
    rows of each global batch (``RowShard``).

Samples and batches keep the types the dataset stores (a packed
``ArrayDataset``: f32 density, uint8 AF3 bits, int8 labels), so a batch
crosses to the card in about a quarter of its widened bytes; the trainer
widens it there (``Trainer._to_device``).  Augmentation and AF3 blanking
run on the device too: the loader only moves bytes.
"""

from __future__ import annotations

import dataclasses
from glob import glob
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..infer.pipeline import prepare_map
from ..io import pdb as pdb_io
from ..ops import masks as mask_ops
from ..ops.rasterize import CHANNEL_NAMES, rasterize_af3_encoding
from ..ops.window import extract_windows
from ..utils.spans import span

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


@dataclasses.dataclass
class RowShard:
    """A data-parallel rank's rows ``first..`` of a global batch of
    ``total`` rows; ``rows`` is laid out as a ``Batch``."""

    rows: Batch
    first: int
    total: int


class NpzGridsDataset:
    """Reads the reference's pre-generated training grids."""

    def __init__(self, grid_paths: Sequence[str]):
        self.paths = list(grid_paths)

    @classmethod
    def from_root(cls, root: str) -> "NpzGridsDataset":
        return cls(sorted(glob(str(Path(root) / "normalized_maps" / "*" / "*.npz"))))

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        p = self.paths[i]

        def grid(kind: str) -> np.ndarray:
            return np.load(p.replace("normalized_maps", kind))["grid"]

        density = np.load(p)["grid"].astype(np.float32)
        bb, ca, aa = (grid(k).astype(np.int32) for k in ("BB_masks", "CA_masks", "AA_masks"))
        af3 = np.stack([grid(f"{t}_encodings") for t in CHANNEL_NAMES]).astype(np.float32)
        return density, af3, bb, ca, aa


@dataclasses.dataclass
class ArrayDataset:
    """In-memory training windows; a sample is the fields' rows in their
    stored types, unwidened."""

    density: np.ndarray  # (N, W, W, W) float32
    af3: np.ndarray  # (N, 24, W, W, W) uint8 (packed) or float32
    bb: np.ndarray  # (N, W, W, W) integer: int8 packed
    ca: np.ndarray
    aa: np.ndarray

    def __len__(self) -> int:
        return len(self.density)

    def __getitem__(self, i: int):
        return self.density[i], self.af3[i], self.bb[i], self.ca[i], self.aa[i]

    def save(self, path: str) -> None:
        np.savez_compressed(path, density=self.density, af3=self.af3.astype(np.uint8),
                            bb=self.bb.astype(np.int8), ca=self.ca.astype(np.int8),
                            aa=self.aa.astype(np.int8))

    @classmethod
    def load(cls, path: str) -> "ArrayDataset":
        d = np.load(path)
        return cls(d["density"], d["af3"], d["bb"], d["ca"], d["aa"])


def build_training_grids(map_path: str, model_pdb_path: str,
                         docked_af3_pdb_path: Optional[str] = None,
                         density_threshold: float = 0.01, device=None) -> ArrayDataset:
    """(density map, deposited model[, docked AF3 model]) -> training
    windows, the JAX function's (64^3: core 48, halo 8).

    The map is prepared (resampled to 1 A and normalized) on ``device``
    (None means the card); the masks and the encoding are rasterized on
    the host; all of them are windowed on ``device``.  Windows are kept
    where the density window's max is >= ``density_threshold``.  Without
    an AF3 model the deposited model is the encoding's source too."""
    dev = resolve_device(device)
    prepared = prepare_map(map_path, device=dev)
    geom = dict(origin=prepared.origin, voxel_size=prepared.voxel_size,
                nstart=prepared.offset)
    atoms = pdb_io.parse_pdb(model_pdb_path)
    shape = prepared.volume.shape
    enc_atoms = (pdb_io.parse_pdb(docked_af3_pdb_path) if docked_af3_pdb_path is not None
                 else atoms)

    dens_w = extract_windows(torch.from_numpy(prepared.volume).to(dev))
    keep = dens_w.flatten(1).amax(dim=1) >= density_threshold

    def windows(vol: np.ndarray) -> np.ndarray:
        return extract_windows(torch.from_numpy(vol).to(dev))[keep].cpu().numpy()

    bb, ca, aa = (windows(fn(atoms, shape, **geom)) for fn in (
        mask_ops.backbone_mask, mask_ops.carbon_alpha_mask, mask_ops.amino_acid_mask))
    # the nearest-voxel encoding is binary: uint8 moves a quarter of the bytes
    af3 = windows(rasterize_af3_encoding(enc_atoms, shape, **geom).astype(np.uint8))
    return ArrayDataset(density=dens_w[keep].cpu().numpy(), af3=af3, bb=bb, ca=ca, aa=aa)


def train_val_split(n: int, val_fraction: float = 0.2,
                    seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled (train, val) index split, the reference's 80/20 with seed 42."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


def batch_iterator(dataset, batch_size: int, indices: Optional[np.ndarray] = None,
                   shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                   mesh=None) -> Iterator:
    """Yield numpy batches (density, af3, bb, ca, aa) in the dataset's
    sample types.  Under a distributed ``mesh`` (every rank draws the same
    shuffle from ``seed``) a batch that divides the world comes as this
    rank's ``RowShard``, the only rows it reads; one that does not comes
    whole, for every rank to evaluate."""
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    stop = len(idx) - (len(idx) % batch_size if drop_last else 0)

    def read(ix):
        # closed before the batch is yielded: a span does not cross a yield
        with span("train.load"):
            samples = [dataset[int(i)] for i in ix]
            return tuple(np.stack([s[f] for s in samples]) for f in range(5))

    for ofs in range(0, stop, batch_size):
        ix = idx[ofs:ofs + batch_size]
        if mesh is None or not mesh.distributed or len(ix) % mesh.size:
            yield read(ix)
            continue
        per = len(ix) // mesh.size
        yield RowShard(read(ix[mesh.rank * per:(mesh.rank + 1) * per]), mesh.rank * per,
                       len(ix))


def synthetic_batch(batch_size: int = 4, size: int = 64, seed: int = 0) -> Batch:
    """Deterministic random data in the batch layout, the JAX package's
    draws from the same seed."""
    rng = np.random.default_rng(seed)
    density = rng.random((batch_size, size, size, size), np.float32)
    af3 = (rng.random((batch_size, 24, size, size, size)) < 0.02).astype(np.float32)
    bb = rng.integers(0, 4, (batch_size, size, size, size), np.int32)
    ca = rng.integers(0, 4, (batch_size, size, size, size), np.int32)
    aa = rng.integers(0, 21, (batch_size, size, size, size), np.int32)
    return density, af3, bb, ca, aa
