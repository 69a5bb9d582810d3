"""Training data (port of ``mica_tpu/train/data.py``, numpy only).

  * ``NpzGridsDataset``: the reference's on-disk ``Grids`` layout
    (``normalized_maps/<id>/grid_*.npz`` with sibling ``BB_masks``,
    ``CA_masks``, ``AA_masks`` and 24 ``<type>_encodings`` directories
    found by path substitution);
  * ``ArrayDataset``: in-memory windows, saved and loaded as one packed
    ``.npz``;
  * ``train_val_split``, ``batch_iterator`` and ``synthetic_batch``.

Augmentation and AF3 blanking run on the device in the trainer; the
loader only moves bytes.  Building grids from a (map, model) pair
(``build_training_grids``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from glob import glob
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ..ops.rasterize import CHANNEL_NAMES

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


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
    """In-memory training windows."""

    density: np.ndarray  # (N, W, W, W) float32
    af3: np.ndarray  # (N, 24, W, W, W) uint8/float32
    bb: np.ndarray  # (N, W, W, W) integer
    ca: np.ndarray
    aa: np.ndarray

    def __len__(self) -> int:
        return len(self.density)

    def __getitem__(self, i: int):
        return (self.density[i].astype(np.float32), self.af3[i].astype(np.float32),
                self.bb[i].astype(np.int32), self.ca[i].astype(np.int32),
                self.aa[i].astype(np.int32))

    def save(self, path: str) -> None:
        np.savez_compressed(path, density=self.density, af3=self.af3.astype(np.uint8),
                            bb=self.bb.astype(np.int8), ca=self.ca.astype(np.int8),
                            aa=self.aa.astype(np.int8))

    @classmethod
    def load(cls, path: str) -> "ArrayDataset":
        d = np.load(path)
        return cls(d["density"], d["af3"], d["bb"], d["ca"], d["aa"])


def train_val_split(n: int, val_fraction: float = 0.2,
                    seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled (train, val) index split, the reference's 80/20 with seed 42."""
    perm = np.random.default_rng(seed).permutation(n)
    n_val = int(round(n * val_fraction))
    return perm[n_val:], perm[:n_val]


def batch_iterator(dataset, batch_size: int, indices: Optional[np.ndarray] = None,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True) -> Iterator[Batch]:
    """Yield numpy batches (density, af3, bb, ca, aa)."""
    idx = np.arange(len(dataset)) if indices is None else np.asarray(indices)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(idx)
    stop = len(idx) - (len(idx) % batch_size if drop_last else 0)
    for ofs in range(0, stop, batch_size):
        samples = [dataset[int(i)] for i in idx[ofs:ofs + batch_size]]
        yield tuple(np.stack([s[f] for s in samples]) for f in range(5))


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
