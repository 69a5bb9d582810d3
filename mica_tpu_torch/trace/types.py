"""Data structures for the tracing/modeling engine."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..io.pdb import THREE_TO_ONE

# one-letter amino acid -> index 0..19 in the model's AA channel order
AA_LETTER_INDEX = {THREE_TO_ONE[k]: i for i, k in enumerate(
    ["ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE", "LYS", "LEU",
     "MET", "ASN", "PRO", "GLN", "ARG", "SER", "THR", "VAL", "TRP", "TYR"]
)}


@dataclasses.dataclass
class ChainModel:
    """Assignment of one chain's sequence positions to candidate indices."""

    chain_id: str
    length: int
    result: np.ndarray = None  # (L,) candidate index or -1
    high_conf: np.ndarray = None

    def __post_init__(self):
        if self.result is None:
            self.result = np.full(self.length, -1, np.int64)
        if self.high_conf is None:
            self.high_conf = np.full(self.length, -1, np.int64)


@dataclasses.dataclass
class SequenceEntry:
    """A FASTA sequence with its chains and optional AF3 template.

    When an AF3 template is loaded (protocol 'AF3_struct'), the working
    sequence is replaced by the template's residue sequence, mirroring
    modeler.py:422-453 (get_seq).
    """

    name: str
    sequence: str
    chains: Dict[str, ChainModel] = dataclasses.field(default_factory=dict)
    af3_coords: Optional[np.ndarray] = None  # (L, 3) CA coords, voxel frame

    # alignment working state
    aligned_frags: List = dataclasses.field(default_factory=list)
    chain_cand_mat: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.sequence)

    @property
    def aa_indices(self) -> np.ndarray:
        """(L,) int: AA channel index per position (-1 for unknown)."""
        return np.array(
            [AA_LETTER_INDEX.get(c, -1) for c in self.sequence], np.int64
        )


@dataclasses.dataclass
class AlignedFragment:
    """A contiguous stretch of sequence matched to a candidate trace."""

    trace: List[int]  # candidate indices
    seq_positions: List[int]  # sequence positions (same length)
    scores: np.ndarray  # per-position scores


def build_seq_cand_aa_mat(entries: List[SequenceEntry],
                          cand_aa_prob: np.ndarray) -> np.ndarray:
    """(n_fasta, max_len, n_cand): per-position candidate AA probability.

    Vectorized equivalent of prepareSeq4Align (modeler.py:1041-1051).
    """
    max_len = max((len(e) for e in entries), default=0)
    n_cand = cand_aa_prob.shape[1]
    mat = np.zeros((len(entries), max_len, n_cand))
    for i, e in enumerate(entries):
        idx = e.aa_indices
        valid = idx >= 0
        mat[i, : len(e)][valid] = cand_aa_prob[idx[valid]]
    return mat
