"""Sparse / lazy pairwise structures for the trace stage.

The reference holds dense ``(N, N)`` float64 ``dist`` and ``neigh_mat``
arrays (modeler.py:863-886), which at 20k candidates cost ~3.2 GB each —
and its fork pools copy them per worker.  Candidate neighborhoods are
physically local (CA-CA relevant range <= 7 A), so both structures are
replaced here:

  * :class:`PairwiseDistances` — a lazy matrix computing distances from
    coordinates on indexing (exact for ANY pair, O(#queried) memory);
  * :class:`SparsePairScores` — CSR-backed pair scores with dense-style
    scalar / fancy indexing (missing pairs read as 0, exactly the dense
    semantics since scores are only nonzero within the 2-6 A band).

Both support the full access patterns of the downstream consumers
(scalar lookups, paired-array fancy indexing).
"""

from __future__ import annotations

import numpy as np


class PairwiseDistances:
    """Lazy (N, N) distance matrix over ``coords`` (N, 3)."""

    def __init__(self, coords: np.ndarray):
        self.coords = np.asarray(coords, np.float64)
        n = len(self.coords)
        self.shape = (n, n)

    def __getitem__(self, idx):
        i, j = idx
        d = self.coords[i] - self.coords[j]
        return np.sqrt(np.sum(d * d, axis=-1))


class SparsePairScores:
    """Sparse symmetric-support (N, N) score matrix, dense-style indexing."""

    def __init__(self, n: int, ii: np.ndarray, jj: np.ndarray,
                 vals: np.ndarray):
        self.n = int(n)
        self.shape = (self.n, self.n)
        ii = np.asarray(ii, np.int64)
        jj = np.asarray(jj, np.int64)
        keys = ii * self.n + jj
        order = np.argsort(keys, kind="stable")
        self._keys = keys[order]
        self._vals = np.asarray(vals, np.float64)[order]

    @classmethod
    def from_dense(cls, mat: np.ndarray) -> "SparsePairScores":
        ii, jj = np.nonzero(mat)
        return cls(mat.shape[0], ii, jj, mat[ii, jj])

    def __getitem__(self, idx):
        i, j = idx
        # numpy negative-index semantics (the dense matrix this replaces
        # supported them; naive keying would alias (i, -1) to (i-1, n-1))
        i = np.where(np.asarray(i) < 0, np.asarray(i) + self.n, i)
        j = np.where(np.asarray(j) < 0, np.asarray(j) + self.n, j)
        k = np.asarray(i, np.int64) * self.n + np.asarray(j, np.int64)
        scalar = k.ndim == 0
        kf = np.atleast_1d(k).ravel()
        if len(self._keys) == 0:
            out = np.zeros(kf.shape)
        else:
            pos = np.searchsorted(self._keys, kf)
            pos = np.minimum(pos, len(self._keys) - 1)
            found = self._keys[pos] == kf
            out = np.where(found, self._vals[pos], 0.0)
        if scalar:
            return float(out[0])
        return out.reshape(np.shape(k))

    def row_nonzero(self, i: int):
        """(cols, vals) of row i."""
        lo = np.searchsorted(self._keys, i * self.n)
        hi = np.searchsorted(self._keys, (i + 1) * self.n)
        return self._keys[lo:hi] - i * self.n, self._vals[lo:hi]

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        out[self._keys // self.n, self._keys % self.n] = self._vals
        return out


class SparseHopMatrix:
    """Row-sparse (n_hop, N, N) reachability stack.

    Per (hop, src) the nonzero destinations are bounded by the top-2
    branching of the best-neighbor walk (<= 2^(h+1) before dst merging), so
    rows are stored padded to the per-hop max width:
    ``indices`` (n_hop, N, K) int32 and ``values`` (n_hop, N, K) float32
    (padding: index 0 with value 0).  ``widths[h]`` is the true max row
    width of hop h — consumers slice ``indices[h, :, :widths[h]]`` so
    early hops (width <= 2) are not processed at the deepest hop's K.
    """

    def __init__(self, indices: np.ndarray, values: np.ndarray, n: int,
                 widths=None):
        self.indices = indices
        self.values = values
        self.n = n
        self.shape = (indices.shape[0], n, n)
        self.widths = (
            list(widths) if widths is not None
            else [indices.shape[2]] * indices.shape[0]
        )

    def hop_dense(self, h: int) -> np.ndarray:
        w = self.widths[h]
        out = np.zeros((self.n, self.n))
        src = np.repeat(np.arange(self.n), w)
        np.maximum.at(out, (src, self.indices[h, :, :w].ravel()),
                      self.values[h, :, :w].ravel())
        return out

    def todense(self) -> np.ndarray:
        return np.stack([self.hop_dense(h) for h in range(self.shape[0])])
