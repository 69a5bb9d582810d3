"""CA candidate extraction: clustering, NMS, refinement, neighbor graph.

Re-implementation of the reference clustering stage (modeler.py:762-899),
vectorized end to end:

  1. threshold the CA probability volume (CA_score_thrh, default 0.3);
  2. cluster the voxel cloud (DBSCAN eps=10, min_points=10 in the
     reference via open3d).  For the dense voxel clouds this operates on,
     every point is a DBSCAN core point, so clustering reduces to
     single-linkage components at distance eps — computed here via a
     ball-dilation + connected-component labeling (O(volume)) instead of a
     pairwise neighbor graph; an exact sklearn DBSCAN is used for small
     clouds;
  3. score clusters by backbone probability (sum filter at max/10, mean
     filter at max/2) and keep the survivors;
  4. greedy non-maximum suppression by descending CA probability with
     squared-radius 9 (kd-tree accelerated);
  5. sub-voxel refinement: 3-cube CA-probability-weighted centroid, with
     the same weights aggregating per-candidate amino-acid probabilities;
  6. neighbor lists at 2-6 / 0-6 / 2-7 / 0-7 A and the pair scoring matrix
     neigh_mat = (distance score around the ideal 3.8 A CA-CA spacing +
     mean backbone probability at 4 points interpolated along the segment)/2
     — fully vectorized over the sparse neighbor pairs;
  7. best_neigh: top-2 scored neighbors per candidate.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List

import numpy as np
import torch
from scipy import ndimage

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Candidates:
    """CA candidates plus their neighbor structure."""

    coords: np.ndarray  # (N, 3) float64 sub-voxel positions (voxel units)
    aa_prob: np.ndarray  # (20, N) aggregated amino-acid probabilities
    aa_pred: np.ndarray  # (N,) argmax type 0..19 at the rounded position
    # lazy/sparse (N, N)-indexable structures (trace/sparse.py): dense
    # matrices at 20k candidates are 3.2 GB each
    dist: "PairwiseDistances"  # dense-style indexing, computed lazily
    neigh_mat: "SparsePairScores"  # dense-style indexing, 0 default
    neighbors2to6: List[np.ndarray]
    neighbors0to6: List[np.ndarray]
    neighbors2to7: List[np.ndarray]
    neighbors0to7: List[np.ndarray]
    best_neigh: List[List[int]]

    def __len__(self) -> int:
        return len(self.coords)


def _values_at(vol, index) -> np.ndarray:
    """``vol[index]`` as a numpy array, ``index`` a tuple of numpy index
    arrays (and slices).  A torch tensor is indexed on its own device, so
    only the gathered values reach the host."""
    if isinstance(vol, torch.Tensor):
        index = tuple(torch.from_numpy(np.ascontiguousarray(i)).to(vol.device)
                      if isinstance(i, np.ndarray) else i for i in index)
        return vol[index].cpu().numpy()
    return np.asarray(vol[index])


def cluster_points(points: np.ndarray, shape, eps: float = 10.0,
                   min_points: int = 10, method: str = "auto") -> np.ndarray:
    """Cluster integer voxel points; returns labels (−1 = noise)."""
    n = len(points)
    if n == 0:
        return np.zeros(0, np.int64)
    if method == "auto":
        method = "dbscan" if n <= 30000 else "morphology"
    if method == "dbscan":
        from sklearn.cluster import DBSCAN

        return DBSCAN(eps=eps, min_samples=min_points).fit(points).labels_

    # ball-dilation single-linkage: centers within eps have overlapping
    # radius-eps/2 balls -> same connected component
    r = int(np.floor(eps / 2))
    mask = np.zeros(shape, bool)
    mask[points[:, 0], points[:, 1], points[:, 2]] = True
    zz, yy, xx = np.ogrid[-r : r + 1, -r : r + 1, -r : r + 1]
    ball = (zz * zz + yy * yy + xx * xx) <= r * r
    dilated = ndimage.binary_dilation(mask, structure=ball)
    labeled, _ = ndimage.label(dilated, structure=np.ones((3, 3, 3)))
    return labeled[points[:, 0], points[:, 1], points[:, 2]].astype(np.int64) - 1


def filter_clusters(points: np.ndarray, labels: np.ndarray,
                    bb_prob: np.ndarray) -> np.ndarray:
    """Keep points of clusters passing the backbone-probability filters."""
    n_labels = labels.max() + 1
    if n_labels <= 0:
        return np.zeros(len(points), bool)
    vals = bb_prob[points[:, 0], points[:, 1], points[:, 2]]
    sums = np.zeros(n_labels)
    counts = np.zeros(n_labels)
    valid = labels >= 0
    np.add.at(sums, labels[valid], vals[valid])
    np.add.at(counts, labels[valid], 1)
    means = np.where(
        (sums > sums.max() / 10) & (counts > 0), sums / np.maximum(counts, 1), 0.0
    )
    keep_label = means > means.max() / 2
    keep = np.zeros(len(points), bool)
    keep[valid] = keep_label[labels[valid]]
    return keep


def nms(points: np.ndarray, scores: np.ndarray, radius_sq: float = 9.0,
        score_threshold: float = 0.3) -> np.ndarray:
    """Greedy NMS by descending score; suppress within sqrt(radius_sq).

    Exact greedy semantics (modeler.py:821-830), computed by parallel
    rounds over the sparse within-radius pair set instead of a serial
    per-survivor ball query: a point is kept when no higher-priority
    point within the radius is still in play; every neighbor of a
    newly-kept point is retired.  Each round is a handful of vectorized
    passes over the pair list, and the round count is bounded by the
    longest descending-score suppression chain (tens, in practice, even
    at 50k candidates — the serial loop this replaces was the one O(N)
    Python hotspot left on the host fallback path).

    Ties break like the serial loop: stable descending sort, so equal
    scores process in ascending original index.
    """
    from scipy.spatial import cKDTree

    order = np.argsort(-scores, kind="stable")
    order = order[scores[order] >= score_threshold]
    m = len(order)
    if m == 0:
        return np.zeros(0, np.int64)
    pts = points[order].astype(np.float64)
    # sparse neighbor pairs within r, in priority (rank) space: hi < lo
    pairs = cKDTree(pts).query_pairs(np.sqrt(radius_sq),
                                     output_type="ndarray")
    hi = np.minimum(pairs[:, 0], pairs[:, 1]) if len(pairs) else np.zeros(0, np.int64)
    lo = np.maximum(pairs[:, 0], pairs[:, 1]) if len(pairs) else np.zeros(0, np.int64)

    active = np.ones(m, bool)
    kept = np.zeros(m, bool)
    rounds = 0
    while True:
        rounds += 1
        if rounds > 256:
            # adversarial suppression chains (a sorted line of points)
            # retire only O(1) points per round; finish the stragglers
            # with the serial scan — identical semantics, tiny remainder
            kept |= _nms_serial_tail(pts, hi, lo, active)
            break
        # keep every active point with no ACTIVE higher-priority neighbor
        blocked = np.zeros(m, bool)
        live = active[hi] & active[lo]
        blocked[lo[live]] = True
        keep_now = active & ~blocked
        if not keep_now.any():
            break
        kept |= keep_now
        # retire the keepers and everything within radius of them (a
        # kept-lo/active-hi pair is impossible: an active hi would have
        # blocked lo — the hi side is masked on `active` for safety only)
        supp = np.zeros(m, bool)
        supp[lo[keep_now[hi]]] = True
        supp[hi[keep_now[lo] & active[hi]]] = True
        active &= ~(keep_now | supp)
        if not active.any():
            break
    return order[kept]


def _nms_serial_tail(pts: np.ndarray, hi: np.ndarray, lo: np.ndarray,
                     active: np.ndarray) -> np.ndarray:
    """Serial greedy over the remaining ``active`` points (rank space).

    Used only when the parallel rounds hit the iteration cap; walks ranks
    ascending (= descending score) over the precomputed pair adjacency."""
    m = len(pts)
    adj = [[] for _ in range(m)]
    for a, b in zip(hi, lo):
        if active[a] or active[b]:
            adj[a].append(b)
            adj[b].append(a)
    kept = np.zeros(m, bool)
    alive = active.copy()
    for i in np.flatnonzero(active):
        if not alive[i]:
            continue
        kept[i] = True
        alive[i] = False
        for j in adj[i]:
            alive[j] = False
    return kept


def refine_candidates(cands: np.ndarray, ca_prob: np.ndarray, aa_prob: np.ndarray):
    """Sub-voxel refinement by 3-cube CA-probability-weighted centroid.

    Boundary candidates (any index at the volume edge) are dropped, like the
    reference's try/except (modeler.py:854-855).
    """
    shape = np.asarray(ca_prob.shape)
    inner = np.all((cands >= 1) & (cands <= shape - 2), axis=1)
    cands = cands[inner]
    n = len(cands)
    if n == 0:
        return np.zeros((0, 3)), np.zeros((aa_prob.shape[0], 0))

    offsets = np.array(
        [[di, dj, dk] for di in (-1, 0, 1) for dj in (-1, 0, 1) for dk in (-1, 0, 1)]
    )  # (27, 3)
    neigh = cands[:, None, :] + offsets[None, :, :]  # (N, 27, 3)
    w = ca_prob[neigh[..., 0], neigh[..., 1], neigh[..., 2]]  # (N, 27)
    w = w / w.sum(axis=1, keepdims=True)
    coords = np.einsum("nk,nkd->nd", w, neigh.astype(np.float64))
    # aa_prob may be a tensor on the card (see solver): the gather runs there
    # and only the (20, N, 27) neighborhood values transfer to host
    aa_vals = _values_at(aa_prob, (slice(None), neigh[..., 0], neigh[..., 1], neigh[..., 2]))
    aa = np.einsum("nk,cnk->cn", w, aa_vals)
    return coords, aa


def pair_scores_sparse(coords: np.ndarray, ii: np.ndarray, jj: np.ndarray,
                       d: np.ndarray, bb_prob: np.ndarray,
                       lo: float = 2.0, hi: float = 6.0):
    """neigh_mat over candidate pairs (modeler.py:877-886), sparse.

    ``(ii, jj, d)`` are directed pairs with their distances; only those in
    the [lo, hi] band score (the dense matrix is zero elsewhere)."""
    band = (d >= lo) & (d <= hi)
    ii, jj, d = ii[band], jj[band], d[band]
    if len(ii) == 0:
        return ii, jj, np.zeros(0)
    dis = np.maximum(0.0, np.abs(d - 3.8) - 0.5)
    dis_score = np.maximum(0.0, 1.0 - dis / 2.0)

    shape = np.asarray(bb_prob.shape)
    pts = np.concatenate([
        np.clip(
            np.rint(j / 5 * coords[jj] + (5 - j) / 5 * coords[ii]).astype(np.int64),
            0, shape - 1,
        )
        for j in range(1, 5)
    ])  # (4P, 3) — one gather; bb_prob may be a tensor on the card, in which
    # case the lookup runs there and only the (4, P) values transfer
    vals = _values_at(bb_prob, (pts[:, 0], pts[:, 1], pts[:, 2])).astype(
        np.float64).reshape(4, len(ii))
    bb = vals.sum(axis=0)
    return ii, jj, (dis_score + bb / 4.0) / 2.0


def extract_candidates(
    ca_prob: np.ndarray,
    bb_prob: np.ndarray,
    aa_prob: np.ndarray,
    aa_pred: np.ndarray,
    ca_score_threshold: float = 0.3,
    cluster_eps: float = 10.0,
    cluster_min_points: int = 10,
    nms_radius_sq: float = 9.0,
    cluster_method: str = "auto",
) -> Candidates:
    """Full candidate-extraction pipeline from the prediction volumes."""
    points = np.argwhere(ca_prob > ca_score_threshold)
    logger.info("candidate extraction: %d voxels above %.2f", len(points),
                ca_score_threshold)
    labels = cluster_points(points, ca_prob.shape, cluster_eps,
                            cluster_min_points, cluster_method)
    keep = filter_clusters(points, labels, bb_prob)
    kept = points[keep]
    logger.info("clusters kept %d/%d voxels", len(kept), len(points))

    scores = ca_prob[kept[:, 0], kept[:, 1], kept[:, 2]]
    keep_ix = nms(kept, scores, nms_radius_sq, ca_score_threshold)
    cand_voxels = kept[keep_ix]
    logger.info("NMS candidates: %d", len(cand_voxels))

    coords, aa = refine_candidates(cand_voxels, ca_prob, aa_prob)
    rounded = np.clip(
        np.rint(coords).astype(np.int64), 0, np.asarray(ca_prob.shape) - 1
    )
    pred = np.asarray(aa_pred[rounded[:, 0], rounded[:, 1], rounded[:, 2]])

    return build_neighbor_structure(coords, aa, pred, bb_prob)


def build_neighbor_structure(coords: np.ndarray, aa: np.ndarray,
                             pred: np.ndarray, bb_prob: np.ndarray
                             ) -> Candidates:
    """Sparse neighbor structure via KD-tree radius queries.

    Replaces the reference's dense (N, N) float64 distance / score
    matrices (modeler.py:863-886): at 20k candidates those are 3.2 GB each
    and O(N^2) to build; a 7 A radius query is O(N log N) and the sparse
    pair set is ~30 pairs/candidate.
    """
    from scipy.spatial import cKDTree

    from .sparse import PairwiseDistances, SparsePairScores

    n = len(coords)
    tree = cKDTree(coords)
    pairs = tree.query_pairs(7.0, output_type="ndarray")  # undirected i<j
    if len(pairs):
        ii = np.concatenate([pairs[:, 0], pairs[:, 1]])
        jj = np.concatenate([pairs[:, 1], pairs[:, 0]])
    else:
        ii = jj = np.zeros(0, np.int64)
    d = np.sqrt(np.sum((coords[ii] - coords[jj]) ** 2, axis=-1))

    # per-candidate neighbor lists (sorted ascending like np.where on rows)
    order = np.argsort(ii * n + jj, kind="stable")
    ii_s, jj_s, d_s = ii[order], jj[order], d[order]
    row_start = np.searchsorted(ii_s, np.arange(n))
    row_end = np.searchsorted(ii_s, np.arange(n) + 1)

    n26, n06, n27, n07 = [], [], [], []
    self_ix = np.arange(n)
    for i in range(n):
        cols = jj_s[row_start[i]:row_end[i]]
        dr = d_s[row_start[i]:row_end[i]]
        n26.append(cols[(dr >= 2) & (dr <= 6)])
        # the <=6 / <=7 bands include the candidate itself (dist 0),
        # matching np.where(dist[i] <= r) on the dense matrix
        n06.append(np.sort(np.append(cols[dr <= 6], self_ix[i])))
        n27.append(cols[(dr >= 2) & (dr <= 7)])
        n07.append(np.sort(np.append(cols[dr <= 7], self_ix[i])))

    si, sj, sv = pair_scores_sparse(coords, ii, jj, d, bb_prob)
    mat = SparsePairScores(n, si, sj, sv)

    best: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        cols, vals = mat.row_nonzero(i)
        if len(cols) == 0:
            continue
        # dense argsort tie-breaking: stable sort over the full row picks
        # the LARGEST index among equal scores last; nonzero scores only
        top = np.argsort(vals, kind="stable")[::-1][:2]
        lst = [int(cols[t]) for t in top if vals[t] != 0]
        best[i] = lst

    return Candidates(
        coords=coords, aa_prob=aa, aa_pred=pred,
        dist=PairwiseDistances(coords), neigh_mat=mat,
        neighbors2to6=n26, neighbors0to6=n06, neighbors2to7=n27,
        neighbors0to7=n07, best_neigh=best,
    )
