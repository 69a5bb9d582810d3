"""Protein domain segmentation: geometric and learned.

Port of ``mica_tpu/models/segmenter.py``:

  * :func:`segment_domains`, the deterministic geometric segmenter
    (recursive spectral bisection of the 8 A CA contact graph with a
    contact-density acceptance, contiguity smoothing and small-domain
    merging), used whenever Merizo's trained weights are absent; numpy and
    scipy, a copy;
  * :class:`DomainSegmenter`, the learned segmenter of the same family as
    Merizo (residue and pairwise-distance embeddings, IPA-style blocks over
    backbone frames, learned domain slots with cosine mask logits), as an
    ``nn.Module`` whose state dict ``models.convert.
    segmenter_state_dict_from_jax_params`` fills from the JAX package's
    flax tree.  Unlike the JAX package, :func:`segment_with_model` does not
    fall back to the geometric segmenter when the network fails: the error
    is raised.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from .mica import exact_f32

MIN_DOMAIN_SIZE = 50
CONTACT_DISTANCE = 8.0


# ===========================================================================
# geometric segmentation
# ===========================================================================

def _contact_matrix(ca: np.ndarray, cutoff: float = CONTACT_DISTANCE) -> np.ndarray:
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    a = (d < cutoff).astype(np.float64)
    np.fill_diagonal(a, 0.0)
    return a


def _fiedler_split(adj: np.ndarray) -> Optional[np.ndarray]:
    """Spectral bisection: sign of the Fiedler vector; None if degenerate."""
    deg = adj.sum(axis=1)
    if (deg == 0).any():
        deg = np.maximum(deg, 1e-9)
    d_isqrt = 1.0 / np.sqrt(deg)
    lap = np.eye(len(adj)) - d_isqrt[:, None] * adj * d_isqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    if len(vals) < 2 or vals[1] > 0.98:  # essentially disconnected or rigid
        return None
    fiedler = vecs[:, 1]
    mask = fiedler >= np.median(fiedler)
    if mask.all() or (~mask).all():
        return None
    return mask


def _cut_quality(adj: np.ndarray, mask: np.ndarray) -> float:
    """Fraction of contacts crossing the cut (lower = better split)."""
    cross = adj[mask][:, ~mask].sum()
    total = adj.sum() / 2
    return float(cross / max(total, 1e-9))


def _smooth_labels(labels: np.ndarray, window: int = 7) -> np.ndarray:
    """Sequence-contiguity smoothing: majority vote in a sliding window."""
    out = labels.copy()
    half = window // 2
    n = len(labels)
    for i in range(n):
        lo, hi = max(0, i - half), min(n, i + half + 1)
        vals, counts = np.unique(labels[lo:hi], return_counts=True)
        out[i] = vals[np.argmax(counts)]
    return out


def segment_domains(
    ca: np.ndarray,
    min_domain_size: int = MIN_DOMAIN_SIZE,
    max_cut_fraction: float = 0.075,
    max_depth: int = 4,
) -> np.ndarray:
    """(N,3) CA coords -> (N,) domain ids (0..K-1).

    Recursive spectral bisection of the contact graph; a split is accepted
    only when both halves meet the size floor and the cut severs a small
    fraction of contacts (domains are contact-dense, inter-domain contact
    is sparse).
    """
    n = len(ca)
    labels = np.zeros(n, np.int64)
    if n < 2 * min_domain_size:
        return labels
    adj = _contact_matrix(ca)
    next_id = [1]

    def recurse(idx: np.ndarray, depth: int):
        if depth >= max_depth or len(idx) < 2 * min_domain_size:
            return
        sub = adj[np.ix_(idx, idx)]
        mask = _fiedler_split(sub)
        if mask is None:
            return
        if mask.sum() < min_domain_size or (~mask).sum() < min_domain_size:
            return
        if _cut_quality(sub, mask) > max_cut_fraction:
            return
        new_id = next_id[0]
        next_id[0] += 1
        labels[idx[mask]] = new_id
        recurse(idx[mask], depth + 1)
        recurse(idx[~mask], depth + 1)

    recurse(np.arange(n), 0)
    labels = _smooth_labels(labels)
    labels = clean_small_domains(labels, min_domain_size)
    # renumber consecutively
    _, labels = np.unique(labels, return_inverse=True)
    return labels


def clean_small_domains(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Merge domains below the size floor into their most-contacted
    sequence neighbor (merizo's clean_domains equivalent)."""
    labels = labels.copy()
    while True:
        vals, counts = np.unique(labels, return_counts=True)
        small = vals[counts < min_size]
        if len(small) == 0 or len(vals) == 1:
            break
        for s in small:
            idx = np.where(labels == s)[0]
            lo, hi = idx.min(), idx.max()
            neighbor = None
            if lo > 0:
                neighbor = labels[lo - 1]
            elif hi + 1 < len(labels):
                neighbor = labels[hi + 1]
            if neighbor is None or neighbor == s:
                others = [v for v in vals if v != s]
                if not others:
                    return labels
                neighbor = others[0]
            labels[idx] = neighbor
        if np.array_equal(vals, np.unique(labels)):
            break
    return labels


def segment_chain_pdb(atoms: np.ndarray, min_domain_size: int = MIN_DOMAIN_SIZE,
                      params=None, device=None) -> np.ndarray:
    """Structured atom array (one chain) -> per-CA domain ids: the learned
    ``DomainSegmenter`` when ``params`` (a module or its state dict) is
    given, on ``device`` (None: the card), else the geometric segmenter."""
    from ..io import pdb as pdb_io

    ca = pdb_io.select(atoms, name="CA", standard_aa=True)
    coords = pdb_io.coords(ca).astype(np.float64)
    if params is not None:
        return segment_with_model(coords, ca["res_name"], params, min_domain_size,
                                  device=device)
    return segment_domains(coords, min_domain_size)


# ===========================================================================
# learned segmenter
# ===========================================================================

def _pseudo_frames(ca: np.ndarray) -> np.ndarray:
    """Per-residue orthonormal frames from consecutive CA geometry."""
    n = len(ca)
    frames = np.tile(np.eye(3), (n, 1, 1))
    for i in range(n):
        a = ca[min(i + 1, n - 1)] - ca[i] if i + 1 < n else ca[i] - ca[i - 1]
        b = ca[i] - ca[i - 1] if i > 0 else a
        e1 = a / max(np.linalg.norm(a), 1e-6)
        c = np.cross(e1, b)
        if np.linalg.norm(c) < 1e-6:
            c = np.cross(e1, [1.0, 0.0, 0.0])
        if np.linalg.norm(c) < 1e-6:
            c = np.cross(e1, [0.0, 1.0, 0.0])
        e2 = c / np.linalg.norm(c)
        e3 = np.cross(e1, e2)
        frames[i] = np.stack([e1, e2, e3], axis=0)
    return frames


class IPABlock(nn.Module):
    """Invariant-point-attention-style block: query/key dot products, a
    pair-distance bias and squared distances between learned query/key
    points in the global frame, then an MLP transition.  LayerNorms at
    flax's default eps 1e-6."""

    def __init__(self, dim: int = 128, z_dim: int = 32, heads: int = 8, points: int = 4):
        super().__init__()
        self.heads, self.points = heads, points
        hp3 = heads * points * 3
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.q_points = nn.Linear(dim, hp3)
        self.k_points = nn.Linear(dim, hp3)
        self.pair_bias = nn.Linear(z_dim, heads)
        self.gamma = nn.Parameter(torch.zeros(heads))
        self.out = nn.Linear(dim + hp3, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.ff1 = nn.Linear(dim, 2 * dim)
        self.ff2 = nn.Linear(2 * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, s, z, frames, coords):
        n, dim = s.shape
        h, p = self.heads, self.points
        d = dim // h
        q = self.q(s).reshape(n, h, d)
        k = self.k(s).reshape(n, h, d)
        v = self.v(s).reshape(n, h, d)
        qp = self.q_points(s).reshape(n, h, p, 3)
        kp = self.k_points(s).reshape(n, h, p, 3)
        qp_g = torch.einsum("nij,nhpi->nhpj", frames, qp) + coords[:, None, None, :]
        kp_g = torch.einsum("nij,nhpi->nhpj", frames, kp) + coords[:, None, None, :]

        logits = torch.einsum("nhd,mhd->hnm", q, k) / np.sqrt(d)
        logits = logits + self.pair_bias(z).permute(2, 0, 1)
        d2 = torch.sum((qp_g[:, None] - kp_g[None, :]) ** 2, dim=(-1, -2))  # (n, m, h)
        logits = logits - F.softplus(self.gamma)[:, None, None] * d2.permute(2, 0, 1) / (2 * p)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("hnm,mhd->nhd", w, v).reshape(n, dim)
        out_p = torch.einsum("hnm,mhpj->nhpj", w, kp_g)
        out_p_local = torch.einsum("nij,nhpj->nhpi", frames,
                                   out_p - coords[:, None, None, :]).reshape(n, h * p * 3)
        s = self.norm1(s + self.out(torch.cat([out, out_p_local], dim=-1)))
        return self.norm2(s + self.ff2(F.relu(self.ff1(s))))


class DomainSegmenter(nn.Module):
    """IPA encoder + query-based domain mask decoder: returns (logits (n,
    n_domains), confidence (n,))."""

    def __init__(self, dim: int = 128, z_dim: int = 32, blocks: int = 4, n_domains: int = 20):
        super().__init__()
        self.z_dim = z_dim
        self.embed_s = nn.Linear(20, dim)
        self.embed_z = nn.Linear(z_dim, z_dim)
        self.blocks = nn.ModuleList([IPABlock(dim, z_dim) for _ in range(blocks)])
        self.domain_queries = nn.Parameter(0.02 * torch.randn(n_domains, dim))
        self.logit_scale = nn.Parameter(torch.ones(()))
        self.confidence = nn.Linear(dim, 1)

    def forward(self, aa_onehot, dist_map, frames, coords):
        s = self.embed_s(aa_onehot)
        centers = torch.linspace(2.0, 22.0, self.z_dim, device=dist_map.device)
        z = self.embed_z(torch.exp(-((dist_map[..., None] - centers) ** 2) / 4.0))
        for block in self.blocks:
            s = block(s, z, frames, coords)
        sn = s / (torch.linalg.norm(s, dim=-1, keepdim=True) + 1e-6)
        qn = self.domain_queries / (
            torch.linalg.norm(self.domain_queries, dim=-1, keepdim=True) + 1e-6)
        logits = sn @ qn.T * self.logit_scale * 10.0
        return logits, torch.sigmoid(self.confidence(s)[:, 0])


def model_inputs(ca: np.ndarray, res_names) -> tuple:
    """CA coords and residue names -> (onehot (n, 20), distances (n, n),
    frames (n, 3, 3), coords (n, 3)), f32 numpy."""
    from ..io.pdb import AA_INDEX

    n = len(ca)
    onehot = np.zeros((n, 20), np.float32)
    for i, rn in enumerate(res_names):
        ix = AA_INDEX.get(str(rn), -1)
        if ix >= 0:
            onehot[i, ix] = 1.0
    dist = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1).astype(np.float32)
    return onehot, dist, _pseudo_frames(ca).astype(np.float32), np.asarray(ca, np.float32)


@torch.no_grad()
def segment_with_model(ca: np.ndarray, res_names, params,
                       min_domain_size: int = MIN_DOMAIN_SIZE, device=None) -> np.ndarray:
    """The learned segmenter's domain ids (0..K-1) for (n, 3) CA coords:
    ``params`` is a ``DomainSegmenter`` or its state dict (default widths),
    run on ``device`` (None: the card; raises where there is none) in f32
    with TF32 off.  A failure raises; nothing falls back."""
    dev = resolve_device(device)
    if isinstance(params, Mapping):
        model = DomainSegmenter()
        model.load_state_dict(params, strict=True)
    else:
        model = params
    model = model.to(dev).eval()
    with exact_f32(torch.float32):
        logits, _ = model(*(torch.from_numpy(a).to(dev) for a in model_inputs(ca, res_names)))
        labels = torch.argmax(logits, dim=-1).cpu().numpy()
    labels = _smooth_labels(labels)
    labels = clean_small_domains(labels, min_domain_size)
    _, labels = np.unique(labels, return_inverse=True)
    return labels
