"""Rigid superposition (Kabsch) — single and batched.

Replaces the reference's per-call ``superpose3d.Superpose3D`` (used from
fork-pool workers in modeler.py:163,202,262; hot path of register scoring
and local alignment).  Convention matches the reference usage:

    rmsd, R, T = superpose(target, mobile)
    mobile_aligned = mobile @ R.T + T   # least-squares fit onto target

The batched variant stacks many small 3x3 SVDs, fast in numpy on the host
for the small batches the aligners pass.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def superpose(target: np.ndarray, mobile: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares rigid fit of ``mobile`` onto ``target`` ((N,3) each).

    Returns (rmsd, R(3,3), T(3,)) with ``aligned = mobile @ R.T + T``.
    """
    target = np.asarray(target, np.float64)
    mobile = np.asarray(mobile, np.float64)
    if target.shape != mobile.shape or target.ndim != 2 or target.shape[1] != 3:
        raise ValueError(f"shape mismatch: {target.shape} vs {mobile.shape}")
    n = len(target)
    if n == 0:
        return 0.0, np.eye(3), np.zeros(3)
    tc = target.mean(axis=0)
    mc = mobile.mean(axis=0)
    t0 = target - tc
    m0 = mobile - mc
    h = m0.T @ t0
    u, s, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    diag = np.diag([1.0, 1.0, d])
    r = vt.T @ diag @ u.T
    t = tc - r @ mc
    aligned = m0 @ r.T + tc
    rmsd = float(np.sqrt(np.mean(np.sum((aligned - target) ** 2, axis=1))))
    return rmsd, r, t


def superpose_batch(targets: np.ndarray, mobiles: np.ndarray):
    """Batched rigid fit: (B,N,3) x (B,N,3) -> (rmsd(B,), R(B,3,3), T(B,3))."""
    targets = np.asarray(targets, np.float64)
    mobiles = np.asarray(mobiles, np.float64)
    tc = targets.mean(axis=1, keepdims=True)
    mc = mobiles.mean(axis=1, keepdims=True)
    t0 = targets - tc
    m0 = mobiles - mc
    h = np.einsum("bni,bnj->bij", m0, t0)
    u, s, vt = np.linalg.svd(h)
    det = np.linalg.det(np.einsum("bij,bkj->bik", vt.transpose(0, 2, 1), u))
    diag = np.repeat(np.eye(3)[None], len(targets), axis=0)
    diag[:, 2, 2] = np.sign(det)
    r = np.einsum("bji,bjk,blk->bil", vt, diag, u)
    t = tc[:, 0] - np.einsum("bij,bj->bi", r, mc[:, 0])
    aligned = np.einsum("bni,bji->bnj", m0, r) + tc
    rmsd = np.sqrt(np.mean(np.sum((aligned - targets) ** 2, axis=2), axis=1))
    return rmsd, r, t


def rmsd_batch(targets: np.ndarray, mobiles: np.ndarray) -> np.ndarray:
    """Batched superposition RMSD only (no rotations returned).

    Uses the eigenvalue form instead of a full SVD: with H the 3x3 cross
    covariance, the optimal superposition residual is

        N * rmsd^2 = tr(T0^T T0) + tr(M0^T M0)
                     - 2 (s1 + s2 + sign(det H) * s3)

    where s_i = sqrt(eig_i(H^T H)) sorted descending — a batched symmetric
    3x3 eigenvalue problem, far cheaper than SVD for the millions of small
    fits in struct scoring (af3_align.struct_scoring).
    """
    targets = np.asarray(targets, np.float64)
    mobiles = np.asarray(mobiles, np.float64)
    n = targets.shape[1]
    t0 = targets - targets.mean(axis=1, keepdims=True)
    m0 = mobiles - mobiles.mean(axis=1, keepdims=True)
    h = np.einsum("bni,bnj->bij", m0, t0)
    e2 = np.sum(t0 * t0, axis=(1, 2)) + np.sum(m0 * m0, axis=(1, 2))
    hth = np.einsum("bij,bik->bjk", h, h)
    lam = np.linalg.eigvalsh(hth)  # ascending
    sig = np.sqrt(np.maximum(lam, 0.0))
    det = np.linalg.det(h)
    s = sig[:, 2] + sig[:, 1] + np.sign(det) * sig[:, 0]
    msd = np.maximum(e2 - 2.0 * s, 0.0) / n
    return np.sqrt(msd)
