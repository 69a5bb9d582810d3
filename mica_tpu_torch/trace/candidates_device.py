"""CA candidate extraction on the volumes' own device, in torch ops.

Counterpart of ``mica_tpu/trace/candidates_device.py``.  The host pipeline
(``candidates.py``) needs the full carbon-alpha and backbone probability
volumes on the host before the trace stage can start.  This module runs

  threshold -> ball-dilation single-linkage clustering -> cluster filter
  -> greedy NMS -> 3-cube neighborhood gathers

on the device that holds the volumes (the card, after
``predict_volume(..., keep_on_device=True)``); only O(candidates) values
reach the host, where the sub-voxel centroid is computed in float64 with
the arithmetic of ``candidates.refine_candidates``.

Semantics match the host pipeline with ``cluster_method='morphology'``
(single linkage at ``eps`` via radius-eps/2 ball dilation + 26-connected
components), in candidate order too.  There is no Pallas kernel in the
reference module and none here: the dilation is a library conv, the rest
are elementwise ops, gathers and sorts.

What differs inside, because torch needs no static shapes: the points above
the threshold are compacted with ``nonzero`` (ascending flat index, so
``argmax``-style ties resolve as the reference's do), and the greedy NMS
runs as parallel rounds over each point's table of neighbours within the
radius: a point is kept when no live neighbour outranks it, and everything
within the radius of a kept point retires.  That is the greedy result
exactly, with one host read per round (tens of rounds) instead of one per
kept candidate.  ``POINT_CAPS`` and ``NMS_CAPS`` keep their meaning as
limits: above the last entry of either, ``None`` sends the caller to the
host path, as in the reference.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

logger = logging.getLogger(__name__)

POINT_CAPS = (4096, 16384, 65536, 262144, 1048576)
NMS_CAPS = (2048, 8192, 32768)
_INF = torch.iinfo(torch.int64).max


def _ball_kernel(r: int) -> np.ndarray:
    zz, yy, xx = np.ogrid[-r:r + 1, -r:r + 1, -r:r + 1]
    return ((zz * zz + yy * yy + xx * xx) <= r * r).astype(np.float32)


def _min3(lbl: torch.Tensor, dim: int) -> torch.Tensor:
    """Running min over a window of 3 along ``dim`` (edges see 2 values).
    Exact on int64 labels, which a pooling op would not take."""
    n = lbl.shape[dim]
    out = lbl.clone()
    if n > 1:
        lo, hi = out.narrow(dim, 0, n - 1), out.narrow(dim, 1, n - 1)
        lo.copy_(torch.minimum(lo, lbl.narrow(dim, 1, n - 1)))
        hi.copy_(torch.minimum(hi, lbl.narrow(dim, 0, n - 1)))
    return out


def _components(dil: torch.Tensor):
    """26-connected components of a boolean volume by min-label relaxation:
    labels start as the voxel's flat index; each round takes the 3x3x3 min
    (separable) and pointer-jumps (lbl = lbl[lbl]), which doubles the
    propagation distance, so O(log diameter) rounds.  One boolean is read
    on the host per round.  Returns (labels, rounds); background is _INF."""
    n_vox = dil.numel()
    flat_ix = torch.arange(n_vox, device=dil.device).reshape(dil.shape)
    inf = torch.full_like(flat_ix, _INF)
    lbl = torch.where(dil, flat_ix, inf)

    def step(lbl):
        m = _min3(_min3(_min3(lbl, 0), 1), 2)
        f = torch.where(dil, m, inf).reshape(-1)
        f = torch.where(f == _INF, f, f[f.clamp(max=n_vox - 1)])
        return f.reshape(dil.shape)

    rounds = 0
    while True:
        new = step(lbl)
        rounds += 1
        if torch.equal(new, lbl):
            return lbl, rounds
        lbl = new


def _nms_offsets(radius_sq: float):
    """Nonzero integer offsets within the radius, as (dx, dy, dz) tuples."""
    r = int(np.floor(np.sqrt(radius_sq)))
    g = np.arange(-r, r + 1)
    offs = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    d2 = (offs ** 2).sum(1)
    return [tuple(int(v) for v in o) for o in offs[(d2 <= radius_sq) & (d2 > 0)]]


def _greedy_nms(pts: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor, shape,
                radius_sq: float):
    """Greedy NMS by descending score over integer points (K, 3) with flat
    indices ``flat`` (ascending) and scores ``vals``; equal scores rank by
    ascending flat index, as a first-max ``argmax`` would pick them.
    Returns (indices into the K points in pick order, rounds)."""
    dev = pts.device
    k = len(pts)
    order = torch.sort(vals, descending=True, stable=True).indices
    rank = torch.empty(k, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(k, device=dev)
    # each point's neighbours within the radius, as point ids (-1: none)
    ident = torch.full((int(np.prod(shape)),), -1, dtype=torch.int64, device=dev)
    ident[flat] = torch.arange(k, device=dev)
    # one column per offset, so the (K, 3) neighbour coordinates never
    # exist for all offsets at once
    lim = torch.tensor(shape, device=dev)
    offs = _nms_offsets(radius_sq)
    nb = torch.empty((k, len(offs)), dtype=torch.int64, device=dev)
    for o, off in enumerate(offs):
        q = pts + torch.tensor(off, device=dev)
        ok = ((q >= 0) & (q < lim)).all(-1)
        qf = flat + int((off[0] * shape[1] + off[1]) * shape[2] + off[2])
        nb[:, o] = torch.where(ok, ident[qf.clamp(0, ident.numel() - 1)], -1)
    has = nb >= 0
    nb = nb.clamp(min=0)
    outranks = has & (rank[nb] < rank[:, None])

    active = torch.ones(k, dtype=torch.bool, device=dev)
    kept = torch.zeros(k, dtype=torch.bool, device=dev)
    rounds = 0
    while bool(active.any()):
        rounds += 1
        keep_now = active & ~(outranks & active[nb]).any(1)
        kept |= keep_now
        retired = (has & keep_now[nb]).any(1)
        active &= ~(keep_now | retired)
    picked = torch.nonzero(kept).reshape(-1)
    return picked[torch.argsort(rank[picked])], rounds


def extract_candidates_device(
    ca_prob,
    bb_prob,
    aa_prob,
    aa_pred=None,
    ca_score_threshold: float = 0.3,
    cluster_eps: float = 10.0,
    nms_radius_sq: float = 9.0,
    stats: Optional[dict] = None,
) -> Optional[dict]:
    """Candidate extraction from volumes resident on a device.

    ``ca_prob``, ``bb_prob`` (X, Y, Z) and ``aa_prob`` (20, X, Y, Z) are
    tensors (the engine's ``keep_on_device`` layout) or arrays; the work
    runs where ``ca_prob`` lies.  Returns ``{"coords", "aa", "pred"}``
    matching ``candidates.extract_candidates(...,
    cluster_method='morphology')`` (the float64 centroid runs on the host
    over gathered f32 values), or ``None`` when the point or NMS caps
    cannot hold the map or ``nms_radius_sq`` is not the default 9.0, as the
    reference does (the caller falls back to the host path).  ``stats``,
    when given, receives the counts, rounds and seconds of the stages.
    """
    if nms_radius_sq != 9.0:
        return None
    stats = {} if stats is None else stats
    ca = torch.as_tensor(ca_prob)
    dev = ca.device
    bb = torch.as_tensor(bb_prob).to(dev)
    aa = torch.as_tensor(aa_prob).to(dev)
    shape = tuple(int(s) for s in ca.shape)
    thr = float(np.float32(ca_score_threshold))

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.time()

    t0 = clock()
    mask = ca > thr
    n_above = int(mask.sum())
    stats["n_above"] = n_above
    if n_above > POINT_CAPS[-1]:
        logger.info("device extraction: %d points exceed the %d cap",
                    n_above, POINT_CAPS[-1])
        return None
    empty = {"coords": np.zeros((0, 3)), "aa": np.zeros((20, 0)),
             "pred": np.zeros((0,), np.int64)}
    if n_above == 0:
        stats.update(n_candidates=0, cc_rounds=0, nms_rounds=0)
        return empty

    # ball dilation (radius eps/2 -> single linkage at eps), then components
    r = int(np.floor(cluster_eps / 2))
    ball = torch.from_numpy(_ball_kernel(r)).to(dev)[None, None]
    dil = F.conv3d(mask[None, None].float(), ball, padding=r)[0, 0] > 0.5
    lbl, cc_rounds = _components(dil)
    t1 = clock()

    flat = torch.nonzero(mask.reshape(-1)).reshape(-1)      # ascending flat index
    vals = ca.reshape(-1)[flat]
    # per-cluster backbone filter (candidates.filter_clusters)
    _, cid = torch.unique(lbl.reshape(-1)[flat], return_inverse=True)
    n_cl = int(cid.max()) + 1
    sums = torch.zeros(n_cl, dtype=torch.float64, device=dev).index_add_(
        0, cid, bb.reshape(-1)[flat].double())
    counts = torch.zeros(n_cl, dtype=torch.float64, device=dev).index_add_(
        0, cid, torch.ones_like(sums[cid]))
    means = torch.where(sums > sums.max() / 10, sums / counts, torch.zeros_like(sums))
    keep = (means > means.max() / 2)[cid]
    flat, vals = flat[keep], vals[keep]
    pts = torch.stack([flat // (shape[1] * shape[2]), (flat // shape[2]) % shape[1],
                       flat % shape[2]], dim=-1)
    t2 = clock()

    picked, nms_rounds = _greedy_nms(pts, flat, vals, shape, nms_radius_sq)
    t3 = clock()
    stats.update(cc_rounds=cc_rounds, nms_rounds=nms_rounds, n_kept_points=int(len(flat)),
                 n_nms=int(len(picked)), cluster_s=t1 - t0, filter_s=t2 - t1, nms_s=t3 - t2)
    if len(picked) > NMS_CAPS[-1]:
        logger.info("device extraction: NMS cap %d overflowed", NMS_CAPS[-1])
        return None

    # 3-cube neighborhood gathers for the sub-voxel refinement
    vox_t = pts[picked]
    lim = torch.tensor(shape, device=dev)
    inner = ((vox_t >= 1) & (vox_t <= lim - 2)).all(1)
    # boundary candidates dropped like the host path
    vox_t = vox_t[inner]
    offs = np.array(
        [[di, dj, dk] for di in (-1, 0, 1) for dj in (-1, 0, 1)
         for dk in (-1, 0, 1)]
    )
    nt = vox_t[:, None, :] + torch.from_numpy(offs).to(dev)[None]       # (M, 27, 3)
    ix = (nt[..., 0], nt[..., 1], nt[..., 2])
    vox = vox_t.cpu().numpy()
    # keep f32 — the host path normalizes the weights and aggregates the
    # AA probabilities in float32 (refine_candidates); matching dtypes
    # makes the centroids identical
    ca_n = ca[ix].cpu().numpy()                                          # (M, 27)
    aa_n = aa[(slice(None),) + ix].permute(1, 2, 0).contiguous().cpu().numpy()  # (M, 27, 20)
    stats.update(n_candidates=int(len(vox)), gather_s=clock() - t3)
    logger.info("device extraction: %d above thr, %d NMS candidates "
                "(%d cc rounds, %d NMS rounds)", n_above, len(picked), cc_rounds, nms_rounds)
    if len(vox) == 0:
        return empty

    # identical arithmetic to candidates.refine_candidates: f32 weight
    # normalization, f64 position einsum, f32 AA aggregation
    neigh = vox[:, None, :] + offs[None, :, :]
    w = ca_n / ca_n.sum(axis=1, keepdims=True)
    coords = np.einsum("nk,nkd->nd", w, neigh.astype(np.float64))
    aa_out = np.einsum("nk,nkc->cn", w, aa_n)

    # aa_pred at the rounded refined position: always inside the gathered
    # 3-cube (|centroid - voxel| < 1 by construction), so the argmax over
    # the matching neighbor's channel vector equals the host's
    # aa_pred-volume gather
    rounded = np.clip(np.rint(coords).astype(np.int64), 0,
                      np.asarray(shape) - 1)
    off = rounded - vox + 1
    flat_off = off[:, 0] * 9 + off[:, 1] * 3 + off[:, 2]
    pred = np.argmax(aa_n[np.arange(len(vox)), flat_off], axis=-1)
    return {"coords": coords, "aa": aa_out, "pred": pred}
