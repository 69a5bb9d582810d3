"""Merizo, the learned domain-segmentation network, in PyTorch.

Port of ``mica_tpu/models/merizo.py``: an invariant-point-attention encoder
(6 weight-shared iterations of one IPA module and a bidirectional-GRU
transition) followed by a mask-transformer decoder (10 blocks with a
symmetric ALiBi bias, learned class embeddings, cosine patch-class masks,
a GRU background head and a GRU confidence head).

The parameter names are the original torch network's, the keys the JAX
package's ``torch_state_dict_to_params`` reads, so the original split
``weights_part_*.pt`` shards load with a strict ``load_state_dict``
(``load_weights``).  The network runs in f32 with TF32 off (``exact_f32``)
on any device; it calls no hand-written kernel, as the JAX package's
Merizo reaches no Pallas kernel.

Quirks kept on purpose (trained weights expect them):
  * rotary embeddings rotate over the HEADS axis of the (N, H, C) q/k
    tensors: a fixed per-head rotation; interleaved pairing, theta 10000;
  * the q/k/v point projections split into x / y / z thirds;
  * the decoder applies no 1/sqrt(d) to its attention logits;
  * the domain-id cleanup runs on the host (``postprocess_masks``).
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from .mica import exact_f32

N_CLASSES = 20
C_S = 512
C_Z = 32
NO_HEADS = 16
NO_QK_POINTS = 4
NO_V_POINTS = 8
NO_BLOCKS = 6
DECODER_LAYERS = 10
INF = 1e5
EPS = 1e-8

MIN_DOMAIN_SIZE = 50
MIN_FRAGMENT_SIZE = 10
DOM_AVE = 200

# forwards of the network by device type ("cuda" / "cpu"), as the kernel
# wrappers count their launches
forwards = {"cuda": 0, "cpu": 0}


# ===========================================================================
# the network
# ===========================================================================

def rotary_rotate_heads(t: torch.Tensor, rot_dim: int, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over axis -2 of an (N, H, C) tensor, i.e. over the
    heads; interleaved pairing; only the first ``rot_dim`` channels rotate."""
    n, h, _ = t.shape
    inv_freq = 1.0 / (theta ** (np.arange(0, rot_dim, 2) / rot_dim))
    freqs = np.repeat(np.einsum("i,j->ij", np.arange(h), inv_freq), 2, axis=-1)
    cos = torch.as_tensor(np.cos(freqs), dtype=t.dtype, device=t.device)[None]
    sin = torch.as_tensor(np.sin(freqs), dtype=t.dtype, device=t.device)[None]
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    x = t_rot.reshape(n, h, rot_dim // 2, 2)
    rot_half = torch.stack([-x[..., 1], x[..., 0]], dim=-1).reshape(n, h, rot_dim)
    return torch.cat([t_rot * cos + rot_half * sin, t_pass], dim=-1)


def bidirectional_gru(input_size: int, hidden_size: int) -> nn.GRU:
    """Two-layer bidirectional GRU; run on an unbatched (L, In) sequence it
    returns ((L, 2H), h_n (4, H)), the original's layout."""
    return nn.GRU(input_size, hidden_size, num_layers=2, bidirectional=True)


class IPA(nn.Module):
    """Invariant point attention over one chain, batch-free (N, ...)."""

    def __init__(self):
        super().__init__()
        h, c, pq, pv = NO_HEADS, C_S, NO_QK_POINTS, NO_V_POINTS
        self.linear_q = nn.Linear(C_S, h * c)
        self.linear_kv = nn.Linear(C_S, 2 * h * c)
        self.linear_q_points = nn.Linear(C_S, h * pq * 3)
        self.linear_kv_points = nn.Linear(C_S, h * (pq + pv) * 3)
        self.linear_b = nn.Linear(C_Z, h)
        self.head_weights = nn.Parameter(torch.zeros(h))
        self.hidden_out = nn.Linear(h * c, C_S)
        self.pair_out = nn.Linear(h * C_Z, C_S)
        self.points_out = nn.Linear(h * pv * 3, C_S)
        self.points_norm_out = nn.Linear(h * pv, C_S)

    def forward(self, s, z, rot, trans, mask):
        n = s.shape[0]
        h, c, pq, pv = NO_HEADS, C_S, NO_QK_POINTS, NO_V_POINTS
        q = self.linear_q(s).reshape(n, h, c)
        kv = self.linear_kv(s).reshape(n, h, 2 * c)
        k, v = kv[..., :c], kv[..., c:]

        def points(lin_out, count):
            p = torch.stack(torch.chunk(lin_out, 3, dim=-1), dim=-1)  # x / y / z thirds
            p = torch.einsum("nij,npj->npi", rot, p) + trans[:, None, :]
            return p.reshape(n, h, count, 3)

        q_pts = points(self.linear_q_points(s), pq)
        kv_pts = points(self.linear_kv_points(s), pq + pv)
        k_pts, v_pts = kv_pts[:, :, :pq], kv_pts[:, :, pq:]

        q = rotary_rotate_heads(q, c // 2)
        k = rotary_rotate_heads(k, c // 2)

        a = torch.einsum("nhc,mhc->hnm", q, k) * math.sqrt(1.0 / (3 * c))
        a = a + math.sqrt(1.0 / 3) * self.linear_b(z).permute(2, 0, 1)
        hw = F.softplus(self.head_weights) * math.sqrt(1.0 / (3 * (pq * 9.0 / 2)))
        d2 = torch.sum((q_pts[:, None] - k_pts[None, :]) ** 2, dim=-1)  # (n, m, h, pq)
        pt_att = torch.sum(d2 * hw[None, None, :, None], dim=-1) * (-0.5)
        a = a + pt_att.permute(2, 0, 1)
        square_mask = INF * (mask[:, None] * mask[None, :] - 1.0)
        a = torch.softmax(a + square_mask[None], dim=-1)  # (h, n, m)

        s_out = self.hidden_out(torch.einsum("hnm,mhc->nhc", a, v).reshape(n, h * c))
        s_out = s_out + self.pair_out(torch.einsum("hnm,nmz->nhz", a, z).reshape(n, h * C_Z))
        o_pt = torch.einsum("hnm,mhpj->nhpj", a, v_pts)
        o_pt = torch.einsum("nji,nhpj->nhpi", rot, o_pt - trans[:, None, None, :])
        o_pt_norm = torch.sqrt(torch.sum(o_pt ** 2, dim=-1) + EPS).reshape(n, h * pv)
        flat = o_pt.reshape(n, h * pv, 3)
        o_pt_cat = torch.cat([flat[..., 0], flat[..., 1], flat[..., 2]], dim=-1)  # all x, y, z
        s_out = s_out + self.points_out(o_pt_cat)
        return s_out + self.points_norm_out(o_pt_norm)


class Transition(nn.Module):
    """The encoder's GRU transition (``layers.0``) and its LayerNorm."""

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList([bidirectional_gru(C_S, C_S // 2)])
        self.layer_norm = nn.LayerNorm(C_S, eps=1e-5)

    def forward(self, s):
        return self.layer_norm(self.layers[0](s)[0])


class IPABlock(nn.Module):
    """The encoder: ``NO_BLOCKS`` iterations of one IPA and one transition."""

    def __init__(self):
        super().__init__()
        self.layer_norm_s = nn.LayerNorm(C_S, eps=1e-5)
        self.linear_in = nn.Linear(C_S, C_S)
        self.layer_norm_z = nn.LayerNorm(C_Z, eps=1e-5)
        self.ipa = IPA()
        self.layer_norm_ipa = nn.LayerNorm(C_S, eps=1e-5)
        self.transition = Transition()

    def forward(self, s, z, rot, trans, mask):
        s = self.linear_in(self.layer_norm_s(s))
        z = self.layer_norm_z(z)
        for _ in range(NO_BLOCKS):  # the same weights every iteration
            s = self.layer_norm_ipa(s + self.ipa(s, z, rot, trans, mask))
            s = self.transition(s)
        return s


class Attention(nn.Module):
    def __init__(self, d_model: int = C_S):
        super().__init__()
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)


class FeedForward(nn.Module):
    def __init__(self, d_model: int = C_S, d_ff: int = C_S):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_ff)
        self.fc2 = nn.Linear(d_ff, d_model)


class DecoderBlock(nn.Module):
    """Pre-LN multi-head attention (no 1/sqrt(d) on the logits) + exact-GELU FF."""

    def __init__(self, heads: int = NO_HEADS, d_model: int = C_S):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.attn = Attention(d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.mlp = FeedForward(d_model)

    def forward(self, x, bias):
        n, d = x.shape
        h = self.heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(n, 3, h, d // h)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        attn = torch.softmax(torch.einsum("nhd,mhd->hnm", q, k) + bias, dim=-1)
        x = x + self.attn.proj(torch.einsum("hnm,mhd->nhd", attn, v).reshape(n, d))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


def alibi_slopes(heads: int) -> np.ndarray:
    """Symmetric ALiBi slopes."""

    def pow2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(heads).is_integer():
        return np.asarray(pow2(heads))
    closest = 2 ** math.floor(math.log2(heads))
    return np.asarray(pow2(closest) + pow2(2 * closest)[0::2][: heads - closest])


def alibi_bias(res_index: torch.Tensor, heads: int = NO_HEADS, clip: int = 32,
               slope_factor: float = 1.0) -> torch.Tensor:
    """(h, n, n) symmetric ALiBi bias from (n,) residue indices."""
    rel = torch.clamp(torch.abs(res_index[None, :] - res_index[:, None]), max=clip)
    slopes = torch.as_tensor(alibi_slopes(heads), dtype=rel.dtype, device=rel.device)
    return -(rel[None] * slopes[:, None, None] * slope_factor)


class MaskDecoder(nn.Module):
    """The mask transformer minus the host cleanup.  ``forward`` returns
    (mask logits (n, 20), bg logits (n, 2), features (n, 512)); the
    per-domain confidence GRU (``conf_gru``, ``conf_out``) runs in
    ``confidence``."""

    def __init__(self):
        super().__init__()
        self.cls_emb = nn.Parameter(torch.randn(1, N_CLASSES, C_S))
        self.blocks = nn.ModuleList([DecoderBlock() for _ in range(DECODER_LAYERS)])
        self.decoder_norm = nn.LayerNorm(C_S, eps=1e-5)
        self.proj_patch = nn.Parameter(torch.randn(C_S, C_S))
        self.proj_classes = nn.Parameter(torch.randn(C_S, C_S))
        self.class_norm = nn.LayerNorm(N_CLASSES, eps=1e-5)
        self.bg_gru = bidirectional_gru(C_S, C_S // 2)
        self.bg_out = nn.Linear(C_S, 2)
        self.conf_gru = bidirectional_gru(N_CLASSES, C_S)
        self.conf_out = nn.Linear(C_S, 1)

    def forward(self, s, bias):
        n = s.shape[0]
        x = torch.cat([s, self.cls_emb[0].to(s.dtype)], dim=0)
        bias = F.pad(bias, (0, N_CLASSES, 0, N_CLASSES))
        for block in self.blocks:
            x = block(x, bias)
        x = self.decoder_norm(x)
        features = x[:n] @ self.proj_patch
        classes = x[n:] @ self.proj_classes
        features = features / torch.linalg.norm(features, dim=-1, keepdim=True)
        classes = classes / torch.linalg.norm(classes, dim=-1, keepdim=True)
        masks = self.class_norm(features @ classes.T)
        bg = self.bg_out(self.bg_gru(features)[0])
        return masks, bg, features

    def confidence(self, dom_masks: torch.Tensor) -> torch.Tensor:
        """One domain's (n_d, 20) mask logits -> its confidence, a scalar:
        the GRU runs along the domain's residues and the last layer's
        reverse-direction final state goes through ``conf_out``."""
        _, h_n = self.conf_gru(dom_masks)
        return torch.clamp(self.conf_out(h_n[-1])[0], 0.0, 1.0)


class Merizo(nn.Module):
    """Embeddings -> IPA encoder -> mask decoder."""

    def __init__(self):
        super().__init__()
        self.linear_s_in = nn.Linear(N_CLASSES, C_S, bias=False)
        self.linear_z_in = nn.Linear(1, C_Z, bias=False)
        self.ipa = IPABlock()
        self.decoder_head = MaskDecoder()

    def forward(self, s_onehot, z_dist, rot, trans, res_index,
                mask: Optional[torch.Tensor] = None):
        if mask is None:
            mask = torch.ones(s_onehot.shape[0], dtype=s_onehot.dtype, device=s_onehot.device)
        s = self.linear_s_in(s_onehot)
        z = self.linear_z_in(z_dist[..., None])
        s = self.ipa(s, z, rot, trans, mask)
        return self.decoder_head(s, alibi_bias(res_index))


# ===========================================================================
# host-side cleanup of the domain ids
# ===========================================================================

def clean_domains(dom_ids: np.ndarray, min_num: int) -> np.ndarray:
    """Too-small domains absorb the previous residue's id."""
    dom_ids = dom_ids.copy()
    nz = dom_ids[dom_ids != 0]
    vals, counts = np.unique(nz, return_counts=True)
    remove = set(vals[counts < min_num].tolist())
    for i in range(len(dom_ids)):
        if dom_ids[i] in remove and i > 0:
            dom_ids[i] = dom_ids[i - 1]
    return dom_ids


def _segment_lengths(dom_ids: np.ndarray) -> np.ndarray:
    """The original's segment lengths, with its off-by-one kept: the counter
    restarts at 0 at each boundary, so every segment after the first reads
    its length less one; a trailing one-residue segment reads 1."""
    n = len(dom_ids)
    counts = np.ones(n, np.int64)
    counter, _idx, idx = 1, 0, 0
    for i in range(n):
        if i == 0:
            counter, _idx, idx = 1, 0, 0
        elif dom_ids[i] == dom_ids[i - 1]:
            counter += 1
            idx = i
        else:
            counts[_idx : idx + 1] = counter
            counter = 0
            _idx = i
        if i == n - 1:
            counts[_idx : idx + 1] = counter
    return counts


def clean_singletons(dom_ids: np.ndarray, threshold: int) -> np.ndarray:
    """Terminal stretches up to and including the first long-or-background
    residue take the id after them; short internal stretches (background
    too) split between their neighbours at the lower median.  Segment
    lengths are computed once and reused by all three stages."""
    dom_ids = np.asarray(dom_ids).copy()
    n = len(dom_ids)
    seg_len = _segment_lengths(dom_ids)

    def assimilate(ids, sl, c_term):
        if c_term:
            ids, sl = ids[::-1].copy(), sl[::-1]
        brk = None
        for i in range(len(ids)):
            if sl[i] >= threshold or ids[i] == 0:
                brk = i
                break
        if brk is not None and brk + 1 < len(ids):
            ids[: brk + 1] = ids[brk + 1]
        return ids[::-1].copy() if c_term else ids

    dom_ids = assimilate(dom_ids, seg_len, c_term=False)
    dom_ids = assimilate(dom_ids, seg_len, c_term=True)

    short = seg_len < threshold
    non_short = np.where(~short)[0]
    if len(non_short):
        short[: non_short[0]] = False
        short[non_short[-1]:] = False
        i = 0
        while i < n:
            if not short[i]:
                i += 1
                continue
            j = i
            while j < n and short[j]:
                j += 1
            mid = (i + j - 1) // 2
            dom_ids[i : mid + 1] = dom_ids[i - 1]
            dom_ids[mid:j] = dom_ids[j]
            i = j
    return dom_ids


def separate_components(dom_ids: np.ndarray, ca_coords: np.ndarray,
                        cutoff: float = 8.0) -> np.ndarray:
    """Split each domain into the connected components of its 8 A CA
    contact graph."""
    out = dom_ids.copy()
    next_id = int(out.max()) + 1 if len(out) else 1
    for d in np.unique(out):
        if d == 0:
            continue
        idx = np.where(out == d)[0]
        if len(idx) < 2:
            continue
        sub = ca_coords[idx]
        adj = np.linalg.norm(sub[:, None] - sub[None], axis=-1) < cutoff
        n_sub = len(idx)
        comp = -np.ones(n_sub, np.int64)
        cur = 0
        for seed in range(n_sub):
            if comp[seed] >= 0:
                continue
            stack = [seed]
            comp[seed] = cur
            while stack:
                u = stack.pop()
                for vtx in np.where(adj[u] & (comp < 0))[0]:
                    comp[vtx] = cur
                    stack.append(vtx)
            cur += 1
        for c in range(1, cur):
            out[idx[comp == c]] = next_id
            next_id += 1
    return out


def remap_ids(dom_ids: np.ndarray) -> np.ndarray:
    """Renumber non-zero ids from 1 in order of occurrence."""
    mapping: Dict[int, int] = {}
    out = np.zeros_like(dom_ids)
    for i, v in enumerate(dom_ids):
        if v == 0:
            continue
        if v not in mapping:
            mapping[v] = len(mapping) + 1
        out[i] = mapping[v]
    return out


def postprocess_masks(mask_logits: np.ndarray, bg_logits: np.ndarray) -> np.ndarray:
    """Mask and background logits -> domain ids (0 = background)."""
    pred = np.argmax(mask_logits, axis=-1)
    pred = clean_domains(pred, MIN_DOMAIN_SIZE)
    pred = clean_singletons(pred, MIN_FRAGMENT_SIZE)
    return pred * np.argmax(bg_logits, axis=-1)


# ===========================================================================
# features
# ===========================================================================

def gram_schmidt_frames(n_xyz: np.ndarray, ca_xyz: np.ndarray, c_xyz: np.ndarray,
                        eps: float = 1e-8):
    """Backbone frames from N, CA, C: R's columns (e1, e2, e3), t = CA."""
    v1 = ca_xyz - n_xyz
    v2 = c_xyz - ca_xyz
    e1 = v1 / np.sqrt((v1 ** 2).sum(-1, keepdims=True) + eps)
    u2 = v2 - e1 * (e1 * v2).sum(-1, keepdims=True)
    e2 = u2 / np.sqrt((u2 ** 2).sum(-1, keepdims=True) + eps)
    e3 = np.cross(e1, e2)
    return np.stack([e1, e2, e3], axis=-1), ca_xyz


def chain_features(atoms: np.ndarray) -> dict:
    """Structured atom array (one chain) -> the network's input features,
    over the residues with all of N, CA, C and O (the original drops
    residues missing any of them, O included)."""
    from ..io import pdb as pdb_io

    ca = pdb_io.select(atoms, name="CA", standard_aa=True)
    ca = ca[np.argsort(ca["res_id"], kind="stable")]
    res_ids = ca["res_id"].astype(np.float32)
    n_at = pdb_io.select(atoms, name="N", standard_aa=True)
    c_at = pdb_io.select(atoms, name="C", standard_aa=True)
    o_at = pdb_io.select(atoms, name="O", standard_aa=True)
    n_by = {int(r): i for i, r in enumerate(n_at["res_id"])}
    c_by = {int(r): i for i, r in enumerate(c_at["res_id"])}
    o_ids = {int(r) for r in o_at["res_id"]}
    keep = [i for i, r in enumerate(ca["res_id"])
            if int(r) in n_by and int(r) in c_by and int(r) in o_ids]
    ca = ca[keep]
    res_ids = res_ids[keep]

    ca_xyz = pdb_io.coords(ca).astype(np.float64)
    n_xyz = np.stack([pdb_io.coords(n_at)[n_by[int(r)]] for r in ca["res_id"]])
    c_xyz = np.stack([pdb_io.coords(c_at)[c_by[int(r)]] for r in ca["res_id"]])

    onehot = np.zeros((len(ca), 20), np.float32)
    for i, rn in enumerate(ca["res_name"]):
        ix = pdb_io.AA_INDEX.get(str(rn), -1)
        if ix >= 0:
            onehot[i, ix] = 1.0
    dist = np.linalg.norm(ca_xyz[:, None] - ca_xyz[None], axis=-1).astype(np.float32)
    rot, trans = gram_schmidt_frames(n_xyz, ca_xyz, c_xyz)
    return {
        "s": onehot,
        "z": dist,
        "rot": rot.astype(np.float32),
        "trans": trans.astype(np.float32),
        "ri": res_ids,
        "ca_xyz": ca_xyz,
        "ca_atoms": ca,
    }


# ===========================================================================
# weights: the split shards
# ===========================================================================

def read_split_weight_files(directory: str) -> Dict[str, torch.Tensor]:
    """Merge the ``*.pt`` weight shards of ``directory``, in name order."""
    weights: Dict[str, torch.Tensor] = {}
    for f in sorted(Path(directory).glob("*.pt")):
        weights.update(torch.load(f, map_location="cpu", weights_only=True))
    return weights


@functools.lru_cache(maxsize=2)
def _load_weights_cached(directory: str, device: str) -> Merizo:
    model = Merizo()
    model.load_state_dict(read_split_weight_files(directory), strict=True)
    return model.to(device).eval()


def load_weights(directory: str, device=None) -> Merizo:
    """Split shards -> a ``Merizo`` on ``device`` (None: the card), loaded
    strictly.  Cached per directory and device: processing an AF3 result
    segments every chain, and re-reading the shards each time is re-work."""
    return _load_weights_cached(str(directory), str(resolve_device(device)))


# ===========================================================================
# segmentation
# ===========================================================================

def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _forward(model: Merizo, feats: dict, keep: Optional[np.ndarray] = None):
    """The network on ``feats`` (rows ``keep`` only, if given) on the
    model's device, TF32 off -> (mask logits, bg logits) as numpy."""
    dev = _device_of(model)
    sel = slice(None) if keep is None else keep
    z = feats["z"][sel][:, sel] if keep is not None else feats["z"]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    with exact_f32(torch.float32):
        masks, bg, _ = model(t(feats["s"][sel]), t(z), t(feats["rot"][sel]),
                             t(feats["trans"][sel]), t(feats["ri"][sel]))
        out = masks.cpu().numpy(), bg.cpu().numpy()
    forwards[dev.type] += 1
    return out


@torch.no_grad()
def domain_confidences(model: Merizo, mask_logits: np.ndarray,
                       dom_ids: np.ndarray) -> np.ndarray:
    """Per-residue confidence: each domain's value from the confidence GRU
    over its residues' mask logits, 0 on background."""
    dev = _device_of(model)
    conf = np.zeros(len(dom_ids), np.float32)
    with exact_f32(torch.float32):
        for d in np.unique(dom_ids[dom_ids != 0]):
            rows = torch.as_tensor(mask_logits[dom_ids == d], dtype=torch.float32, device=dev)
            conf[dom_ids == d] = float(model.decoder_head.confidence(rows))
    return conf


def segment(model: Merizo, feats: dict, iterate: bool = True,
            max_iterations: int = 3) -> Tuple[np.ndarray, np.ndarray]:
    """The segmentation protocol: one forward, the cleanup, and on chains
    over ``2 * DOM_AVE`` residues up to ``max_iterations`` rounds that
    segment each domain over ``DOM_AVE`` residues again on its own.

    Returns (domain ids (n,), per-residue confidence (n,)); ids numbered
    from 1 in order of occurrence, 0 = background."""
    masks, bg = _forward(model, feats)
    dom_ids = postprocess_masks(masks, bg).astype(np.int64)
    conf = domain_confidences(model, masks, dom_ids)

    if iterate and len(dom_ids) > DOM_AVE * 2:
        ignore: set = set()
        for _ in range(max_iterations):
            big = [d for d in np.unique(dom_ids[dom_ids != 0])
                   if d not in ignore and (dom_ids == d).sum() > DOM_AVE]
            if not big:
                break
            counter = 1
            for d in big:
                keep = np.where(dom_ids == d)[0]
                masks_d, bg_d = _forward(model, feats, keep)
                sub_ids = postprocess_masks(masks_d, bg_d).astype(np.int64)
                if len(np.unique(sub_ids[sub_ids != 0])) <= 1:
                    ignore.add(d)
                    continue
                sub_conf = domain_confidences(model, masks_d, sub_ids)
                new_ids = sub_ids + counter * N_CLASSES
                new_ids[sub_ids == 0] = 0
                dom_ids[keep] = new_ids
                conf[keep] = sub_conf
                counter += 1

    dom_ids = separate_components(dom_ids, feats["ca_xyz"])
    if len(np.unique(dom_ids)) > 1:
        dom_ids = clean_domains(dom_ids, MIN_DOMAIN_SIZE)
        dom_ids = clean_singletons(dom_ids, MIN_FRAGMENT_SIZE)
    return remap_ids(dom_ids), conf


def segment_chain_atoms(atoms: np.ndarray, weights_dir: str, min_confidence: float = 0.0,
                        device=None):
    """Chain atom array + shard directory -> (domain ids, residue ids) over
    the residues with complete backbones, the network on ``device`` (None:
    the card; raises where there is none).  Domains whose mean confidence
    falls below ``min_confidence`` become background."""
    model = load_weights(weights_dir, device)
    feats = chain_features(atoms)
    ids, conf = segment(model, feats)
    if min_confidence > 0:
        for d in np.unique(ids[ids != 0]):
            if conf[ids == d].mean() < min_confidence:
                ids[ids == d] = 0
    return ids, feats["ca_atoms"]["res_id"].astype(np.int64)
