"""Synthetic cryo-EM scenarios (tests, smoke runs, fixtures).

The port's own copy of ``mica_tpu/utils/synthetic.py``.  Generates a
ground-truth CA chain (smooth self-avoiding walk at 3.8 A spacing), a
random sequence, and the four prediction volumes the network would produce
for a perfect prediction: Gaussian CA bumps, backbone density along the
CA-CA segments, and per-type amino-acid probability bumps.
"""

from __future__ import annotations

import numpy as np

AA_LETTERS = "ACDEFGHIKLMNPQRSTVWY"


def make_chain(n_res: int, shape, seed: int = 0, step: float = 3.8):
    """Smooth self-avoiding CA walk inside the volume with margins."""
    rng = np.random.default_rng(seed)
    lo = np.array([8.0, 8.0, 8.0])
    hi = np.asarray(shape) - 8.0
    coords = [np.asarray(shape, float) / 2.0]
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    for _ in range(n_res - 1):
        for _ in range(200):
            cand_dir = direction + rng.normal(scale=0.55, size=3)
            cand_dir /= np.linalg.norm(cand_dir)
            nxt = coords[-1] + cand_dir * step
            if np.any(nxt < lo) or np.any(nxt > hi):
                direction = (np.asarray(shape, float) / 2 - coords[-1])
                direction /= np.linalg.norm(direction)
                continue
            if len(coords) > 2 and np.min(
                np.linalg.norm(np.asarray(coords[:-1]) - nxt, axis=1)
            ) < 3.4:
                direction = rng.normal(size=3)
                direction /= np.linalg.norm(direction)
                continue
            coords.append(nxt)
            direction = cand_dir
            break
        else:
            raise RuntimeError("could not grow chain")
    return np.asarray(coords)


def _add_bump(vol, center, sigma, amplitude):
    c = np.asarray(center)
    lo = np.maximum(0, np.floor(c - 3 * sigma).astype(int))
    hi = np.minimum(np.asarray(vol.shape), np.ceil(c + 3 * sigma).astype(int) + 1)
    xs = [np.arange(lo[a], hi[a]) for a in range(3)]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    d2 = (gx - c[0]) ** 2 + (gy - c[1]) ** 2 + (gz - c[2]) ** 2
    bump = amplitude * np.exp(-d2 / (2 * sigma**2))
    region = vol[lo[0] : hi[0], lo[1] : hi[1], lo[2] : hi[2]]
    np.maximum(region, bump, out=region)


def make_scenario(n_res: int = 60, shape=(64, 64, 64), seed: int = 0):
    rng = np.random.default_rng(seed + 1)
    ca = make_chain(n_res, shape, seed)
    seq = "".join(rng.choice(list(AA_LETTERS), size=n_res))

    ca_prob = np.zeros(shape, np.float32)
    bb_prob = np.zeros(shape, np.float32)
    aa_prob = np.zeros((20,) + tuple(shape), np.float32)

    letters = list(AA_LETTERS)
    for i, c in enumerate(ca):
        _add_bump(ca_prob, c, 1.0, 0.95)
        _add_bump(bb_prob, c, 1.2, 0.95)
        aa_ix = letters.index(seq[i])
        _add_bump(aa_prob[aa_ix], c, 1.6, 0.9)
        if i + 1 < len(ca):
            for frac in (0.25, 0.5, 0.75):
                mid = (1 - frac) * c + frac * ca[i + 1]
                _add_bump(bb_prob, mid, 1.0, 0.9)

    # normalize AA probs to a distribution-ish (leave softmax-like mass)
    total = aa_prob.sum(axis=0, keepdims=True)
    rest = np.maximum(0.0, 1.0 - total)
    aa_prob = aa_prob + rest / 20.0
    aa_pred = np.argmax(aa_prob, axis=0).astype(np.int64)

    volumes = {
        "carbon_alpha_probability": ca_prob,
        "backbone_probability": bb_prob,
        "amino_acid_probability": aa_prob,
        "amino_acid_prediction": aa_pred,
    }
    return ca, seq, volumes


def make_multichain_volumes(chain_specs, shape):
    """Prediction volumes for several chains in one map.

    ``chain_specs`` is a list of ``(sequence, ca_coords)`` pairs (the
    same sequence may appear multiple times — chain copies).  Returns
    the four prediction-volume dict in the same format as
    :func:`make_scenario`.
    """
    ca_prob = np.zeros(shape, np.float32)
    bb_prob = np.zeros(shape, np.float32)
    aa_prob = np.zeros((20,) + tuple(shape), np.float32)
    letters = list(AA_LETTERS)
    for seq, ca in chain_specs:
        assert len(seq) == len(ca)
        for i, c in enumerate(ca):
            _add_bump(ca_prob, c, 1.0, 0.95)
            _add_bump(bb_prob, c, 1.2, 0.95)
            _add_bump(aa_prob[letters.index(seq[i])], c, 1.6, 0.9)
            if i + 1 < len(ca):
                for frac in (0.25, 0.5, 0.75):
                    mid = (1 - frac) * c + frac * ca[i + 1]
                    _add_bump(bb_prob, mid, 1.0, 0.9)
    total = aa_prob.sum(axis=0, keepdims=True)
    aa_prob = aa_prob + np.maximum(0.0, 1.0 - total) / 20.0
    return {
        "carbon_alpha_probability": ca_prob,
        "backbone_probability": bb_prob,
        "amino_acid_probability": aa_prob,
        "amino_acid_prediction": np.argmax(aa_prob, axis=0).astype(np.int64),
    }


def random_rigid(seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(3, 3))
    q, _ = np.linalg.qr(a)
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    t = rng.normal(scale=30.0, size=3)
    return q, t
