"""The numbers that decide ``correct``, each held below its limit.

Prediction: the probabilities the timed path returned on the host, at a
sample of windows drawn from the seed, against the reference's.

  * ``prob_rms``: the root mean square of the gap over every sampled
    voxel of the 22 probability volumes (backbone, CA, 20 amino acids);
  * ``prob_max``: the widest gap there;
  * ``aa_argmax_off``: the share of sampled voxels, among those whose
    reference amino-acid probabilities lead by more than ``MARGIN``,
    where the returned prediction volume names another type.

Training: the first steps of the timed step against the reference's.

  * ``loss_gap``: the widest relative gap of a step's loss
    (``loss1_gap``: the first step's);
  * ``grad_gap``: the first gradient as Adam received it, the worst
    leaf's gap of norms over max(its reference norm, the median leaf's)
    (``grad_gap_median``: the median leaf's gap);
  * ``update_gap``: the same of the parameters' change over the steps
    (``update_gap_median``);
  * ``grad_diff``: the first gradient's difference from the reference's,
    the worst leaf's norm over max(its reference norm, the median leaf's)
    (``grad_diff_median``: the median leaf's); ``grad_diff_p10``: the
    difference over the leaf's own reference norm at the tenth percentile
    of the leaves, the best-conditioned tenth, where the gap is the
    rounding of products alone and not the discrete flips (a ReLU unit,
    the sign of a sum that nearly cancels) that bf16 and lower precisions
    share in the other leaves.

Leaves whose gradient is nought to rounding in the reference are left
out of every leaf number: a leaf whose reference gradient's norm is under ``QUIET`` of
the median leaf's, and a bias whose reference gradient's RMS is under
``QUIET`` of its layer weight's.  A conv bias before an InstanceNorm has
a gradient of rounding alone, and Adam moves such a leaf by a full step
all the same (the program, whose fused convolution and norm drop the
bias, leaves it where it was).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

MARGIN = 0.02
QUIET = 1e-3


def predict_numbers(got: Sequence[Dict[str, np.ndarray]],
                    want: Sequence[Dict[str, np.ndarray]]) -> Dict[str, float]:
    """``got``/``want``: per compared window, ``probs`` (22, ...) f32 and
    (``got`` only) ``argmax`` (...) of the amino-acid type, both cropped
    to the volume."""
    sq, n, worst, flips, lead = 0.0, 0, 0.0, 0, 0
    for g, w in zip(got, want):
        d = g["probs"].astype(np.float64) - w["probs"].astype(np.float64)
        sq += float((d * d).sum())
        n += d.size
        worst = max(worst, float(np.abs(d).max()) if d.size else 0.0)
        aa = w["probs"][2:]
        top2 = np.sort(aa, axis=0)[-2:]
        sure = (top2[1] - top2[0]) > MARGIN
        lead += int(sure.sum())
        flips += int((sure & (g["argmax"] != aa.argmax(axis=0))).sum())
    return {"prob_rms": (sq / max(n, 1)) ** 0.5, "prob_max": worst,
            "aa_argmax_off": flips / lead if lead else 0.0}


def counted(want: Dict) -> List[str]:
    """The leaves whose reference gradient is more than rounding."""
    g, n = want["grad_norms"], want["sizes"]
    med = float(np.median(list(g.values())))
    rms = {k: g[k] / n[k] ** 0.5 for k in g}

    def rounding(k):
        w = k[:-len(".bias")] + ".weight" if k.endswith(".bias") else None
        return g[k] < QUIET * med or (w in g and rms[k] < QUIET * rms[w])

    return [k for k in g if not rounding(k)]


def _leaf_ratios(diff: Dict[str, float], want: Dict[str, float], keys: List[str]) -> List[float]:
    med = float(np.median([want[k] for k in keys]))
    return [diff[k] / max(want[k], med) for k in keys]


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys: List[str]) -> List[float]:
    return _leaf_ratios({k: abs(got[k] - want[k]) for k in keys}, want, keys)


def worst_leaves(got: Dict, want: Dict, n: int = 3) -> Dict[str, list]:
    """The ``n`` leaves with the widest gaps of each kind, with their
    reference norms over the median leaf's: what drives the worst-leaf
    numbers."""
    keys = counted(want)
    g_ref = want["grad_norms"]
    kinds = {"grad_norms": (_leaf_gaps(got["grad_norms"], g_ref, keys), g_ref),
             "update_norms": (_leaf_gaps(got["update_norms"], want["update_norms"], keys),
                              want["update_norms"])}
    if "grad_diff" in got:
        kinds["grad_diff"] = (_leaf_ratios(got["grad_diff"], g_ref, keys), g_ref)
    out = {}
    for kind, (gaps, ref) in kinds.items():
        m = float(np.median([ref[k] for k in keys]))
        top = sorted(zip(gaps, keys), reverse=True)[:n]
        out[kind] = [[k, round(g, 6), round(ref[k] / m, 6)] for g, k in top]
    return out


def train_numbers(got: Dict, want: Dict) -> Dict[str, float]:
    """``got``/``want``: ``losses`` (a step's loss each), ``grad_norms`` and
    ``update_norms`` (a float per leaf), ``sizes`` (elements per leaf);
    ``got`` may carry ``grad_diff`` (a float per leaf)."""
    g_ref = want["grad_norms"]
    keys = counted(want)
    loss = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
    grad = _leaf_gaps(got["grad_norms"], g_ref, keys)
    update = _leaf_gaps(got["update_norms"], want["update_norms"], keys)
    out = {"loss_gap": max(loss), "loss1_gap": loss[0],
           "grad_gap": max(grad), "grad_gap_median": float(np.median(grad)),
           "update_gap": max(update), "update_gap_median": float(np.median(update))}
    if "grad_diff" in got:
        diff = _leaf_ratios(got["grad_diff"], g_ref, keys)
        own = [got["grad_diff"][k] / g_ref[k] for k in keys]
        out.update(grad_diff=max(diff), grad_diff_median=float(np.median(diff)),
                   grad_diff_p10=float(np.percentile(own, 10)))
    return out
