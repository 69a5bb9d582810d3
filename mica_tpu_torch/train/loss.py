"""Weighted multi-task cross-entropy with cosine-annealed task weights.

Port of ``mica_tpu/train/loss.py``: three per-class-weighted
cross-entropies (backbone 4-class, C-alpha 4-class, amino-acid 21-class)
on channels-last logits, combined with task weights that anneal from
(0.6, 0.25, 0.15) to (0.25, 0.4, 0.35) over 25 epochs on a cosine ramp and
are renormalised to sum to 1.  The weighted mean follows
``F.cross_entropy(weight=...)``: ``sum_i w[y_i] nll_i / sum_i w[y_i]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

BACKBONE_CLASS_WEIGHTS = (0.03, 0.001, 0.3, 1.0)
CARBON_ALPHA_CLASS_WEIGHTS = (0.01, 0.001, 0.1, 1.0)
AMINO_ACID_CLASS_WEIGHTS = (
    0.001,  # background + masked
    1.0, 1.8, 1.1, 1.1, 1.3,  # ALA CYS ASP GLU PHE
    1.0, 1.6, 1.1, 1.1, 0.9,  # GLY HIS ILE LYS LEU
    1.7, 1.2, 1.2, 1.3, 1.1,  # MET ASN PRO GLN ARG
    1.0, 1.1, 1.0, 2.2, 1.4,  # SER THR VAL TRP TYR
)
CLASS_WEIGHTS = (BACKBONE_CLASS_WEIGHTS, CARBON_ALPHA_CLASS_WEIGHTS, AMINO_ACID_CLASS_WEIGHTS)

START_LAMBDAS = (0.6, 0.25, 0.15)
TARGET_LAMBDAS = (0.25, 0.4, 0.35)
TRANSITION_EPOCH = 25

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def cosine_transition(epoch: float, start_epoch: float, end_epoch: float) -> float:
    """Smooth 0 -> 1 cosine ramp."""
    if epoch <= start_epoch:
        return 0.0
    if epoch >= end_epoch:
        return 1.0
    progress = (epoch - start_epoch) / (end_epoch - start_epoch)
    return 0.5 * (1.0 - math.cos(math.pi * progress))


def task_lambdas(epoch: float) -> Tuple[float, float, float]:
    """Annealed, normalised (lambda_b, lambda_c, lambda_a) for an epoch."""
    p = cosine_transition(epoch, 0, TRANSITION_EPOCH)
    lams = [s + (t - s) * p for s, t in zip(START_LAMBDAS, TARGET_LAMBDAS)]
    total = sum(lams)
    return tuple(lam / total for lam in lams)


def _weights(class_weights: Sequence[float], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(class_weights, dtype=torch.float32, device=like.device)


def weighted_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                           class_weights: Sequence[float], label_smoothing: float = 0.0,
                           denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-class-weighted CE of channels-last ``logits`` (..., C) against
    integer ``targets`` (...).  ``denominator`` replaces the normaliser
    ``sum_i w[y_i]``: microbatch accumulation passes the full batch's."""
    w = _weights(class_weights, logits)
    logp = F.log_softmax(logits.float(), dim=-1)
    targets = targets.long()
    if label_smoothing > 0.0:
        n_cls = logits.shape[-1]
        smoothed = (F.one_hot(targets, n_cls).float() * (1.0 - label_smoothing)
                    + label_smoothing / n_cls)
        nll = -(smoothed * logp).sum(dim=-1)
    else:
        nll = -logp.gather(-1, targets[..., None])[..., 0]
    sample_w = w[targets]
    if denominator is None:
        denominator = sample_w.sum()
    return (sample_w * nll).sum() / denominator


def class_weight_denominators(targets: Triple) -> Triple:
    """Per-task normalisers ``sum_i w[y_i]`` over a batch: a function of the
    targets alone, so the full batch's can scale each microbatch's loss."""
    return tuple(_weights(w, t)[t.long()].sum() for w, t in zip(CLASS_WEIGHTS, targets))


def multi_task_loss(outputs: Triple, targets: Triple, lambdas,
                    label_smoothing: float = 0.0,
                    denominators: Optional[Triple] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined loss of the (backbone, ca, aa) logits (N, D, H, W, C) and
    their metrics, all tensors on the logits' device.  ``lambdas`` is the
    (3,) task-weight vector (``task_lambdas``)."""
    dn = denominators if denominators is not None else (None, None, None)
    losses = [weighted_cross_entropy(o, t, w, label_smoothing, d)
              for o, t, w, d in zip(outputs, targets, CLASS_WEIGHTS, dn)]
    lam = torch.as_tensor(lambdas, dtype=torch.float32, device=outputs[0].device)
    total = lam[0] * losses[0] + lam[1] * losses[1] + lam[2] * losses[2]
    return total, {
        "total_loss": total,
        "backbone_loss": losses[0],
        "carbon_alpha_loss": losses[1],
        "amino_acid_loss": losses[2],
        "lambda_b": lam[0],
        "lambda_c": lam[1],
        "lambda_a": lam[2],
    }
