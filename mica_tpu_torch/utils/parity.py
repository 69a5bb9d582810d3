"""Dice report between two sets of prediction volumes (numpy only).

The port's own copy of ``dice`` and ``mask_dice_report`` from
``mica_tpu/utils/parity.py``: Dice coefficients between thresholded
backbone and CA probability volumes and the agreement of the amino-acid
labels, the measure of the mask-parity north star (Dice >= 0.999).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def dice(a: np.ndarray, b: np.ndarray) -> float:
    """Dice coefficient of two binary masks."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    denom = a.sum() + b.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(a, b).sum() / denom)


def mask_dice_report(
    ours: Dict[str, np.ndarray],
    reference: Dict[str, np.ndarray],
    bb_threshold: float = 0.5,
    ca_threshold: float = 0.5,
) -> Dict[str, float]:
    """Dice between thresholded probability volumes + AA label agreement."""
    report = {
        "backbone_dice": dice(
            ours["backbone_probability"] >= bb_threshold,
            reference["backbone_probability"] >= bb_threshold,
        ),
        "carbon_alpha_dice": dice(
            ours["carbon_alpha_probability"] >= ca_threshold,
            reference["carbon_alpha_probability"] >= ca_threshold,
        ),
        "amino_acid_agreement": float(
            np.mean(
                ours["amino_acid_prediction"] == reference["amino_acid_prediction"]
            )
        ),
    }
    report["min_dice"] = min(report["backbone_dice"], report["carbon_alpha_dice"])
    return report
