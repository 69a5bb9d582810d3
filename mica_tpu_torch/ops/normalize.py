"""Density-map normalization in PyTorch, numpy-parity.

Port of ``mica_tpu/ops/normalize.py``: median-threshold, clip at the
99.9th percentile of positive values, scale to [0, 1].  The percentile of
the positive subset comes from one global sort plus an index, with the
rank computed in float32 exactly as the JAX version does.
"""

from __future__ import annotations

import torch


def normalize_map(volume: torch.Tensor) -> torch.Tensor:
    """Normalize a density volume to [0, 1].

      1. nan -> 0
      2. v = (v > median) * (v - median)
      3. p = 99.9th percentile (linear interpolation) of strictly positive v
      4. v = min(v, p) / p
    """
    v = torch.nan_to_num(volume.to(torch.float32))
    flat = v.reshape(-1)
    n = flat.shape[0]

    sorted_all = torch.sort(flat).values
    mid = n // 2
    if n % 2 == 1:
        median = sorted_all[mid]
    else:
        median = 0.5 * (sorted_all[mid - 1] + sorted_all[mid])

    zero = torch.zeros((), dtype=torch.float32, device=v.device)
    thresh = torch.where(flat > median, flat - median, zero)

    # after the median shift the positive values are exactly the top
    # ``count`` entries of the sorted shifted array
    sorted_thresh = torch.sort(thresh).values
    count = torch.sum(thresh > 0)
    start = n - count

    q = torch.tensor(0.999, dtype=torch.float32, device=v.device) * (
        count.to(torch.float32) - 1.0)
    lo = torch.floor(q).to(torch.int64)
    frac = q - lo.to(torch.float32)
    v_lo = sorted_thresh[torch.clamp(start + lo, 0, n - 1)]
    v_hi = sorted_thresh[torch.clamp(start + lo + 1, 0, n - 1)]
    percentile = torch.where(
        count > 1, v_lo + frac * (v_hi - v_lo),
        torch.where(count == 1, sorted_thresh[n - 1], zero))

    safe_p = torch.where(percentile > 0, percentile, torch.ones_like(percentile))
    clipped = torch.minimum(thresh, percentile)
    out = torch.where(percentile > 0, clipped / safe_p, thresh)
    return out.reshape(v.shape)
