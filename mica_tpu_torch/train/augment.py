"""On-device training augmentation (port of ``mica_tpu/train/augment.py``).

Per sample, with the reference's probabilities: a gate (p=0.4); Gaussian
noise sigma=0.03 (p=0.7); brightness +-0.05 (p=0.5); contrast 0.9-1.1
(p=0.5); a joint spatial block (p=0.6) of rot90 (p=0.5, one of 9
axis-pair/quarter-turn variants), flip (p=0.3, one of 3 axes) and a
+-2-voxel roll per axis (p=0.4); a separable 3-tap Gaussian blur with
sigma 0.5-1.0 on the density only (p=0.2).  Spatial ops move the stacked
inputs (density + 24 AF3 channels) and the three integer target masks
together.

All draws come from one explicit ``torch.Generator`` on the batch's
device: the per-sample choices as one (N, 17) uniform tensor, read on the
host once per batch to pick the ops, and the noise as device tensors.
The generator's numbers differ from ``jax.random``'s, so the tests hold
the distributions and the spatial helpers, not the draws, against JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

GAUSSIAN_NOISE_STD = 0.03
BRIGHTNESS_RANGE = 0.05
CONTRAST_RANGE = (0.9, 1.1)
ROTATION_PROB = 0.5
FLIP_PROB = 0.3
TRANSLATION_PIXELS = 2
BLUR_PROB = 0.2
AUGMENT_PROB = 0.4
SPATIAL_PROB = 0.6
NOISE_PROB = 0.7
INTENSITY_PROB = 0.5
TRANSLATION_PROB = 0.4

# columns of the per-sample uniform draws
(GATE, NOISE, BRIGHT, BRIGHT_V, CONTRAST, CONTRAST_V, ROT, ROT_V, FLIP, FLIP_V, SHIFT,
 SHIFT_Z, SHIFT_Y, SHIFT_X, SPATIAL, BLUR, BLUR_V) = range(17)
N_DRAWS = 17

_ROT_AXES = ((1, 2), (1, 3), (2, 3))


def rot90_variant(x: torch.Tensor, variant: int) -> torch.Tensor:
    """Variant 0..8 = (axis pair (1,2)/(1,3)/(2,3)) x (k = 1, 2, 3) of
    ``rot90`` over dims 1..3, in ``_rot90_variants``' order."""
    return torch.rot90(x, variant % 3 + 1, _ROT_AXES[variant // 3])


def flip_variant(x: torch.Tensor, axis_idx: int) -> torch.Tensor:
    return torch.flip(x, (axis_idx + 1,))


def blur3(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable 3-tap Gaussian blur with zero padding over dims 1..3 of
    (C, D, H, W)."""
    w = torch.exp(-0.5 * (torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float32) / sigma) ** 2)
    w = (w / w.sum()).tolist()
    for dim in (1, 2, 3):
        pad = [0, 0] * (x.dim() - dim - 1) + [1, 1]
        xp = F.pad(x, pad)
        n = x.shape[dim]
        x = (w[0] * xp.narrow(dim, 0, n) + w[1] * xp.narrow(dim, 1, n)
             + w[2] * xp.narrow(dim, 2, n))
    return x


def _uniform(u: float, lo: float, hi: float) -> float:
    return lo + (hi - lo) * u


def _draws_noise(u) -> bool:
    """Whether a sample with draws ``u`` takes its noise from the generator."""
    return u[GATE] < AUGMENT_PROB and u[NOISE] < NOISE_PROB


def augment_sample(draws, gen: torch.Generator, density: torch.Tensor, af3: torch.Tensor,
                   targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sample: density (1, D, H, W), af3 (24, D, H, W), targets
    (3, D, H, W) integer; ``draws`` its N_DRAWS uniforms."""
    u = draws
    if not u[GATE] < AUGMENT_PROB:
        return density, af3, targets
    if _draws_noise(u):
        density = density + GAUSSIAN_NOISE_STD * torch.randn(
            density.shape, generator=gen, device=density.device, dtype=density.dtype)
    if u[BRIGHT] < INTENSITY_PROB:
        density = density + _uniform(u[BRIGHT_V], -BRIGHTNESS_RANGE, BRIGHTNESS_RANGE)
    if u[CONTRAST] < INTENSITY_PROB:
        mean = density.mean()
        density = (density - mean) * _uniform(u[CONTRAST_V], *CONTRAST_RANGE) + mean

    if u[SPATIAL] < SPATIAL_PROB:
        inputs = torch.cat([density, af3], dim=0)
        if u[ROT] < ROTATION_PROB:
            variant = min(int(u[ROT_V] * 9), 8)
            inputs, targets = rot90_variant(inputs, variant), rot90_variant(targets, variant)
        if u[FLIP] < FLIP_PROB:
            axis = min(int(u[FLIP_V] * 3), 2)
            inputs, targets = flip_variant(inputs, axis), flip_variant(targets, axis)
        if u[SHIFT] < TRANSLATION_PROB:
            span = 2 * TRANSLATION_PIXELS + 1
            shifts = [min(int(u[c] * span), span - 1) - TRANSLATION_PIXELS
                      for c in (SHIFT_Z, SHIFT_Y, SHIFT_X)]
            inputs = torch.roll(inputs, shifts, dims=(1, 2, 3))
            targets = torch.roll(targets, shifts, dims=(1, 2, 3))
        density, af3 = inputs[:1], inputs[1:]

    if u[BLUR] < BLUR_PROB:
        density = blur3(density, _uniform(u[BLUR_V], 0.5, 1.0))
    return density, af3, targets


def augment_batch(gen: torch.Generator, density: torch.Tensor, af3: torch.Tensor,
                  targets: torch.Tensor, first: int = 0, total: Optional[int] = None):
    """Per-sample augmentation of density (N, 1, D, H, W), af3
    (N, 24, D, H, W) and targets (N, 3, D, H, W), on their device, drawing
    from ``gen`` (on that device).  Returns new tensors.

    ``first``, ``total``: the N samples are rows first.. of a batch of
    ``total`` split over data-parallel ranks.  The draws are made for the
    whole batch in its order (the other rows' noise drawn and dropped), so
    each row gets what one process would give it and every rank's
    generator stays in step."""
    n = density.shape[0]
    total = n if total is None else total
    draws = torch.rand((total, N_DRAWS), generator=gen, device=density.device).tolist()
    outs = []
    for i in range(total):
        if first <= i < first + n:
            j = i - first
            outs.append(augment_sample(draws[i], gen, density[j], af3[j], targets[j]))
        elif _draws_noise(draws[i]):
            torch.randn(density.shape[1:], generator=gen, device=density.device,
                        dtype=density.dtype)
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))
