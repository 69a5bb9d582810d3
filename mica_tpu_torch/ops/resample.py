"""Cubic B-spline volume resampling in PyTorch, scipy-parity.

Port of ``mica_tpu/ops/resample.py``: the semantics of
``scipy.ndimage.zoom(data, factors, order=3)``:

  * cubic B-spline prefilter (pole sqrt(3)-2) with mirror boundary and
    exact initialisation;
  * endpoint-aligned coordinate mapping ``coord[i] = i * (in-1)/(out-1)``
    evaluated in float64 numpy on the host, so coordinates that land an
    ulp past ``in-1`` give cval=0 exactly as scipy's C kernel does;
  * mirror extension of spline coefficients for in-range coordinates.

The prefilter is a first-order linear recurrence along the axis; here it
runs as a sequential loop over whole planes (one small elementwise op per
plane), which is cheap next to the network.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

_POLE = np.sqrt(3.0) - 2.0  # cubic B-spline filter pole
_GAIN = 6.0


def _linear_recurrence(x: torch.Tensor, z: float, c0: torch.Tensor) -> torch.Tensor:
    """c[0] = c0, c[k] = x[k] + z * c[k-1] along axis 0."""
    out = torch.empty_like(x)
    out[0] = c0
    for k in range(1, x.shape[0]):
        out[k] = x[k] + z * out[k - 1]
    return out


def spline_prefilter(x: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficients along axis 0 (mirror boundary, exact init)."""
    n = x.shape[0]
    if n == 1:
        return x
    z = float(np.float32(_POLE)) if x.dtype == torch.float32 else float(_POLE)
    c = x * _GAIN

    # exact causal init under mirror extension (period 2n-2)
    k = np.arange(2 * n - 2, dtype=np.float64)
    zk = (_POLE ** k) / (1.0 - _POLE ** (2 * n - 2))
    zk = torch.as_tensor(zk, dtype=x.dtype, device=x.device).reshape(
        (-1,) + (1,) * (x.ndim - 1))
    ext = torch.cat([c, torch.flip(c[1:-1], dims=(0,))], dim=0)
    c_plus0 = torch.sum(zk * ext, dim=0)

    c_plus = _linear_recurrence(c, z, c_plus0)

    # anticausal pass, reversed
    c_minus_last = (z / (z * z - 1.0)) * (c_plus[-1] + z * c_plus[-2])
    rev = -z * torch.flip(c_plus, dims=(0,))
    c_minus = _linear_recurrence(rev, z, c_minus_last)
    return torch.flip(c_minus, dims=(0,))


def _mirror_index(idx: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * n - 2
    idx = np.abs(idx) % period
    return np.where(idx >= n, period - idx, idx)


def _cubic_tap_tables(in_n: int, out_n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(taps, weights, outside-mask) tables for one axis, in float64 numpy
    to match scipy's coordinate arithmetic exactly."""
    if out_n == 1:
        coords = np.zeros(1, dtype=np.float64)
    else:
        zoom = np.float64(in_n - 1) / np.float64(out_n - 1)
        coords = np.arange(out_n, dtype=np.float64) * zoom
    outside = (coords < 0) | (coords > in_n - 1)
    coords_in = np.clip(coords, 0, in_n - 1)
    f = np.floor(coords_in).astype(np.int64)
    t = coords_in - f
    w = np.stack(
        [
            (1 - t) ** 3 / 6.0,
            (4 - 6 * t * t + 3 * t ** 3) / 6.0,
            (1 + 3 * t + 3 * t * t - 3 * t ** 3) / 6.0,
            t ** 3 / 6.0,
        ],
        axis=0,
    )  # (4, out_n)
    taps = np.stack([_mirror_index(f + o - 1, in_n) for o in range(4)], axis=0)
    return taps, w, outside


def _interp_axis0(c: torch.Tensor, in_n: int, out_n: int) -> torch.Tensor:
    taps, w, outside = _cubic_tap_tables(in_n, out_n)
    wshape = (-1,) + (1,) * (c.ndim - 1)
    acc = torch.zeros((out_n,) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
    for o in range(4):
        wo = torch.as_tensor(w[o], dtype=c.dtype, device=c.device).reshape(wshape)
        idx = torch.as_tensor(taps[o], device=c.device)
        acc = acc + wo * c.index_select(0, idx)
    if outside.any():
        mask = torch.as_tensor(outside, device=c.device).reshape(wshape)
        acc = torch.where(mask, torch.zeros((), dtype=c.dtype, device=c.device), acc)
    return acc


def _resize_axis(x: torch.Tensor, axis: int, out_n: int) -> torch.Tensor:
    x = torch.movedim(x, axis, 0)
    in_n = x.shape[0]
    c = spline_prefilter(x) if in_n > 1 else x
    x = _interp_axis0(c, in_n, out_n)
    return torch.movedim(x, 0, axis).contiguous()


def zoom_output_shape(shape: Sequence[int], factors: Sequence[float]) -> Tuple[int, ...]:
    """scipy's output-shape rule: round(in * factor) per axis."""
    return tuple(int(round(s * f)) for s, f in zip(shape, factors))


def zoom_cubic(volume: torch.Tensor, output_shape: Tuple[int, ...]) -> torch.Tensor:
    """Cubic-spline resample ``volume`` to ``output_shape``; axes whose size
    is unchanged pass through untouched, as in the JAX package."""
    out = volume
    for axis, out_n in enumerate(output_shape):
        if out.shape[axis] != out_n:
            out = _resize_axis(out, axis, out_n)
    return out


def resample_to_voxel_size(
    volume: torch.Tensor,
    voxel_size: Sequence[float],
    target_voxel_size: float = 1.0,
) -> torch.Tensor:
    """Resample a (d0,d1,d2) volume so each axis has ``target_voxel_size`` Å;
    ``voxel_size`` gives the Å spacing of each data axis of ``volume``."""
    factors = [float(v) / float(target_voxel_size) for v in voxel_size]
    out_shape = zoom_output_shape(volume.shape, factors)
    if tuple(out_shape) == tuple(volume.shape):
        return volume
    return zoom_cubic(volume, out_shape)
