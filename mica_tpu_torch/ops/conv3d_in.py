"""Fused 3x3x3 conv + InstanceNorm + ReLU on channels-last tensors.

Counterpart of ``mica_tpu/ops/wino_pallas.py``.  Two kernels, each beside
its plain PyTorch version:

  * K1 ``conv3d`` (CUDA C++, ``csrc/conv3d_stats.cu``): 3x3x3 SAME conv +
    bias over the channel concat of 1-3 operands, with the per-(batch,
    channel) sums of y and y^2 of the f32 value before the cast.  Replaces
    ``_wino_T``; bounded by the tensor cores (see the source's note).
  * K2 ``in_apply`` (Triton): y = relu((y - mean) * scale) in place, with
    mean and scale cast to the tensor's dtype first.  Replaces
    ``_in_apply_T``.  One read and one write per element and a tiny
    per-(batch, channel) table: bounded by device-memory bandwidth alone;
    masked 2-D block loads move exactly those bytes.

``conv3d_in_relu`` chains them the way ``wino_conv3d_in_relu_pallas``
does: f32 statistics in the E[x^2]-E[x]^2 form, variance clamped at 0,
apply in the compute dtype.

Weights are in torch layout, (Co, sum Ci, 3, 3, 3).  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
or raises.  ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = {"conv3d_stats": 0, "in_apply": 0}

_BF16 = torch.bfloat16


def _as_parts(parts) -> list:
    return list(parts) if isinstance(parts, (list, tuple)) else [parts]


# ---------------------------------------------------------------------------
# K1: conv3d + IN statistics
# ---------------------------------------------------------------------------


def conv3d_plain(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 with_stats: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of K1: the same products in f32 (the weight rounded
    to the parts' dtype first, as the kernel takes it), bias added in f32,
    statistics of that f32 value, output cast to the parts' dtype."""
    parts = _as_parts(parts)
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    dt = x.dtype
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.to(dt).float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1)
    if bias is not None:
        y = y + bias.float()
    stats = None
    if with_stats:
        stats = torch.stack([y.sum(dim=(1, 2, 3)), (y * y).sum(dim=(1, 2, 3))], dim=1)
    return y.to(dt), stats


_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV_ARGS = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Co, 27 * Ci) bf16, [co][tap][ci]: K1's B operand."""
    co = weight.shape[0]
    return weight.permute(0, 2, 3, 4, 1).reshape(co, -1).to(_BF16).contiguous()


def conv3d(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           with_stats: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1.  ``parts``: 1-3 tensors (B, D, H, W, Ci_k) standing for their
    channel concat; ``weight`` (Co, sum Ci_k, 3, 3, 3); ``bias`` (Co,) or
    None.  Returns (out (B, D, H, W, Co) in the parts' dtype, stats
    (B, 2, Co) f32 or None)."""
    parts = _as_parts(parts)
    if parts[0].device.type == "cpu":
        return conv3d_plain(parts, weight, bias, with_stats)
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"conv3d takes 1-3 operands, got {len(parts)}")
    b, d, h, w = parts[0].shape[:4]
    for p in parts:
        if p.device != parts[0].device or p.dtype != _BF16 or not p.is_contiguous():
            raise TypeError("conv3d on the card takes contiguous bf16 operands on "
                            "one device; f32 parity runs on the CPU")
        if p.dim() != 5 or tuple(p.shape[:4]) != (b, d, h, w) or p.shape[4] % 32:
            raise ValueError(f"operand shape {tuple(p.shape)}: needs (B,D,H,W,Ci) "
                             "with a shared (B,D,H,W) and Ci % 32 == 0")
    cis = [p.shape[4] for p in parts]
    co = weight.shape[0]
    if tuple(weight.shape[1:]) != (sum(cis), 3, 3, 3) or co % 32:
        raise ValueError(f"weight shape {tuple(weight.shape)} for Ci {sum(cis)}; "
                         "Co must be a multiple of 32")
    wp = pack_weight(weight.to(parts[0].device))
    bp = None
    if bias is not None:
        bp = bias.to(device=parts[0].device, dtype=torch.float32).contiguous()
    out = torch.empty((b, d, h, w, co), dtype=_BF16, device=parts[0].device)
    stats = (torch.zeros((b, 2, co), dtype=torch.float32, device=out.device)
             if with_stats else None)
    ptrs = [p.data_ptr() for p in parts] + [None] * (3 - len(parts))
    cis = cis + [0] * (3 - len(cis))
    err = _build.function("conv3d_stats", "conv3d_stats_bf16", _CONV_ARGS)(
        ptrs[0], ptrs[1], ptrs[2], cis[0], cis[1], cis[2],
        wp.data_ptr(), None if bp is None else bp.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        b, d, h, w, co, torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "conv3d_stats")
    launches["conv3d_stats"] += 1
    return out, stats


# ---------------------------------------------------------------------------
# K2: InstanceNorm apply + ReLU
# ---------------------------------------------------------------------------


def in_apply_plain(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 (out of place): relu((y - m) * s) in y's dtype,
    m and s being the (B, C) f32 mean and scale cast to that dtype."""
    dt = y.dtype
    m = mean.to(dt)[:, None, None, None, :]
    s = scale.to(dt)[:, None, None, None, :]
    return torch.relu((y - m) * s)


_triton_kernel = None


def _in_apply_triton():
    global _triton_kernel
    if _triton_kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def in_apply_kernel(y_ptr, m_ptr, s_ptr, S, C,
                            BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
            pid_s = tl.program_id(0)
            pid_c = tl.program_id(1)
            b = tl.program_id(2)
            rows = pid_s * BLOCK_S + tl.arange(0, BLOCK_S)
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            # mean and scale are cast to bf16 before the apply, as the
            # reference does; each op then rounds to bf16 like the eager
            # bf16 expression in the plain version
            m = tl.load(m_ptr + b * C + cols, mask=cmask, other=0.0)
            s = tl.load(s_ptr + b * C + cols, mask=cmask, other=0.0)
            m = m.to(tl.bfloat16).to(tl.float32)
            s = s.to(tl.bfloat16).to(tl.float32)
            offs = ((b * S + rows).to(tl.int64))[:, None] * C + cols[None, :]
            mask = (rows < S)[:, None] & cmask[None, :]
            x = tl.load(y_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            t = (x - m[None, :]).to(tl.bfloat16).to(tl.float32)
            # relu commutes with the round to bf16
            r = tl.maximum(t * s[None, :], 0.0)
            tl.store(y_ptr + offs, r.to(tl.bfloat16), mask=mask)

        _triton_kernel = (triton, in_apply_kernel)
    return _triton_kernel


def in_apply(y: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K2.  ``y`` (B, D, H, W, C); ``mean``/``scale`` (B, C) f32.  On the
    card it overwrites ``y`` with relu((y - m) * s) and returns it."""
    if y.device.type == "cpu":
        return in_apply_plain(y, mean, scale)
    if y.dtype != _BF16 or not y.is_contiguous() or y.dim() != 5:
        raise TypeError("in_apply on the card takes a contiguous bf16 (B,D,H,W,C) tensor")
    b, c = y.shape[0], y.shape[4]
    s = y.shape[1] * y.shape[2] * y.shape[3]
    mean = mean.to(torch.float32).contiguous()
    scale = scale.to(torch.float32).contiguous()
    if tuple(mean.shape) != (b, c) or tuple(scale.shape) != (b, c):
        raise ValueError("mean/scale must be (B, C)")
    triton, kernel = _in_apply_triton()
    block_c = min(128, triton.next_power_of_2(c))
    block_s = max(16, 8192 // block_c)
    grid = (triton.cdiv(s, block_s), triton.cdiv(c, block_c), b)
    kernel[grid](y, mean, scale, s, c, BLOCK_S=block_s, BLOCK_C=block_c, num_warps=8)
    launches["in_apply"] += 1
    return y


def in_stats(stats: torch.Tensor, n: int, eps: float = 1e-5):
    """(B, 2, C) sums -> (mean, scale) in f32, the reference's variance form."""
    mean = stats[:, 0] / n
    var = torch.clamp(stats[:, 1] / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def conv3d_in_relu(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """relu(instance_norm(conv3x3(concat(parts)) + bias)) through K1 + K2;
    matches ``wino_conv3d_in_relu_pallas``."""
    out, stats = conv3d(parts, weight, bias, with_stats=True)
    mean, scale = in_stats(stats, out.shape[1] * out.shape[2] * out.shape[3], eps)
    return in_apply(out, mean, scale)
