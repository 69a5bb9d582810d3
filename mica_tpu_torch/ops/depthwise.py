"""Depthwise 3x3x3 SAME conv + bias on channels-last tensors.

Counterpart of ``mica_tpu/ops/depthwise_pallas.py``.  K3 ``depthwise_conv3``
(CUDA C++, ``csrc/depthwise3.cu``) replaces ``depthwise_conv3_pallas``:
f32 accumulation with the f32 taps, output in the input's dtype.  It does
27 multiply-adds per element against one read and one write, so it is
bounded by device-memory bandwidth (see the source's note).

Training (``depthwise_conv3_ad``, the ``DepthwiseConv3Fn`` autograd
function, counterpart of ``depthwise_conv3_pallas_ad``) adds K7
``depthwise_grads`` (CUDA C++, ``csrc/depthwise3_grads.cu``), which
replaces ``_depthwise_conv3_grads``: the 27 tap gradients and the bias
gradient in one f32 pass over x and g, bounded by device-memory
bandwidth.

The weight is in torch grouped layout, (C, 1, 3, 3, 3).  Given CPU tensors
a wrapper runs its plain version; given CUDA tensors it launches its
kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

launches = {"depthwise3": 0, "depthwise3_grads": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_GRAD_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]


def depthwise_conv3_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: f32 grouped conv of the upcast input with the
    f32 taps and bias, cast to x's dtype."""
    c = x.shape[-1]
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.float(), bias.float(),
                 padding=1, groups=c)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def depthwise_conv3(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """K3.  x (B, D, H, W, C); weight (C, 1, 3, 3, 3); bias (C,)."""
    if x.device.type == "cpu":
        return depthwise_conv3_plain(x, weight, bias)
    b, d, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("depthwise_conv3 on the card takes a contiguous bf16 "
                        "tensor; f32 parity runs on the CPU")
    if tuple(weight.shape) != (c, 1, 3, 3, 3) or c % 8:
        raise ValueError(f"weight {tuple(weight.shape)} for C={c}: needs "
                         "(C,1,3,3,3) with C % 8 == 0")
    taps = weight.reshape(c, 27).t().to(device=x.device, dtype=torch.float32).contiguous()
    bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    err = _build.function("depthwise3", "depthwise3_bf16", _ARGS)(
        x.data_ptr(), taps.data_ptr(), bf.data_ptr(), out.data_ptr(),
        b, d, h, w, c, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "depthwise3")
    launches["depthwise3"] += 1
    return out


def depthwise_grads_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: (28, C) f32, rows 0..26 dk[tap] = Σ_p
    x[p + tap − 1]·g[p] in (dz, dy, dx) order, row 27 db = Σ_p g[p], from
    the f32 values of x and g."""
    b, d, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1, 1, 1))
    gf = g.float()
    rows = [(xp[:, dz:dz + d, dy:dy + h, dx:dx + w] * gf).sum(dim=(0, 1, 2, 3))
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return torch.stack(rows + [gf.sum(dim=(0, 1, 2, 3))])


def depthwise_grads(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7.  x, g (B, D, H, W, C) -> (28, C) f32: the 27 tap gradients of the
    depthwise conv and its bias gradient."""
    if x.device.type == "cpu":
        return depthwise_grads_plain(x, g)
    b, d, h, w, c = x.shape
    for t in (x, g):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.shape != x.shape:
            raise TypeError("depthwise_grads on the card takes contiguous bf16 x and g "
                            "of one shape")
    if c % 8:
        raise ValueError(f"depthwise_grads needs C % 8 == 0, got C={c}")
    out = torch.zeros((28, c), dtype=torch.float32, device=x.device)
    err = _build.function("depthwise3_grads", "depthwise3_grads_bf16", _GRAD_ARGS)(
        x.data_ptr(), g.data_ptr(), out.data_ptr(), b, d, h, w, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "depthwise3_grads")
    launches["depthwise3_grads"] += 1
    return out


class DepthwiseConv3Fn(torch.autograd.Function):
    """Depthwise conv with the reference's custom backward: forward K3;
    dx = K3 on g with the zyx-flipped taps and zero bias; dk (27 taps) and
    db in one K7 pass over x and g, in f32.  ``apply(x, weight, bias)``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return depthwise_conv3(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dk = db = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv3(g, weight.flip(2, 3, 4), torch.zeros_like(weight[:, 0, 0, 0, 0]))
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            sums = depthwise_grads(x, g)
            dk = sums[:27].t().reshape(weight.shape).to(weight.dtype)
            db = sums[27].to(weight.dtype)
        return dx, dk, db


def depthwise_conv3_ad(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Differentiable ``depthwise_conv3``; matches ``depthwise_conv3_pallas_ad``."""
    return DepthwiseConv3Fn.apply(x, weight, bias)
