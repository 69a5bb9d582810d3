"""Depthwise 3x3x3 SAME conv + bias on channels-last tensors.

Counterpart of ``mica_tpu/ops/depthwise_pallas.py``.  K3 ``depthwise_conv3``
(CUDA C++, ``csrc/depthwise3.cu``) replaces ``depthwise_conv3_pallas``:
f32 accumulation with the f32 taps, output in the input's dtype.  It does
27 multiply-adds per element against one read and one write, so it is
bounded by device-memory bandwidth (see the source's note).

The weight is in torch grouped layout, (C, 1, 3, 3, 3).  Given CPU tensors
the wrapper runs the plain version; given CUDA tensors it launches K3 or
raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

launches = {"depthwise3": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


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
