"""The multi-scale input stem: four Cin=1 SAME convs as one 9^3 conv + bias.

Counterpart of ``mica_tpu/ops/stem_pallas.py``.  K8 ``stem_conv`` (CUDA
C++, ``csrc/stem9.cu``) replaces ``stem_conv_pallas``: x and the 9^3
weights in the compute dtype, every product accumulated in f32, the bias
added in f32, one cast to x's dtype.  The source's note says what bounds it.

The weight travels packed, ``pack_weight``: (C, 832) with the taps of each
(dz, dy) row at ``(dz*9 + dy)*10 + dx`` and zeros elsewhere, the order the
kernel streams.  It is derived once from the four convs' weights (the
model caches it), not per call.

Given a CPU tensor the wrapper runs its plain version; given a CUDA tensor
it launches the kernel or raises.  The kernel has no backward: on the card
the wrapper refuses tensors that autograd records.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

launches = {"stem9": 0}

K = 9
ROW_TAPS = 10          # 9 taps of a (dz, dy) row and one zero
K_PACKED = 832         # 81 * 10 = 810 taps, padded to 26 * 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def combine_weights(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """(c_i, 1, k_i, k_i, k_i) kernels, k_i odd and <= 9, zero-embedded in
    9^3 and stacked: (sum c_i, 1, 9, 9, 9)."""
    return torch.cat([F.pad(w, ((K - w.shape[-1]) // 2,) * 6) for w in weights], dim=0)


def pack_weight(w9: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(C, 1, 9, 9, 9) -> the packed (C, 832) weight, rounded to ``dtype``."""
    c = w9.shape[0]
    rows = F.pad(w9.reshape(c, K * K, K), (0, ROW_TAPS - K)).reshape(c, K * K * ROW_TAPS)
    return F.pad(rows, (0, K_PACKED - rows.shape[1])).to(dtype).contiguous()


def unpack_weight(packed: torch.Tensor) -> torch.Tensor:
    """The packed (C, 832) weight back as (C, 1, 9, 9, 9)."""
    c = packed.shape[0]
    rows = packed[:, :K * K * ROW_TAPS].reshape(c, K * K, ROW_TAPS)[..., :K]
    return rows.reshape(c, 1, K, K, K)


def stem_conv_plain(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the 9^3 SAME conv of the upcast input with the
    upcast weight in f32, the f32 bias, one cast to x's dtype."""
    y = F.conv3d(x.float()[:, None], unpack_weight(packed).float(), bias.float(), padding=K // 2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def stem_conv(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K8.  x (B, D, H, W); packed (C, 832) from ``pack_weight`` in x's dtype;
    bias (C,) -> (B, D, H, W, C) in x's dtype.  Any D, H, W."""
    if x.dim() != 4 or packed.dim() != 2 or packed.shape[1] != K_PACKED:
        raise ValueError(f"stem_conv: x {tuple(x.shape)}, packed weight {tuple(packed.shape)}; "
                         f"needs (B, D, H, W) and (C, {K_PACKED})")
    if packed.dtype != x.dtype or packed.device != x.device:
        raise TypeError(f"stem_conv: weight {packed.dtype} on {packed.device} for x "
                        f"{x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return stem_conv_plain(x, packed, bias)
    b, d, h, w = x.shape
    c = packed.shape[0]
    if torch.is_grad_enabled() and (x.requires_grad or packed.requires_grad or bias.requires_grad):
        raise RuntimeError("stem_conv has no backward on the card: call it under "
                           "torch.no_grad(), or run the model with train=True")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or not packed.is_contiguous():
        raise TypeError("stem_conv on the card takes contiguous bf16 tensors; the model "
                        "routes f32 to the library conv")
    if c % 32 or tuple(bias.shape) != (c,):
        raise ValueError(f"stem_conv needs C % 32 == 0 and a (C,) bias, got C={c}, "
                         f"bias {tuple(bias.shape)}")
    bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, d, h, w, c), dtype=x.dtype, device=x.device)
    err = _build.function("stem9", "stem9_bf16", _ARGS)(
        x.data_ptr(), packed.data_ptr(), bf.data_ptr(), out.data_ptr(), b, d, h, w, c,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stem9")
    launches["stem9"] += 1
    return out
