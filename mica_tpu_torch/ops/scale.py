"""y = x·2: the elementwise scale of the layout probe.

Counterpart of ``copy_kernel`` in ``scripts/probe_layout_boundary.py``
(lines 35-66), which the probe launches on (B, D, H, W, C) and on the
transposed (D, H, W, B, C).  K13 ``scale2`` (CUDA C++,
``csrc/scale2.cu``): one flat pass over a contiguous bf16 tensor of any
shape, exact to the bit (doubling is exact in bf16), bounded by
device-memory bandwidth (see the source's note).

The wrapper refuses a tensor that is not contiguous instead of copying it:
the probe counts the copies that a layout costs, and a hidden
``.contiguous()`` here would be one of them.  Given a CPU tensor it runs
the plain version; given a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"scale2": 0}

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K13: x * 2 in x's dtype."""
    return x * 2


def scale2(x: torch.Tensor) -> torch.Tensor:
    """K13: a new tensor y = x * 2, of x's shape and dtype."""
    if x.device.type == "cpu":
        return scale2_plain(x)
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"scale2 on the card takes a contiguous bf16 tensor, got {x.dtype} "
                        f"with strides {x.stride()}: make it contiguous where that copy "
                        "belongs to the caller")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    err = _build.function("scale2", "scale2_bf16", _ARGS)(
        x.data_ptr(), y.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "scale2")
    launches["scale2"] += 1
    return y
