"""The multi-scale input stem: four Cin=1 SAME convs (k = 3, 5, 7, 9) + bias.

Counterpart of ``mica_tpu/ops/stem_pallas.py``.  K8 ``stem_conv`` (CUDA
C++, ``csrc/stem9.cu``) replaces ``stem_conv_pallas``: x and the weights in
the compute dtype, every product accumulated in f32, the bias added in f32,
one cast to x's dtype.  The source's note says what bounds it.

The kernel runs four GEMMs, one per kernel size, over the real taps only.
Its weight travels packed, ``pack_weight``: for group k (C/4 channels) the
k^2 (dz, dy) rows of k + 1 taps (the last one zero), padded to a multiple
of 16 (48 + 160 + 400 + 816 = ``K_TOTAL`` taps), cut into passes of ``NG``
channels (``k8_ng``) and laid out as wgmma reads B from shared memory:
per k16 step, 8 x 8 core matrices, [channel / 8][tap half][channel % 8]
[tap % 8].  It is derived once from the four convs' weights (the model
caches it), not per call.  The plain version computes the 9^3 conv of the
four kernels zero-embedded (``combine_weights``), as the JAX kernel does.

Given a CPU tensor the wrapper runs its plain version; given a CUDA tensor
it launches the kernel or raises.  The kernel has no backward: on the card
the wrapper refuses tensors that autograd records.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = {"stem9": 0}

K = 9
KS = (3, 5, 7, 9)
K_GROUP = tuple(-(-k * k * (k + 1) // 16) * 16 for k in KS)   # 48, 160, 400, 816
K_TOTAL = sum(K_GROUP)                                          # 1424
REAL_TAPS = sum(k ** 3 for k in KS)                             # 1224

# K8's tile and shared-memory layout (the constants of csrc/stem9.cu)
TILE = (4, 4, 16)              # (z, y, x) voxels a CTA computes at a time
HALO = (12, 12, 32)            # the tile's inputs, x from x0 - 8
COPY = 12 * 12 * 32 + 16       # elements of one copy of the halo
TABLE_WORDS = 4 * sum(-(-(kg // 16) // 4) * 4 for kg in K_GROUP)   # 384

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P] + [_I] * 8 + [_P]


def k8_ng(cg: int) -> int:
    """Channels of a group a pass computes (wgmma's N): 32, 16 or 8."""
    return 32 if cg % 32 == 0 else 16 if cg % 16 == 0 else 8


@dataclass(frozen=True)
class K8Plan:
    """K8's plan for x of ``shape`` (B, D, H, W) and ``c`` channels: tiles
    of ``TILE`` voxels, x fastest, then y, z, sample; ``passes`` of ``ng``
    channels of each group; ``ctas`` persistent CTAs, CTA i on pass
    i % passes, walking tiles i // passes, + ctas // passes, ..."""

    shape: Tuple[int, int, int, int]
    c: int
    ng: int
    ctas: int

    @property
    def cg(self) -> int:
        return self.c // 4

    @property
    def passes(self) -> int:
        return self.cg // self.ng

    @property
    def tiles(self) -> Tuple[int, int, int]:
        """Tiles per axis (z, y, x) of one sample."""
        _, d, h, w = self.shape
        return tuple(-(-n // t) for n, t in zip((d, h, w), TILE))

    @property
    def n_tiles(self) -> int:
        tz, ty, tx = self.tiles
        return self.shape[0] * tz * ty * tx

    @property
    def smem(self) -> int:
        """Dynamic shared memory: 1024 B of alignment slack, one pass's
        weight, four staging tiles, two halo slots of two copies, the offset
        table, the bias and a barrier."""
        tz, ty, tx = TILE
        weight = K_TOTAL * self.ng * 2
        stage = 4 * tz * ty * tx * self.ng * 2
        return 1024 + weight + stage + 2 * 2 * COPY * 2 + TABLE_WORDS * 4 + 4 * self.ng * 4 + 8

    @property
    def mma_ratio(self) -> float:
        """MACs issued (K_TOTAL taps for every voxel of every tile) over the
        four convs' real ones."""
        b, d, h, w = self.shape
        return self.n_tiles * TILE[0] * TILE[1] * TILE[2] * K_TOTAL / (b * d * h * w * REAL_TAPS)

    def tile(self, t: int) -> Tuple[int, int, int, int]:
        """(b, z0, y0, x0) of tile ``t``."""
        tz, ty, tx = self.tiles
        t, ix = divmod(t, tx)
        t, iy = divmod(t, ty)
        b, iz = divmod(t, tz)
        return b, iz * TILE[0], iy * TILE[1], ix * TILE[2]

    def cta_work(self, i: int) -> Tuple[int, range]:
        """(pass, tiles) of CTA ``i``."""
        return i % self.passes, range(i // self.passes, self.n_tiles, self.ctas // self.passes)


def k8_plan(shape: Sequence[int], c: int, sm_count: int = 132) -> K8Plan:
    """K8's plan for x (B, D, H, W) and ``c`` output channels: one CTA an
    SM, a whole number of them per pass.  Raises ``ValueError`` for a
    width the kernel does not take (C a multiple of 32)."""
    b, d, h, w = (int(v) for v in shape)
    if c <= 0 or c % 32:
        raise ValueError(f"K8 takes C % 32 == 0 (four groups of a multiple of 8), got C={c}")
    ng = k8_ng(c // 4)
    passes = c // 4 // ng
    plan = K8Plan((b, d, h, w), c, ng, passes)
    ctas = min(max(1, sm_count // passes) * passes, plan.n_tiles * passes)
    return K8Plan((b, d, h, w), c, ng, ctas)


def combine_weights(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """(c_i, 1, k_i, k_i, k_i) kernels, k_i odd and <= 9, zero-embedded in
    9^3 and stacked: (sum c_i, 1, 9, 9, 9)."""
    return torch.cat([F.pad(w, ((K - w.shape[-1]) // 2,) * 6) for w in weights], dim=0)


def _check_weights(weights: Sequence[torch.Tensor]) -> int:
    cg = weights[0].shape[0]
    if len(weights) != 4 or any(tuple(w.shape) != (cg, 1, k, k, k)
                                for w, k in zip(weights, KS)):
        raise ValueError("the stem takes four (C/4, 1, k, k, k) kernels, k = 3, 5, 7, 9; got "
                         f"{[tuple(w.shape) for w in weights]}")
    return cg


def pack_weight(weights: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The four convs' (C/4, 1, k, k, k) kernels -> K8's packed weight,
    (passes, K_TOTAL * NG) rounded to ``dtype``: per pass, per group, per
    k16 step, [channel / 8][tap half][channel % 8][tap % 8].  A group
    width that is not a multiple of NG (only the CPU takes one) is padded
    with zero channels."""
    cg = _check_weights(weights)
    ng = k8_ng(cg)
    passes = -(-cg // ng)
    blocks = []
    for w, k, kp in zip(weights, KS, K_GROUP):
        rows = F.pad(w.reshape(cg, k * k, k), (0, 1)).reshape(cg, k * k * (k + 1))
        flat = F.pad(rows, (0, kp - rows.shape[1], 0, passes * ng - cg))   # (passes * ng, kp)
        # (pass, n / 8, n % 8, step, half, tap % 8) -> (pass, step, n / 8, half, n % 8, tap % 8)
        t = flat.reshape(passes, ng // 8, 8, kp // 16, 2, 8).permute(0, 3, 1, 4, 2, 5)
        blocks.append(t.reshape(passes, -1))
    return torch.cat(blocks, dim=1).to(dtype).contiguous()


def _check_packed(packed: torch.Tensor, c: int) -> None:
    cg = c // 4
    ng = k8_ng(cg)
    if c % 4 or packed.dim() != 2 or tuple(packed.shape) != (-(-cg // ng), K_TOTAL * ng):
        raise ValueError(f"packed stem weight {tuple(packed.shape)} for C={c}: needs "
                         f"({-(-cg // ng)}, {K_TOTAL * ng}) from ``pack_weight``")


def unpack_weight(packed: torch.Tensor, c: int) -> List[torch.Tensor]:
    """The packed weight of ``c`` channels back as the four (C/4, 1, k, k,
    k) kernels."""
    _check_packed(packed, c)
    passes, width = packed.shape
    ng = width // K_TOTAL
    cg = c // 4
    out, off = [], 0
    for k, kp in zip(KS, K_GROUP):
        t = packed[:, off * ng:(off + kp) * ng].reshape(passes, kp // 16, ng // 8, 2, 8, 8)
        flat = t.permute(0, 2, 4, 1, 3, 5).reshape(passes * ng, kp)[:cg]
        rows = flat[:, :k * k * (k + 1)].reshape(cg, k * k, k + 1)[..., :k]
        out.append(rows.reshape(cg, 1, k, k, k))
        off += kp
    return out


def stem_conv_plain(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the 9^3 SAME conv of the upcast input with the
    four upcast kernels zero-embedded, the f32 bias, one cast to x's dtype
    into a contiguous (B, D, H, W, C), as the kernel writes it."""
    w9 = combine_weights(unpack_weight(packed, bias.shape[0])).float()
    y = F.conv3d(x.float()[:, None], w9, bias.float(), padding=K // 2)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype, memory_format=torch.contiguous_format)


def stem_conv(x: torch.Tensor, packed: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K8.  x (B, D, H, W); packed from ``pack_weight`` in x's dtype; bias
    (C,) -> (B, D, H, W, C) in x's dtype.  Any D, H, W; on the card C % 32
    == 0 (``k8_plan`` raises otherwise)."""
    if x.dim() != 4 or bias.dim() != 1:
        raise ValueError(f"stem_conv: x {tuple(x.shape)}, bias {tuple(bias.shape)}; needs "
                         "(B, D, H, W) and (C,)")
    c = bias.shape[0]
    _check_packed(packed, c)
    if packed.dtype != x.dtype or packed.device != x.device:
        raise TypeError(f"stem_conv: weight {packed.dtype} on {packed.device} for x "
                        f"{x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return stem_conv_plain(x, packed, bias)
    if torch.is_grad_enabled() and (x.requires_grad or packed.requires_grad or bias.requires_grad):
        raise RuntimeError("stem_conv has no backward on the card: call it under "
                           "torch.no_grad(), or run the model with train=True")
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or not packed.is_contiguous():
        raise TypeError("stem_conv on the card takes contiguous bf16 tensors; the model "
                        "routes f32 to the library conv")
    b, d, h, w = x.shape
    plan = k8_plan(x.shape, c, _build.sm_count(x.device))
    bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, d, h, w, c), dtype=x.dtype, device=x.device)
    err = _build.function("stem9", "stem9_bf16", _ARGS)(
        x.data_ptr(), packed.data_ptr(), bf.data_ptr(), out.data_ptr(), b, d, h, w, c,
        plan.ng, plan.ctas, plan.smem, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stem9")
    launches["stem9"] += 1
    return out
