"""Fused 3x3x3 conv + InstanceNorm + ReLU on channels-last tensors.

Counterpart of ``mica_tpu/ops/wino_pallas.py``.  Two kernels, each beside
its plain PyTorch version:

  * K1 ``conv3d`` (CUDA C++, ``csrc/conv3d_stats.cu``): 3x3x3 SAME conv +
    bias over the channel concat of 1-3 operands, with the per-(batch,
    channel) sums of y and y^2 of the f32 value before the cast.  Replaces
    ``_wino_T``; bounded by the tensor cores (see the source's note).  Its
    tile plan (``k1_plan``) is computed here and handed to the kernel.
  * K2 ``in_apply`` (Triton): y = relu((y - mean) * scale) in place, with
    mean and scale cast to the tensor's dtype first.  Replaces
    ``_in_apply_T``.  One read and one write per element and a tiny
    per-(batch, channel) table: bounded by device-memory bandwidth alone;
    masked 2-D block loads move exactly those bytes.

``conv3d_in_relu`` chains them the way ``wino_conv3d_in_relu_pallas``
does: f32 statistics in the E[x^2]-E[x]^2 form, variance clamped at 0,
apply in the compute dtype.

The training path (``conv3d_in_relu_ad``, the ``Conv3dInReluFn`` autograd
function) adds three Triton kernels, the passes of the reference's
custom VJP ``wino_conv3d_in_relu_pallas_ad``:

  * K4 ``in_apply_ad``: y = relu(x̂) in place and x̂ = (c - m)·s
    (replaces ``_in_apply_ad_T``);
  * K5 ``in_bwd_stats``: per-(b, c) sums of g = dy·[x̂ > 0] and g·x̂
    (replaces ``_in_bwd_stats_T``), partials of voxel chunks summed in a
    fixed order (``k5_plan``);
  * K6 ``in_bwd_apply``: dc = s·(g − m1 − x̂·m2) (replaces
    ``_in_bwd_apply_T``).

Weights are in torch layout, (Co, sum Ci, 3, 3, 3).  A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches its kernel
or raises.  ``launches`` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from ._build import SMEM_MAX

launches = {"conv3d_stats": 0, "in_apply": 0, "in_apply_ad": 0, "in_bwd_stats": 0,
            "in_bwd_apply": 0}

_BF16 = torch.bfloat16


def _as_parts(parts) -> list:
    return list(parts) if isinstance(parts, (list, tuple)) else [parts]


def _tile(c: int, triton) -> Tuple[int, int]:
    """(BLOCK_S, BLOCK_C) of the Triton passes: up to 128 channels, ~8K
    elements a tile."""
    block_c = min(128, triton.next_power_of_2(c))
    return max(16, 8192 // block_c), block_c


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
_CONV_ARGS = [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I] + [_I] * 8 + [_P]

# (BN, MT) pairs compiled into ``csrc/conv3d_stats.cu`` (``K1_CONFIGS``
# there): N tile and m64 slices per consumer warpgroup.  MT 2 (a 256-voxel
# brick) up to BN 128 and MT 1 above: the fastest of MT 1, 2 and 4 on the
# H100.
K1_CONFIGS = ((256, 1), (192, 1), (128, 2), (96, 2), (64, 2), (32, 2))
K1_MT = dict(K1_CONFIGS)
MAX_STAGES = 8


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


@dataclass(frozen=True)
class K1Plan:
    """K1's tile plan, handed to the kernel as it is.

    ``bk`` channels a K step (one tap, one part), swizzled ``2 * bk``
    bytes; ``bn`` output channels an N tile, ``n_tiles`` of them; ``mt``
    m64 slices per consumer warpgroup, so a brick of ``bm = 128 * mt``
    voxels ``brick = (bw, bh, bd)``; ``bricks`` per axis (x, y, z) of one
    sample; ``stages`` of the TMA ring; ``ctas`` persistent blocks, in
    clusters of two that share each weight tile (each loads half and
    multicasts it): a cluster's tile is two adjacent bricks."""

    cis: Tuple[int, ...]
    co: int
    shape: Tuple[int, int, int, int]
    bk: int
    bn: int
    n_tiles: int
    mt: int
    brick: Tuple[int, int, int]
    bricks: Tuple[int, int, int]
    stages: int
    ctas: int

    @property
    def bm(self) -> int:
        return 128 * self.mt

    @property
    def n_bricks(self) -> int:
        nbx, nby, nbz = self.bricks
        return self.shape[0] * nbx * nby * nbz

    @property
    def tiles(self) -> int:
        """Tiles of the CTAs, two per cluster tile (the last partner of an
        odd brick count idle)."""
        return 2 * (-(-self.n_bricks // 2)) * self.n_tiles

    @property
    def ksteps(self) -> int:
        return 27 * sum(self.cis) // self.bk

    @property
    def stage_bytes(self) -> int:
        return -(-(self.bm * self.bk * 2 + self.bn * self.bk * 2) // 1024) * 1024

    @property
    def smem(self) -> int:
        """Dynamic shared memory: 1024 B of alignment slack, the ring, its
        full/empty barriers and the (2, Co) f32 statistics."""
        return 1024 + self.stages * (self.stage_bytes + 16) + 8 * self.co

    def tile(self, t: int) -> Optional[Tuple[int, int, int, int, int]]:
        """(b, x0, y0, z0, n0) of tile ``t`` = 2 * cluster tile + CTA rank,
        or None for an idle partner: brick pairs in order, the N tiles of a
        pair adjacent (the kernel's ``decode``)."""
        nbx, nby, nbz = self.bricks
        bw, bh, bd = self.brick
        pair, rank = divmod(t, 2)
        pb, nt = divmod(pair, self.n_tiles)
        brick = 2 * pb + rank
        if brick >= self.n_bricks:
            return None
        brick, bx = divmod(brick, nbx)
        brick, by = divmod(brick, nby)
        b, bz = divmod(brick, nbz)
        return b, bx * bw, by * bh, bz * bd, nt * self.bn

    def ksteps_of(self):
        """(dz, dy, dx, part, channel, weight column) of each K step, in
        the producer's order: taps, then parts, then BK channel blocks."""
        kw = 0
        for tap in range(27):
            dz, dy, dx = tap // 9 - 1, (tap // 3) % 3 - 1, tap % 3 - 1
            for part, c in enumerate(self.cis):
                for c0 in range(0, c, self.bk):
                    yield dz, dy, dx, part, c0, kw
                    kw += self.bk


def k1_takes(cis: Sequence[int], co: int) -> bool:
    """K1's width rule: 1-3 parts, every Ci and Co a positive multiple of
    32.  A site K1 takes, K1's training dx conv takes too (Co in, sum Ci
    out).  The model routes the sites it refuses to the library convs."""
    return (1 <= len(cis) <= 3 and all(c > 0 and c % 32 == 0 for c in cis)
            and co > 0 and co % 32 == 0)


def k1_plan(cis: Sequence[int], co: int, shape: Sequence[int], sm_count: int = 132) -> K1Plan:
    """The tile plan of K1 for parts of channels ``cis``, ``co`` outputs
    and volume ``shape`` (B, D, H, W).  Raises ``ValueError`` for widths the
    kernel does not take (``k1_takes``)."""
    cis = tuple(int(c) for c in cis)
    b, d, h, w = (int(v) for v in shape)
    if not k1_takes(cis, co):
        raise ValueError(f"K1 takes 1-3 parts with Ci % 32 == 0 and Co % 32 == 0, got "
                         f"{list(cis)} -> {co}")
    bk = 64 if all(c % 64 == 0 for c in cis) else 32
    n_tiles = next(n for n in range(1, co // 32 + 1)
                   if co % n == 0 and co // n in K1_MT)
    bn = co // n_tiles
    mt = K1_MT[bn]
    bm = 128 * mt
    bw = min(_pow2_at_least(w), bm, 256)
    bh = min(_pow2_at_least(h), bm // bw, 256)
    bd = bm // (bw * bh)
    while bd > 256:
        if bw < 256:
            bw *= 2
        else:
            bh *= 2
        bd //= 2
    bricks = (-(-w // bw), -(-h // bh), -(-d // bd))
    plan = K1Plan(cis, co, (b, d, h, w), bk, bn, n_tiles, mt, (bw, bh, bd), bricks, 2, 1)
    stages = min(MAX_STAGES, (SMEM_MAX - 1024 - 8 * co) // (plan.stage_bytes + 16))
    if stages < 2:
        raise ValueError(f"K1: no two stages of {plan.stage_bytes} bytes fit beside Co {co}")
    return replace(plan, stages=stages, ctas=min(sm_count // 2 * 2, plan.tiles))


def k1_sites(base: int = 64):
    """(parts' channels, Co, stats) of every K1 launch in one MICA forward
    at width ``base``: per stage the RDB convs and the transition, then the
    heads' conv1 (no statistics)."""
    sites = []
    c = base
    for _ in range(3):
        h = c // 2
        sites += [([c], h, True), ([c, h], h, True), ([c, h, h], c, True), ([c], 2 * c, True)]
        c *= 2
    sites.append(([base] * 3, 192, False))
    return sites


def k1_dx_sites(base: int = 64):
    """{(Ci, Co): launches per training step} of K1's dx convs: one part
    of a forward site's Co in, that site's summed Ci out, statistics and
    bias off (``Conv3dInReluFn.backward``)."""
    sites = {}
    for cis, co, stats in k1_sites(base):
        if stats:
            sites[(co, sum(cis))] = sites.get((co, sum(cis)), 0) + 1
    return sites


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Co, Ci, 3, 3, 3) -> (Co, 27 * Ci) bf16, [co][tap][ci]: K1's B operand,
    K-major as wgmma reads it."""
    co = weight.shape[0]
    return weight.permute(0, 2, 3, 4, 1).reshape(co, -1).to(_BF16).contiguous()


def conv3d(parts, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           with_stats: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1.  ``parts``: 1-3 tensors (B, D, H, W, Ci_k) standing for their
    channel concat; ``weight`` (Co, sum Ci_k, 3, 3, 3); ``bias`` (Co,) or
    None.  Returns (out (B, D, H, W, Co) in the parts' dtype, stats
    (B, 2, Co) f32 or None).  On the card every part must be contiguous
    bf16 at a 16-byte-aligned address (TMA reads it in place)."""
    parts = _as_parts(parts)
    if parts[0].device.type == "cpu":
        return conv3d_plain(parts, weight, bias, with_stats)
    if not 1 <= len(parts) <= 3:
        raise ValueError(f"conv3d takes 1-3 operands, got {len(parts)}")
    b, d, h, w = parts[0].shape[:4]
    for p in parts:
        if p.device != parts[0].device or p.dtype != _BF16 or not p.is_contiguous():
            raise TypeError("conv3d on the card takes contiguous bf16 operands on "
                            "one device; the model routes f32 to the library convs")
        if p.dim() != 5 or tuple(p.shape[:4]) != (b, d, h, w):
            raise ValueError(f"operand shape {tuple(p.shape)}: needs (B,D,H,W,Ci) "
                             "with a shared (B,D,H,W)")
        if p.data_ptr() % 16:
            raise ValueError("conv3d on the card reads each operand by TMA, which needs "
                             "a 16-byte-aligned address; this operand is not (it is not "
                             "copied)")
    cis = [p.shape[4] for p in parts]
    co = weight.shape[0]
    if tuple(weight.shape[1:]) != (sum(cis), 3, 3, 3):
        raise ValueError(f"weight shape {tuple(weight.shape)} for Ci {sum(cis)}")
    # the widths K1 takes (``k1_takes``): ``k1_plan`` raises for the others
    plan = k1_plan(cis, co, (b, d, h, w), _build.sm_count(parts[0].device))
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
        None if stats is None else stats.data_ptr(), b, d, h, w, co,
        plan.bk, plan.bn, plan.mt, *plan.brick, plan.stages, plan.ctas,
        torch.cuda.current_stream(out.device).cuda_stream)
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
    block_s, block_c = _tile(c, triton)
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
    matches ``wino_conv3d_in_relu_pallas``.  Not differentiable: training
    takes ``conv3d_in_relu_ad``."""
    out, stats = conv3d(parts, weight, bias, with_stats=True)
    mean, scale = in_stats(stats, out.shape[1] * out.shape[2] * out.shape[3], eps)
    return in_apply(out, mean, scale)


# ---------------------------------------------------------------------------
# K4-K6: the InstanceNorm + ReLU passes of the training path
# ---------------------------------------------------------------------------
#
# All three are Triton, one pass over the voxels with a per-(batch,
# channel) table, and bounded by device-memory bandwidth alone (a few
# flops per 2-byte element).  Tiles are (BLOCK_S voxels, BLOCK_C
# channels) of the channels-last tensor, so a row of a tile is one
# voxel's contiguous channel run.


def _check_bf16_5d(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != _BF16 or not t.is_contiguous() or t.dim() != 5 or t.shape != ts[0].shape:
            raise TypeError(f"{name} on the card takes contiguous bf16 (B,D,H,W,C) "
                            "tensors of one shape")


def _check_table(name: str, b: int, c: int, *ts: torch.Tensor) -> list:
    out = [t.to(torch.float32).contiguous() for t in ts]
    if any(tuple(t.shape) != (b, c) for t in out):
        raise ValueError(f"{name}: the per-channel tables must be (B, C) = ({b}, {c})")
    return out


def in_apply_ad_plain(c: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor):
    """Plain version of K4: x̂ = (c - m) * s in c's dtype (m, s cast to it
    first, each op rounded), y = relu(x̂) taken through f32.  Returns
    (y, x̂) out of place."""
    dt = c.dtype
    m = mean.to(dt)[:, None, None, None, :]
    s = scale.to(dt)[:, None, None, None, :]
    xh = (c - m) * s
    return torch.relu(xh.float()).to(dt), xh


def in_bwd_stats_plain(xh: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: (B, 2, C) f32 sums over the voxels of
    g = dy·[x̂ > 0] and g·x̂, products of the f32 values."""
    xf = xh.float()
    g = torch.where(xf > 0, dy.float(), 0.0)
    return torch.stack([g.sum(dim=(1, 2, 3)), (g * xf).sum(dim=(1, 2, 3))], dim=1)


def in_bwd_apply_plain(xh: torch.Tensor, dy: torch.Tensor, m1: torch.Tensor,
                       m2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: dc = s·(g − m1 − x̂·m2) in x̂'s dtype, g =
    dy·[x̂ > 0], with the (B, C) f32 m1, m2 and s cast to that dtype and
    each op rounded, as ``_bwd_apply_kernel`` does."""
    dt = xh.dtype
    g = torch.where(xh.float() > 0, dy, torch.zeros((), dtype=dy.dtype)).to(dt)
    m1, m2, s = (t.to(dt)[:, None, None, None, :] for t in (m1, m2, scale))
    return s * (g - m1 - xh * m2)


_round_bf16 = None


def round_bf16_jit():
    """The Triton helper ``round_bf16(x)``: f32 -> nearest bf16 (ties to
    even) -> f32 in integer ops, a rounding that no compiler contracts
    away (with plain casts K6's card result differed from the eager
    expression by an ulp of x̂·m2 where (g - m1) and x̂·m2 cancel).  Built
    on first use; K6 and K11 call it."""
    global _round_bf16
    if _round_bf16 is None:
        import triton
        import triton.language as tl

        @triton.jit
        def round_bf16(x):
            bits = x.to(tl.int32, bitcast=True)
            bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & -65536
            return bits.to(tl.float32, bitcast=True)

        _round_bf16 = round_bf16
    return _round_bf16


_ad_kernels = None


def _ad_triton():
    global _ad_kernels
    if _ad_kernels is None:
        import triton
        import triton.language as tl

        round_bf16 = round_bf16_jit()

        @triton.jit
        def in_apply_ad_kernel(y_ptr, xh_ptr, m_ptr, s_ptr, S, C,
                               BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
            pid_s = tl.program_id(0)
            pid_c = tl.program_id(1)
            b = tl.program_id(2)
            rows = pid_s * BLOCK_S + tl.arange(0, BLOCK_S)
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            m = tl.load(m_ptr + b * C + cols, mask=cmask, other=0.0)
            s = tl.load(s_ptr + b * C + cols, mask=cmask, other=0.0)
            m = m.to(tl.bfloat16).to(tl.float32)
            s = s.to(tl.bfloat16).to(tl.float32)
            offs = ((b * S + rows).to(tl.int64))[:, None] * C + cols[None, :]
            mask = (rows < S)[:, None] & cmask[None, :]
            x = tl.load(y_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            t = (x - m[None, :]).to(tl.bfloat16).to(tl.float32)
            xh = (t * s[None, :]).to(tl.bfloat16)
            tl.store(xh_ptr + offs, xh, mask=mask)
            # relu of the rounded x̂ is exact in bf16
            tl.store(y_ptr + offs, tl.maximum(xh.to(tl.float32), 0.0).to(tl.bfloat16),
                     mask=mask)

        @triton.jit
        def in_bwd_stats_kernel(xh_ptr, dy_ptr, buf_ptr, S, C, CHUNK, N_CHUNKS,
                                BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
            pid_s = tl.program_id(0)
            pid_c = tl.program_id(1)
            b = tl.program_id(2)
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            # tile-shaped sums: each tile is added elementwise, and the rows
            # are reduced once, after the loop
            acc_g = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
            acc_gx = tl.zeros((BLOCK_S, BLOCK_C), dtype=tl.float32)
            start = pid_s * CHUNK
            for s0 in range(start, tl.minimum(start + CHUNK, S), BLOCK_S):
                rows = s0 + tl.arange(0, BLOCK_S)
                offs = ((b * S + rows).to(tl.int64))[:, None] * C + cols[None, :]
                mask = (rows < S)[:, None] & cmask[None, :]
                xh = tl.load(xh_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
                g = tl.where(xh > 0, dy, 0.0)
                acc_g += g
                acc_gx += g * xh
            # this chunk's two partial rows: (B + b·N_CHUNKS + chunk, :, :) of
            # the (B·(1 + N_CHUNKS), 2, C) buffer, after the B rows of sums
            row = (tl.num_programs(2) + b * N_CHUNKS + pid_s) * 2 * C
            tl.store(buf_ptr + row + cols, tl.sum(acc_g, axis=0), mask=cmask)
            tl.store(buf_ptr + row + C + cols, tl.sum(acc_gx, axis=0), mask=cmask)

        @triton.jit
        def in_bwd_stats_sum_kernel(buf_ptr, C, N_CHUNKS,
                                    BLOCK_R: tl.constexpr, BLOCK_C: tl.constexpr):
            # buf[b, k, c] = the sum over the chunks of the partials, in a
            # fixed order: BLOCK_R rows at a time, then across them
            pid_c = tl.program_id(0)
            k = tl.program_id(1)
            b = tl.program_id(2)
            first = tl.num_programs(2) + b * N_CHUNKS
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            acc = tl.zeros((BLOCK_R, BLOCK_C), dtype=tl.float32)
            for r0 in range(0, N_CHUNKS, BLOCK_R):
                r = r0 + tl.arange(0, BLOCK_R)
                offs = ((first + r) * 2 + k)[:, None] * C + cols[None, :]
                acc += tl.load(buf_ptr + offs, mask=(r < N_CHUNKS)[:, None] & cmask[None, :],
                               other=0.0)
            tl.store(buf_ptr + (b * 2 + k) * C + cols, tl.sum(acc, axis=0), mask=cmask)

        @triton.jit
        def in_bwd_apply_kernel(xh_ptr, dy_ptr, dc_ptr, m1_ptr, m2_ptr, s_ptr, S, C,
                                BLOCK_S: tl.constexpr, BLOCK_C: tl.constexpr):
            pid_s = tl.program_id(0)
            pid_c = tl.program_id(1)
            b = tl.program_id(2)
            rows = pid_s * BLOCK_S + tl.arange(0, BLOCK_S)
            cols = pid_c * BLOCK_C + tl.arange(0, BLOCK_C)
            cmask = cols < C
            m1 = tl.load(m1_ptr + b * C + cols, mask=cmask, other=0.0)
            m2 = tl.load(m2_ptr + b * C + cols, mask=cmask, other=0.0)
            s = tl.load(s_ptr + b * C + cols, mask=cmask, other=0.0)
            m1 = round_bf16(m1)
            m2 = round_bf16(m2)
            s = round_bf16(s)
            offs = ((b * S + rows).to(tl.int64))[:, None] * C + cols[None, :]
            mask = (rows < S)[:, None] & cmask[None, :]
            xh = tl.load(xh_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.where(xh > 0, dy, 0.0)
            # each op rounds to bf16, as the eager bf16 expression does
            t1 = round_bf16(g - m1[None, :])
            t2 = round_bf16(xh * m2[None, :])
            t3 = round_bf16(t1 - t2)
            tl.store(dc_ptr + offs, (s[None, :] * t3).to(tl.bfloat16), mask=mask)

        _ad_kernels = (triton, in_apply_ad_kernel, (in_bwd_stats_kernel, in_bwd_stats_sum_kernel),
                       in_bwd_apply_kernel)
    return _ad_kernels


def in_apply_ad(c: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor):
    """K4, replaces ``_in_apply_ad_T``.  ``c`` (B, D, H, W, C) conv output;
    ``mean``/``scale`` (B, C) f32.  Returns (y, x̂); on the card y is
    written over ``c`` and x̂ into a new tensor."""
    if c.device.type == "cpu":
        return in_apply_ad_plain(c, mean, scale)
    _check_bf16_5d("in_apply_ad", c)
    b, ch = c.shape[0], c.shape[4]
    s = c.shape[1] * c.shape[2] * c.shape[3]
    mean, scale = _check_table("in_apply_ad", b, ch, mean, scale)
    triton, kernel, _, _ = _ad_triton()
    xh = torch.empty_like(c)
    block_s, block_c = _tile(ch, triton)
    grid = (triton.cdiv(s, block_s), triton.cdiv(ch, block_c), b)
    kernel[grid](c, xh, mean, scale, s, ch, BLOCK_S=block_s, BLOCK_C=block_c, num_warps=8)
    launches["in_apply_ad"] += 1
    return c, xh


# K5 is a reduction bounded by device-memory bandwidth alone (4 bytes read
# an element, a few f32 flops).  A program sums a chunk of voxels for one
# block of up to 128 channels (all of them up to C = 128, so its loads are
# whole rows) into tile-shaped f32 accumulators, reduces across rows once at
# the end, and writes its two partial rows to a buffer; a second kernel
# sums the chunks in a fixed order into the buffer's first rows.  No atomics and no zero fill: two calls
# give the same bits.
K5_TILE = 4096            # elements of a (BLOCK_S, BLOCK_C) tile: 16 a thread
K5_WARPS = 8
K5_PROGRAMS_PER_SM = 8    # two waves of four resident 8-warp programs
K5_SUM_ROWS = 32          # chunks a step of the sum kernel


@dataclass(frozen=True)
class K5Plan:
    """K5's plan for x̂, dy of ``shape`` (B, D, H, W, C): programs of
    ``block_s`` voxels x ``block_c`` channels a tile, each summing ``chunk``
    voxels (a multiple of ``block_s``) of one sample and channel block."""

    shape: Tuple[int, int, int, int, int]
    block_s: int
    block_c: int
    chunk: int

    @property
    def voxels(self) -> int:
        _, d, h, w, _ = self.shape
        return d * h * w

    @property
    def n_c(self) -> int:
        return -(-self.shape[4] // self.block_c)

    @property
    def n_chunks(self) -> int:
        return -(-self.voxels // self.chunk)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(chunks, channel blocks, samples) of the kernel that sums the
        voxels."""
        return self.n_chunks, self.n_c, self.shape[0]

    @property
    def programs(self) -> int:
        return self.n_chunks * self.n_c * self.shape[0]

    @property
    def buffer(self) -> Tuple[int, int, int]:
        """The f32 buffer of both kernels, (B·(1 + chunks), 2, C): the sums
        of sample b in row b, the partials of its chunk i in row
        B + b·chunks + i."""
        return self.shape[0] * (1 + self.n_chunks), 2, self.shape[4]

    @property
    def sum_grid(self) -> Tuple[int, int, int]:
        """(channel blocks, 2, samples) of the kernel that sums the chunks."""
        return self.n_c, 2, self.shape[0]

    def rows(self, i: int) -> Tuple[int, int]:
        """The voxels [start, stop) that chunk ``i`` sums."""
        return i * self.chunk, min((i + 1) * self.chunk, self.voxels)


@functools.lru_cache(maxsize=64)
def k5_plan(shape: Sequence[int], sm_count: int = 132) -> K5Plan:
    """K5's plan for (B, D, H, W, C): about ``K5_PROGRAMS_PER_SM`` programs
    an SM in all, whatever the batch and width."""
    b, d, h, w, c = (int(v) for v in shape)
    block_c = min(128, _pow2_at_least(c))
    block_s = K5_TILE // block_c
    tiles = -(-(d * h * w) // block_s)
    per = max(1, K5_PROGRAMS_PER_SM * sm_count // (b * -(-c // block_c)))
    n = min(tiles, per)
    return K5Plan((b, d, h, w, c), block_s, block_c, -(-tiles // n) * block_s)


# (plan, device, x̂ and dy 16-byte aligned) -> K5's two compiled kernels and
# their launchers.  Triton specialises a kernel on its integer arguments (all
# fixed by the plan) and on its pointers' alignment, so one pair serves a key.
k5_kernels: dict = {}


def in_bwd_stats(xh: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K5, replaces ``_in_bwd_stats_T``.  Per-(b, c) sums of g = dy·[x̂>0]
    and g·x̂ over the voxels: (B, 2, C) f32, in a fixed order (``k5_plan``)."""
    if xh.device.type == "cpu":
        return in_bwd_stats_plain(xh, dy)
    _check_bf16_5d("in_bwd_stats", xh, dy)
    plan = k5_plan(xh.shape, _build.sm_count(xh.device))
    b, ch = plan.shape[0], plan.shape[4]
    buf = torch.empty(plan.buffer, dtype=torch.float32, device=xh.device)
    args = (xh, dy, buf, plan.voxels, ch, plan.chunk, plan.n_chunks, plan.block_s,
            plan.block_c)
    sum_args = (buf, ch, plan.n_chunks, K5_SUM_ROWS, plan.block_c)
    key = (plan, xh.device, xh.data_ptr() % 16 == 0, dy.data_ptr() % 16 == 0)
    compiled = k5_kernels.get(key)
    if compiled is None:
        # the first call of a key compiles through Triton's dispatcher; later
        # calls launch the compiled pair directly, without the dispatcher's
        # per-call binding and cache lookup, most of the host's time a call
        _, _, (kernel, sum_kernel), _ = _ad_triton()
        k = kernel[plan.grid](*args[:7], BLOCK_S=plan.block_s, BLOCK_C=plan.block_c,
                              num_warps=K5_WARPS)
        s = sum_kernel[plan.sum_grid](*sum_args[:3], BLOCK_R=K5_SUM_ROWS,
                                      BLOCK_C=plan.block_c, num_warps=4)
        k5_kernels[key] = (k, s, k[plan.grid], s[plan.sum_grid])
    else:
        compiled[2](*args)
        compiled[3](*sum_args)
    launches["in_bwd_stats"] += 1
    return buf[:b]


def in_bwd_apply(xh: torch.Tensor, dy: torch.Tensor, m1: torch.Tensor,
                 m2: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K6, replaces ``_in_bwd_apply_T``: dc = s·(g − m1 − x̂·m2) into a new
    tensor; m1, m2, s (B, C) f32."""
    if xh.device.type == "cpu":
        return in_bwd_apply_plain(xh, dy, m1, m2, scale)
    _check_bf16_5d("in_bwd_apply", xh, dy)
    b, ch = xh.shape[0], xh.shape[4]
    s = xh.shape[1] * xh.shape[2] * xh.shape[3]
    m1, m2, scale = _check_table("in_bwd_apply", b, ch, m1, m2, scale)
    triton, _, _, kernel = _ad_triton()
    dc = torch.empty_like(xh)
    block_s, block_c = _tile(ch, triton)
    grid = (triton.cdiv(s, block_s), triton.cdiv(ch, block_c), b)
    kernel[grid](xh, dy, dc, m1, m2, scale, s, ch, BLOCK_S=block_s, BLOCK_C=block_c,
                 num_warps=8)
    launches["in_bwd_apply"] += 1
    return dc


def _ncdhw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 4, 1, 2, 3)


class Conv3dInReluFn(torch.autograd.Function):
    """relu(instance_norm(conv3x3(concat(parts)) + bias)) with the custom
    backward of ``wino_conv3d_in_relu_pallas_ad``:

      forward   K1 (with statistics) -> ``in_stats`` -> K4, saving the
                parts, the weight, x̂ and the (B, Co) f32 scale;
      backward  K5 -> m1, m2 = sums / n -> K6 gives dc;
                dx = K1 on dc with the zyx-flipped, Ci<->Co swapped
                weight, no bias and no statistics, split per part;
                dk = the library's weight-grad conv per part, in the parts'
                dtype (one rounding of the f32 accumulation), cast to f32
                once at the end, as the reference's XLA weight-grad does;
                db = 0 exactly: InstanceNorm subtracts each channel's mean,
                so a constant shift never reaches y.

    ``apply(weight, bias, eps, *parts)``."""

    @staticmethod
    def forward(ctx, weight, bias, eps, *parts):
        out, stats = conv3d(list(parts), weight, bias, with_stats=True)
        mean, scale = in_stats(stats, out.shape[1] * out.shape[2] * out.shape[3], eps)
        y, xh = in_apply_ad(out, mean, scale)
        ctx.save_for_backward(weight, xh, scale, *parts)
        return y

    @staticmethod
    def backward(ctx, dy):
        weight, xh, scale, *parts = ctx.saved_tensors
        dy = dy.to(xh.dtype).contiguous()
        n = xh.shape[1] * xh.shape[2] * xh.shape[3]
        gstats = in_bwd_stats(xh, dy)
        dc = in_bwd_apply(xh, dy, gstats[:, 0] / n, gstats[:, 1] / n, scale)
        dparts = [None] * len(parts)
        if any(ctx.needs_input_grad[3:]):
            dx, _ = conv3d([dc], weight.flip(2, 3, 4).transpose(0, 1), None, with_stats=False)
            offs = 0
            for i, p in enumerate(parts):
                dparts[i] = dx[..., offs:offs + p.shape[-1]]
                offs += p.shape[-1]
        dweight = dbias = None
        if ctx.needs_input_grad[0]:
            dks = [torch.nn.grad.conv3d_weight(_ncdhw(p), (weight.shape[0], p.shape[-1], 3, 3, 3),
                                               _ncdhw(dc.to(p.dtype)), padding=1)
                   for p in parts]
            dweight = torch.cat(dks, dim=1).to(weight.dtype)
        if ctx.needs_input_grad[1]:
            dbias = torch.zeros_like(weight[:, 0, 0, 0, 0])
        return (dweight, dbias, None, *dparts)


def conv3d_in_relu_ad(parts: Sequence[torch.Tensor], weight: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Differentiable ``conv3d_in_relu`` (K1, K4 forward; K5, K6, K1 and a
    library weight-grad backward); matches ``wino_conv3d_in_relu_pallas_ad``."""
    return Conv3dInReluFn.apply(weight, bias, eps, *_as_parts(parts))
