"""Depthwise 3x3x3 SAME conv + bias on channels-last tensors.

Counterpart of ``mica_tpu/ops/depthwise_pallas.py``.  K3 ``depthwise_conv3``
(CUDA C++, ``csrc/depthwise3.cu``) replaces ``depthwise_conv3_pallas``:
f32 accumulation with the f32 taps, output in the input's dtype.  It does
27 multiply-adds per element against one read and one write, so it is
bounded by device-memory bandwidth (see the source's note).  A block of
the kernel owns a (TY x TX) tile of (y, x) columns x CG channels of one
sample over a segment of z; its tile plan (``k3_plan``) is computed here
and handed to the kernel.

Training (``depthwise_conv3_ad``, the ``DepthwiseConv3Fn`` autograd
function, counterpart of ``depthwise_conv3_pallas_ad``) adds K7
``depthwise_grads`` (CUDA C++, ``csrc/depthwise3_grads.cu``), which
replaces ``_depthwise_conv3_grads``: the 27 tap gradients and the bias
gradient in one f32 pass over x and g, bounded by device-memory
bandwidth.  It walks the same tiles as K3 (``k7_plan``), writes one
partial a block and sums the partials in a fixed order, so two calls give
the same bits.

The weight is in torch grouped layout, (C, 1, 3, 3, 3).  Given CPU tensors
a wrapper runs its plain version; given CUDA tensors it launches its
kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = {"depthwise3": 0, "depthwise3_grads": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P] + [_I] * 10 + [_P]   # K3 and K7 alike


def depthwise_conv3_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: f32 grouped conv of the upcast input with the
    f32 taps and bias, cast to x's dtype."""
    c = x.shape[-1]
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.float(), bias.float(),
                 padding=1, groups=c)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


XT = 8                  # x positions a thread computes (``XT`` in both sources)
MAX_THREADS = 128       # K3's block (``MAX_THREADS`` in depthwise3.cu)
K7_MAX_THREADS = 256    # K7's block (``MAX_THREADS`` in depthwise3_grads.cu)
STAGES = 4              # planes in the shared-memory ring
K3_BLOCKS_PER_SM = 4    # K3's ``__launch_bounds__`` (127 registers)
K7_BLOCKS_PER_SM = 2    # K7's ``__launch_bounds__`` (128 registers)
TAPS = 28               # K7's 27 tap sums and the bias sum


def _align128(v: int) -> int:
    return -(-v // 128) * 128


@dataclass(frozen=True)
class _TilePlan:
    """A tile plan of K3 or K7, handed to the kernel as it is.

    A block owns ``ty`` x ``tx`` (y, x) columns x ``cg`` channels of one
    sample over ``seg`` planes of z: ``cg / 2`` lanes (two channels each)
    times ``ty * tx / XT`` strips of ``XT`` x positions.  Each input
    plane's (ty + 2) x (tx + 2) x cg box, zero-filled outside the volume,
    lands in a ring of ``stages`` slots; a segment reads its two
    neighbouring planes as well.  Blocks run x tile fastest, then y tile,
    channel group, z segment, sample (``block``)."""

    shape: Tuple[int, int, int, int]
    c: int
    cg: int
    ty: int
    tx: int
    seg: int
    stages: int

    @property
    def lanes(self) -> int:
        return self.cg // 2

    @property
    def strips(self) -> int:
        return self.ty * (self.tx // XT)

    @property
    def threads(self) -> int:
        return self.lanes * self.strips

    @property
    def grid(self) -> Tuple[int, int, int, int, int]:
        """(tiles in x, tiles in y, channel groups, z segments, samples)."""
        b, d, h, w = self.shape
        return (-(-w // self.tx), -(-h // self.ty), self.c // self.cg, -(-d // self.seg), b)

    @property
    def blocks(self) -> int:
        n = 1
        for v in self.grid:
            n *= v
        return n

    @property
    def box_bytes(self) -> int:
        return (self.ty + 2) * (self.tx + 2) * self.cg * 2

    def block(self, i: int) -> Tuple[int, int, int, int, int]:
        """(b, z0, c0, y0, x0) of block ``i``; it covers planes z0 up to
        z0 + seg of its tile, clipped to the volume."""
        nx, ny, ng, ns, _ = self.grid
        i, bx = divmod(i, nx)
        i, by = divmod(i, ny)
        i, bg = divmod(i, ng)
        b, bs = divmod(i, ns)
        return b, bs * self.seg, bg * self.cg, by * self.ty, bx * self.tx


class K3Plan(_TilePlan):
    """K3's tile plan: ``seg`` output planes a block."""

    @property
    def smem(self) -> int:
        """Dynamic shared memory: 128 B of alignment slack, the input ring,
        two output tiles (a TMA store drains one while the next fills) and
        the ring's barriers."""
        return (128 + self.stages * _align128(self.box_bytes)
                + 2 * _align128(self.ty * self.tx * self.cg * 2) + 8 * self.stages)


class K7Plan(_TilePlan):
    """K7's tile plan: a block sums ``seg`` planes of g against x planes
    z0 - 1 .. z0 + seg; a ring slot holds the x halo box and the g box of
    one plane.  Block ``i`` writes its (28, cg) partial at row ``row(i)``
    of a (``rows``, 28, C) workspace, channels c0 .. c0 + cg."""

    @property
    def rows(self) -> int:
        nx, ny, _, ns, b = self.grid
        return nx * ny * ns * b

    def row(self, i: int) -> int:
        nx, ny, ng, _, _ = self.grid
        tile = i % (nx * ny)
        return (i // (nx * ny * ng)) * nx * ny + tile

    @property
    def stage_bytes(self) -> int:
        return _align128(self.box_bytes) + _align128(self.ty * self.tx * self.cg * 2)

    @property
    def smem(self) -> int:
        """Dynamic shared memory: 128 B of alignment slack, the ring (which
        afterwards holds the strips' sums, if they take more) and its
        barriers."""
        ring = max(self.stages * self.stage_bytes, self.strips * TAPS * self.cg * 4)
        return 128 + _align128(ring) + 8 * self.stages


def _tile_plan(cls, shape: Sequence[int], c: int, max_threads: int, what: str):
    """The plan with the squarest tile ``max_threads`` allow and z uncut."""
    b, d, h, w = (int(v) for v in shape)
    c = int(c)
    if c <= 0 or c % 8 or min(b, d, h, w) <= 0:
        raise ValueError(f"{what} takes C % 8 == 0 and a nonempty volume, got C={c}, "
                         f"shape {(b, d, h, w)}")
    # the widest channel group up to 64 (32 lanes: a warp reads 128
    # contiguous bytes of one voxel)
    cg = max(g for g in range(8, 65, 8) if c % g == 0)
    strips = max(1, max_threads // (cg // 2))
    ty, tx = 1, XT
    while 2 * ty * (tx // XT) <= strips:       # as square a tile as the threads allow
        if tx <= ty:
            tx *= 2
        else:
            ty *= 2
    ty, tx = min(ty, h), min(tx, -(-w // XT) * XT)
    return cls((b, d, h, w), c, cg, ty, tx, d, STAGES)


def _segmented(plan, n_seg: int):
    """``plan`` with z cut into ``n_seg`` segments (fewer if they round
    up), each at least 8 planes deep."""
    d = plan.shape[1]
    n_seg = max(1, min(n_seg, d // 8))
    return type(plan)(plan.shape, plan.c, plan.cg, plan.ty, plan.tx, -(-d // n_seg),
                      plan.stages)


def k3_plan(shape: Sequence[int], c: int, sm_count: int = 132) -> K3Plan:
    """The tile plan of K3 for x (B, D, H, W, C) with ``shape`` (B, D, H, W).
    Raises ``ValueError`` for a width the kernel does not take (C % 8)."""
    plan = _tile_plan(K3Plan, shape, c, MAX_THREADS, "K3")
    # split z into segments while the grid is short of two waves (batch 1,
    # a short last batch)
    return _segmented(plan, -(-2 * K3_BLOCKS_PER_SM * sm_count // plan.blocks))


def k7_plan(shape: Sequence[int], c: int, sm_count: int = 132) -> K7Plan:
    """The tile plan of K7 for x and g (B, D, H, W, C) with ``shape`` (B, D,
    H, W).  Raises ``ValueError`` for a width the kernel does not take (C %
    8).  z is cut into the number of segments nearest to two waves of
    blocks: at batch 8 x 64^3 C 64 the uncut grid is 0.97 of two waves,
    and cutting it in two was slower in development runs on the H100
    (each segment reads two more x planes and writes one more partial)."""
    plan = _tile_plan(K7Plan, shape, c, K7_MAX_THREADS, "K7")
    return _segmented(plan, round(2 * K7_BLOCKS_PER_SM * sm_count / plan.blocks))


def depthwise_conv3(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """K3.  x (B, D, H, W, C); weight (C, 1, 3, 3, 3); bias (C,).  On the
    card x must be contiguous bf16 at a 16-byte-aligned address (TMA reads
    it in place)."""
    if x.device.type == "cpu":
        return depthwise_conv3_plain(x, weight, bias)
    b, d, h, w, c = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("depthwise_conv3 on the card takes a contiguous bf16 "
                        "tensor; the model routes f32 to the library convs")
    if tuple(weight.shape) != (c, 1, 3, 3, 3) or c % 8:
        raise ValueError(f"weight {tuple(weight.shape)} for C={c}: needs "
                         "(C,1,3,3,3) with C % 8 == 0")
    if x.data_ptr() % 16:
        raise ValueError("depthwise_conv3 on the card reads x by TMA, which needs a "
                         "16-byte-aligned address; this one is not (it is not copied)")
    plan = k3_plan((b, d, h, w), c)
    taps = weight.reshape(c, 27).t().to(device=x.device, dtype=torch.float32).contiguous()
    bf = bias.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty_like(x)
    err = _build.function("depthwise3", "depthwise3_bf16", _ARGS)(
        x.data_ptr(), taps.data_ptr(), bf.data_ptr(), out.data_ptr(),
        b, d, h, w, c, plan.cg, plan.ty, plan.tx, plan.seg, plan.stages,
        torch.cuda.current_stream(x.device).cuda_stream)
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
    depthwise conv and its bias gradient.  On the card x and g must be
    contiguous bf16 of one shape at 16-byte-aligned addresses (TMA reads
    them in place)."""
    if x.device.type == "cpu":
        return depthwise_grads_plain(x, g)
    b, d, h, w, c = x.shape
    for t in (x, g):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.shape != x.shape:
            raise TypeError("depthwise_grads on the card takes contiguous bf16 x and g "
                            "of one shape")
    if c % 8:
        raise ValueError(f"depthwise_grads needs C % 8 == 0, got C={c}")
    if x.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("depthwise_grads on the card reads x and g by TMA, which needs "
                         "16-byte-aligned addresses; these are not (they are not copied)")
    plan = k7_plan((b, d, h, w), c)
    part = torch.empty((plan.rows, TAPS, c), dtype=torch.float32, device=x.device)
    out = torch.empty((TAPS, c), dtype=torch.float32, device=x.device)
    err = _build.function("depthwise3_grads", "depthwise3_grads_bf16", _ARGS)(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
        b, d, h, w, c, plan.cg, plan.ty, plan.tx, plan.seg, plan.stages,
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
