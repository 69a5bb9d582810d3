"""K3's tile plan (``depthwise.k3_plan``) on the CPU.

The card alone runs K3, but the plan it is handed is Python: these tests
hold it at every K3 site of MICA at base 16, 32 and 64 (the DualAttention
widths base, 2 base, 4 base), and at the odd widths 16 and 24, on the 64^3
training window, a 16^3 window and odd volumes.  A width that is not a
multiple of 8 must be refused.  Then a torch reference computes the conv
tile by tile as the kernel does, each output plane of a block from the
zero-filled (ty + 2) x (tx + 2) x cg boxes of the input planes around it
(what TMA loads), clipped to the volume as the TMA store clips, and must
equal ``depthwise_conv3_plain`` in f32 to 1e-5 of the largest output (sums
of the same products in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mica_tpu_torch.ops import depthwise
from mica_tpu_torch.ops._build import SMEM_MAX
from mica_tpu_torch.ops.depthwise import MAX_THREADS, XT, k3_plan

SHAPES = [(8, 64, 64, 64), (2, 16, 16, 16), (3, 5, 7, 9), (1, 3, 1, 130)]
SMALL = SHAPES[1:]


def _widths(base):
    return [base, 2 * base, 4 * base, 16, 24]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_tiles_cover_every_output_voxel_and_channel_once(base, shape):
    b, d, h, w = shape
    for c in _widths(base):
        plan = k3_plan(shape, c)
        assert plan.cg % 8 == 0 and c % plan.cg == 0 and plan.cg <= 64, plan
        assert plan.tx % XT == 0 and plan.ty >= 1 and plan.seg >= 1, plan
        assert 0 < plan.threads <= MAX_THREADS and plan.smem <= SMEM_MAX, plan
        assert max(plan.cg, plan.tx + 2, plan.ty + 2) <= 256, plan   # TMA box limits
        count = np.zeros((c // plan.cg, b, d, h, w), np.int16)
        for i in range(plan.blocks):
            s, z0, c0, y0, x0 = plan.block(i)
            # every block's origin lies in the volume: no block is idle
            assert 0 <= s < b and 0 <= z0 < d and 0 <= y0 < h and 0 <= x0 < w, (i, plan)
            assert c0 % plan.cg == 0 and c0 < c
            count[c0 // plan.cg, s, z0:z0 + plan.seg, y0:y0 + plan.ty, x0:x0 + plan.tx] += 1
        assert (count == 1).all(), plan


def _tiled_reference(x, weight, bias, plan):
    """K3's arithmetic, block by block: each input plane's zero-filled halo
    box, 27 taps summed in f32 onto the bias, the tile clipped to the
    volume."""
    b, d, h, w, c = x.shape
    ty, tx, cg, seg = plan.ty, plan.tx, plan.cg, plan.seg
    # zeros around the volume: one voxel of SAME padding before, and after
    # it as much as the last tile and segment overhang
    xp = F.pad(x, (0, 0, 1, tx + 1, 1, ty + 1, 1, seg + 1))
    taps = weight.reshape(c, 27).t()
    out = torch.full_like(x, float("nan"))
    for i in range(plan.blocks):
        s, z0, c0, y0, x0 = plan.block(i)
        # the boxes of input planes z0 - 1 .. z0 + seg, origin (x0 - 1, y0 - 1)
        box = xp[s, z0:z0 + seg + 2, y0:y0 + ty + 2, x0:x0 + tx + 2, c0:c0 + cg]
        acc = bias[c0:c0 + cg].expand(seg, ty, tx, cg).clone()
        for tap in range(27):
            dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
            acc += box[dz:dz + seg, dy:dy + ty, dx:dx + tx] * taps[tap, c0:c0 + cg]
        nz, ny, nx = min(seg, d - z0), min(ty, h - y0), min(tx, w - x0)
        out[s, z0:z0 + nz, y0:y0 + ny, x0:x0 + nx, c0:c0 + cg] = acc[:nz, :ny, :nx]
    return out


@pytest.mark.parametrize("shape", SMALL)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_tile_by_tile_reference_equals_the_plain_version(base, shape):
    g = torch.Generator().manual_seed(base + sum(shape))
    for c in _widths(base):
        x = torch.randn(shape + (c,), generator=g)
        weight = torch.randn(c, 1, 3, 3, 3, generator=g) * 0.2
        bias = torch.randn(c, generator=g) * 0.1
        plan = k3_plan(shape, c)
        got = _tiled_reference(x, weight, bias, plan)
        want = depthwise.depthwise_conv3_plain(x, weight, bias)
        assert not torch.isnan(got).any(), plan
        err = (got - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), (plan, err)


@pytest.mark.parametrize("c", [0, 4, 12, 20, 100])
def test_plan_refuses_widths_the_kernel_does_not_take(c):
    with pytest.raises(ValueError):
        k3_plan((2, 16, 16, 16), c)


@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (1, 64, 64, 64), (3, 64, 64, 64)])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_plan_fills_the_card_at_any_batch(shape, c):
    """The engine computes the all-zero window at batch 1 and runs a short
    last batch: z segments keep at least 2 blocks an SM there, and none
    is cut below 8 planes; the full batch is not cut at all beyond that."""
    plan = k3_plan(shape, c, sm_count=132)
    assert plan.blocks >= 2 * 132, plan
    assert plan.seg >= 8, plan
    if shape[0] == 8 and c >= 128:
        assert plan.seg == shape[1], plan
