"""K1's tile plan (``conv3d_in.k1_plan``) on the CPU.

The card alone runs K1, but the plan it is handed is Python: these tests
hold it at every forward and dx geometry of MICA at base 16, 32 and 64, on
the 64^3 training window, a 16^3 window and odd volumes.  A geometry with a
width that is not a multiple of 32 must be refused (the card needs every
RDB/transition width a multiple of 32).  Then a torch reference computes the
conv tile by tile as the kernel does, each K step from a zero-filled box of
the volume shifted by its tap (what TMA loads), and must equal
``conv3d_plain`` in f32 to 1e-5 of the largest output (sums of the same
products in another order).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mica_tpu_torch.ops import conv3d_in
from mica_tpu_torch.ops._build import SMEM_MAX
from mica_tpu_torch.ops.conv3d_in import K1_CONFIGS, k1_plan

SHAPES = [(8, 64, 64, 64), (2, 16, 16, 16), (3, 5, 7, 9), (1, 3, 1, 130)]


def _geometries(base):
    """(cis, co) of every forward and dx launch of K1 at ``base``."""
    fwd = [(cis, co) for cis, co, _ in conv3d_in.k1_sites(base)]
    dx = [([ci], co) for ci, co in conv3d_in.k1_dx_sites(base)]
    return fwd + dx


def _plans(base, shape):
    """The plans of the valid geometries; the others must be refused."""
    plans = []
    for cis, co in _geometries(base):
        if any(c % 32 for c in cis) or co % 32:
            with pytest.raises(ValueError):
                k1_plan(cis, co, shape)
        else:
            plans.append(k1_plan(cis, co, shape))
    return plans


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_bricks_cover_every_voxel_once_within_a_sample(base, shape):
    b, d, h, w = shape
    for plan in _plans(base, shape):
        bw, bh, bd = plan.brick
        assert bw * bh * bd == plan.bm and max(plan.brick) <= 256
        count = np.zeros((plan.n_tiles, b, d, h, w), np.int32)
        assert plan.tiles == 2 * (-(-plan.n_bricks // 2)) * plan.n_tiles
        for t in range(plan.tiles):
            if plan.tile(t) is None:      # the idle partner of an odd last brick
                assert plan.n_bricks % 2 and t % 2
                continue
            s, x0, y0, z0, n0 = plan.tile(t)
            # the brick's origin lies in sample s's volume, so its voxels are
            # s's (or outside the volume, where the kernel drops them)
            assert 0 <= s < b and 0 <= z0 < d and 0 <= y0 < h and 0 <= x0 < w, (t, plan)
            assert n0 % plan.bn == 0
            count[n0 // plan.bn, s, z0:z0 + bd, y0:y0 + bh, x0:x0 + bw] += 1
        assert (count == 1).all(), plan


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_k_steps_stay_in_one_tap_and_part(base, shape):
    for plan in _plans(base, shape):
        ci_tot = sum(plan.cis)
        offsets = np.cumsum([0] + list(plan.cis))
        steps = list(plan.ksteps_of())
        assert len(steps) == plan.ksteps == 27 * ci_tot // plan.bk
        seen = set()
        for dz, dy, dx, part, c0, kw in steps:
            tap = (dz + 1) * 9 + (dy + 1) * 3 + dx + 1
            assert c0 % plan.bk == 0 and c0 + plan.bk <= plan.cis[part]
            assert kw == tap * ci_tot + offsets[part] + c0
            seen.add(kw)
        assert seen == set(range(0, 27 * ci_tot, plan.bk))
        # BK 64 (128-byte swizzle) exactly where every part is a multiple of 64
        assert plan.bk == (64 if all(c % 64 == 0 for c in plan.cis) else 32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_n_tiles_are_valid_wgmma_widths_covering_co(base, shape):
    for plan in _plans(base, shape):
        assert plan.bn % 32 == 0 and 8 <= plan.bn <= 256      # wgmma N; 4 n8 chunks a store
        assert plan.n_tiles * plan.bn == plan.co
        assert (plan.bn, plan.mt) in K1_CONFIGS
        if plan.co <= 256:
            assert plan.n_tiles == 1    # each tap's input box fetched once


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_stages_fit_shared_memory(base, shape):
    for plan in _plans(base, shape):
        assert 2 <= plan.stages <= conv3d_in.MAX_STAGES
        assert plan.smem <= SMEM_MAX
        assert plan.stage_bytes % 1024 == 0       # each stage 1024-byte aligned
        assert (plan.bm * plan.bk * 2) % 1024 == 0   # so is its B tile
        assert 2 <= plan.ctas <= min(132, plan.tiles) and plan.ctas % 2 == 0   # clusters of 2
        assert plan.bn // 2 % 8 == 0          # each CTA multicasts half of the B box


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        k1_plan([48], 64, (1, 8, 8, 8))
    with pytest.raises(ValueError):
        k1_plan([64], 40, (1, 8, 8, 8))
    with pytest.raises(ValueError):
        k1_plan([32] * 4, 64, (1, 8, 8, 8))
    with pytest.raises(ValueError):
        k1_plan([], 64, (1, 8, 8, 8))


def _tiled_conv(parts, weight, bias, plan, with_stats=True):
    """K1's computation, tile by tile: each K step multiplies a box of the
    volume at the brick's origin shifted by its tap, zero outside the
    volume, by a (BN, BK) block of the packed weight; then bias, the
    statistics of the rows inside the volume, and their store."""
    b, d, h, w = plan.shape
    bw, bh, bd = plan.brick
    nbx, nby, nbz = plan.bricks
    # a zero margin stands for TMA's out-of-bounds fill
    padded = [F.pad(p, (0, 0, 1, nbx * bw - w + 1, 1, nby * bh - h + 1, 1, nbz * bd - d + 1))
              for p in parts]
    wp = weight.permute(0, 2, 3, 4, 1).reshape(plan.co, -1)
    out = torch.zeros(b, d, h, w, plan.co)
    stats = torch.zeros(b, 2, plan.co)
    zz, yy, xx = torch.meshgrid(torch.arange(bd), torch.arange(bh), torch.arange(bw),
                                indexing="ij")
    for t in range(plan.tiles):
        if plan.tile(t) is None:
            continue
        s, x0, y0, z0, n0 = plan.tile(t)
        acc = torch.zeros(plan.bm, plan.bn)
        for dz, dy, dx, part, c0, kw in plan.ksteps_of():
            z, y, x = z0 + dz + 1, y0 + dy + 1, x0 + dx + 1
            box = padded[part][s, z:z + bd, y:y + bh, x:x + bw, c0:c0 + plan.bk]
            acc += box.reshape(plan.bm, plan.bk) @ wp[n0:n0 + plan.bn, kw:kw + plan.bk].T
        if bias is not None:
            acc += bias[n0:n0 + plan.bn]
        vz, vy, vx = (z0 + zz).ravel(), (y0 + yy).ravel(), (x0 + xx).ravel()
        ok = (vz < d) & (vy < h) & (vx < w)
        rows = acc[ok]
        out[s, vz[ok], vy[ok], vx[ok], n0:n0 + plan.bn] = rows
        stats[s, 0, n0:n0 + plan.bn] += rows.sum(0)
        stats[s, 1, n0:n0 + plan.bn] += (rows * rows).sum(0)
    return out, (stats if with_stats else None)


@pytest.mark.parametrize("shape,cis,co", [
    ((2, 5, 6, 7), [32], 64),
    ((1, 4, 9, 3), [64, 32], 96),        # BK 32 over a 64-channel part
    ((3, 5, 7, 9), [32, 32, 32], 128),   # an odd brick count: one idle partner
    ((2, 4, 4, 8), [64, 64], 512),       # two N tiles
    ((2, 3, 6, 17), [64], 192),          # W past one brick
    ((1, 8, 8, 8), [128], 32),
])
def test_tiled_reference_equals_plain_conv(shape, cis, co):
    rng = np.random.default_rng(sum(shape) + co)
    parts = [torch.from_numpy(rng.standard_normal(shape + (c,)).astype(np.float32)) for c in cis]
    weight = torch.from_numpy(rng.standard_normal((co, sum(cis), 3, 3, 3)).astype(np.float32))
    weight = weight * 0.05
    bias = torch.from_numpy(rng.standard_normal(co).astype(np.float32))
    plan = k1_plan(cis, co, shape)
    got, got_st = _tiled_conv(parts, weight, bias, plan)
    want, want_st = conv3d_in.conv3d_plain(parts, weight, bias)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(got_st[:, 0], want_st[:, 0], rtol=1e-5,
                               atol=1e-5 * want.abs().sum(dim=(1, 2, 3)).max().item())
    torch.testing.assert_close(got_st[:, 1], want_st[:, 1], rtol=1e-5, atol=1e-5)
