"""K7's tile plan (``depthwise.k7_plan``) on the CPU.

The card alone runs K7, but the plan it is handed is Python: these tests
hold it at every K7 site of MICA at base 16, 32 and 64 (the DualAttention
widths base, 2 base, 4 base), and at the odd widths 16 and 24, on the 64^3
training window, a 16^3 window and odd volumes.  Every g voxel and channel
must be summed by exactly one block, and every (workspace row, channel)
written by exactly one.  A width that is not a multiple of 8 must be
refused, and batch 1 must still fill the card.

Then a torch reference computes the sums block by block as the kernel
does: step t of a block takes x plane z0 - 1 + t from the zero-filled
(ty + 2) x (tx + 2) x cg box (what TMA loads) and meets the g boxes of the
three planes around it (zero outside the block's segment); each strip's
sums run over the steps, the block sums its strips in order into its
workspace row, and the rows are summed in the column-sum kernel's order.
That must equal ``depthwise_grads_plain`` to 1e-5 of the sum of the
terms' magnitudes per tap (f32 sums of the same products in another
order), and the reference's ``_depthwise_conv3_grads`` (Pallas in
interpret mode) to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mica_tpu.ops.depthwise_pallas import _depthwise_conv3_grads
from mica_tpu_torch.ops import depthwise
from mica_tpu_torch.ops._build import SMEM_MAX
from mica_tpu_torch.ops.depthwise import K7_BLOCKS_PER_SM, K7_MAX_THREADS, TAPS, XT, k7_plan

SHAPES = [(8, 64, 64, 64), (2, 16, 16, 16), (3, 5, 7, 9), (1, 3, 1, 130)]
SMALL = [(2, 16, 16, 16), (3, 5, 7, 9), (1, 3, 1, 130), (1, 20, 12, 8)]
SUM_ROW_LANES = 32      # the column-sum kernel's warps: row r goes to lane r % 32


def _widths(base):
    return [base, 2 * base, 4 * base, 16, 24]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_plan_tiles_cover_every_voxel_channel_and_partial_once(base, shape):
    b, d, h, w = shape
    for c in _widths(base):
        plan = k7_plan(shape, c)
        assert plan.cg % 8 == 0 and c % plan.cg == 0 and plan.cg <= 64, plan
        assert plan.tx % XT == 0 and plan.ty >= 1 and plan.seg >= 1, plan
        assert 0 < plan.threads <= K7_MAX_THREADS and plan.smem <= SMEM_MAX, plan
        assert max(plan.cg, plan.tx + 2, plan.ty + 2) <= 256, plan   # TMA box limits
        count = np.zeros((c // plan.cg, b, d, h, w), np.int16)
        written = np.zeros((plan.rows, c), np.int16)
        for i in range(plan.blocks):
            s, z0, c0, y0, x0 = plan.block(i)
            # every block's origin lies in the volume: no block is idle
            assert 0 <= s < b and 0 <= z0 < d and 0 <= y0 < h and 0 <= x0 < w, (i, plan)
            assert c0 % plan.cg == 0 and c0 < c
            count[c0 // plan.cg, s, z0:z0 + plan.seg, y0:y0 + plan.ty, x0:x0 + plan.tx] += 1
            written[plan.row(i), c0:c0 + plan.cg] += 1
        assert (count == 1).all(), plan
        assert (written == 1).all(), plan


def _tiled_reference(x, g, plan):
    """K7's arithmetic, block by block, in the kernel's order of sums."""
    b, d, h, w, c = x.shape
    ty, tx, cg, seg = plan.ty, plan.tx, plan.cg, plan.seg
    # x: one voxel of SAME padding before, and after it as much as the last
    # tile and segment overhang; g: zero past the volume (the TMA fill)
    xp = F.pad(x, (0, 0, 1, tx + 1, 1, ty + 1, 1, seg + 1))
    gpad = F.pad(g, (0, 0, 0, tx, 0, ty, 0, seg))
    zero = torch.zeros(ty, tx, cg)
    part = torch.full((plan.rows, TAPS, c), float("nan"))
    for i in range(plan.blocks):
        s, z0, c0, y0, x0 = plan.block(i)
        z1 = min(z0 + seg, d)
        ng = z1 - z0
        n_it = ng + (2 if z1 < d else 1)
        # (strip row, strip in x, tap, channel): each thread's sums
        acc = torch.zeros(ty, tx // XT, TAPS, cg)
        gs = [zero, zero, zero]                   # g at planes zi + 1, zi, zi - 1
        for t in range(n_it):
            zi = z0 - 1 + t
            gs = [gpad[s, z0 + t, y0:y0 + ty, x0:x0 + tx, c0:c0 + cg] if t < ng else zero,
                  gs[0], gs[1]]
            acc[:, :, 27] += gs[0].reshape(ty, tx // XT, XT, cg).sum(2)
            if zi < 0:
                continue
            box = xp[s, zi + 1, y0:y0 + ty + 2, x0:x0 + tx + 2, c0:c0 + cg]
            for tap in range(27):
                dz, dy, dx = tap // 9, (tap // 3) % 3, tap % 3
                prod = box[dy:dy + ty, dx:dx + tx] * gs[dz]
                acc[:, :, tap] += prod.reshape(ty, tx // XT, XT, cg).sum(2)
        strips = acc.reshape(-1, TAPS, cg)
        total = torch.zeros(TAPS, cg)
        for j in range(strips.shape[0]):
            total += strips[j]
        part[plan.row(i), :, c0:c0 + cg] = total
    lanes = [part[r::SUM_ROW_LANES].sum(0) for r in range(min(SUM_ROW_LANES, plan.rows))]
    out = torch.zeros(TAPS, c)
    for v in lanes:
        out += v
    return out


def _inputs(shape, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (c,)).astype(np.float32)
    g = rng.normal(size=shape + (c,)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(g)


def _assert_within_magnitudes(got, want, mag, plan):
    assert not torch.isnan(got).any(), plan
    excess = ((got - want).abs() - 1e-5 * mag).max().item()
    assert excess <= 0, (plan, excess)


@pytest.mark.parametrize("shape", SMALL)
@pytest.mark.parametrize("base", [16, 32, 64])
def test_tile_by_tile_reference_equals_the_plain_version(base, shape):
    for c in _widths(base):
        x, g = _inputs(shape, c, base + sum(shape) + c)
        plan = k7_plan(shape, c)
        got = _tiled_reference(x, g, plan)
        want = depthwise.depthwise_grads_plain(x, g)
        mag = depthwise.depthwise_grads_plain(x.abs(), g.abs())
        assert got.shape == want.shape == (TAPS, c)
        _assert_within_magnitudes(got, want, mag, plan)


def test_tile_by_tile_reference_at_batch_1_with_z_segments():
    """The all-zero window's shape (batch 1 of 64^3 at C 64, cut to 8 x 8
    columns here): z is cut into segments, each reading its neighbours'
    boundary x planes."""
    shape, c = (1, 64, 8, 8), 64
    plan = k7_plan(shape, c)
    assert plan.grid[3] > 1, plan
    x, g = _inputs(shape, c, 7)
    got = _tiled_reference(x, g, plan)
    want = depthwise.depthwise_grads_plain(x, g)
    _assert_within_magnitudes(got, want, depthwise.depthwise_grads_plain(x.abs(), g.abs()), plan)


def test_tile_by_tile_reference_equals_the_pallas_reference():
    shape, c = (2, 9, 6, 11), 16
    x, g = _inputs(shape, c, 3)
    x, g = x * 0.25, g * 0.25
    plan = k7_plan(shape, c)
    got = _tiled_reference(x, g, plan)
    dk, db = _depthwise_conv3_grads(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                                    interpret=True)
    want = torch.from_numpy(np.concatenate([np.asarray(dk).reshape(27, c),
                                            np.asarray(db)[None]]))
    _assert_within_magnitudes(got, want, depthwise.depthwise_grads_plain(x.abs(), g.abs()), plan)


@pytest.mark.parametrize("c", [0, 4, 12, 20, 100])
def test_plan_refuses_widths_the_kernel_does_not_take(c):
    with pytest.raises(ValueError):
        k7_plan((2, 16, 16, 16), c)


@pytest.mark.parametrize("shape", [(8, 64, 64, 64), (1, 64, 64, 64), (3, 64, 64, 64)])
@pytest.mark.parametrize("c", [64, 128, 256])
def test_plan_fills_the_card_at_any_batch(shape, c):
    """Batch 1 and a short last batch leave few tiles: z segments keep more
    than a wave of blocks on the card there (the count nearest to two
    waves), none cut below 8 planes; the full batch is not cut."""
    plan = k7_plan(shape, c, sm_count=132)
    assert plan.blocks > K7_BLOCKS_PER_SM * 132, plan
    assert plan.seg >= 8, plan
    if shape[0] == 8:
        assert plan.seg == shape[1], plan
