"""K5's plan (``conv3d_in.k5_plan``) and its two-pass sum, on the CPU.

The card alone runs K5, but the plan it is handed is Python: these tests
hold it at every K5 width of a MICA training step at base 64 (C 32, 64,
128, 256, 512 on the 8 x 64^3 batch), at batch 1, and at odd shapes (C 24
and 96, voxel counts that are not a multiple of the tile).  Every (voxel,
channel) must be summed by exactly one program, every partial row of the
buffer written by exactly one, and the grid must fill the card at batch 1 and at
the short C 32 sites.

Then a torch reference computes the sums as the two kernels do: tiles of
a chunk added elementwise into tile-shaped accumulators, the rows reduced
once, one partial row per (sample, chunk), then the chunks summed
``K5_SUM_ROWS`` at a time and across.  That must equal
``in_bwd_stats_plain`` within 1e-5 of the sum of the terms' magnitudes
(f32 sums of the same products in another order), and the reference's
``_in_bwd_stats_T`` (Pallas in interpret mode) to the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from mica_tpu.ops.wino_pallas import _in_bwd_stats_T, _to_T
from mica_tpu_torch.ops import conv3d_in
from mica_tpu_torch.ops.conv3d_in import (K5_PROGRAMS_PER_SM, K5_SUM_ROWS, K5_TILE, K5Plan,
                                          k5_plan)

TRAIN_WIDTHS = (32, 64, 128, 256, 512)     # K5's sites in a step at base 64
SHAPES = [(8, 64, 64, 64), (1, 64, 64, 64), (1, 3, 5, 7), (2, 5, 6, 11), (3, 16, 16, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", TRAIN_WIDTHS + (24, 96))
def test_plan_sums_every_voxel_channel_and_partial_once(shape, c):
    plan = k5_plan(shape + (c,))
    assert isinstance(plan, K5Plan) and plan.shape == shape + (c,)
    assert plan.block_c <= 128 and plan.block_s * plan.block_c == K5_TILE
    assert plan.block_c & (plan.block_c - 1) == 0 and plan.chunk % plan.block_s == 0
    # up to 128 channels one block holds all of them: whole rows a load
    assert plan.n_c == 1 if c <= 128 else plan.block_c == 128 and c % 128 == 0
    b = shape[0]
    s = plan.voxels
    assert s == shape[1] * shape[2] * shape[3]
    covered = np.zeros(s, np.int16)
    for i in range(plan.n_chunks):
        start, stop = plan.rows(i)
        assert start < stop, (i, plan)         # no chunk is empty: no idle program
        covered[start:stop] += 1
    assert (covered == 1).all(), plan
    assert plan.grid == (plan.n_chunks, plan.n_c, b)
    assert plan.programs == plan.n_chunks * plan.n_c * b
    assert plan.buffer == (b * (1 + plan.n_chunks), 2, c)   # the sums, then the partials
    assert plan.sum_grid == (plan.n_c, 2, b)
    assert plan.n_c * plan.block_c >= c > (plan.n_c - 1) * plan.block_c


@pytest.mark.parametrize("c", TRAIN_WIDTHS)
@pytest.mark.parametrize("batch", [8, 1])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_grid_is_sized_to_the_card(c, batch, sm_count):
    """About ``K5_PROGRAMS_PER_SM`` programs an SM at every training width,
    batch 8 and batch 1, and never fewer than one wave of one an SM."""
    plan = k5_plan((batch, 64, 64, 64, c), sm_count)
    want = K5_PROGRAMS_PER_SM * sm_count
    assert sm_count <= plan.programs <= want, plan
    assert plan.programs >= want // 2, plan
    assert plan.n_chunks == -(-plan.voxels // plan.chunk)


def _two_pass(xh, dy, plan):
    """K5's arithmetic in f32: per (sample, chunk, channel block) the tiles
    added elementwise, rows reduced once; then the chunks summed
    ``K5_SUM_ROWS`` at a time and across."""
    b, d, h, w, c = xh.shape
    s = d * h * w
    n_ch, bs, bc = plan.n_chunks, plan.block_s, plan.block_c
    xf = xh.float().reshape(b, s, c)
    g = torch.where(xf > 0, dy.float().reshape(b, s, c), 0.0)
    pad_s, pad_c = n_ch * plan.chunk - s, plan.n_c * bc - c
    terms = torch.stack([g, g * xf], dim=1)                       # (B, 2, S, C)
    terms = F.pad(terms, (0, pad_c, 0, pad_s))
    tiles = terms.reshape(b, 2, n_ch, plan.chunk // bs, bs, plan.n_c * bc)
    acc = torch.zeros(b, 2, n_ch, bs, plan.n_c * bc)
    for t in range(tiles.shape[3]):                              # the loop of a program
        acc += tiles[:, :, :, t]
    ws = acc.sum(dim=3)[..., :c]                                  # (B, 2, chunks, C)
    ws = F.pad(ws, (0, 0, 0, -(-n_ch // K5_SUM_ROWS) * K5_SUM_ROWS - n_ch))
    steps = ws.reshape(b, 2, -1, K5_SUM_ROWS, c)
    total = torch.zeros(b, 2, K5_SUM_ROWS, c)
    for r in range(steps.shape[2]):                              # the loop of the sum kernel
        total += steps[:, :, r]
    return total.sum(dim=2)


def _within_magnitudes(got, want, xh, dy):
    mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
    assert ((got - want).abs() <= 1e-5 * mag + 1e-30).all(), (got - want).abs().max()


@pytest.mark.parametrize("shape,c", [((2, 5, 6, 11), 32), ((1, 3, 5, 7), 24),
                                     ((2, 9, 8, 7), 96), ((1, 8, 8, 8), 256),
                                     ((2, 16, 16, 16), 64)])
def test_two_pass_sum_matches_plain(rng, shape, c):
    xh = torch.from_numpy(rng.standard_normal(shape + (c,)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal(shape + (c,)).astype(np.float32)).to(torch.bfloat16)
    want = conv3d_in.in_bwd_stats_plain(xh, dy)
    plan = k5_plan(xh.shape)
    _within_magnitudes(_two_pass(xh, dy, plan), want, xh, dy)
    # chunks of two tiles: the loop of a program adds tiles elementwise
    two = K5Plan(plan.shape, plan.block_s, plan.block_c, 2 * plan.block_s)
    assert two.n_chunks == -(-two.voxels // (2 * plan.block_s))
    _within_magnitudes(_two_pass(xh, dy, two), want, xh, dy)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 4, 4, 6)])
def test_two_pass_sum_matches_reference_kernel_in_interpret_mode(rng, shape):
    c = 128                                  # the reference's channel block
    b = shape[0]
    xh = rng.standard_normal(shape + (c,)).astype(np.float32)
    dy = rng.standard_normal(shape + (c,)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _in_bwd_stats_T(_to_T(jnp.asarray(xh)), _to_T(jnp.asarray(dy)), b)
    xt, dt, want = torch.from_numpy(xh), torch.from_numpy(dy), torch.from_numpy(np.array(want))
    _within_magnitudes(_two_pass(xt, dt, k5_plan(xt.shape, sm_count=2)), want, xt, dt)
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = dict(conv3d_in.launches)
    _within_magnitudes(conv3d_in.in_bwd_stats(xt, dt), want, xt, dt)
    assert conv3d_in.launches == before
