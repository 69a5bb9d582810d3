"""``in_sums``'s plan (``conv3d_in.in_sums_plan``) and its two-pass sum, on
the CPU.

The card alone runs ``in_sums``, but the plan it is handed is Python.  These
tests hold it at the widths of the inference forward's 19 sites at base 64
(C 32, 64, 128, 256) and base 16 (C 16, 32, 64), at batch 1 and 8, and at
odd shapes (C 24 and 96, voxel counts that are not a multiple of the tile):
every (voxel, channel) summed by exactly one program, every partial row of
the buffer written by exactly one, a grid that fills the card at batch 1,
and a chunk that does not depend on the batch.

Then a torch reference computes the sums as the two kernels do (tiles of a
chunk added elementwise, rows reduced once, one partial row pair per
(sample, chunk), the chunks summed ``K5_SUM_ROWS`` at a time and across).
It must equal ``in_sums_plain`` within 1e-5 of the sum of |x| and x², give
sample 0 the same bits at batch 8 as at batch 1, and the mean and scale
built on it must match the JAX package's ``instance_norm`` and
``global_avg_pool`` on the CPU.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mica_tpu.models.mica import global_avg_pool as jax_global_avg_pool
from mica_tpu.models.mica import instance_norm as jax_instance_norm
from mica_tpu_torch.ops import conv3d_in
from mica_tpu_torch.ops.conv3d_in import (IN_SUMS_PROGRAMS_PER_SM, IN_SUMS_TILE, K5_SUM_ROWS,
                                          in_stats, in_sums_plan, in_sums_plain)

SITE_WIDTHS = (16, 32, 64, 128, 256)      # the 19 sites' widths at base 64 and base 16
SHAPES = [(8, 64, 64, 64), (1, 64, 64, 64), (1, 3, 5, 7), (2, 5, 6, 11), (3, 16, 16, 16)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", SITE_WIDTHS + (24, 96))
def test_plan_sums_every_voxel_channel_and_partial_once(shape, c):
    plan = in_sums_plan(shape + (c,))
    assert plan.shape == shape + (c,)
    assert 16 <= plan.block_c <= 128 and plan.block_s * plan.block_c == IN_SUMS_TILE
    assert plan.block_c & (plan.block_c - 1) == 0 and plan.chunk % plan.block_s == 0
    # up to 128 channels one block holds all of them: whole rows a load
    assert plan.n_c == 1 if c <= 128 else plan.block_c == 128 and c % 128 == 0
    b, s = shape[0], plan.voxels
    assert s == shape[1] * shape[2] * shape[3]
    covered = np.zeros(s, np.int16)
    for i in range(plan.n_chunks):
        start, stop = plan.rows(i)
        assert start < stop, (i, plan)         # no chunk is empty: no idle program
        covered[start:stop] += 1
    assert (covered == 1).all(), plan
    assert plan.grid == (plan.n_chunks, plan.n_c, b)
    assert plan.buffer == (b * (1 + plan.n_chunks), 2, c)   # the sums, then the partials
    assert plan.sum_grid == (plan.n_c, 2, b)
    assert plan.n_c * plan.block_c >= c > (plan.n_c - 1) * plan.block_c


@pytest.mark.parametrize("c", SITE_WIDTHS)
@pytest.mark.parametrize("sm_count", [132, 114])
def test_chunk_does_not_depend_on_the_batch_and_batch_1_fills_the_card(c, sm_count):
    """The plan at batch 8 is the plan at batch 1 with another batch; at
    batch 1 about ``IN_SUMS_PROGRAMS_PER_SM`` programs an SM, never fewer
    than one an SM."""
    one = in_sums_plan((1, 64, 64, 64, c), sm_count)
    for batch in (2, 8):
        plan = in_sums_plan((batch, 64, 64, 64, c), sm_count)
        assert plan == replace(one, shape=(batch,) + one.shape[1:])
        assert plan.programs == batch * one.programs
    want = IN_SUMS_PROGRAMS_PER_SM * sm_count
    assert sm_count <= one.programs <= want, one
    assert one.programs >= want // 2, one


def _two_pass(x, plan):
    """The arithmetic of the two kernels in f32: per (sample, chunk, channel
    block) the tiles added elementwise, rows reduced once; then the chunks
    summed ``K5_SUM_ROWS`` at a time and across."""
    b, d, h, w, c = x.shape
    s = d * h * w
    n_ch, bs, bc = plan.n_chunks, plan.block_s, plan.block_c
    xf = x.float().reshape(b, s, c)
    terms = F.pad(torch.stack([xf, xf * xf], dim=1), (0, plan.n_c * bc - c, 0,
                                                      n_ch * plan.chunk - s))
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


def _within_magnitudes(got, want, x):
    mag = in_sums_plain(x.abs())
    assert ((got - want).abs() <= 1e-5 * mag + 1e-30).all(), (got - want).abs().max()


def _bf16(rng, shape, loc=0.0):
    return torch.from_numpy((rng.standard_normal(shape) + loc).astype(np.float32)).to(
        torch.bfloat16)


@pytest.mark.parametrize("shape,c", [((2, 5, 6, 11), 32), ((1, 3, 5, 7), 24),
                                     ((2, 9, 8, 7), 96), ((1, 8, 8, 8), 256),
                                     ((2, 16, 16, 16), 64), ((1, 16, 16, 16), 16)])
def test_two_pass_sum_matches_plain(rng, shape, c):
    x = _bf16(rng, shape + (c,), loc=0.5)
    want = in_sums_plain(x)
    plan = in_sums_plan(x.shape)
    _within_magnitudes(_two_pass(x, plan), want, x)
    # small chunks: many partial rows, and more than one step of the sum kernel
    one = replace(plan, chunk=plan.block_s)
    assert one.n_chunks == -(-one.voxels // plan.block_s)
    _within_magnitudes(_two_pass(x, one), want, x)


@pytest.mark.parametrize("c", [16, 64, 256])
def test_sample_0_has_the_same_bits_at_batch_8_and_batch_1(rng, c):
    x = _bf16(rng, (8, 12, 10, 9, c), loc=1.0)
    eight = _two_pass(x, in_sums_plan(x.shape, sm_count=4))
    one = _two_pass(x[:1], in_sums_plan(x[:1].shape, sm_count=4))
    assert torch.equal(eight[:1], one)


@pytest.mark.parametrize("shape", [(2, 6, 5, 7, 64), (1, 4, 4, 4, 256), (3, 5, 5, 5, 32)])
def test_mean_and_scale_match_the_jax_package(rng, shape):
    """``in_stats`` of the emulated sums against the JAX package's
    statistics on the CPU: its f32 ``instance_norm`` of the same values is
    (x - mean) * scale, its ``global_avg_pool`` the mean."""
    x = _bf16(rng, shape, loc=0.3)
    n = shape[1] * shape[2] * shape[3]
    sums = _two_pass(x, in_sums_plan(x.shape, sm_count=2))
    mean, scale = in_stats(sums, n)
    xf = x.float()
    got = (xf - mean[:, None, None, None, :]) * scale[:, None, None, None, :]
    want = np.asarray(jax_instance_norm(jnp.asarray(xf.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    pool = np.asarray(jax_global_avg_pool(jnp.asarray(xf.numpy())))[:, 0, 0, 0]
    np.testing.assert_allclose(mean.numpy(), pool, rtol=1e-6, atol=1e-7)
    # in bf16, the pool the model takes equals the JAX package's bf16 pool
    jax_bf16 = np.asarray(jax_global_avg_pool(jnp.asarray(xf.numpy()).astype(jnp.bfloat16)))
    np.testing.assert_array_equal((sums[:, 0] / n).to(torch.bfloat16).float().numpy(),
                                  jax_bf16.astype(np.float32)[:, 0, 0, 0])


def test_wrapper_on_the_cpu_is_the_plain_version_and_launches_nothing(rng):
    x = _bf16(rng, (2, 3, 4, 5, 48))
    before = dict(conv3d_in.launches)
    assert torch.equal(conv3d_in.in_sums(x), in_sums_plain(x))
    assert conv3d_in.launches == before
