"""K1's statistics reduction, emulated on the CPU from ``conv3d_in.k1_plan``.

On the card K1 writes one partial row pair (sum y, sum y^2 over the brick's
voxels inside the volume) per (sample, brick, N tile) into a
``K1Plan.partials`` buffer, each slot written by exactly one tile, and a
second kernel adds each sample's bricks in a fixed order
(``conv3d_in.sum_partials_plain`` is that order).  These tests emulate both
steps from the plan at every forward site of MICA at base 64 and at the
base-16 sites K1 takes, and hold them to:

  * coverage at the 8 x 64^3 training window: every slot written once,
    every voxel of a sample in exactly one slot of that sample, per N tile;
  * the plain statistics of the same f32 conv (``conv3d_plain``): sum y
    within 1e-5 of sum |y|, sum y^2 within 1e-5 relative (the same f32
    values added in another order);
  * the JAX package's ``_wino_T`` statistics (``wino_conv3d_pallas`` in
    interpret mode, as ``tests/test_torch_conv3d_in.py`` runs it) at the
    tolerances of that file (rtol 1e-4, atol 1e-4 of the largest sum);
  * batch invariance: sample 0's statistics at B = 8 equal, to the bit,
    its statistics at B = 1 (the brick order depends only on the sample's
    geometry, not on the batch or on the persistent schedule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.wino_pallas import wino_conv3d_pallas
from mica_tpu_torch.ops import conv3d_in
from mica_tpu_torch.ops.conv3d_in import K1_SUM_GROUPS, k1_plan

SITES = [(cis, co) for cis, co, stats in conv3d_in.k1_sites(64) if stats]
# the base-16 sites K1 takes that base 64 does not have
SITES += [(cis, co) for cis, co, stats in conv3d_in.k1_sites(16)
          if stats and conv3d_in.k1_takes(cis, co) and (cis, co) not in SITES]
IDS = [f"{'+'.join(map(str, cis))}->{co}" for cis, co in SITES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread while the file runs: under a loaded suite a pool
    of a thread a core waits on descheduled threads at every parallel
    region, and these tests ran ~13x slower there than alone."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _slot(plan, x0, y0, z0):
    """The brick's slot within its sample: (z * nby + y) * nbx + x."""
    bw, bh, bd = plan.brick
    nbx, nby, _ = plan.bricks
    return (z0 // bd * nby + y0 // bh) * nbx + x0 // bw


def _emulated_stats(y, plan):
    """(B, 2, Co) of y (B, D, H, W, Co) f32 as K1 sums it: each tile's
    partial row pair into its slot (the buffer starts as NaN: the kernel
    does not zero it, so every slot must be written), then the second
    kernel's fixed order."""
    bw, bh, bd = plan.brick
    part = torch.full(plan.partials, float("nan"))
    for t in range(plan.tiles):
        if plan.tile(t) is None:
            continue
        s, x0, y0, z0, n0 = plan.tile(t)
        rows = y[s, z0:z0 + bd, y0:y0 + bh, x0:x0 + bw, n0:n0 + plan.bn].reshape(-1, plan.bn)
        slot = _slot(plan, x0, y0, z0)
        part[s, slot, 0, n0:n0 + plan.bn] = rows.sum(0)
        part[s, slot, 1, n0:n0 + plan.bn] = (rows * rows).sum(0)
    assert not torch.isnan(part).any(), "a slot of the partials was never written"
    return conv3d_in.sum_partials_plain(part)


def _inputs(shape, cis, co, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(tuple(shape) + (c,)).astype(np.float32) for c in cis]
    k = (rng.standard_normal((3, 3, 3, sum(cis), co)) * np.sqrt(2.0 / (27 * sum(cis))))
    b = rng.standard_normal(co).astype(np.float32)
    # torch layout (Co, Ci, 3, 3, 3) from DHWIO
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k.astype(np.float32), (4, 3, 0, 1, 2))))
    return xs, k.astype(np.float32), b, w


@pytest.mark.parametrize("cis,co", SITES, ids=IDS)
def test_every_slot_written_once_and_every_voxel_counted_once(cis, co):
    plan = k1_plan(cis, co, (8, 64, 64, 64))
    b, d, h, w = plan.shape
    bw, bh, bd = plan.brick
    nb = plan.bricks_per_sample
    assert plan.partials == (b, nb, 2, co)
    written = np.zeros((plan.n_tiles, b, nb), np.int32)
    voxels = np.zeros((plan.n_tiles, b, d, h, w), np.int32)
    for t in range(plan.tiles):
        if plan.tile(t) is None:
            continue
        s, x0, y0, z0, n0 = plan.tile(t)
        slot = _slot(plan, x0, y0, z0)
        written[n0 // plan.bn, s, slot] += 1
        voxels[n0 // plan.bn, s, z0:z0 + bd, y0:y0 + bh, x0:x0 + bw] += 1
    assert (written == 1).all() and (voxels == 1).all(), plan
    # the second kernel's rows visit each slot of a sample once
    visited = sorted(k for g in range(K1_SUM_GROUPS) for k in range(g, nb, K1_SUM_GROUPS))
    assert visited == list(range(nb))


@pytest.mark.parametrize("cis,co", SITES, ids=IDS)
def test_emulated_stats_equal_the_plain_stats(cis, co):
    # bricks cut by the volume's edge in y and x, several a sample
    shape = (2, 3, 5, 20)
    xs, _, b, w = _inputs(shape, cis, co, seed=co + sum(cis))
    plan = k1_plan(cis, co, shape)
    assert plan.bricks_per_sample > 1
    y, want = conv3d_in.conv3d_plain([torch.from_numpy(x) for x in xs], w, torch.from_numpy(b))
    got = _emulated_stats(y, plan)
    abs_sum = y.abs().sum(dim=(1, 2, 3))
    assert ((got[:, 0] - want[:, 0]).abs() <= 1e-5 * abs_sum).all()
    assert ((got[:, 1] - want[:, 1]).abs() <= 1e-5 * want[:, 1]).all()


@pytest.mark.parametrize("cis,co", [([64], 128), ([128, 64, 64], 128)])
def test_emulated_stats_match_the_jax_kernel(cis, co):
    shape = (2, 8, 8, 8)
    xs, k, b, w = _inputs(shape, cis, co, seed=7)
    _, want = wino_conv3d_pallas(tuple(jnp.asarray(x) for x in xs), jnp.asarray(k),
                                 jnp.asarray(b), interpret=True)
    want = np.asarray(want)
    y, _ = conv3d_in.conv3d_plain([torch.from_numpy(x) for x in xs], w, torch.from_numpy(b))
    plan = k1_plan(cis, co, shape)
    assert plan.bricks_per_sample > 1
    got = _emulated_stats(y, plan).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("cis,co", SITES, ids=IDS)
def test_a_samples_stats_do_not_depend_on_its_batch(cis, co):
    """More bricks a sample than the second kernel's rows, so each row adds
    several; heavy-tailed values, so another order would change the bits."""
    shape = (8, 5, 16, 64)
    g = torch.Generator().manual_seed(co)
    y = torch.randn((*shape, co), generator=g) * torch.exp(3 * torch.randn((*shape, co),
                                                                          generator=g))
    plan8, plan1 = k1_plan(cis, co, shape), k1_plan(cis, co, (1,) + shape[1:])
    assert plan8.ctas != plan1.ctas or plan8.tiles != plan1.tiles
    assert plan1.bricks_per_sample > K1_SUM_GROUPS or plan1.bm == 256
    got8, got1 = _emulated_stats(y, plan8), _emulated_stats(y[:1], plan1)
    assert torch.equal(got8[:1], got1)


def test_sum_partials_plain_is_the_kernels_order():
    """Row g adds bricks g, g + 32, ... from zero, then the rows are added
    in order: the same f32 adds, one at a time, in numpy."""
    g = torch.Generator().manual_seed(3)
    part = torch.randn(2, 70, 2, 32, generator=g) * torch.exp(4 * torch.randn(2, 70, 2, 32,
                                                                              generator=g))
    p = part.numpy()
    want = np.zeros((2, 2, 32), np.float32)
    for b in range(2):
        rows = np.zeros((K1_SUM_GROUPS, 2, 32), np.float32)
        for r in range(K1_SUM_GROUPS):
            for k in range(r, 70, K1_SUM_GROUPS):
                rows[r] = rows[r] + p[b, k]
        acc = rows[0]
        for r in range(1, K1_SUM_GROUPS):
            acc = acc + rows[r]
        want[b] = acc
    assert np.array_equal(conv3d_in.sum_partials_plain(part).numpy(), want)
