"""The port's conv3d + IN statistics and conv3d_in_relu (plain versions, on
the CPU) against the Pallas Winograd kernels in interpret mode.

f32 throughout.  Tolerances: 1e-4 for the conv output (Winograd and
direct conv differ by float reassociation), the statistics at 1e-4
relative (sums over the volume), 5e-4 for the normalized output as in
the JAX package's own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.wino_pallas import (wino_conv3d_in_relu_pallas,
                                      wino_conv3d_pallas,
                                      wino_conv3d_pallas_padded)
from mica_tpu_torch.ops import conv3d_in


def _case(rng, shapes, co):
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ci = sum(s[-1] for s in shapes)
    k = (rng.standard_normal((3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    # torch layout (Co, Ci, 3, 3, 3) from DHWIO
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
    return xs, k, b, w


@pytest.mark.parametrize("shapes,co", [
    ([(1, 8, 8, 8, 16)], 128),
    ([(2, 8, 8, 8, 16), (2, 8, 8, 8, 8), (2, 8, 8, 8, 8)], 256),
])
def test_conv3d_stats_matches_pallas(rng, shapes, co):
    xs, k, b, w = _case(rng, shapes, co)
    want, want_st = wino_conv3d_pallas(tuple(jnp.asarray(x) for x in xs),
                                       jnp.asarray(k), jnp.asarray(b), interpret=True)
    got, st = conv3d_in.conv3d([torch.from_numpy(x) for x in xs], w,
                               torch.from_numpy(b), with_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    want_st = np.asarray(want_st)
    scale = np.abs(want_st).max()
    np.testing.assert_allclose(st.numpy(), want_st, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("shapes", [[(2, 8, 8, 8, 8)],
                                    [(2, 8, 8, 8, 16), (2, 8, 8, 8, 8)]])
def test_conv3d_in_relu_matches_pallas(rng, shapes):
    xs, k, b, w = _case(rng, shapes, 128)
    want = wino_conv3d_in_relu_pallas(tuple(jnp.asarray(x) for x in xs),
                                      jnp.asarray(k), jnp.asarray(b), interpret=True)
    got = conv3d_in.conv3d_in_relu([torch.from_numpy(x) for x in xs], w,
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=1e-3)


def test_conv3d_no_stats_matches_padded_heads_kernel(rng):
    """The heads' mode: three operands, no bias, no statistics, Co=192."""
    shapes = [(1, 8, 8, 8, 16)] * 3
    xs, k, _, w = _case(rng, shapes, 192)
    want = wino_conv3d_pallas_padded(tuple(jnp.asarray(x) for x in xs),
                                     jnp.asarray(k), interpret=True)[..., :192]
    got, st = conv3d_in.conv3d([torch.from_numpy(x) for x in xs], w, None,
                               with_stats=False)
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_in_apply_plain_bf16_rounding():
    """K2's plain version casts mean/scale to bf16 before the apply and
    rounds each op to bf16, as ``_apply_kernel`` does; exact comparison
    against the same expression in f32 with explicit rounds."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn(2, 4, 4, 4, 32, generator=g).to(torch.bfloat16)
    mean = torch.randn(2, 32, generator=g)
    scale = torch.rand(2, 32, generator=g) + 0.5
    got = conv3d_in.in_apply(y, mean, scale)
    m = mean.to(torch.bfloat16).float()[:, None, None, None]
    s = scale.to(torch.bfloat16).float()[:, None, None, None]
    t = (y.float() - m).to(torch.bfloat16).float()
    want = torch.relu((t * s).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_in_stats_clamps_negative_variance():
    """A constant window has var = 0 exactly (or slightly below from f32
    cancellation): the scale is rsqrt(eps), never NaN."""
    stats = torch.tensor([[[8.0], [7.9999]]])
    mean, scale = conv3d_in.in_stats(stats, 8)
    assert torch.isfinite(scale).all()
    assert torch.allclose(scale, torch.rsqrt(torch.tensor(1e-5)))
