"""The port's depthwise-conv gradients (``DepthwiseConv3Fn``, K7's plain
version on the CPU) against the reference's ``_depthwise_conv3_grads``
and custom VJP ``depthwise_conv3_pallas_ad`` in interpret mode.

f32 throughout.  Tolerance atol 1e-5 (rtol 1e-5) on dk and db, and on dx
(the same sums in another order); the shapes are the reference's own
grad-parity cases.  x and the cotangent are drawn at a quarter of unit
scale: at unit scale the 27-tap sums reach ~85, where the reference's own
f32 summation is 2e-5 from the exact value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.depthwise_pallas import _depthwise_conv3_grads, depthwise_conv3_pallas_ad
from mica_tpu_torch.ops import depthwise

SHAPES = [((2, 8, 8, 8, 8), 4), ((1, 8, 8, 8, 16), 8), ((2, 5, 6, 7, 8), 0)]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape,d_block", SHAPES)
def test_grads_plain_matches_pallas(rng, shape, d_block):
    x = (rng.normal(size=shape) * 0.25).astype(np.float32)
    g = (rng.normal(size=shape) * 0.25).astype(np.float32)
    dk_ref, db_ref = _depthwise_conv3_grads(jnp.asarray(x), jnp.asarray(g),
                                            d_block=d_block, interpret=True)
    got = depthwise.depthwise_grads(_t(x), _t(g)).numpy()
    assert got.shape == (28, shape[-1])
    np.testing.assert_allclose(got[:27], np.asarray(dk_ref).reshape(27, -1), **TOL)
    np.testing.assert_allclose(got[27], np.asarray(db_ref), **TOL)


@pytest.mark.parametrize("shape,d_block", SHAPES)
def test_autograd_fn_matches_custom_vjp(rng, shape, d_block):
    c = shape[-1]
    x = (rng.normal(size=shape) * 0.25).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 1, c)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    cot = (rng.normal(size=shape) * 0.25).astype(np.float32)

    def loss(x_, k_, b_):
        return jnp.sum(depthwise_conv3_pallas_ad(x_, k_, b_, True, d_block) * cot)

    g_ref = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k),
                                              jnp.asarray(bias))
    xt = _t(x).requires_grad_()
    w = _t(np.transpose(k, (4, 3, 0, 1, 2))).requires_grad_()
    bt = _t(bias).requires_grad_()
    (depthwise.depthwise_conv3_ad(xt, w, bt) * _t(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref[0]), **TOL)
    np.testing.assert_allclose(np.transpose(w.grad.numpy(), (2, 3, 4, 1, 0)),
                               np.asarray(g_ref[1]), **TOL)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(g_ref[2]), **TOL)
    assert w.grad.dtype == bt.grad.dtype == torch.float32


def test_grads_plain_matches_torch_autodiff(rng):
    """K7's plain version equals PyTorch's own weight and bias gradients of
    the grouped conv (a second, independent reference)."""
    x = _t(rng.normal(size=(2, 5, 4, 6, 8)).astype(np.float32))
    g = _t(rng.normal(size=(2, 5, 4, 6, 8)).astype(np.float32))
    w = torch.zeros(8, 1, 3, 3, 3, requires_grad=True)
    b = torch.zeros(8, requires_grad=True)
    y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w, b, padding=1, groups=8)
    (y * g.permute(0, 4, 1, 2, 3)).sum().backward()
    got = depthwise.depthwise_grads(x, g)
    torch.testing.assert_close(got[:27], w.grad.reshape(8, 27).t(), **TOL)
    torch.testing.assert_close(got[27], b.grad, **TOL)
