"""The port's training conv + InstanceNorm + ReLU (``Conv3dInReluFn``, its
kernels' plain versions on the CPU) against the reference's custom VJP
``wino_conv3d_in_relu_pallas_ad`` in interpret mode.

f32 throughout.  Tolerances: the plain K4/K5/K6 against the JAX formulas
of ``_wino_in_relu_ad_fwd``/``_bwd`` 1e-5 (the same f32 arithmetic, sums
in another order); y 5e-4 and dx/dk 2e-3 as in the JAX package's own
test of the custom VJP (Winograd and direct conv differ by float
reassociation, amplified by the normalisation); db exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.wino_pallas import wino_conv3d_in_relu_pallas_ad
from mica_tpu_torch.ops import conv3d_in


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_in_apply_ad_plain_matches_reference_formula(rng):
    c = rng.standard_normal((2, 4, 5, 6, 32)).astype(np.float32)
    mean = rng.standard_normal((2, 32)).astype(np.float32)
    scale = (rng.random((2, 32)) + 0.5).astype(np.float32)
    y, xh = conv3d_in.in_apply_ad(_t(c), _t(mean), _t(scale))
    # _wino_in_relu_ad_fwd, XLA branch: xh = (c - m) * s; y = relu(xh)
    xh_ref = (c - mean[:, None, None, None]) * scale[:, None, None, None]
    np.testing.assert_allclose(xh.numpy(), xh_ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), np.maximum(xh.numpy(), 0))


def test_in_bwd_plain_matches_reference_formula(rng):
    xh = rng.standard_normal((2, 4, 5, 6, 32)).astype(np.float32)
    dy = rng.standard_normal(xh.shape).astype(np.float32)
    scale = (rng.random((2, 32)) + 0.5).astype(np.float32)
    n = 4 * 5 * 6
    st = conv3d_in.in_bwd_stats(_t(xh), _t(dy)).numpy()
    g = np.where(xh > 0, dy, 0.0)
    np.testing.assert_allclose(st[:, 0], g.sum(axis=(1, 2, 3)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st[:, 1], (g * xh).sum(axis=(1, 2, 3)), rtol=1e-5, atol=1e-5)
    m1, m2 = st[:, 0] / n, st[:, 1] / n
    dc = conv3d_in.in_bwd_apply(_t(xh), _t(dy), _t(m1), _t(m2), _t(scale)).numpy()
    e = lambda v: v[:, None, None, None]  # noqa: E731
    want = e(scale) * (g - e(m1) - xh * e(m2))
    np.testing.assert_allclose(dc, want, rtol=1e-5, atol=1e-5)


def test_in_bwd_apply_plain_bf16_rounding():
    """K6's plain version rounds g, m1, m2, s and each op to bf16, in the
    reference body's order: s * ((g - m1) - xh * m2)."""
    g_ = torch.Generator().manual_seed(0)
    xh = torch.randn(2, 3, 4, 5, 32, generator=g_).to(torch.bfloat16)
    dy = torch.randn(2, 3, 4, 5, 32, generator=g_).to(torch.bfloat16)
    m1, m2 = torch.randn(2, 32, generator=g_), torch.randn(2, 32, generator=g_)
    s = torch.rand(2, 32, generator=g_) + 0.5
    got = conv3d_in.in_bwd_apply(xh, dy, m1, m2, s)
    r = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    e = lambda v: r(v)[:, None, None, None]  # noqa: E731
    g = torch.where(xh.float() > 0, dy.float(), 0.0)
    want = r(e(s) * r(r(g - e(m1)) - r(xh.float() * e(m2))))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), want)


@pytest.mark.parametrize("shapes,co", [
    ([(2, 8, 8, 8, 128)], 128),
    ([(2, 8, 8, 8, 16), (2, 8, 8, 8, 8)], 128),
    ([(2, 8, 8, 8, 16), (2, 8, 8, 8, 8), (2, 8, 8, 8, 8)], 128),
])
def test_autograd_fn_matches_custom_vjp(rng, shapes, co):
    """y, dx per part and dk against ``jax.grad`` of the reference's custom
    VJP, under a fixed cotangent-shaping target (a pure sum() would zero
    the m1 term); db exactly 0."""
    xs = [(rng.standard_normal(s) * 0.5).astype(np.float32) for s in shapes]
    ci = sum(s[-1] for s in shapes)
    k = (rng.standard_normal((3, 3, 3, ci, co)) * 0.2).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    t = rng.standard_normal(shapes[0][:4] + (co,)).astype(np.float32)

    def loss_ref(xs_, k_, b_):
        y = wino_conv3d_in_relu_pallas_ad(xs_, k_, b_, 1e-5, True)
        return jnp.sum(y * t), y

    (_, y_ref), g_ref = jax.value_and_grad(loss_ref, argnums=(0, 1, 2), has_aux=True)(
        tuple(jnp.asarray(x) for x in xs), jnp.asarray(k), jnp.asarray(b))

    parts = [_t(x).requires_grad_() for x in xs]
    w = _t(np.transpose(k, (4, 3, 0, 1, 2))).requires_grad_()
    bias = _t(b).requires_grad_()
    y = conv3d_in.conv3d_in_relu_ad(parts, w, bias)
    (y * _t(t)).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=5e-4, rtol=1e-3)
    for p, r in zip(parts, g_ref[0]):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), atol=2e-3, rtol=2e-3)
    dk = np.transpose(w.grad.numpy(), (2, 3, 4, 1, 0))
    np.testing.assert_allclose(dk, np.asarray(g_ref[1]), atol=2e-3, rtol=2e-3)
    assert w.grad.dtype == torch.float32
    assert torch.count_nonzero(bias.grad) == 0


def test_autograd_fn_matches_torch_autodiff_of_composition(rng):
    """The same function differentiated by PyTorch itself (library conv,
    InstanceNorm formula, relu): the custom backward agrees to 1e-4."""
    xs = [_t((rng.standard_normal((2, 6, 6, 6, c)) * 0.5).astype(np.float32)) for c in (8, 16)]
    w = _t((rng.standard_normal((32, 24, 3, 3, 3)) * 0.2).astype(np.float32))
    b = _t(rng.standard_normal(32).astype(np.float32))
    t = _t(rng.standard_normal((2, 6, 6, 6, 32)).astype(np.float32))

    def compose(parts, w_, b_):
        x = torch.cat(parts, -1).permute(0, 4, 1, 2, 3)
        c = torch.nn.functional.conv3d(x, w_, b_, padding=1).permute(0, 2, 3, 4, 1)
        mean = c.mean(dim=(1, 2, 3), keepdim=True)
        var = torch.clamp((c * c).mean(dim=(1, 2, 3), keepdim=True) - mean * mean, min=0)
        return torch.relu((c - mean) * torch.rsqrt(var + 1e-5))

    grads = []
    for fn in (conv3d_in.conv3d_in_relu_ad, compose):
        ps = [x.clone().requires_grad_() for x in xs]
        wi = w.clone().requires_grad_()
        (fn(ps, wi, b) * t).sum().backward()
        grads.append([p.grad for p in ps] + [wi.grad])
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, atol=1e-4, rtol=1e-4)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    from mica_tpu_torch.ops import depthwise

    g = torch.Generator().manual_seed(1)
    c = torch.randn(1, 3, 4, 5, 32, generator=g)
    m, s = torch.randn(1, 32, generator=g), torch.rand(1, 32, generator=g) + 0.5
    before = {**conv3d_in.launches, **depthwise.launches}
    y, xh = conv3d_in.in_apply_ad(c, m, s)
    assert y.data_ptr() != c.data_ptr()  # out of place off the card
    st = conv3d_in.in_bwd_stats(xh, c)
    dc = conv3d_in.in_bwd_apply(xh, c, st[:, 0], st[:, 1], s)
    dk = depthwise.depthwise_grads(c, dc)
    assert st.shape == (1, 2, 32) and dc.shape == c.shape and dk.shape == (28, 32)
    assert {**conv3d_in.launches, **depthwise.launches} == before
