"""The port's stem (K8's plain version and ``MultiScaleInput.stem``) against
the JAX package's, on the CPU.

Same numpy inputs and weights on both sides.  Tolerances: f32 atol 1e-5
against the Pallas kernel in interpret mode and against the XLA stem (as
``tests/test_ops.py`` holds the two to each other: f32 sums in another
order); through the module, the 1e-4 of ``tests/test_torch_model.py`` in
f32, and in bf16 one bf16 rounding of the output (2^-8 relative) since
both sides round x and the weights to bf16 and accumulate in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mica_tpu.ops.conv_fast import embed_kernel, multiscale_stem_conv
from mica_tpu.ops.stem_pallas import stem_conv_pallas
from mica_tpu_torch.models.mica import MultiScaleInput
from mica_tpu_torch.ops import stem

KS = (3, 5, 7, 9)


def _weights(rng, c):
    kernels = [rng.standard_normal((k, k, k, 1, c // 4)).astype(np.float32) * 0.1 for k in KS]
    biases = [rng.standard_normal(c // 4).astype(np.float32) for _ in KS]
    return kernels, biases


def _torch_weights(kernels):
    """JAX DHWIO kernels as torch OIDHW."""
    return [torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
            for k in kernels]


def _packed(kernels, dtype=torch.float32):
    return stem.pack_weight(_torch_weights(kernels), dtype)


@pytest.mark.parametrize("shape", [(1, 7, 9, 5), (2, 5, 6, 11)])
def test_plain_matches_pallas_interpret_at_odd_sizes(rng, shape):
    c = 16
    kernels, biases = _weights(rng, c)
    x = rng.standard_normal(shape).astype(np.float32)
    combined = jnp.concatenate(
        [embed_kernel(jnp.asarray(k), 9).reshape(9, 81, -1) for k in kernels], axis=-1)
    want = stem_conv_pallas(jnp.asarray(x), combined, jnp.asarray(np.concatenate(biases)),
                            interpret=True)
    before = dict(stem.launches)
    got = stem.stem_conv(torch.from_numpy(x), _packed(kernels),
                         torch.from_numpy(np.concatenate(biases)))
    assert stem.launches == before  # a CPU tensor takes the plain version
    assert got.shape == shape + (c,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_plain_matches_xla_stem_at_even_size(rng):
    c = 16
    kernels, biases = _weights(rng, c)
    x = rng.standard_normal((2, 8, 8, 8, 1)).astype(np.float32)
    want = multiscale_stem_conv(jnp.asarray(x), [jnp.asarray(k) for k in kernels],
                                [jnp.asarray(b) for b in biases], allow_pallas=False)
    got = stem.stem_conv_plain(torch.from_numpy(x[..., 0]), _packed(kernels),
                               torch.from_numpy(np.concatenate(biases)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_pack_weight_layout_round_trips(rng):
    kernels, _ = _weights(rng, 8)                   # 2 channels a group: padded to 8
    ws = _torch_weights(kernels)
    packed = stem.pack_weight(ws, torch.float32)
    assert packed.shape == (1, stem.K_TOTAL * 8)
    assert all(torch.equal(a, b) for a, b in zip(stem.unpack_weight(packed, 8), ws))
    # tap (dz, dy, dx) of channel n of group k sits at K index (dz*k + dy)*(k + 1) + dx
    # of the group, in the k16 step's core matrix [n / 8][K half][n % 8][K % 8]
    off = sum(stem.K_GROUP[:2])                     # the 7^3 group
    kk = (2 * 7 + 5) * 8 + 6
    s, half, e = kk // 16, (kk % 16) // 8, kk % 8
    assert packed[0, off * 8 + s * 8 * 16 + half * 64 + 1 * 8 + e] == ws[2][1, 0, 2, 5, 6]
    # the zero tap ending each row, the K padding and the padded channels
    w3 = packed[0, :stem.K_GROUP[0] * 8].reshape(3, 1, 2, 8, 8).permute(1, 3, 0, 2, 4).reshape(8, 48)
    assert not w3[:, 3:36:4].any() and not w3[:, 36:].any() and not w3[2:].any()
    assert torch.equal(w3[:2, :36].reshape(2, 9, 4)[..., :3].reshape(2, 1, 3, 3, 3), ws[0])
    # the 3^3 kernel is embedded at the centre of the 9^3 one
    w9 = stem.combine_weights(ws)
    assert torch.equal(w9[0, 0, 3:6, 3:6, 3:6], ws[0][0, 0])
    assert w9[0, 0, :3].abs().sum() == 0


def _module(kernels, biases, base):
    m = MultiScaleInput(base)
    with torch.no_grad():
        for conv, w, b in zip(m.exp_convs, _torch_weights(kernels), biases):
            conv.weight.copy_(w)
            conv.bias.copy_(torch.from_numpy(b))
    return m


@pytest.mark.parametrize("shape", [(2, 8, 8, 8), (1, 7, 8, 9)])
@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-4, atol=1e-4)),
                                        ("bfloat16", dict(rtol=2 ** -8, atol=2 ** -8))])
def test_module_stem_matches_jax_stem(rng, shape, dtype, tol):
    base = 16
    kernels, biases = _weights(rng, 2 * base)
    x = rng.standard_normal(shape + (1,)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = multiscale_stem_conv(jnp.asarray(x).astype(jdt), [jnp.asarray(k) for k in kernels],
                                [jnp.asarray(b) for b in biases], compute_dtype=jdt,
                                allow_pallas=False)
    m = _module(kernels, biases, base)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with torch.no_grad():
        got = m.stem(xt)
    assert got.dtype == xt.dtype and got.shape == shape + (2 * base,)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_packed_weight_is_cached_and_invalidated(rng):
    base = 16
    kernels, biases = _weights(rng, 2 * base)
    m = _module(kernels, biases, base)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 6, 1)).astype(np.float32))
    with torch.no_grad():
        y0 = m.stem(x)
        packed = m._packed_stem_weight(torch.float32)
        assert m._packed_stem_weight(torch.float32) is packed          # derived once
        assert m._packed_stem_weight(torch.bfloat16).dtype == torch.bfloat16
        m.exp_convs[3].weight.mul_(2.0)                                 # an in-place step
        assert m._packed_stem_weight(torch.float32) is not packed
        y1 = m.stem(x)
        assert not torch.equal(y0[..., 24:], y1[..., 24:]) and torch.equal(y0[..., :24], y1[..., :24])
        state = {k: v.clone() for k, v in m.state_dict().items()}
        state["exp_convs.0.weight"] = state["exp_convs.0.weight"] * 0.0
        m.load_state_dict(state)
        y2 = m.stem(x)
    assert "_stem_cache" not in m.state_dict() and len(m.state_dict()) == len(state)
    b0 = torch.from_numpy(biases[0])
    assert torch.allclose(y2[..., :8], b0.expand_as(y2[..., :8]))


def test_training_stem_keeps_the_library_conv_and_its_gradient(rng):
    base = 16
    kernels, biases = _weights(rng, 2 * base)
    m = _module(kernels, biases, base)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 6, 1)).astype(np.float32))
    before = dict(stem.launches)
    y = m.stem(x, train=True)
    y.sum().backward()
    assert m.exp_convs[3].weight.grad is not None and stem.launches == before
    with torch.no_grad():
        torch.testing.assert_close(m.stem(x), y, rtol=1e-4, atol=1e-4)


def test_inference_stem_goes_through_the_wrapper_whatever_autograd_records(rng, monkeypatch):
    """The stem routes on ``train`` alone: an inference stem outside
    ``no_grad`` still calls K8's wrapper (its plain version here, which
    autograd can follow to the four kernels) and never a cached weight
    detached from them."""
    base = 16
    kernels, biases = _weights(rng, 2 * base)
    m = _module(kernels, biases, base)
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 6, 1)).astype(np.float32))
    calls = []
    wrapper = stem.stem_conv
    monkeypatch.setattr(stem, "stem_conv", lambda *a: (calls.append(1), wrapper(*a))[1])
    y = m.stem(x)
    y.square().sum().backward()
    assert len(calls) == 1 and m._stem_cache is None
    assert all(c.weight.grad is not None and c.bias.grad is not None for c in m.exp_convs)
    with torch.no_grad():
        assert torch.equal(m.stem(x), y)
    assert len(calls) == 2 and m._stem_cache is not None
    # the training route (a library conv) gives the same gradients
    grads = [c.weight.grad.clone() for c in m.exp_convs]
    m.zero_grad(set_to_none=True)
    m.stem(x, train=True).square().sum().backward()
    assert len(calls) == 2
    for c, g in zip(m.exp_convs, grads):
        torch.testing.assert_close(c.weight.grad, g, rtol=1e-4, atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        stem.stem_conv(x, torch.zeros(16, 729), torch.zeros(16))
    with pytest.raises(TypeError):
        stem.stem_conv(x, torch.zeros(1, stem.K_TOTAL * 8, dtype=torch.bfloat16), torch.zeros(16))
