"""The training route of the InstanceNorm + ReLU that follow no K1 and of
the average pools (``in_relu_ad``, ``avg_pool_ad``), on the CPU.

On the CPU the wrappers run their plain versions (``in_sums``, K4-K6), so:

  * ``AvgPoolFn``'s forward and dx equal autograd through the library's
    ``global_avg_pool`` to the bit (the same f32 division and casts);
  * ``InReluFn``'s dx from bf16 inputs stays within ``DX_REL`` (relative
    L2) of autograd through ``instance_norm`` in f32 from the same values;
  * with K4 writing y over its input, as it does on the card, a bf16
    training step's gradients are the out-of-place ones to the bit:
    autograd's version counters would raise if a node had saved an input
    that K4 overwrites.
"""

import pytest
import torch

from mica_tpu_torch.models.mica import MICA, global_avg_pool, instance_norm
from mica_tpu_torch.ops import conv3d_in

# InReluFn's dx in bf16 against the f32 reference.  The inputs are chosen
# so that both sides hold the same mean and scale in f32 and the same ReLU
# mask (below), leaving the bf16 roundings: the forward's scale and x̂,
# K6's casts of m1, m2 and s, and its four ops, eight roundings of at most
# 2^-9 of their values, 1.6 % where all align.  Measured 0.59-0.81 % over
# 60 draws; dropping K6's x̂·m2 term misses by more than 110 %.
DX_REL = 2e-2


def _exact_stats_input(gen: torch.Generator, c: int, b: int = 2, d: int = 8) -> torch.Tensor:
    """bf16 (B, d, d, d, C) whose f32 sums are exact: each channel is a
    power of two times (z + o) / 64, z integers in [-96, 96] in +/- pairs
    (so the mean is o / 64 exactly, bf16 too) and o in [-64, 64].  Then
    x - mean is exact in bf16, and x̂ has the f32 reference's sign."""
    n = d ** 3
    half = torch.randint(-96, 97, (b, n // 2, c), generator=gen)
    z = torch.cat([half, -half], 1)[:, torch.randperm(n, generator=gen)]
    o = torch.randint(-64, 65, (b, 1, c), generator=gen)
    p = 2.0 ** torch.randint(-2, 2, (b, 1, c), generator=gen)
    x = ((z + o) / 64 * p).reshape(b, d, d, d, c)
    assert torch.equal(x.to(torch.bfloat16).float(), x)
    return x.to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 16), (2, 8, 8, 8, 64), (1, 4, 4, 4, 256)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_avg_pool_forward_and_dx_are_the_library_ones_to_the_bit(shape, dtype):
    gen = torch.Generator().manual_seed(shape[-1])
    x = (torch.randn(shape, generator=gen) + 0.5).to(dtype)
    g = torch.randn(shape[0], 1, 1, 1, shape[-1], generator=gen).to(dtype)
    got, want = [], []
    for fn, out in ((conv3d_in.avg_pool_ad, got), (global_avg_pool, want)):
        xl = x.clone().requires_grad_()
        y = fn(xl)
        out += [y, *torch.autograd.grad(y, xl, g)]
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("c", [16, 32, 64])
def test_in_relu_dx_is_within_bf16_rounding_of_f32_autograd(c):
    gen = torch.Generator().manual_seed(c)
    x = _exact_stats_input(gen, c)
    xl = x.clone().requires_grad_()
    y = conv3d_in.in_relu_ad(xl.clone())
    dy = (y.detach().float() + 0.5 * torch.randn(y.shape, generator=gen)).to(torch.bfloat16)
    dx, = torch.autograd.grad(y, xl, dy)
    xf = x.float().requires_grad_()
    want, = torch.autograd.grad(torch.relu(instance_norm(xf)), xf, dy.float())
    assert dx.dtype == torch.bfloat16
    err = ((dx.float() - want).norm() / want.norm()).item()
    assert err <= DX_REL, err
    # the data make K6's x̂·m2 term count: without it dx misses by far more
    n = x.shape[1] * x.shape[2] * x.shape[3]
    mean, scale = conv3d_in.in_stats(conv3d_in.in_sums(x), n)
    _, xh = conv3d_in.in_apply_ad(x.clone(), mean, scale)
    sums = conv3d_in.in_bwd_stats(xh, dy)
    no_m2 = conv3d_in.in_bwd_apply(xh, dy, sums[:, 0] / n, torch.zeros_like(sums[:, 1]), scale)
    assert ((no_m2.float() - want).norm() / want.norm()).item() > 10 * DX_REL


def test_k4_over_its_input_leaves_a_bf16_step_as_it_was(monkeypatch):
    """K4 emulated in place (y copied over its input, as on the card) at
    every site: no error from autograd, and a bf16 step's loss and
    gradients (recomputation and dropout on) are the out-of-place run's to
    the bit.  Every in-place write is at a site of ``in_relu_ad`` or
    ``conv3d_in_relu_ad`` (9 norms + 5 K1 sites at base 16, forward and
    recomputed)."""
    x = torch.rand(2, 8, 8, 8, 1, generator=torch.Generator().manual_seed(0))
    af = (torch.rand(2, 8, 8, 8, 24, generator=torch.Generator().manual_seed(1)) < 0.1).float()
    plain = conv3d_in.in_apply_ad
    written = []

    def over_input(c, mean, scale, drop=None):
        y, xh = plain(c, mean, scale, drop=drop)
        written.append(c.shape[-1])
        return c.copy_(y), xh

    runs = []
    for inplace in (False, True):
        if inplace:
            monkeypatch.setattr(conv3d_in, "in_apply_ad", over_input)
        model = MICA(base=16, dtype=torch.bfloat16, remat=True).init_weights(
            torch.Generator().manual_seed(2))
        outs = model(x, af, train=True, dropout_rate=0.01,
                     generator=torch.Generator().manual_seed(3))
        loss = sum((o.float() ** 2).mean() for o in outs)
        loss.backward()
        runs.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    # forward + recomputed: the 9 norms twice, K1's 5 sites + 3 recomputed RDB sites
    assert len(written) == 2 * 9 + 8, written
