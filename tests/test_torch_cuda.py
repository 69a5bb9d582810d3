"""The port's kernels against their plain versions on the card.

Marked ``cuda``; each test skips where there is no card.  On a machine
with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are bf16; the plain versions run in f32 from the same bf16 values.
Tolerance: 1e-2 of the largest reference value (one bf16 rounding of
the output is 2^-9 relative), statistics 1e-4 relative (f32 sums in
another order, with atomics).  K4 and K6 are bitwise equal to their bf16
plain versions; K5's and K7's f32 sums stay within 1e-5 of the sum of
the terms' magnitudes.  ``Conv3dInReluFn``'s output and gradients stay
within 1e-2 relative L2 of the same function run on the CPU.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, rel=1e-2):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("shape,cis,co,stats", [
    ((2, 8, 8, 8), [64], 32, True),
    ((2, 8, 8, 8), [64, 32, 32], 64, True),
    ((1, 8, 8, 8), [64, 64, 64], 192, False),
    ((3, 5, 7, 9), [32], 128, True),   # blocks span samples: per-row atomics
])
def test_conv3d_stats_matches_plain(gen, shape, cis, co, stats):
    from mica_tpu_torch.ops import conv3d_in

    torch.backends.cudnn.allow_tf32 = False
    parts = [torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
             for c in cis]
    w = torch.randn(co, sum(cis), 3, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen) if stats else None
    before = conv3d_in.launches["conv3d_stats"]
    out, st = conv3d_in.conv3d(parts, w, b, with_stats=stats)
    ref, ref_st = conv3d_in.conv3d_plain([p.float() for p in parts],
                                         w.to(torch.bfloat16).float(), b, stats)
    torch.cuda.synchronize()
    assert conv3d_in.launches["conv3d_stats"] == before + 1
    assert out.dtype == torch.bfloat16
    _close(out, ref)
    if stats:
        _close(st, ref_st, rel=1e-4)


@pytest.mark.parametrize("c", [32, 192, 512])
def test_in_apply_matches_plain_bitwise(gen, c):
    from mica_tpu_torch.ops import conv3d_in

    y = torch.randn(2, 4, 6, 8, c, device="cuda", generator=gen).to(torch.bfloat16)
    mean = torch.randn(2, c, device="cuda", generator=gen)
    scale = torch.rand(2, c, device="cuda", generator=gen) + 0.5
    want = conv3d_in.in_apply_plain(y, mean, scale)
    got = conv3d_in.in_apply(y, mean, scale)
    assert got.data_ptr() == y.data_ptr()  # in place
    assert torch.equal(got, want)


@pytest.mark.parametrize("c", [64, 256])
def test_depthwise_matches_plain(gen, c):
    from mica_tpu_torch.ops import depthwise

    x = torch.randn(2, 7, 6, 9, c, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen)
    _close(depthwise.depthwise_conv3(x, w, b),
           depthwise.depthwise_conv3_plain(x.float(), w, b))


def test_wrappers_refuse_f32_on_card(gen):
    from mica_tpu_torch.ops import conv3d_in, depthwise

    x = torch.randn(1, 4, 4, 4, 32, device="cuda", generator=gen)
    with pytest.raises(TypeError):
        conv3d_in.conv3d([x], torch.randn(32, 32, 3, 3, 3, device="cuda"), None)
    with pytest.raises(TypeError):
        depthwise.depthwise_conv3(x, torch.randn(32, 1, 3, 3, 3, device="cuda"),
                                  torch.zeros(32, device="cuda"))


@pytest.mark.parametrize("c", [32, 192, 512])
def test_in_apply_ad_matches_plain_bitwise(gen, c):
    from mica_tpu_torch.ops import conv3d_in

    x = torch.randn(2, 4, 6, 8, c, device="cuda", generator=gen).to(torch.bfloat16)
    mean = torch.randn(2, c, device="cuda", generator=gen)
    scale = torch.rand(2, c, device="cuda", generator=gen) + 0.5
    want_y, want_xh = conv3d_in.in_apply_ad_plain(x, mean, scale)
    before = conv3d_in.launches["in_apply_ad"]
    y, xh = conv3d_in.in_apply_ad(x, mean, scale)
    assert y.data_ptr() == x.data_ptr()  # y in place
    assert conv3d_in.launches["in_apply_ad"] == before + 1
    assert torch.equal(y, want_y) and torch.equal(xh, want_xh)


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 64), (3, 5, 7, 9, 192), (1, 16, 16, 16, 32)])
def test_in_bwd_kernels_match_plain(gen, shape):
    """K5 against its f32 sums at 1e-5 of the terms' magnitudes; K6
    bitwise against its bf16 plain version."""
    from mica_tpu_torch.ops import conv3d_in

    xh = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    st = conv3d_in.in_bwd_stats(xh, dy)
    want = conv3d_in.in_bwd_stats_plain(xh, dy)
    mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
    assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
    n = shape[1] * shape[2] * shape[3]
    scale = torch.rand(shape[0], shape[-1], device="cuda", generator=gen) + 0.5
    args = (xh, dy, st[:, 0] / n, st[:, 1] / n, scale)
    assert torch.equal(conv3d_in.in_bwd_apply(*args), conv3d_in.in_bwd_apply_plain(*args))


@pytest.mark.parametrize("shape", [(2, 7, 6, 9, 64), (1, 16, 16, 16, 256), (2, 3, 4, 5, 8)])
def test_depthwise_grads_matches_plain(gen, shape):
    from mica_tpu_torch.ops import depthwise

    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    got = depthwise.depthwise_grads(x, g)
    want = depthwise.depthwise_grads_plain(x, g)
    mag = depthwise.depthwise_grads_plain(x.abs(), g.abs())
    assert got.shape == (28, shape[-1])
    assert ((got - want).abs() <= 1e-5 * mag + 1e-4).all()


@pytest.mark.parametrize("cis,co", [([64], 32), ([64, 32], 32), ([64, 32, 32], 64),
                                    ([32], 128)])
def test_conv3d_in_relu_ad_backward_matches_plain(gen, cis, co):
    """y, dx per part (K1 on the swapped geometry, Co -> sum Ci) and dk of
    ``Conv3dInReluFn`` on the card against the same function on the CPU,
    where every wrapper runs its plain version, from the same bf16 inputs
    and upstream gradient: relative L2 within 1e-2 (roundings flip where
    f32 sums run in another order)."""
    from mica_tpu_torch.ops import conv3d_in

    parts = [torch.randn(2, 8, 8, 8, c, device="cuda", generator=gen).to(torch.bfloat16)
             for c in cis]
    w = torch.randn(co, sum(cis), 3, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen)
    dy = torch.randn(2, 8, 8, 8, co, device="cuda", generator=gen)
    got = []
    for dev in ("cuda", "cpu"):
        # fresh leaves on each side (``to`` returns the same tensor on its own device)
        *ps, wd, bd = [t.to(dev).detach().requires_grad_() for t in parts + [w, b]]
        y = conv3d_in.conv3d_in_relu_ad(ps, wd, bd)
        (y.float() * dy.to(dev)).sum().backward()
        got.append([t.detach().float().cpu() for t in [y, wd.grad] + [p.grad for p in ps]])
        assert torch.count_nonzero(bd.grad) == 0
    for a, want in zip(*got):
        assert a.shape == want.shape
        assert (a - want).norm() <= 1e-2 * want.norm(), ((a - want).norm() / want.norm()).item()


def test_autograd_fns_launch_their_kernels(gen):
    """One backward through each autograd function launches K4-K7 and
    returns f32 weight gradients; db of the conv before the norm is 0."""
    from mica_tpu_torch.ops import conv3d_in, depthwise

    x = torch.randn(2, 8, 8, 8, 64, device="cuda", generator=gen).to(torch.bfloat16)
    x.requires_grad_()
    w = (torch.randn(32, 64, 3, 3, 3, device="cuda", generator=gen) * 0.05).requires_grad_()
    b = torch.zeros(32, device="cuda", requires_grad=True)
    k = (torch.randn(64, 1, 3, 3, 3, device="cuda", generator=gen) * 0.2).requires_grad_()
    kb = torch.zeros(64, device="cuda", requires_grad=True)
    before = {**conv3d_in.launches, **depthwise.launches}
    y = conv3d_in.conv3d_in_relu_ad([depthwise.depthwise_conv3_ad(x, k, kb)], w, b)
    y.float().square().sum().backward()
    after = {**conv3d_in.launches, **depthwise.launches}
    for name in ("in_apply_ad", "in_bwd_stats", "in_bwd_apply", "depthwise3_grads"):
        assert after[name] == before[name] + 1, name
    assert after["conv3d_stats"] == before["conv3d_stats"] + 2  # forward and dx
    assert w.grad.dtype == k.grad.dtype == torch.float32
    assert torch.count_nonzero(b.grad) == 0 and x.grad.shape == x.shape
