"""The port's kernels against their plain versions on the card.

Marked ``cuda``; each test skips where there is no card.  On a machine
with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are bf16; the plain versions run in f32 from the same bf16 values.
Tolerance: 1e-2 of the largest reference value (one bf16 rounding of
the output is 2^-9 relative), statistics 1e-4 relative (f32 sums in
another order, with atomics).
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
