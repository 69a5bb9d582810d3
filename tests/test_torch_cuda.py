"""The port's kernels against their plain versions on the card.

Marked ``cuda``; each test skips where there is no card.  On a machine
with a card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Inputs are bf16; the plain versions run in f32 from the same bf16 values.
Tolerance: 1e-2 of the largest reference value (one bf16 rounding of
the output is 2^-9 relative), statistics 1e-4 relative (f32 sums in
another order, with atomics).  K4 and K6 are bitwise equal to their bf16
plain versions; K5's and K7's f32 sums stay within 1e-5 of the sum of
the terms' magnitudes, and both are equal to the bit from call to call.
``Conv3dInReluFn``'s output and gradients stay
within 1e-2 relative L2 of the same function run on the CPU.  K8 stays
within 1e-2 of the largest reference value (f32 sums in another order, one
bf16 rounding); K9 and K10 are exact, and K9 leaves a window
that would leave the volume unwritten; device candidate extraction equals
the host path in order and ``pred`` and to 1e-12 in ``coords`` and ``aa``.
K11 and K13 are bitwise equal to their bf16 plain versions, in each mode
and in place or not; K12's f32 sums stay within 1e-5 of the sum of the
terms' magnitudes.  The f32 route of the engine (library convs, TF32 off)
stays within 1e-4 of the CPU's probabilities.
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
    ((2, 8, 8, 8), [64, 32, 32], 64, True),       # BK 32 over a 64-channel part
    ((2, 8, 8, 8), [128, 64], 64, True),          # BK 64, two parts
    ((1, 8, 8, 8), [64, 64, 64], 192, False),     # the heads: one N tile of 192
    ((1, 6, 8, 8), [64], 512, True),              # two N tiles of 256
    ((3, 5, 7, 9), [32], 128, True),              # odd: bricks cut every edge, W < brick
    ((2, 9, 10, 5), [32], 96, False),             # a dx geometry, 32 -> 96
    ((2, 16, 16, 16), [64], 32, True),            # many tiles per CTA
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


def test_conv3d_stats_sums_per_sample_when_ctas_span_samples(gen):
    """Three samples of 128 bricks each: a cluster's tiles lie 132 bricks
    apart, so every CTA's statistics are flushed for more than one sample,
    and every sample's sums still match."""
    from mica_tpu_torch.ops import conv3d_in

    shape, cis, co = (3, 32, 32, 32), [64, 32], 64
    plan = conv3d_in.k1_plan(cis, co, shape)
    assert plan.n_bricks // shape[0] < plan.ctas < plan.tiles
    parts = [torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
             for c in cis]
    w = torch.randn(co, sum(cis), 3, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen)
    out, st = conv3d_in.conv3d(parts, w, b)
    ref, ref_st = conv3d_in.conv3d_plain([p.float() for p in parts],
                                         w.to(torch.bfloat16).float(), b)
    torch.cuda.synchronize()
    _close(out, ref)
    _close(st, ref_st, rel=1e-4)


def test_conv3d_stats_refuses_misaligned_operands(gen):
    """TMA needs 16-byte-aligned addresses: a view at a 2-byte offset is
    refused, not copied."""
    from mica_tpu_torch.ops import conv3d_in

    n = 2 * 4 * 4 * 4 * 32
    flat = torch.randn(n + 1, device="cuda", generator=gen).to(torch.bfloat16)
    x = flat[1:].view(2, 4, 4, 4, 32)
    assert x.is_contiguous() and x.data_ptr() % 16 == 2
    w = torch.randn(32, 32, 3, 3, 3, device="cuda", generator=gen)
    before = conv3d_in.launches["conv3d_stats"]
    with pytest.raises(ValueError, match="16-byte"):
        conv3d_in.conv3d([x], w, None)
    assert conv3d_in.launches["conv3d_stats"] == before
    out, _ = conv3d_in.conv3d([x.clone()], w, None, with_stats=False)
    _close(out, conv3d_in.conv3d_plain([x.float()], w.to(torch.bfloat16).float(), None,
                                       False)[0])


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


@pytest.mark.parametrize("shape,flip", [
    ((1, 64, 64, 64, 64), False),     # batch 1: the grid is cut into z segments
    ((3, 5, 7, 9, 16), False),        # H, W not multiples of the tile; C 16
    ((1, 3, 1, 130, 24), False),      # C 24: a 24-channel group; 9 x tiles
    ((2, 1, 13, 21, 64), False),      # D = 1: both z neighbours outside
    ((2, 16, 16, 16, 128), True),     # the dx form: flipped taps, zero bias
])
def test_depthwise_odd_shapes_and_dx_form_match_plain(gen, shape, flip):
    from mica_tpu_torch.ops import depthwise

    c = shape[-1]
    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=gen)
    b = torch.randn(c, device="cuda", generator=gen)
    if flip:
        w, b = w.flip(2, 3, 4), torch.zeros_like(b)
    before = depthwise.launches["depthwise3"]
    got = depthwise.depthwise_conv3(x, w, b)
    assert depthwise.launches["depthwise3"] == before + 1
    _close(got, depthwise.depthwise_conv3_plain(x.float(), w, b))


def test_depthwise_refuses_an_unaligned_operand(gen):
    from mica_tpu_torch.ops import depthwise

    flat = torch.randn(2 * 4 * 4 * 4 * 8 + 4, device="cuda", generator=gen).to(torch.bfloat16)
    x = flat[4:].view(2, 4, 4, 4, 8)          # contiguous, 8 bytes past an aligned start
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        depthwise.depthwise_conv3(x, torch.randn(8, 1, 3, 3, 3, device="cuda"),
                                  torch.zeros(8, device="cuda"))


def test_predict_volume_f32_on_the_card_matches_the_cpu(gen):
    """f32 takes the library route on the card, with TF32 off: its
    probabilities agree with the CPU's to 1e-4 and no K1/K2/K3/K8 kernel
    launches (base 16: the f32 route has no width rule)."""
    import numpy as np

    from mica_tpu_torch.infer import engine
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in, depthwise, stem

    rng = np.random.default_rng(5)
    vol = rng.random((30, 26, 22)).astype(np.float32)
    af = (rng.random((24, 30, 26, 22)) < 0.05).astype(np.float32)
    model = MICA(base=16, dtype=torch.float32).init_weights(torch.Generator().manual_seed(4))
    out = {}
    for dev in ("cpu", "cuda"):
        pred = engine.SlidingWindowPredictor(model.state_dict(), batch_size=2,
                                             dtype=torch.float32, base_filters=16, core=12,
                                             halo=4, device=dev)
        before = dict(conv3d_in.launches, **depthwise.launches, **stem.launches)
        out[dev] = pred.predict_volume(vol, af)
        after = dict(conv3d_in.launches, **depthwise.launches, **stem.launches)
        assert after == before
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        np.testing.assert_allclose(out["cuda"][k], out["cpu"][k], rtol=0, atol=1e-4)


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


@pytest.mark.parametrize("shape", [
    (1, 64, 64, 64, 32),              # batch 1 at a short C 32 site
    (2, 5, 6, 11, 24),                # C 24; 330 voxels, not a multiple of the tile
    (3, 7, 9, 5, 96),                 # C 96: one masked 128-channel block
    (1, 9, 10, 11, 256),              # two channel blocks
    (8, 16, 16, 16, 512),
])
def test_in_bwd_stats_is_deterministic_at_odd_shapes(gen, shape):
    """K5 within 1e-5 of the terms' magnitudes and equal to the bit from
    call to call: partials of fixed chunks summed in a fixed order."""
    from mica_tpu_torch.ops import conv3d_in

    xh = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    before = conv3d_in.launches["in_bwd_stats"]
    st = conv3d_in.in_bwd_stats(xh, dy)
    assert conv3d_in.launches["in_bwd_stats"] == before + 1
    assert st.shape == (shape[0], 2, shape[-1]) and st.dtype == torch.float32
    want = conv3d_in.in_bwd_stats_plain(xh, dy)
    mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
    assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
    assert torch.equal(conv3d_in.in_bwd_stats(xh, dy), st)


def test_in_bwd_stats_takes_a_misaligned_operand(gen):
    """K5 at one plan on aligned operands, then on an x̂ 2 bytes past a
    16-byte boundary: Triton specialises a kernel on its pointers'
    alignment, so the wrapper keeps a compiled pair for each; both within
    1e-5 of the terms' magnitudes and equal to the bit from call to call."""
    from mica_tpu_torch.ops import conv3d_in

    shape = (2, 5, 6, 11, 24)
    n = 2 * 5 * 6 * 11 * 24
    flat = torch.randn(n + 1, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    for xh in (flat[:n].view(shape), flat[1:].view(shape)):
        st = conv3d_in.in_bwd_stats(xh, dy)
        want = conv3d_in.in_bwd_stats_plain(xh, dy)
        mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
        assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
        assert torch.equal(conv3d_in.in_bwd_stats(xh, dy), st)
    assert flat[1:].data_ptr() % 16 == 2


@pytest.mark.parametrize("shape", [
    (2, 7, 6, 9, 64), (1, 16, 16, 16, 256), (2, 3, 4, 5, 8),
    (1, 64, 64, 64, 64),              # batch 1: the grid is cut into z segments
    (3, 5, 7, 9, 16),                 # H, W not multiples of the tile; C 16
    (1, 3, 1, 130, 24),               # C 24: a 24-channel group; a single row
    (2, 1, 13, 21, 64),               # D = 1: both z neighbours outside
    (3, 16, 16, 16, 128),             # a short batch of 16^3 windows
])
def test_depthwise_grads_matches_plain(gen, shape):
    """K7 within 1e-5 of the terms' magnitudes, and a second call on the
    same inputs equal to the bit (the partials are summed in a fixed
    order, no atomics)."""
    from mica_tpu_torch.ops import depthwise

    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    g = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    before = depthwise.launches["depthwise3_grads"]
    got = depthwise.depthwise_grads(x, g)
    assert depthwise.launches["depthwise3_grads"] == before + 1
    want = depthwise.depthwise_grads_plain(x, g)
    mag = depthwise.depthwise_grads_plain(x.abs(), g.abs())
    assert got.shape == (28, shape[-1])
    assert ((got - want).abs() <= 1e-5 * mag + 1e-4).all()
    assert torch.equal(depthwise.depthwise_grads(x, g), got)


def test_depthwise_grads_refuses_an_unaligned_operand(gen):
    from mica_tpu_torch.ops import depthwise

    flat = torch.randn(2 * 4 * 4 * 4 * 8 + 4, device="cuda", generator=gen).to(torch.bfloat16)
    x = flat[4:].view(2, 4, 4, 4, 8)          # contiguous, 8 bytes past an aligned start
    assert x.is_contiguous() and x.data_ptr() % 16
    ok = torch.randn(2, 4, 4, 4, 8, device="cuda", generator=gen).to(torch.bfloat16)
    for a, b in ((x, ok), (ok, x)):
        with pytest.raises(ValueError, match="16-byte"):
            depthwise.depthwise_grads(a, b)
    with pytest.raises(TypeError):
        depthwise.depthwise_grads(ok.float(), ok.float())


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


def _stem_inputs(gen, shape, c, offset=0):
    flat = torch.randn(offset + int(torch.tensor(shape).prod()), device="cuda", generator=gen)
    x = flat.to(torch.bfloat16)[offset:].view(*shape)
    ws = [torch.randn(c // 4, 1, k, k, k, device="cuda", generator=gen) * k ** -1.5
          for k in (3, 5, 7, 9)]
    return x, ws, torch.randn(c, device="cuda", generator=gen)


@pytest.mark.parametrize("shape,c", [
    ((2, 16, 16, 16), 128),   # even, whole tiles
    ((1, 15, 17, 19), 128),   # odd: masked tiles on every axis
    ((2, 5, 6, 7), 32),       # smaller than a tile, the narrow channel tile
    ((1, 8, 8, 33), 64),
    ((8, 64, 64, 64), 32),    # the main path's batch at every stem width: NG 8, 16, 32
    ((8, 64, 64, 64), 64),
    ((8, 64, 64, 64), 128),
    ((2, 33, 35, 37), 32),    # W % 8 != 0: the halo by 2-byte loads
    ((2, 33, 35, 37), 64),
    ((2, 33, 35, 37), 128),
    ((1, 9, 10, 24), 96),     # three passes of NG 8
    ((1, 6, 7, 16), 256),     # two passes of NG 32
])
def test_stem_conv_matches_plain(gen, shape, c):
    from mica_tpu_torch.ops import stem

    torch.backends.cudnn.allow_tf32 = False
    x, ws, bias = _stem_inputs(gen, shape, c)
    packed = stem.pack_weight(ws, torch.bfloat16)
    before = stem.launches["stem9"]
    got = stem.stem_conv(x, packed, bias)
    torch.cuda.synchronize()
    assert stem.launches["stem9"] == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == shape + (c,)
    _close(got, stem.stem_conv_plain(x.float(), packed.float(), bias))
    with pytest.raises(TypeError):
        stem.stem_conv(x.float(), packed.float(), bias)
    # no backward on the card: a tensor that autograd records is refused
    with pytest.raises(RuntimeError, match="no backward"):
        stem.stem_conv(x, packed, bias.requires_grad_())
    assert stem.launches["stem9"] == before + 1


def test_stem_conv_takes_an_unaligned_x_and_refuses_other_widths(gen):
    """An x 2 bytes past a 16-byte boundary takes the 2-byte halo loads and
    agrees; C = 48 (groups of 12) is refused before any launch."""
    from mica_tpu_torch.ops import stem

    x, ws, bias = _stem_inputs(gen, (2, 8, 8, 32), 64, offset=1)
    assert x.is_contiguous() and x.data_ptr() % 16
    packed = stem.pack_weight(ws, torch.bfloat16)
    _close(stem.stem_conv(x, packed, bias), stem.stem_conv_plain(x.float(), packed.float(), bias))
    x, ws, bias = _stem_inputs(gen, (1, 8, 8, 8), 48)
    before = stem.launches["stem9"]
    with pytest.raises(ValueError, match="C % 32"):
        stem.stem_conv(x, stem.pack_weight(ws, torch.bfloat16), bias)
    assert stem.launches["stem9"] == before


@pytest.mark.parametrize("with_af", [True, False])
@pytest.mark.parametrize("extent,w,starts", [
    ((80, 80, 80), 32, [[0, 0, 0], [24, 24, 24], [48, 0, 24], [13, 7, 41], [48, 48, 48]]),
    ((41, 43, 45), 16, [[0, 0, 0], [25, 27, 29], [3, 5, 7]]),      # nothing 16-byte aligned
    ((160, 160, 160), 64, [[0, 48, 96], [96, 0, 48]]),
    ((208, 208, 208), 64, [[0, 48, 96], [96, 0, 48], [144, 144, 144], [1, 2, 3], [47, 13, 5],
                           [0, 0, 0], [96, 96, 0], [48, 144, 96]]),   # the engine's frame
    ((176, 176, 180), 80, [[0, 64, 96], [96, 0, 3], [17, 31, 100]]),
    ((240, 240, 240), 128, [[0, 112, 112], [112, 0, 1]]),
])
def test_gather_windows_exact(gen, extent, w, starts, with_af):
    from mica_tpu_torch.ops import window_copy as wc

    pm = torch.rand(extent, device="cuda", generator=gen)
    pa = (torch.randint(0, 2 ** 24, extent, device="cuda", generator=gen, dtype=torch.int32)
          if with_af else None)
    st = wc.starts_tensor(torch.tensor(starts).numpy(), extent, w, "cuda")
    before = wc.launches["gather_windows"]
    got = wc.gather_windows(pm, pa, st, w)
    want = wc.gather_windows_plain(pm, pa, st, w)
    torch.cuda.synchronize()
    assert wc.launches["gather_windows"] == before + 1
    if with_af:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("with_af", [True, False])
@pytest.mark.parametrize("extent,w", [((96, 96, 96), 32), ((41, 43, 45), 16)])
def test_gather_windows_leaves_a_start_outside_the_volume_unwritten(gen, extent, w, with_af):
    from mica_tpu_torch.ops import window_copy as wc

    pm = torch.rand(extent, device="cuda", generator=gen)
    pa = (torch.randint(0, 2 ** 24, extent, device="cuda", generator=gen, dtype=torch.int32)
          if with_af else None)
    starts = [[0, 0, 0], [extent[0] - w + 1, 0, 0], [5, 6, 7], [0, -1, 0], [1, 1, extent[2]]]
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")   # not checked on the host
    # the wrapper's launch, into outputs filled beforehand
    wins = torch.full((len(starts), w, w, w), -1.0, device="cuda")
    afs = (torch.full((len(starts), w, w, w), -1, dtype=torch.int32, device="cuda")
           if with_af else None)
    got = wc._launch(pm, pa, st, wins, afs)
    torch.cuda.synchronize()
    outs = (wins, afs) if with_af else (wins,)
    assert all(g_ is o for g_, o in zip(got if with_af else (got,), outs))
    for out, src in zip(outs, (pm, pa)):
        for i in (0, 2):
            x, y, z = starts[i]
            assert torch.equal(out[i], src[x:x + w, y:y + w, z:z + w])
        assert bool((out[[1, 3, 4]] == -1).all())     # skipped whole, never written


@pytest.mark.parametrize("extent,c,a,starts,n_valid", [
    ((80, 80, 80), 24, 4, [[0, 0, 0], [24, 24, 24], [48, 0, 24], [48, 48, 48], [48, 48, 48]], 4),
    ((41, 43, 45), 13, 3, [[0, 0, 0], [26, 13, 31], [13, 26, 5]], 2),   # unaligned rows
    ((96, 96, 96), 48, 20, [[0, 48, 0], [48, 0, 48]], 2),
])
def test_scatter_cores_exact_and_skips_tail(gen, extent, c, a, starts, n_valid):
    from mica_tpu_torch.ops import window_copy as wc

    n = len(starts)
    vols = (torch.rand(extent, device="cuda", generator=gen),
            torch.rand(extent, device="cuda", generator=gen),
            torch.rand(extent + (a,), device="cuda", generator=gen))
    cores = (torch.rand((n, c, c, c), device="cuda", generator=gen),
             torch.rand((n, c, c, c), device="cuda", generator=gen),
             torch.rand((n, c, c, c, a), device="cuda", generator=gen))
    # a skipped entry is not read: poison the tail
    for t in cores:
        t[n_valid:] = float("nan")
    st = wc.starts_tensor(torch.tensor(starts).numpy(), extent, c, "cuda")
    want = wc.scatter_cores_plain(tuple(v.clone() for v in vols), cores, st, n_valid, c)
    before = wc.launches["scatter_cores"]
    got = wc.scatter_cores(vols, cores, st, n_valid, c)
    torch.cuda.synchronize()
    assert wc.launches["scatter_cores"] == before + 1
    for g, v, w_ in zip(got, vols, want):
        assert g.data_ptr() == v.data_ptr()  # in place
        assert torch.equal(g, w_)


@pytest.mark.parametrize("n_res,size,seed", [(40, 48, 7), (120, 96, 3)])
def test_device_candidate_extraction_matches_host(gen, n_res, size, seed):
    import numpy as np

    from mica_tpu_torch.trace.candidates import extract_candidates
    from mica_tpu_torch.trace.candidates_device import extract_candidates_device
    from mica_tpu_torch.utils.synthetic import make_scenario

    _, _, vols = make_scenario(n_res=n_res, shape=(size,) * 3, seed=seed)
    keys = ("carbon_alpha_probability", "backbone_probability", "amino_acid_probability")
    host = extract_candidates(*(vols[k] for k in keys), vols["amino_acid_prediction"],
                              cluster_method="morphology")
    stats = {}
    got = extract_candidates_device(*(torch.from_numpy(vols[k]).cuda() for k in keys),
                                    stats=stats)
    assert len(got["coords"]) == len(host.coords) == stats["n_candidates"] > 0
    np.testing.assert_array_equal(got["pred"], host.aa_pred)     # order too
    np.testing.assert_allclose(got["coords"], host.coords, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got["aa"], host.aa_prob, rtol=0, atol=1e-12)


def test_engine_keeps_volumes_on_the_card_through_the_copy_kernels(gen):
    """Core blend with a packed AF encoding: one K9 and one K10 launch per
    computed batch, one K8 launch per forward, volumes returned as CUDA
    tensors."""
    import numpy as np

    from mica_tpu_torch.infer import engine
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import stem, window_copy as wc

    rng = np.random.default_rng(21)
    vol = np.zeros((40, 30, 20), np.float32)
    vol[2:30, 3:22, 1:15] = rng.random((28, 19, 14))
    af = np.zeros((24, 40, 30, 20), np.float32)
    af[:, 4:10, 4:9, 2:8] = rng.random((24, 6, 5, 6)) < 0.05
    model = MICA(base=64).init_weights(torch.Generator().manual_seed(0))
    pred = engine.SlidingWindowPredictor(model, batch_size=2, base_filters=64, core=16, halo=8)
    before = dict(stem.launches, **wc.launches)
    kept = pred.predict_volume(vol, af, keep_on_device=True)
    batches = pred.timing["n_forwards"] - 1
    assert batches >= 2
    assert stem.launches["stem9"] == before["stem9"] + batches + 1
    assert wc.launches["gather_windows"] == before["gather_windows"] + batches
    assert wc.launches["scatter_cores"] == before["scatter_cores"] + batches
    for k, v in kept.items():
        assert v.is_cuda and v.shape[-3:] == vol.shape and bool(torch.isfinite(v).all())
    assert kept["amino_acid_probability"].shape == (20,) + vol.shape


@pytest.mark.parametrize("shape", [(3, 5, 13, 96), (2, 9, 16, 200)])  # odd R, C past a tile, H % 8
@pytest.mark.parametrize("h_block", [0, 8])
@pytest.mark.parametrize("body", ["k1", "k2", "k3", "k4"])
def test_rows_ew_matches_plain_bitwise(gen, body, h_block, shape):
    from mica_tpu_torch.ops import ew_rows

    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    dy = (torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16) if body == "k4"
          else None)
    table = torch.randn(ew_rows.BODIES[body], *shape[2:], device="cuda", generator=gen)
    want = ew_rows.rows_ew_plain(x, table, body, dy)
    want = want if isinstance(want, tuple) else (want,)
    before = ew_rows.launches["rows_ew"]
    got = ew_rows.rows_ew(x, table, body, dy=dy, h_block=h_block)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # in place, as the aliased variants run: into x, or into dy for k4
    target = (x if dy is None else dy).clone()
    res = (ew_rows.rows_ew(target, table, body, out=target, h_block=h_block) if dy is None
           else ew_rows.rows_ew(x, table, body, dy=target, out=target, h_block=h_block))
    y = res[0] if body == "k2" else res
    torch.cuda.synchronize()
    assert y.data_ptr() == target.data_ptr() and torch.equal(y, want[0])
    assert ew_rows.launches["rows_ew"] == before + 2


@pytest.mark.parametrize("shape,b_sz", [((3, 5, 16, 96), 8), ((2, 7, 13, 200), 8),
                                        ((64, 1, 512, 128), 8), ((2, 3, 20, 32), 4)])
def test_masked_sq_stats_matches_plain(gen, shape, b_sz):
    from mica_tpu_torch.ops import ew_rows

    x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    before = ew_rows.launches["masked_sq_stats"]
    got = ew_rows.masked_sq_stats(x, dy, b_sz)
    torch.cuda.synchronize()
    assert ew_rows.launches["masked_sq_stats"] == before + 1
    want = ew_rows.masked_sq_stats_plain(x, dy, b_sz)
    mag = ew_rows.masked_sq_stats_plain(x, dy.abs(), b_sz)
    assert got.shape == (b_sz, 2, shape[-1])
    assert ((got - want).abs() <= 1e-5 * mag + 1e-4).all()


@pytest.mark.parametrize("n,offset", [(4096, 0), (1001, 0), (1001, 1), (7, 3), ((1 << 20) + 5, 0)])
def test_scale2_matches_plain_bitwise(gen, n, offset):
    """16-byte words with a tail, and a view that starts off the 16-byte
    grid (the element path)."""
    from mica_tpu_torch.ops import scale

    base = torch.randn(n + offset, device="cuda", generator=gen).to(torch.bfloat16)
    base[offset] = 3e38   # doubles to infinity, as the eager product does
    x = base[offset:]
    before = scale.launches["scale2"]
    got = scale.scale2(x)
    torch.cuda.synchronize()
    assert scale.launches["scale2"] == before + 1
    assert got.dtype == torch.bfloat16 and torch.equal(got, scale.scale2_plain(x))


def test_scale2_refuses_what_it_would_have_to_copy(gen):
    from mica_tpu_torch.ops import scale

    x = torch.randn(2, 4, 4, 4, 8, device="cuda", generator=gen).to(torch.bfloat16)
    before = scale.launches["scale2"]
    with pytest.raises(TypeError, match="contiguous"):
        scale.scale2(x.permute(1, 2, 3, 0, 4))
    with pytest.raises(TypeError):
        scale.scale2(x.float())
    assert scale.launches["scale2"] == before
    assert torch.equal(scale.scale2(x.permute(1, 2, 3, 0, 4).contiguous()),
                       scale.scale2_plain(x).permute(1, 2, 3, 0, 4))


def test_predict_volume_base16_bf16_takes_k1_where_it_takes_the_widths(gen):
    """bf16 at base 16 on the card: K1 and K2 launch at the 5 of a
    forward's 13 sites whose widths K1 takes (``k1_takes``), K3 at 3, K8
    once, and the probabilities stay within 0.1 of the f32 CPU's."""
    import numpy as np

    from mica_tpu_torch.infer import engine
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in, depthwise, stem

    rng = np.random.default_rng(5)
    vol = rng.random((40, 30, 20)).astype(np.float32)
    af = (rng.random((24, 40, 30, 20)) < 0.03).astype(np.float32)
    sd = MICA(base=16).init_weights(torch.Generator().manual_seed(0)).state_dict()
    taken = sum(conv3d_in.k1_takes(cis, co) for cis, co, _ in conv3d_in.k1_sites(16))
    assert taken == 5
    pred = engine.SlidingWindowPredictor(sd, batch_size=2, base_filters=16, core=16, halo=8)
    before = dict(conv3d_in.launches, **depthwise.launches, **stem.launches)
    got = pred.predict_volume(vol, af)
    fw = pred.timing["n_forwards"]
    after = dict(conv3d_in.launches, **depthwise.launches, **stem.launches)
    assert {k: after[k] - before[k] for k in ("conv3d_stats", "in_apply", "depthwise3",
                                              "stem9")} == {
        "conv3d_stats": 5 * fw, "in_apply": 5 * fw, "depthwise3": 3 * fw, "stem9": fw}
    want = engine.SlidingWindowPredictor(sd, batch_size=2, dtype=torch.float32,
                                         base_filters=16, core=16, halo=8,
                                         device="cpu").predict_volume(vol, af)
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        assert np.isfinite(got[k]).all() and np.abs(got[k] - want[k]).max() <= 0.1, k


def test_trainer_step_base16_bf16_on_the_card(gen):
    """A base-16 bf16 ``Trainer`` step on the card: finite, and K1 launches
    only at the sites it takes (5 forward, 3 recomputed RDB sites, 5 dx),
    with K4 at 8 and K5, K6 at 5."""
    import numpy as np

    from mica_tpu_torch.ops import conv3d_in
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.trainer import Trainer

    tr = Trainer(base_filters=16, seed=1)
    state = tr.init_state()
    batch = synthetic_batch(2, 32, seed=3)
    before = dict(conv3d_in.launches)
    met = tr.train_step(state, batch, (1.0, 1.0, 1.0), 0.01)
    assert np.isfinite(float(met["total_loss"]))
    assert {k: conv3d_in.launches[k] - before[k] for k in before} == {
        "conv3d_stats": 13, "in_apply": 0, "in_apply_ad": 8, "in_bwd_stats": 5,
        "in_bwd_apply": 5}
