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
With a channel dropout's keep table K4 and K6 stay bitwise equal to their
plain versions (the eager ``torch.where(keep, v / keep_prob, 0)`` on the
card), and K5 equals itself without the table over that eager dy.
``Conv3dInReluFn``'s and ``InReluFn``'s outputs and gradients stay
within 1e-2 relative L2 of the same function run on the CPU, and
``AvgPoolFn``'s gradient equals it.  K8 stays
within 1e-2 of the largest reference value (f32 sums in another order, one
bf16 rounding); K9 and K10 are exact, and K9 leaves a window
that would leave the volume unwritten; device candidate extraction equals
the host path in order and ``pred`` and to 1e-12 in ``coords`` and ``aa``.
K11 and K13 are bitwise equal to their bf16 plain versions, in each mode
and in place or not; K12's f32 sums stay within 1e-5 of the sum of the
terms' magnitudes; ``in_sums`` within 1e-5 of its terms' magnitudes,
equal to the bit from call to call and from batch 8 to a sample alone,
and a whole bf16 forward repeats to the bit.  The f32 route of the engine (library convs, TF32 off)
stays within 1e-4 of the CPU's probabilities.  The replicated engine
through a one-rank NCCL group equals the plain engine to the bit (f32,
cuDNN deterministic).

Beside small and odd shapes, each kernel test takes the shapes the port
runs it at: the engine's batch of 8 x 64^3 windows at every width of
MICA's base-64 forward and training step, and the sites of the base-16
model that the learned test trains, where they differ.  There the limits
above hold, and where a check reads a sum's error against its terms the
output's limit is per sample and channel: K1's statistics within 1e-4
of sum |y| and of sum y^2 (plus 1e-3), ``in_sums``, K5, K7 and K12 within
1e-5 of their terms' magnitudes.  K2, K4 and K6 also stay within 1e-2
(K6: 2e-2) of their f32 plain versions from the same bf16 inputs.  K1
repeats to the bit at each forward site, over two calls and for a sample
alone; the whole bf16 forward and the engine repeat to the bit, and a
window's output does not depend on the other windows of its batch.
"""

import pytest
import torch

from mica_tpu_torch.ops import conv3d_in as _conv3d_in

pytestmark = pytest.mark.cuda

ENGINE_BATCH = (8, 64, 64, 64)      # the engine's batch of 64^3 windows
# 8 of the 64 cores of 48 of a 160^3 map's 192^3 volumes
ENGINE_CORES = [[0, 0, 0], [48, 96, 144], [144, 48, 0], [96, 144, 48], [0, 144, 96],
                [144, 0, 144], [48, 48, 48], [96, 0, 96]]
LEARNED_FWD = (2, 32, 32, 32)       # the learned test's forward check
LEARNED_SITES = [(cis, co) for cis, co, st in _conv3d_in.k1_sites(16)
                 if st and _conv3d_in.k1_takes(cis, co)]


def _k1_cases():
    """(shape, parts' channels, Co, form) of K1: hand-picked geometries,
    then each forward site at base 64 on the engine's batch with
    statistics (``stats``) and without, bias as the forward passes it
    (``bias``, ``plain``), each dx geometry of a base-64 training step
    (``dx``: the flipped, transposed weight of a Co -> sum Ci conv, no
    bias), and the base-16 sites K1 takes (at the learned forward check's
    shape too) with their dx convs, where they are not base 64's."""
    cases = [
        ((2, 8, 8, 8), [64], 32, "stats"),
        ((2, 8, 8, 8), [64, 32, 32], 64, "stats"),     # BK 32 over a 64-channel part
        ((2, 8, 8, 8), [128, 64], 64, "stats"),        # BK 64, two parts
        ((1, 8, 8, 8), [64, 64, 64], 192, "plain"),    # the heads: one N tile of 192
        ((1, 6, 8, 8), [64], 512, "stats"),            # two N tiles of 256
        ((3, 5, 7, 9), [32], 128, "stats"),            # odd: bricks cut every edge, W < brick
        ((2, 9, 10, 5), [32], 96, "plain"),            # a dx geometry, 32 -> 96
        ((2, 16, 16, 16), [64], 32, "stats"),          # many tiles per CTA
    ]
    for cis, co, st in _conv3d_in.k1_sites(64):
        cases += [(ENGINE_BATCH, cis, co, "stats"),
                  (ENGINE_BATCH, cis, co, "bias" if st else "plain")]
    cases += [(ENGINE_BATCH, [ci], co, "dx") for ci, co in _conv3d_in.k1_dx_sites(64)]
    for cis, co in LEARNED_SITES:
        cases += [(ENGINE_BATCH, cis, co, "stats"), (LEARNED_FWD, cis, co, "stats"),
                  (ENGINE_BATCH, [co], sum(cis), "dx")]
    return [c for i, c in enumerate(cases) if c not in cases[:i]]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, rel=1e-2):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("shape,cis,co,form", _k1_cases())
def test_conv3d_stats_matches_plain(gen, shape, cis, co, form):
    from mica_tpu_torch.ops import conv3d_in

    torch.backends.cudnn.allow_tf32 = False
    parts = [torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
             for c in cis]
    if form == "dx":        # the forward conv's weight, Co -> sum Ci, flipped and transposed
        w = torch.randn(sum(cis), co, 3, 3, 3, device="cuda", generator=gen) * 0.05
        w = w.flip(2, 3, 4).transpose(0, 1)
    else:
        w = torch.randn(co, sum(cis), 3, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen) if form in ("stats", "bias") else None
    stats = form == "stats"
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
        err = (st - ref_st).abs()
        assert (err[:, 0] <= 1e-4 * ref.abs().sum(dim=(1, 2, 3)) + 1e-3).all()
        assert (err[:, 1] <= 1e-4 * ref_st[:, 1] + 1e-3).all()


@pytest.mark.parametrize("cis,co,stats", _conv3d_in.k1_sites(64))
def test_conv3d_stats_repeats_to_the_bit(gen, cis, co, stats):
    """K1 at each forward site at base 64 on the engine's batch, as the
    forward runs it: a second call, and sample 0 alone at batch 1, give
    the same bits, output and statistics; the statistics' second kernel
    (the partials' fixed-order sum) equals its plain version to the bit."""
    from mica_tpu_torch.ops import conv3d_in

    parts = [torch.randn(*ENGINE_BATCH, c, device="cuda", generator=gen).to(torch.bfloat16)
             for c in cis]
    w = torch.randn(co, sum(cis), 3, 3, 3, device="cuda", generator=gen) * 0.05
    b = torch.randn(co, device="cuda", generator=gen) if stats else None
    out, st = conv3d_in.conv3d(parts, w, b, with_stats=stats)
    again, st2 = conv3d_in.conv3d(parts, w, b, with_stats=stats)
    one, st1 = conv3d_in.conv3d([p[:1].contiguous() for p in parts], w, b, with_stats=stats)
    assert torch.equal(out, again) and torch.equal(out[:1], one)
    if stats:
        assert torch.equal(st, st2) and torch.equal(st[:1], st1)
        plan = conv3d_in.k1_plan(cis, co, ENGINE_BATCH)
        part = torch.randn(plan.partials, device="cuda", generator=gen)
        assert torch.equal(conv3d_in.sum_partials(part), conv3d_in.sum_partials_plain(part))


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


@pytest.mark.parametrize("shape,c", [((2, 4, 6, 8), c) for c in (32, 192, 512)]
                         + [(ENGINE_BATCH, c) for c in (32, 64, 128, 256, 512)]
                         + [(LEARNED_FWD, c) for c in (32, 64, 128)])
def test_in_apply_matches_plain_bitwise(gen, shape, c):
    from mica_tpu_torch.ops import conv3d_in

    y = torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
    mean = torch.randn(shape[0], c, device="cuda", generator=gen)
    scale = torch.rand(shape[0], c, device="cuda", generator=gen) + 0.5
    want = conv3d_in.in_apply_plain(y, mean, scale)
    want32 = conv3d_in.in_apply_plain(y.float(), mean.to(torch.bfloat16).float(),
                                      scale.to(torch.bfloat16).float())
    got = conv3d_in.in_apply(y, mean, scale)
    assert got.data_ptr() == y.data_ptr()  # in place
    assert torch.equal(got, want)
    _close(got, want32)


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
    ((3, 16, 16, 16, 128), False),    # a short batch of 16^3 windows
] + [(ENGINE_BATCH + (c,), flip) for c in (16, 32, 64, 128, 256) for flip in (False, True)]
  + [(LEARNED_FWD + (c,), flip) for c in (16, 32, 64) for flip in (False, True)])
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


@pytest.mark.parametrize("shape,c", [((2, 4, 6, 8), c) for c in (32, 192, 512)]
                         + [(ENGINE_BATCH, c) for c in (16, 32, 64, 128, 256, 512)])
def test_in_apply_ad_matches_plain_bitwise(gen, shape, c):
    """Bitwise against the bf16 plain version; y and x^ within 1e-2 of the
    largest |x^| of the f32 one."""
    from mica_tpu_torch.ops import conv3d_in

    x = torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
    mean = torch.randn(shape[0], c, device="cuda", generator=gen)
    scale = torch.rand(shape[0], c, device="cuda", generator=gen) + 0.5
    want_y, want_xh = conv3d_in.in_apply_ad_plain(x, mean, scale)
    f32_y, f32_xh = conv3d_in.in_apply_ad_plain(x.float(), mean.to(torch.bfloat16).float(),
                                                scale.to(torch.bfloat16).float())
    before = conv3d_in.launches["in_apply_ad"]
    y, xh = conv3d_in.in_apply_ad(x, mean, scale)
    assert y.data_ptr() == x.data_ptr()  # y in place
    assert conv3d_in.launches["in_apply_ad"] == before + 1
    assert torch.equal(y, want_y) and torch.equal(xh, want_xh)
    err = max((y.float() - f32_y).abs().max().item(), (xh.float() - f32_xh).abs().max().item())
    assert err <= 1e-2 * f32_xh.abs().max().item(), err


def _drop_table(gen, b: int, c: int, rate: float):
    """A channel dropout at ``rate`` as the model hands it to K4-K6: a
    (B, C) keep table, sample 0 dropping every channel and sample 1
    keeping every one, and the bf16 keep_prob."""
    from mica_tpu_torch.models.mica import keep_prob

    keep = torch.rand(b, c, device="cuda", generator=gen) >= rate
    keep[0], keep[1] = False, True
    return keep, keep_prob(rate, torch.bfloat16)


def _launched(before: dict) -> dict:
    from mica_tpu_torch.ops import conv3d_in

    return {k: v - before[k] for k, v in conv3d_in.launches.items() if v != before[k]}


# the widths of the sites whose dropout K4-K6 apply at base 64 (the RDB
# convs, transitions, DualAttention and heads' norms), beside odd shapes
DROP_CASES = ([((2, 4, 6, 8), c) for c in (32, 192)]
              + [(ENGINE_BATCH, c) for c in (32, 64, 128, 256, 512)])


@pytest.mark.parametrize("rate", [0.01, 0.3])
@pytest.mark.parametrize("shape,c", DROP_CASES)
def test_in_apply_ad_with_a_drop_table_matches_plain_bitwise(gen, shape, c, rate):
    """K4 with a keep table: y and x̂ bitwise against the plain version
    (eager dropout on the card), y 0 in the sample that drops all and
    the undropped y / keep_prob in the one that keeps all; one launch,
    counted in ``drop_fwd``."""
    from mica_tpu_torch.ops import conv3d_in

    x = torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
    mean = torch.randn(shape[0], c, device="cuda", generator=gen)
    scale = torch.rand(shape[0], c, device="cuda", generator=gen) + 0.5
    drop = _drop_table(gen, shape[0], c, rate)
    want_y, want_xh = conv3d_in.in_apply_ad_plain(x, mean, scale, drop)
    bare_y, _ = conv3d_in.in_apply_ad_plain(x, mean, scale)
    before = dict(conv3d_in.launches)
    y, xh = conv3d_in.in_apply_ad(x, mean, scale, drop=drop)
    assert _launched(before) == {"in_apply_ad": 1, "drop_fwd": 1}
    assert torch.equal(y, want_y) and torch.equal(xh, want_xh)
    assert not y[0].any() and torch.equal(y[1], bare_y[1] / drop[1])


@pytest.mark.parametrize("rate", [0.01, 0.3])
@pytest.mark.parametrize("shape,c", DROP_CASES)
def test_in_bwd_kernels_with_a_drop_table_match_plain(gen, shape, c, rate):
    """K5 with a keep table equal to the bit to K5 without one over the
    eager dropout of dy (``drop_plain``) and from call to call, within
    1e-5 of the terms' magnitudes of its plain version; K6 with the table
    bitwise against its plain version and against K6 over the eager dy;
    one K6 launch counted in ``drop_bwd``."""
    from mica_tpu_torch.ops import conv3d_in

    xh = torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, c, device="cuda", generator=gen).to(torch.bfloat16)
    drop = _drop_table(gen, shape[0], c, rate)
    dy_drop = conv3d_in.drop_plain(dy, drop)
    before = dict(conv3d_in.launches)
    st = conv3d_in.in_bwd_stats(xh, dy, drop=drop)
    assert _launched(before) == {"in_bwd_stats": 1}
    assert torch.equal(st, conv3d_in.in_bwd_stats(xh, dy_drop))
    assert torch.equal(conv3d_in.in_bwd_stats(xh, dy, drop=drop), st)
    want = conv3d_in.in_bwd_stats_plain(xh, dy, drop)
    mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy_drop.abs())
    assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
    assert not st[0].any()
    n = shape[1] * shape[2] * shape[3]
    scale = torch.rand(shape[0], c, device="cuda", generator=gen) + 0.5
    args = (xh, dy, st[:, 0] / n, st[:, 1] / n, scale)
    before = dict(conv3d_in.launches)
    got = conv3d_in.in_bwd_apply(*args, drop=drop)
    assert _launched(before) == {"in_bwd_apply": 1, "drop_bwd": 1}
    assert torch.equal(got, conv3d_in.in_bwd_apply_plain(*args, drop=drop))
    assert torch.equal(got, conv3d_in.in_bwd_apply(xh, dy_drop, *args[2:]))


@pytest.mark.parametrize("shape", [(2, 4, 6, 8, 64), (3, 5, 7, 9, 192), (1, 16, 16, 16, 32)]
                         + [ENGINE_BATCH + (c,) for c in (16, 32, 64, 128, 256, 512)])
def test_in_bwd_kernels_match_plain(gen, shape):
    """K5 against its f32 sums at 1e-5 of the terms' magnitudes, equal to
    the bit from call to call; K6 bitwise against its bf16 plain version
    and within 2e-2 of the largest value of its f32 one (bf16 rounding of
    four ops)."""
    from mica_tpu_torch.ops import conv3d_in

    xh = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    st = conv3d_in.in_bwd_stats(xh, dy)
    want = conv3d_in.in_bwd_stats_plain(xh, dy)
    mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
    assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
    assert torch.equal(conv3d_in.in_bwd_stats(xh, dy), st)
    n = shape[1] * shape[2] * shape[3]
    scale = torch.rand(shape[0], shape[-1], device="cuda", generator=gen) + 0.5
    args = (xh, dy, st[:, 0] / n, st[:, 1] / n, scale)
    got = conv3d_in.in_bwd_apply(*args)
    assert torch.equal(got, conv3d_in.in_bwd_apply_plain(*args))
    r = [t.to(torch.bfloat16).float() for t in args[2:]]
    _close(got, conv3d_in.in_bwd_apply_plain(xh.float(), dy.float(), *r), rel=2e-2)


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
    (8, 16, 16, 16, 16), (8, 16, 16, 16, 32), (2, 32, 32, 32, 64), (2, 16, 16, 16, 128),
    (1, 16, 16, 16, 256),             # the forward's widths at base 16 and 64
    (3, 5, 7, 9, 24),                 # C 24, 315 voxels: masked channels and rows
    (2, 9, 10, 11, 96),               # C 96: one masked 128-channel block
] + [ENGINE_BATCH + (c,) for c in (16, 32, 64, 128, 256)])
def test_in_sums_matches_plain_and_repeats_to_the_bit(gen, shape):
    """``in_sums`` within 1e-5 of the sum of |x| and x², and equal to the
    bit from call to call: partials of fixed chunks summed in a fixed
    order."""
    from mica_tpu_torch.ops import conv3d_in

    x = (torch.randn(*shape, device="cuda", generator=gen) + 0.5).to(torch.bfloat16)
    before = conv3d_in.launches["in_sums"]
    st = conv3d_in.in_sums(x)
    assert conv3d_in.launches["in_sums"] == before + 1
    assert st.shape == (shape[0], 2, shape[-1]) and st.dtype == torch.float32
    want = conv3d_in.in_sums_plain(x)
    mag = conv3d_in.in_sums_plain(x.abs())
    assert ((st - want).abs() <= 1e-5 * mag + 1e-4).all()
    assert torch.equal(conv3d_in.in_sums(x), st)


@pytest.mark.parametrize("c", [16, 32, 64, 128, 256])
def test_in_sums_of_a_sample_do_not_depend_on_the_batch(gen, c):
    """At the engine's 8 x 64^3 batch, samples 0 and 7 alone give the bits
    they give in the batch."""
    from mica_tpu_torch.ops import conv3d_in

    x = torch.randn(8, 64, 64, 64, c, device="cuda", generator=gen).to(torch.bfloat16)
    eight = conv3d_in.in_sums(x)
    for i in (0, 7):
        assert torch.equal(conv3d_in.in_sums(x[i:i + 1]), eight[i:i + 1])


def test_in_sums_takes_a_misaligned_operand(gen):
    """An x 2 bytes past a 16-byte boundary: Triton specialises on the
    pointer's alignment, so the wrapper keeps a compiled pair for each."""
    from mica_tpu_torch.ops import conv3d_in

    shape = (2, 5, 6, 11, 24)
    n = 2 * 5 * 6 * 11 * 24
    flat = torch.randn(n + 1, device="cuda", generator=gen).to(torch.bfloat16)
    assert flat[1:].data_ptr() % 16 == 2
    for x in (flat[:n].view(shape), flat[1:].view(shape)):
        st = conv3d_in.in_sums(x)
        mag = conv3d_in.in_sums_plain(x.abs())
        assert ((st - conv3d_in.in_sums_plain(x)).abs() <= 1e-5 * mag + 1e-4).all()
        assert torch.equal(conv3d_in.in_sums(x), st)


@pytest.mark.parametrize("path", ["forward", "engine"])
def test_mica_bf16_forward_repeats_to_the_bit(gen, path, tmp_path):
    """``forward``: a whole bf16 forward at base 64, twice: the same bits,
    with the 19 ``in_sums`` launches a forward.  ``engine``: on a 160^3
    map with a docked model (bf16, batch 8, core 48, halo 8), two
    ``predict_map`` runs, three more of the second's predictor and two of
    a new one: seven runs, one set of volumes."""
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in

    model = MICA(base=64).init_weights(torch.Generator().manual_seed(0))
    if path == "engine":
        import torch_parallel_ranks as ranks
        from mica_tpu_torch.infer.engine import SlidingWindowPredictor
        from mica_tpu_torch.infer.pipeline import build_af3_encoding, predict_map

        kw = dict(batch_size=8, dtype=torch.bfloat16, base_filters=64, core=48, halo=8)
        map_path, pdb_path = ranks.card_map(tmp_path, 160, 0)
        runs = [predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
                for _ in range(2)]
        pred, prepared = runs[1]["predictor"], runs[1]["prepared_map"]
        enc = build_af3_encoding(prepared, str(pdb_path))
        runs += [pred.predict_volume(prepared.volume, enc) for _ in range(3)]
        second = SlidingWindowPredictor(model, **kw)
        runs += [second.predict_volume(prepared.volume, enc) for _ in range(2)]
        first = ranks.probs(runs[0])
        for i, run in enumerate(runs[1:], 1):
            assert ranks.vol_dist(ranks.probs(run), first) == 0.0, f"run {i}"
        return
    model.cuda()
    x = torch.rand(2, 32, 32, 32, 1, device="cuda", generator=gen)
    af = (torch.rand(2, 32, 32, 32, 24, device="cuda", generator=gen) < 0.05).float()
    before = conv3d_in.launches["in_sums"]
    with torch.no_grad():
        first = model(x, af)
        again = model(x, af)
    assert conv3d_in.launches["in_sums"] == before + 38
    for a, b in zip(first, again):
        assert torch.isfinite(a).all() and torch.equal(a, b)


def _fingerprints(model, x, af) -> list:
    """("module: op", per-window fingerprint) of every aten op in one
    forward of ``x``, ``af``, in the order they run: an exact integer sum
    of the output's bits per window, or None where the output does not
    have the windows as its first axis or is an allocation (the
    hand-written kernels fill it; the next op that reads it shows what
    they wrote)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n, stack, prints = len(x), ["MICA"], []
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            t = res[0] if isinstance(res, (tuple, list)) else res
            fp = None
            if (isinstance(t, torch.Tensor) and t.is_cuda and t.dim() > 0 and t.shape[0] == n
                    and "empty" not in str(func)):
                bits = t.detach().contiguous().view(n, -1).view(ints[t.element_size()])
                fp = bits.long().sum(dim=1).tolist()
            prints.append((f"{stack[-1]}: {func}", fp))
            return res

    def enter(name):
        def hook(_mod, _inp):
            stack.append(name or "MICA")
        return hook

    def leave(_mod, _inp, _out):
        stack.pop()

    handles = []
    for name, m in model.named_modules():
        handles += [m.register_forward_pre_hook(enter(name)), m.register_forward_hook(leave)]
    try:
        with torch.no_grad(), Record():
            model(x, af)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return prints


@pytest.mark.parametrize("whole,start,n", [(8, 0, 4), (8, 4, 4), (3, 0, 2), (3, 2, 1)])
def test_mica_bf16_forward_of_a_window_does_not_depend_on_its_batch(gen, whole, start, n):
    """The engine's bf16 network at base 64 on 64^3 windows with AF3
    channels, split as the engine splits a batch over two ranks (8 -> 4 +
    4, the last batch of 3 -> 2 + 1): every op's output for the part's
    windows has the bits it has in the whole batch; a failure names the
    first module and op where it does not."""
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.models.mica import MICA

    model = SlidingWindowPredictor(
        MICA(base=64).init_weights(torch.Generator().manual_seed(0)), batch_size=8,
        dtype=torch.bfloat16, base_filters=64, core=48, halo=8).model
    x = torch.rand(whole, 64, 64, 64, 1, device="cuda", generator=gen)
    af = (torch.rand(whole, 64, 64, 64, 24, device="cuda", generator=gen) < 0.03).float()
    with torch.no_grad():     # the first forward also packs the stem's weight
        model(x[:1], af[:1])
    ref = _fingerprints(model, x, af)
    got = _fingerprints(model, x[start:start + n], af[start:start + n])
    assert [g[0] for g in got] == [r[0] for r in ref], "the two forwards ran different ops"
    differ = [g[0] for g, r in zip(got, ref)
              if g[1] is not None and r[1] is not None and g[1] != r[1][start:start + n]]
    assert not differ, f"{len(differ)} of {len(got)} ops differ, the first {differ[0]}"


@pytest.mark.parametrize("shape", [
    (2, 7, 6, 9, 64), (1, 16, 16, 16, 256), (2, 3, 4, 5, 8),
    (1, 64, 64, 64, 64),              # batch 1: the grid is cut into z segments
    (3, 5, 7, 9, 16),                 # H, W not multiples of the tile; C 16
    (1, 3, 1, 130, 24),               # C 24: a 24-channel group; a single row
    (2, 1, 13, 21, 64),               # D = 1: both z neighbours outside
    (3, 16, 16, 16, 128),             # a short batch of 16^3 windows
] + [ENGINE_BATCH + (c,) for c in (16, 32, 64, 128, 256)])
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


@pytest.mark.parametrize("shape", [(2, 5, 6, 7, 24)]
                         + [ENGINE_BATCH + (c,) for c in (32, 64, 128, 256)])
def test_in_relu_ad_and_avg_pool_ad_match_the_cpu(gen, shape):
    """``InReluFn`` (``in_sums``, K4 over x; K5, K6) and ``AvgPoolFn`` on
    the card against the same functions on the CPU, where every wrapper
    runs its plain version, from the same bf16 input and upstream
    gradients: the norm's y and dx within 1e-2 relative L2 (``in_sums``
    adds in another order, so roundings flip), the pool within 1e-2 of its
    largest value and its dx equal to the bit; one launch of each kernel,
    y written over x; a non-contiguous or f32 input raises."""
    from mica_tpu_torch.ops import conv3d_in

    x = (torch.randn(*shape, device="cuda", generator=gen) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
    gp = torch.randn(shape[0], 1, 1, 1, shape[-1], device="cuda", generator=gen).to(torch.bfloat16)
    got, launched = [], {}
    for dev in ("cuda", "cpu"):
        before = dict(conv3d_in.launches)
        xd = x.to(dev).clone().requires_grad_()
        c = xd * 1                    # a fresh non-leaf, as the model's sites give
        y = conv3d_in.in_relu_ad(c)
        pool = conv3d_in.avg_pool_ad(xd)
        if dev == "cuda":
            assert y.data_ptr() == c.data_ptr()
        dx, = torch.autograd.grad(y, xd, dy.to(dev))
        dxp, = torch.autograd.grad(pool, xd, gp.to(dev))
        got.append([t.detach().cpu() for t in (y, dx, pool, dxp)])
        launched[dev] = {k: conv3d_in.launches[k] - before[k] for k in before}
    assert launched["cuda"] == {"conv3d_stats": 0, "in_apply": 0, "in_apply_ad": 1,
                                "in_bwd_stats": 1, "in_bwd_apply": 1, "in_sums": 2,
                                "drop_fwd": 0, "drop_bwd": 0}
    assert set(launched["cpu"].values()) == {0}
    (y, dx, pool, dxp), (y_c, dx_c, pool_c, dxp_c) = got
    for a, want in ((y, y_c), (dx, dx_c)):
        assert (a.float() - want.float()).norm() <= 1e-2 * want.float().norm()
    _close(pool, pool_c)
    assert torch.equal(dxp, dxp_c)
    with pytest.raises(TypeError):
        conv3d_in.in_relu_ad(x.float())
    with pytest.raises(TypeError):
        conv3d_in.in_relu_ad(x.transpose(1, 2))


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
    (LEARNED_FWD, 32),
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
    ((41, 43, 45), 16, [[0, 0, 0], [25, 27, 29], [3, 5, 7], [13, 1, 22]]),  # nothing 16-byte aligned
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
] + [((192, 192, 192), 48, 20, starts, n_valid)      # the engine's volumes for a 160^3 map
     for starts in (ENGINE_CORES, [[48 * i + 1, 48 * j + 2, 48 * k + 3] for i, j, k in
                                   ((0, 0, 0), (1, 2, 0), (2, 1, 2), (0, 2, 1), (2, 0, 0),
                                    (1, 1, 1), (0, 1, 2), (2, 2, 2))])
     for n_valid in (8, 5)])
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


@pytest.mark.parametrize("shape", [(3, 5, 13, 96), (2, 9, 16, 200),  # odd R, C past a tile, H % 8
                                   (64, 64, 512, 128)])              # distill_ew_crash's
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
                                        ((64, 1, 512, 128), 8), ((2, 3, 20, 32), 4),
                                        ((64, 64, 512, 128), 8)])
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
    assert torch.equal(ew_rows.masked_sq_stats(x, dy, b_sz), got)


@pytest.mark.parametrize("n,offset", [(4096, 0), (1001, 0), (1001, 1), (7, 3), ((1 << 20) + 5, 0),
                                      (8 * 64 ** 3 * 256, 0),   # probe_layout_boundary's tensor
                                      (1 << 24, 1), ((1 << 24) + 3, 0)])
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
    """bf16 at base 16 on the card: K1 launches at the 5 of a forward's 13
    sites whose widths K1 takes (``k1_takes``), K2 after those and at the 9
    norms that take ``in_sums`` (19 a forward with the pools), K3 at 3, K8
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
    assert {k: after[k] - before[k] for k in ("conv3d_stats", "in_apply", "in_sums",
                                              "depthwise3", "stem9")} == {
        "conv3d_stats": 5 * fw, "in_apply": 14 * fw, "in_sums": 19 * fw, "depthwise3": 3 * fw,
        "stem9": fw}
    want = engine.SlidingWindowPredictor(sd, batch_size=2, dtype=torch.float32,
                                         base_filters=16, core=16, halo=8,
                                         device="cpu").predict_volume(vol, af)
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        assert np.isfinite(got[k]).all() and np.abs(got[k] - want[k]).max() <= 0.1, k


def test_trainer_step_base16_bf16_on_the_card(gen):
    """A base-16 bf16 ``Trainer`` step on the card: finite, and K1 launches
    only at the sites it takes (5 forward, 3 recomputed RDB sites, 5 dx),
    with K4 at those 8 and at the 9 norms that follow no K1, forward and
    recomputed (26), K5, K6 at 5 + 9, ``in_sums`` at those 9 norms and the
    10 pools, forward and, but for the stem's pool, recomputed (37); the
    dropout (0.01) in K4 at the 5 K1 sites, the 3 DualAttention and 3
    heads' second norms and, recomputed, 3 + 3 + 3 of them (20), in K6 at
    the 11."""
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
        "conv3d_stats": 13, "in_apply": 0, "in_apply_ad": 26, "in_bwd_stats": 14,
        "in_bwd_apply": 14, "in_sums": 37, "drop_fwd": 20, "drop_bwd": 11}


def test_merizo_on_the_card_matches_the_cpu(gen):
    """Merizo in f32 on the card (TF32 held off, the flags restored after)
    against the same weights on the CPU: mask and background logits within
    1e-3; one forward counted on the card."""
    import numpy as np

    from mica_tpu_torch.models import merizo

    torch.manual_seed(0)
    model = merizo.Merizo().eval()
    rng = np.random.default_rng(0)
    n = 150
    t = np.arange(n) * (100.0 * np.pi / 180.0)
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], 1)
    rot, trans = merizo.gram_schmidt_frames(ca + [-1.2, 0.3, -0.5], ca, ca + [1.2, -0.4, 0.4])
    feats = {"s": np.eye(20, dtype=np.float32)[rng.integers(0, 20, n)],
             "z": np.linalg.norm(ca[:, None] - ca[None], axis=-1).astype(np.float32),
             "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
             "ri": np.arange(1, n + 1, dtype=np.float32), "ca_xyz": ca}
    want = merizo._forward(model, feats)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    before = merizo.forwards["cuda"]
    got = merizo._forward(model.cuda(), feats)
    assert merizo.forwards["cuda"] == before + 1
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= 1e-3


def test_reference_dumps_on_the_card_go_through_the_copy_kernels(gen, tmp_path):
    """Reference-layout dumps at base 64 bf16: K9 and K10 launch once a
    computed batch, as without dumps; four files a window, empty windows
    included; the volumes rebuilt from them equal the returned ones."""
    import numpy as np

    from mica_tpu_torch.infer import engine
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import window_copy as wc

    rng = np.random.default_rng(3)
    vol = np.zeros((40, 30, 20), np.float32)
    vol[2:20, 3:22, 1:15] = rng.random((18, 19, 14))
    model = MICA(base=64).init_weights(torch.Generator().manual_seed(0))
    pred = engine.SlidingWindowPredictor(model, batch_size=2, base_filters=64, core=16, halo=8)
    before = dict(wc.launches)
    out = pred.predict_volume(vol, dump_windows_dir=str(tmp_path), dump_format="reference")
    batches = pred.timing["n_forwards"] - 1
    assert pred.timing["n_empty"] > 0 and batches >= 1
    assert {k: wc.launches[k] - before[k] for k in before} == {
        "gather_windows": batches, "scatter_cores": batches}
    for key in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        files = sorted(tmp_path.glob(f"grid_*_{key}.npz"))
        assert len(files) == pred.timing["n_windows"]
        rebuilt = np.zeros(out[key].shape, np.float32)
        for f in files:
            z = np.load(f, allow_pickle=True)
            m = z["metadata"].item()
            i, j, k, di, dj, dk = (m[c] for c in ("i", "j", "k", "di", "dj", "dk"))
            rebuilt[..., i:i + di, j:j + dj, k:k + dk] = z["data"][..., 8:8 + di, 8:8 + dj,
                                                                   8:8 + dk]
        np.testing.assert_array_equal(rebuilt, out[key], err_msg=key)


@pytest.fixture
def nccl_world1(gen, tmp_path):
    """A one-rank NCCL process group in this process, torn down after."""
    from mica_tpu_torch.parallel import distributed

    distributed.initialize(init_method=f"file://{tmp_path}/rendezvous", world_size=1, rank=0,
                           backend="nccl", local_rank=0, timeout_seconds=120)
    try:
        yield distributed.global_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_resolve_device_under_a_group_is_the_local_ranks_card(nccl_world1):
    from mica_tpu_torch.device import resolve_device

    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert nccl_world1.device == torch.device("cuda", 0) and nccl_world1.distributed


def test_replicated_engine_at_world_1_on_nccl(nccl_world1):
    """The replicated engine through NCCL at world size 1: K9 and K10 once
    a computed batch, and the plain engine's volumes to the bit (f32 with
    cuDNN's deterministic algorithms: bf16 runs differ from run to run,
    K1's statistics being summed with atomics)."""
    import numpy as np

    from mica_tpu_torch.infer import engine
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import window_copy as wc

    rng = np.random.default_rng(3)
    vol = np.zeros((40, 30, 20), np.float32)
    vol[2:30, 3:22, 1:15] = rng.random((28, 19, 14))
    af = np.zeros((24, 40, 30, 20), np.float32)
    af[:, 4:10, 4:9, 2:8] = rng.random((24, 6, 5, 6)) < 0.05
    model = MICA(base=16).init_weights(torch.Generator().manual_seed(0))
    kw = dict(batch_size=2, dtype=torch.float32, base_filters=16, core=16, halo=8)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        want = engine.SlidingWindowPredictor(model, **kw).predict_volume(vol, af)
        pred = engine.SlidingWindowPredictor(model, mesh=nccl_world1, **kw)
        before = dict(wc.launches)
        got = pred.predict_volume(vol, af)
    finally:
        torch.backends.cudnn.deterministic = saved
    batches = pred.timing["n_forwards"] - 1
    assert batches >= 2
    assert wc.launches["gather_windows"] == before["gather_windows"] + batches
    assert wc.launches["scatter_cores"] == before["scatter_cores"] + batches
    for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
