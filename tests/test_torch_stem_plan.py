"""K8's plan (``stem.k8_plan``), its packed weight and its arithmetic, on
the CPU.

The card alone runs K8, but its plan and the layouts it reads are Python:
these tests hold the plan at the stem widths of MICA at base 16, 32 and 64
(C = 32, 64, 128) and at C 96 and 256 (several passes a group), on the 8 x
64^3 batch, batch 1 and odd volumes: every (voxel, channel) is computed by
exactly one (CTA, tile), the CTAs fill the card, the shared memory fits,
and the MMAs issued stay within 1.2x the four convs' real taps.  A width
that is not a multiple of 32 is refused.

Then a torch reference computes the stem tile by tile as the kernel does:
the (12, 12, 32) halo of a tile, zero outside the volume, and its copy
shifted one element; each group's tap pairs read at the offsets of the
kernel's table (two 16-bit offsets a word, a lane's four k16 steps a
16-byte row), from the copy the parity of x + tap picks; B read from the
packed weight at the addresses of the wgmma descriptor (core matrices of
8 x 16 bytes, the K half 128 B on, the next 8 channels 256 B on); f32
products, the f32 bias, the clipped store.  That must equal ``F.conv3d``
of the four kernels zero-embedded in 9^3 at 1e-5 in f32 (sums in another
order), and ``stem_conv_pallas`` in interpret mode at the odd sizes that
``tests/test_torch_stem.py`` holds the plain version to.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mica_tpu.ops.conv_fast import embed_kernel
from mica_tpu.ops.stem_pallas import stem_conv_pallas
from mica_tpu_torch.ops import stem
from mica_tpu_torch.ops._build import SMEM_MAX
from mica_tpu_torch.ops.stem import COPY, HALO, K_GROUP, K_TOTAL, KS, TABLE_WORDS, TILE, k8_plan

SHAPES = [(8, 64, 64, 64), (1, 64, 64, 64), (2, 33, 35, 37), (1, 7, 9, 5), (3, 4, 4, 16)]
WIDTHS = (32, 64, 128, 96, 256)
HZ, HY, HXS = HALO


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", WIDTHS)
def test_plan_covers_every_voxel_and_channel_once(shape, c):
    plan = k8_plan(shape, c)
    b, d, h, w = shape
    assert plan.ng in (8, 16, 32) and (c // 4) % plan.ng == 0
    assert plan.passes * plan.ng == c // 4
    assert plan.ctas % plan.passes == 0 and plan.passes <= plan.ctas <= 132
    assert plan.smem <= SMEM_MAX
    count = np.zeros((plan.passes, b, d, h, w), np.int16)
    for i in range(plan.ctas):
        q, tiles = plan.cta_work(i)
        assert len(tiles) > 0, (i, plan)          # no CTA is idle
        for t in tiles:
            s, z0, y0, x0 = plan.tile(t)
            assert 0 <= s < b and 0 <= z0 < d and 0 <= y0 < h and 0 <= x0 < w
            count[q, s, z0:z0 + TILE[0], y0:y0 + TILE[1], x0:x0 + TILE[2]] += 1
    assert (count == 1).all(), plan


@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("batch", [8, 1])
def test_plan_fills_the_card_and_issues_few_zero_taps(c, batch):
    plan = k8_plan((batch, 64, 64, 64), c)
    assert plan.ctas == 132 // plan.passes * plan.passes       # one CTA an SM
    assert plan.n_tiles * plan.passes >= 2 * plan.ctas
    assert K_TOTAL == 1424 and K_GROUP == (48, 160, 400, 816)
    assert plan.mma_ratio <= 1.2 and abs(plan.mma_ratio - 1424 / 1224) < 1e-12
    # the shared memory of csrc/stem9.cu: 196744 B at NG 32
    assert plan.smem == {32: 196744, 16: 118152, 8: 78856}[plan.ng]


@pytest.mark.parametrize("c", [16, 48, 100, 0])
def test_plan_refuses_widths_the_kernel_does_not_take(c):
    with pytest.raises(ValueError):
        k8_plan((1, 8, 8, 8), c)


def _weights(gen, c):
    return [torch.randn(c // 4, 1, k, k, k, generator=gen, dtype=torch.float64).float() * k ** -1.5
            for k in KS]


@pytest.mark.parametrize("c", WIDTHS)
def test_packed_weight_round_trips_to_the_four_convs(c):
    gen = torch.Generator().manual_seed(c)
    ws = _weights(gen, c)
    packed = stem.pack_weight(ws, torch.bfloat16)
    plan = k8_plan((1, 4, 4, 16), c)
    assert packed.shape == (plan.passes, K_TOTAL * plan.ng) and packed.dtype == torch.bfloat16
    for got, want in zip(stem.unpack_weight(packed, c), ws):
        assert torch.equal(got, want.to(torch.bfloat16))


def _tap_offset(k, kk):
    """The kernel's ``tap_offset``: the halo offset of tap kk of group k for
    a voxel at the tile's origin, less the group's parity."""
    h = (k - 1) // 2
    if kk >= k * k * (k + 1):
        kk = 0
    row, dx = divmod(kk, k + 1)
    dz, dy = divmod(row, k)
    return ((4 - h + dz) * HY + (4 - h + dy)) * HXS + (8 - h + dx) - (h & 1)


def _table():
    """The kernel's offset table: for group i, lane c4 and k16 step s, the
    word (pair 8s + c4) | (pair 8s + c4 + 4) << 16."""
    words, tbase = [], []
    for k, kp in zip(KS, K_GROUP):
        tbase.append(len(words))
        s4 = -(-(kp // 16) // 4) * 4
        for c4 in range(4):
            for s in range(s4):
                o0 = _tap_offset(k, 2 * (8 * s + c4))
                o1 = _tap_offset(k, 2 * (8 * s + c4 + 4))
                assert 0 <= o0 < 1 << 16 and 0 <= o1 < 1 << 16 and o0 % 2 == o1 % 2 == 0
                words.append(o0 | o1 << 16)
    assert len(words) == TABLE_WORDS
    return words, tbase


def _a_index(k, gi, words, tbase):
    """(256 voxels, kp) indices into a slot's two copies (2 * COPY
    elements): the A operand of group k, as the lanes load it."""
    kp = K_GROUP[gi]
    s4 = -(-(kp // 16) // 4) * 4
    par = ((k - 1) // 2) & 1
    idx = np.zeros((TILE[0] * TILE[1] * TILE[2], kp), np.int64)
    for v in range(idx.shape[0]):
        zy, lx = divmod(v, TILE[2])
        lz, ly = divmod(zy, TILE[1])
        row_off = (lz * HY + ly) * HXS
        g, hi = lx % 8, lx // 8                    # lane row g, or g + 8 (8 elements on)
        e = g + par
        base = (e & 1) * COPY + (e & ~1) + row_off + 8 * hi
        for kk in range(kp):
            s, within = divmod(kk, 16)
            reg, c4 = within // 8, (within % 8) // 2
            word = words[tbase[gi] + c4 * s4 + s]
            off = word & 0xFFFF if reg == 0 else word >> 16
            idx[v, kk] = base + off + kk % 2
    assert idx.max() < 2 * COPY
    return torch.from_numpy(idx)


def _b_matrix(packed, gi, q, ng):
    """(ng, kp) B of group gi, pass q, read at the descriptor's addresses."""
    kp = K_GROUP[gi]
    base = sum(K_GROUP[:gi]) * ng
    n = torch.arange(ng)[:, None]
    kk = torch.arange(kp)[None, :]
    elem = (kk // 16) * ng * 16 + (n // 8) * 128 + ((kk % 16) // 8) * 64 + (n % 8) * 8 + kk % 8
    return packed[q, base + elem].float()


def _emulate(x, packed, bias, plan):
    """K8 tile by tile, in f32 (x and the packed weight as given)."""
    b, d, h, w = x.shape
    c = plan.c
    words, tbase = _table()
    out = torch.full((b, d, h, w, c), float("nan"))
    tz, ty, tx = TILE
    # zero-padded volume: the halo of tile (z0, y0, x0) starts at (z0-4, y0-4, x0-8)
    xp = F.pad(x.float(), (8, HXS, 4, HY, 4, HZ))
    halos = []
    for t in range(plan.n_tiles):
        s, z0, y0, x0 = plan.tile(t)
        first = xp[s, z0:z0 + HZ, y0:y0 + HY, x0:x0 + HXS].reshape(-1)
        copy1 = F.pad(first, (0, COPY - first.numel()))
        copy2 = F.pad(copy1[1:], (0, 1))
        halos.append(torch.cat([copy1, copy2]))
    halos = torch.stack(halos)                                   # (tiles, 2 * COPY)
    for gi, k in enumerate(KS):
        a = halos[:, _a_index(k, gi, words, tbase)]              # (tiles, 256, kp)
        for q in range(plan.passes):
            y = a @ _b_matrix(packed, gi, q, plan.ng).T          # (tiles, 256, ng)
            ch = gi * plan.cg + q * plan.ng
            y = y + bias[ch:ch + plan.ng].float()
            for t in range(plan.n_tiles):
                s, z0, y0, x0 = plan.tile(t)
                blk = y[t].reshape(tz, ty, tx, plan.ng)
                dz, dy, dx = min(tz, d - z0), min(ty, h - y0), min(tx, w - x0)
                out[s, z0:z0 + dz, y0:y0 + dy, x0:x0 + dx, ch:ch + plan.ng] = blk[:dz, :dy, :dx]
    return out


@pytest.mark.parametrize("shape,c", [((1, 7, 9, 5), 32), ((2, 5, 6, 11), 64),
                                     ((1, 9, 6, 37), 128), ((1, 5, 4, 17), 96),
                                     ((1, 4, 5, 8), 256)])
def test_tiled_reference_matches_the_zero_embedded_conv(shape, c):
    gen = torch.Generator().manual_seed(sum(shape) + c)
    x = torch.randn(*shape, generator=gen)
    ws = _weights(gen, c)
    bias = torch.randn(c, generator=gen)
    packed = stem.pack_weight(ws, torch.float32)
    plan = k8_plan(shape, c, sm_count=4)
    got = _emulate(x, packed, bias, plan)
    want = F.conv3d(x[:, None], stem.combine_weights(ws), bias, padding=4).permute(0, 2, 3, 4, 1)
    assert not got.isnan().any()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(stem.stem_conv_plain(x, packed, bias), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 7, 9, 5), (2, 5, 6, 11)])
def test_tiled_reference_matches_pallas_interpret_at_odd_sizes(rng, shape):
    c = 32
    kernels = [rng.standard_normal((k, k, k, 1, c // 4)).astype(np.float32) * 0.1 for k in KS]
    biases = [rng.standard_normal(c // 4).astype(np.float32) for _ in KS]
    x = rng.standard_normal(shape).astype(np.float32)
    combined = jnp.concatenate(
        [embed_kernel(jnp.asarray(k), 9).reshape(9, 81, -1) for k in kernels], axis=-1)
    want = stem_conv_pallas(jnp.asarray(x), combined, jnp.asarray(np.concatenate(biases)),
                            interpret=True)
    ws = [torch.from_numpy(np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2))))
          for k in kernels]
    got = _emulate(torch.from_numpy(x), stem.pack_weight(ws, torch.float32),
                   torch.from_numpy(np.concatenate(biases)), k8_plan(shape, c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
