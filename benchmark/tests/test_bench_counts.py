"""The yardstick's counts, against values worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import counts

V = 64 ** 3          # voxels of a window


def test_k1_site_by_hand():
    # RDB conv1 of stage 0 at base 64: 64 -> 32, batch 8 of 64^3
    # ops 2 * (8 * 262144) * 27 * 64 * 32; bytes bf16 in (64) and out (32)
    # a voxel, plus the 27 * 64 * 32 bf16 weight
    ops, nbytes = counts.k1_launch(8, 64, (64,), 32)
    assert ops == 231_928_233_984
    assert nbytes == 402_653_184 + 110_592
    assert counts.least_s(ops, nbytes) == pytest.approx(231_928_233_984 / 989e12)
    # the heads' fused conv1: three 64-channel parts -> 192
    ops, nbytes = counts.k1_launch(8, 64, (64, 64, 64), 192)
    assert ops == 4_174_708_211_712
    assert nbytes == 2 * 2_097_152 * 384 + 2 * 27 * 192 * 192


def test_other_sites_by_hand():
    # the stem's four Cin=1 convs over their real taps, 32 channels each
    assert sum(counts.conv_flops(V, 1, 32, k) for k in (3, 5, 7, 9)) == 20_535_312_384
    # a depthwise 3^3 over 64 channels; a 1x1 from 128 to 64
    assert counts.conv_flops(V, 64, 64, 3, groups=64) == 905_969_664
    assert counts.conv_flops(V, 128, 64, 1) == 4_294_967_296


def test_network_and_launch_counts():
    f = counts.forward_flops(64, 64, True, 48)
    assert 6.5e12 < f < 7.5e12
    assert f - counts.forward_flops(64, 64, False, 48) == (
        counts.conv_flops(V, 24, 64, 3) + counts.conv_flops(V, 64, 16, 1)
        + counts.conv_flops(V, 16, 1, 1) + counts.conv_flops(V, 192, 64, 1))
    assert len(counts.k1_sites(64)) == 13
    assert counts.k1_predict_least_s(64, 64, [8, 8, 3])[1] == 39
    t, n = counts.k1_train_least_s(64, 64, 8)
    assert n == 33 and t > 2 * counts.k1_predict_least_s(64, 64, [8])[0]


def test_kernel_names():
    assert counts.is_k1("conv3d_stats_kernel(CUtensorMap, CUtensorMap, Params)")
    assert counts.is_k1("stats_sum_kernel(float const*, float*, int, int)")
    assert not counts.is_k1("in_bwd_stats_sum_kernel")
    assert not counts.is_library("in_apply_kernel_0d1d2d3d")
    assert not counts.is_library("Memcpy HtoD (Pageable -> Device)")
    assert counts.is_library("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32")
