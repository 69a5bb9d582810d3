"""The yardstick's arithmetic: the H100's published peaks, the operations
and bytes of the network and of K1's launches counted from shapes, and the
names of the port's own kernels in a profile.

Operations count a multiply-add as two and only the convolutions and
dense products the algorithm needs (real taps, no zero padding of the
stem's kernels, no recomputation).  Bytes count each input read once and
each output written once, at the launch's dtype (bf16: 2 bytes).
"""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple

PEAK_BF16 = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_BYTES = 3.35e12    # HBM3 bytes/s, same sheet

Site = Tuple[Tuple[int, ...], int, bool]   # (parts' channels, Co, statistics)


def conv_flops(voxels: float, ci: int, co: int, k: int, groups: int = 1) -> float:
    return 2.0 * voxels * k ** 3 * (ci // groups) * co


def forward_flops(base: int, window: int, af3: bool, aa_crop: int = 0) -> float:
    """One window's MICA forward: ``af3`` adds the AF3 branch (feat_conv,
    its gate and the fusion); ``aa_crop`` > 0 crops the amino-acid head's
    final 1x1 to that cube, as inference does."""
    v = float(window) ** 3
    b = base
    f = sum(conv_flops(v, 1, b // 2, k) for k in (3, 5, 7, 9))     # stem
    f += 2 * (2 * b * b + b * 2 * b)                                 # its attention, pooled
    f += conv_flops(v, 2 * b, b, 1)                                  # exp_downsizing
    if af3:
        f += conv_flops(v, 24, b, 3) + conv_flops(v, b, b // 4, 1) + conv_flops(v, b // 4, 1, 1)
        f += conv_flops(v, 3 * b, b, 1)
    for i in range(3):
        c = b * 2 ** i
        f += conv_flops(v, c, c // 2, 3) + conv_flops(v, c + c // 2, c // 2, 3)
        f += conv_flops(v, 2 * c, c, 3)
        f += 2 * (c * (c // 16) * 2)                                 # SE, pooled
        f += conv_flops(v, c, c, 3, groups=c)                        # depthwise
        f += 2 * (c * (c // 4) * 2)                                  # global attention, pooled
        f += conv_flops(v, 2 * c, c, 1)                              # fusion
        f += conv_flops(v, c, 2 * c, 3)                              # transition
    for i in range(3):
        f += conv_flops(v, b * 2 ** (i + 1), b, 1) + conv_flops(v, b, b, 3)
    for extra, n_cls in ((0, 4), (4, 4), (8, 21)):
        f += conv_flops(v, 3 * b + extra, 64, 3) + conv_flops(v, 64, 32, 3)
        f += 2 * (32 * 8 * 2)                                        # calibration, pooled
        vf = float(aa_crop) ** 3 if (n_cls == 21 and aa_crop) else v
        f += conv_flops(vf, 32, n_cls, 1)
    return f


def k1_sites(base: int) -> List[Site]:
    """K1's launches in one forward: per stage the three RDB convs and the
    transition (with statistics), then the heads' fused conv1."""
    sites: List[Site] = []
    c = base
    for _ in range(3):
        h = c // 2
        sites += [((c,), h, True), ((c, h), h, True), ((c, h, h), c, True), ((c,), 2 * c, True)]
        c *= 2
    sites.append(((base,) * 3, 192, False))
    return sites


def k1_launch(rows: int, window: int, cis: Sequence[int], co: int) -> Tuple[float, float]:
    """(operations, bytes) of one K1 launch over ``rows`` windows: a 3^3
    conv of the parts' concat, bf16 in and out, bf16 weight."""
    m = float(rows) * window ** 3
    ci = sum(cis)
    ops = 2.0 * m * 27 * ci * co
    nbytes = 2.0 * m * (ci + co) + 2.0 * 27 * ci * co
    return ops, nbytes


def least_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def k1_predict_least_s(base: int, window: int, batches: Sequence[int]) -> Tuple[float, int]:
    """(least seconds, launches) of K1 over forwards of the given batch
    rows."""
    t, n = 0.0, 0
    for rows in batches:
        for cis, co, _ in k1_sites(base):
            t += least_s(*k1_launch(rows, window, cis, co))
            n += 1
    return t, n


def k1_train_least_s(base: int, window: int, rows: int) -> Tuple[float, int]:
    """(least seconds, launches) of K1 in one training step under per-block
    recomputation: each RDB conv forward twice, each transition once, and
    one dx conv (Co in, the parts' sum out) for each of the twelve sites;
    the heads' conv1 is a library conv in training."""
    t, n = 0.0, 0
    for i, (cis, co, stats) in enumerate(k1_sites(base)):
        if not stats:
            continue
        fwd = 1 if i % 4 == 3 else 2
        t += fwd * least_s(*k1_launch(rows, window, cis, co))
        t += least_s(*k1_launch(rows, window, (co,), sum(cis)))
        n += fwd + 1
    return t, n


# the port's own kernels, by the names a profile gives them
K1_NAME = re.compile(r"conv3d_stats_kernel|(?:^|[^a-z_])stats_sum_kernel")
PORT_NAME = re.compile(
    r"conv3d_stats_kernel|stats_sum_kernel|in_apply_kernel|in_apply_ad_kernel|"
    r"in_bwd_stats_kernel|in_bwd_stats_sum_kernel|in_bwd_apply_kernel|depthwise3_kernel|"
    r"depthwise3_grads_kernel|depthwise3_grads_sum_kernel|stem9_kernel|"
    r"gather_windows_kernel|scatter_cores_kernel|rows_ew_kernel|masked_sq_stats|scale2")
COPY_NAME = re.compile(r"^(Memcpy|Memset)")


def is_k1(name: str) -> bool:
    return bool(K1_NAME.search(name))


def is_library(name: str) -> bool:
    """A device kernel that is not the port's own (copies and fills are
    not kernels)."""
    return not PORT_NAME.search(name) and not COPY_NAME.search(name)
