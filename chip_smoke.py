#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--map-size 160]

Phases, each printing what it found; any failure ends the run non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``mica_tpu_torch/csrc`` (one ``nvcc`` per
     source, all at once);
  3. hold every kernel against its plain PyTorch version at the shapes of
     its path (batch 8, 64^3 windows, the widths of MICA at base 64; for
     K1 also every dx geometry of a training step), in f32 from the same
     bf16 inputs, and time kernel, plain version and one library call (a
     yardstick the port never calls);
  4. the prediction path: ``predict_map`` on a synthetic map written to an
     MRC, with a docked model for the AF3 encoding, random weights from
     ``--seed``, bf16, batch 8, core 48 / halo 8; the launch counts of
     that run alone; a profile of one batch forward; then a small window
     batch against the f32 network on the CPU;
  5. the training path: ``Trainer`` at base 64, bf16, batch 8 of 64^3
     ``synthetic_batch`` windows, recomputation and augmentation on, the
     epoch-0 dropout rate; 2 warm-up and 5 timed steps with the launch
     counts of those 5 alone; 8 steps on one fixed batch whose loss must
     fall; a profile of one step; 2 x 16^3 gradients against the f32
     network on the CPU, at weights initialised from ``--seed`` (held on
     the whole vector and on every tensor) and at the trained weights.

The kernels' JSON record and the card's name come before the last line,
``{"ok": true, "device": {...}}``.  Details go to ``--out`` (default
``build/chip_smoke.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PEAK_BF16 = 989e12      # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_F32 = 67e12        # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # HBM3 bytes/s
BASE = 64
BATCH, WIN = 8, 64


class Failure(Exception):
    pass


def fail_if(cond: bool, msg: str) -> None:
    if cond:
        raise Failure(msg)


def cuda_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters():
    """The kernel wrappers' launch counts (module dicts, mutable)."""
    from mica_tpu_torch.ops import conv3d_in, depthwise

    return conv3d_in.launches, depthwise.launches


def _reset_counts():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def k1_sites_of(base: int = BASE):
    """(parts' channels, Co, stats) of every K1 launch in one forward."""
    sites = []
    c = base
    for _ in range(3):
        h = c // 2
        sites += [([c], h, True), ([c, h], h, True), ([c, h, h], c, True), ([c], 2 * c, True)]
        c *= 2
    sites.append(([base] * 3, 192, False))
    return sites


def check_k1(torch, F, conv3d_in, g, detail):
    """K1 at every site, stats on and off, against the plain version in f32."""
    rows = []
    for cis, co, main_stats in k1_sites_of():
        parts = [torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g)
                 .to(torch.bfloat16) for c in cis]
        ci = sum(cis)
        w = torch.randn(co, ci, 3, 3, 3, device="cuda", generator=g) * math.sqrt(
            2.0 / (27 * (ci + co)))
        b = torch.randn(co, device="cuda", generator=g) * 0.1
        ref, ref_st = conv3d_in.conv3d_plain([p.float() for p in parts],
                                             w.to(torch.bfloat16).float(), b)
        abs_sum = ref.abs().sum(dim=(1, 2, 3))
        for stats in (True, False):
            bias = b if stats or main_stats else None
            want = ref if bias is not None else ref - b
            out, st = conv3d_in.conv3d(parts, w, bias, with_stats=stats)
            torch.cuda.synchronize()
            err = (out.float() - want).abs().max().item()
            tol = 1e-2 * want.abs().max().item()
            fail_if(not err <= tol, f"K1 {cis}->{co} stats={stats}: err {err} > {tol}")
            line = f"K1 {cis}->{co} stats={stats}: max_abs_err {err:.3e} (tol {tol:.3e})"
            if stats:
                s_err = (st - ref_st).abs()
                fail_if(bool((s_err[:, 0] > 1e-4 * abs_sum + 1e-3).any()),
                        f"K1 {cis}->{co}: sum(y) off by {s_err[:, 0].max().item()}")
                fail_if(bool((s_err[:, 1] > 1e-4 * ref_st[:, 1] + 1e-3).any()),
                        f"K1 {cis}->{co}: sum(y^2) off by {s_err[:, 1].max().item()}")
                line += (f"; stats max err {s_err.max().item():.3e} (tol 1e-4 of "
                         "sum|y| and of sum y^2)")
            print(line, flush=True)
            if stats != main_stats:
                continue
            m = BATCH * WIN ** 3
            flops = 2.0 * m * 27 * ci * co
            nbytes = 2.0 * m * (ci + co) + 2.0 * w.numel() + (8.0 * BATCH * co if stats else 0)
            bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
            ms = cuda_ms(lambda: conv3d_in.conv3d(parts, w, bias, with_stats=stats))
            fparts = [p.float() for p in parts]
            wf = w.to(torch.bfloat16).float()
            plain = cuda_ms(lambda: conv3d_in.conv3d_plain(fparts, wf, bias, stats), reps=1)
            xcat = torch.cat(parts, -1).permute(0, 4, 1, 2, 3)
            wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            lib = cuda_ms(lambda: F.conv3d(xcat, wl, bias.to(torch.bfloat16)
                                           if bias is not None else None, padding=1))
            rows.append(dict(site=f"{cis}->{co}", max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd, bound_by=by,
                             tflops=flops / ms / 1e9))
            print(f"  time {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.3f} ms, "
                  f"library conv3d {lib:.3f} ms, bound {bnd:.3f} ms ({by})", flush=True)
        del parts, ref, ref_st
        torch.cuda.empty_cache()
    detail["conv3d_stats"] = rows
    return rows


def k1_dx_sites_of(base: int = BASE):
    """{(Ci, Co): launches per training step} of K1's dx convs: one part
    of a forward site's Co in, that site's summed Ci out, statistics and
    bias off (``Conv3dInReluFn.backward``)."""
    sites = {}
    for cis, co, stats in k1_sites_of(base):
        if stats:
            sites[(co, sum(cis))] = sites.get((co, sum(cis)), 0) + 1
    return sites


def check_k1_dx(torch, F, conv3d_in, g, detail):
    """K1 at every dx geometry of a training step, with the flipped and
    transposed weight the backward passes, against the plain version in f32."""
    rows = []
    for (ci, co), per_step in k1_dx_sites_of().items():
        dc = torch.randn(BATCH, WIN, WIN, WIN, ci, device="cuda", generator=g).to(torch.bfloat16)
        w_fwd = torch.randn(ci, co, 3, 3, 3, device="cuda", generator=g) * math.sqrt(
            2.0 / (27 * (ci + co)))
        w = w_fwd.flip(2, 3, 4).transpose(0, 1)
        want, _ = conv3d_in.conv3d_plain([dc.float()], w.to(torch.bfloat16).float(), None, False)
        out, _ = conv3d_in.conv3d([dc], w, None, with_stats=False)
        torch.cuda.synchronize()
        err = (out.float() - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        fail_if(not err <= tol, f"K1 dx {ci}->{co}: err {err} > {tol}")
        m = BATCH * WIN ** 3
        flops = 2.0 * m * 27 * ci * co
        bnd, by = bound_ms(flops, 2.0 * m * (ci + co) + 2.0 * w.numel(), PEAK_BF16)
        ms = cuda_ms(lambda: conv3d_in.conv3d([dc], w, None, with_stats=False))
        wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        lib = cuda_ms(lambda: F.conv3d(dc.permute(0, 4, 1, 2, 3), wl, padding=1))
        rows.append(dict(site=f"{ci}->{co}", launches_per_step=per_step, max_abs_err=err,
                         ms=ms, library_ms=lib, bound_ms=bnd, bound_by=by))
        print(f"K1 dx {ci}->{co} (x{per_step} per step): max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"time {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), library conv3d {lib:.3f} ms, "
              f"bound {bnd:.3f} ms ({by})", flush=True)
        del dc, want, out
        torch.cuda.empty_cache()
    detail["conv3d_stats_dx"] = rows
    return rows


def check_k2(torch, conv3d_in, g, detail):
    rows = []
    for c in (32, 64, 128, 256, 512):
        y = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        mean = torch.randn(BATCH, c, device="cuda", generator=g) * 0.1
        scale = torch.rand(BATCH, c, device="cuda", generator=g) * 0.5 + 0.5
        want = conv3d_in.in_apply_plain(y.float(), mean.to(torch.bfloat16).float(),
                                         scale.to(torch.bfloat16).float())
        got = conv3d_in.in_apply(y.clone(), mean, scale)
        torch.cuda.synchronize()
        exact = torch.equal(got, conv3d_in.in_apply_plain(y, mean, scale))
        err = (got.float() - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        fail_if(not err <= tol, f"K2 C={c}: err {err} > {tol}")
        nbytes = 2.0 * 2 * y.numel() + 8.0 * BATCH * c
        bnd, by = bound_ms(2.0 * y.numel(), nbytes, PEAK_F32)
        ms = cuda_ms(lambda: conv3d_in.in_apply(y, mean, scale), reps=5)
        plain = cuda_ms(lambda: conv3d_in.in_apply_plain(y, mean, scale))
        m16 = mean.to(torch.bfloat16)[:, None, None, None]
        s16 = scale.to(torch.bfloat16)[:, None, None, None]
        lib = cuda_ms(lambda: y.sub_(m16).mul_(s16).relu_())
        rows.append(dict(site=f"C={c}", max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd, bound_by=by))
        print(f"K2 C={c}: max_abs_err {err:.3e} (tol {tol:.3e}), bitwise equal to the bf16 "
              f"plain version: {exact}; time {ms:.3f} ms, plain {plain:.3f} ms, eager "
              f"in-place {lib:.3f} ms, bound {bnd:.3f} ms ({by})", flush=True)
        del y, want, got
    detail["in_apply"] = rows
    return rows


def check_k3(torch, F, depthwise, g, detail):
    rows = []
    for c in (64, 128, 256):
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=g) * 0.2
        b = torch.randn(c, device="cuda", generator=g) * 0.1
        want = depthwise.depthwise_conv3_plain(x.float(), w, b)
        got = depthwise.depthwise_conv3(x, w, b)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        fail_if(not err <= tol, f"K3 C={c}: err {err} > {tol}")
        nbytes = 2.0 * 2 * x.numel() + 4.0 * 28 * c
        bnd, by = bound_ms(2.0 * 27 * x.numel(), nbytes, PEAK_F32)
        ms = cuda_ms(lambda: depthwise.depthwise_conv3(x, w, b), reps=5)
        xf = x.float()
        plain = cuda_ms(lambda: depthwise.depthwise_conv3_plain(xf, w, b), reps=1)
        xl = x.permute(0, 4, 1, 2, 3)
        wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        bl = b.to(torch.bfloat16)
        lib = cuda_ms(lambda: F.conv3d(xl, wl, bl, padding=1, groups=c))
        rows.append(dict(site=f"C={c}", max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd, bound_by=by))
        print(f"K3 C={c}: max_abs_err {err:.3e} (tol {tol:.3e}); time {ms:.3f} ms, plain "
              f"{plain:.3f} ms, library grouped conv3d {lib:.3f} ms, bound {bnd:.3f} ms "
              f"({by})", flush=True)
        del x, xf, want, got
    detail["depthwise3"] = rows
    return rows


# Launches of K4-K6 per training step at each output width Co, at base 64
# with recomputation: every RDB/transition site once in the forward (K4),
# the 9 RDB sites again in the recomputation (K4), and each site once in
# the backward (K5, K6).
K4_PER_STEP = {32: 4, 64: 6, 128: 7, 256: 3, 512: 1}
K56_PER_STEP = {32: 2, 64: 3, 128: 4, 256: 2, 512: 1}
K7_PER_STEP = {64: 1, 128: 1, 256: 1}


def _bf16_table(torch, g, c, lo, hi):
    return (torch.rand(BATCH, c, device="cuda", generator=g) * (hi - lo) + lo)


def check_k4(torch, conv3d_in, g, detail):
    rows = []
    for c in K4_PER_STEP:
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        mean = _bf16_table(torch, g, c, -0.1, 0.1)
        scale = _bf16_table(torch, g, c, 0.5, 1.5)
        want_y, want_xh = conv3d_in.in_apply_ad_plain(
            x.float(), mean.to(torch.bfloat16).float(), scale.to(torch.bfloat16).float())
        y, xh = conv3d_in.in_apply_ad(x.clone(), mean, scale)
        torch.cuda.synchronize()
        py, pxh = conv3d_in.in_apply_ad_plain(x, mean, scale)
        exact = torch.equal(y, py) and torch.equal(xh, pxh)
        err = max((y.float() - want_y).abs().max().item(), (xh.float() - want_xh).abs().max().item())
        tol = 1e-2 * want_xh.abs().max().item()
        fail_if(not err <= tol, f"K4 C={c}: err {err} > {tol}")
        bnd, by = bound_ms(3.0 * x.numel(), 6.0 * x.numel() + 8.0 * BATCH * c, PEAK_F32)
        buf = x.clone()
        ms = cuda_ms(lambda: conv3d_in.in_apply_ad(buf, mean, scale), reps=5)
        plain = cuda_ms(lambda: conv3d_in.in_apply_ad_plain(x, mean, scale))
        m16 = mean.to(torch.bfloat16)[:, None, None, None]
        s16 = scale.to(torch.bfloat16)[:, None, None, None]
        lib = cuda_ms(lambda: torch.relu(torch.sub(x, m16).mul_(s16)))
        rows.append(dict(site=c, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bnd, bound_by=by))
        print(f"K4 C={c}: max_abs_err {err:.3e} (tol {tol:.3e}), bitwise equal to the bf16 "
              f"plain version: {exact}; time {ms:.3f} ms, plain {plain:.3f} ms, eager bf16 "
              f"{lib:.3f} ms, bound {bnd:.3f} ms ({by})", flush=True)
        del x, y, xh, want_y, want_xh, py, pxh, buf
        torch.cuda.empty_cache()
    detail["in_apply_ad"] = rows
    return rows


def check_k5_k6(torch, conv3d_in, g, detail):
    rows5, rows6 = [], []
    for c in K56_PER_STEP:
        xh = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        dy = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        n = WIN ** 3
        # K5: f32 sums against the plain version's; tolerance 1e-5 of the
        # sum of the terms' magnitudes (f32 sums in another order)
        st = conv3d_in.in_bwd_stats(xh, dy)
        torch.cuda.synchronize()
        want = conv3d_in.in_bwd_stats_plain(xh, dy)
        mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
        err5 = (st - want).abs().max().item()
        excess = ((st - want).abs() - 1e-5 * mag).max().item()
        fail_if(not excess <= 1e-3, f"K5 C={c}: err {err5} beyond 1e-5 of the magnitudes")
        bnd, by = bound_ms(4.0 * xh.numel(), 4.0 * xh.numel() + 8.0 * BATCH * c, PEAK_F32)
        ms = cuda_ms(lambda: conv3d_in.in_bwd_stats(xh, dy), reps=5)
        plain = cuda_ms(lambda: conv3d_in.in_bwd_stats_plain(xh, dy))

        def lib_sums():
            gg = torch.where(xh > 0, dy, 0)
            return torch.stack([gg.sum(dim=(1, 2, 3), dtype=torch.float32),
                                (gg * xh).sum(dim=(1, 2, 3), dtype=torch.float32)], 1)

        lib = cuda_ms(lib_sums)
        rows5.append(dict(site=c, max_abs_err=err5, ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by=by))
        print(f"K5 C={c}: max_abs_err {err5:.3e} (tol 1e-5 of sum |g|, sum |g x^|); time "
              f"{ms:.3f} ms, plain {plain:.3f} ms, torch.sum of the products {lib:.3f} ms, "
              f"bound {bnd:.3f} ms ({by})", flush=True)

        m1, m2 = st[:, 0] / n, st[:, 1] / n
        scale = _bf16_table(torch, g, c, 0.5, 1.5)
        dc = conv3d_in.in_bwd_apply(xh, dy, m1, m2, scale)
        torch.cuda.synchronize()
        exact = torch.equal(dc, conv3d_in.in_bwd_apply_plain(xh, dy, m1, m2, scale))
        r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        want6 = conv3d_in.in_bwd_apply_plain(xh.float(), dy.float(), r(m1), r(m2), r(scale))
        err6 = (dc.float() - want6).abs().max().item()
        tol = 2e-2 * want6.abs().max().item()
        fail_if(not err6 <= tol, f"K6 C={c}: err {err6} > {tol}")
        bnd, by = bound_ms(5.0 * xh.numel(), 6.0 * xh.numel() + 12.0 * BATCH * c, PEAK_F32)
        ms = cuda_ms(lambda: conv3d_in.in_bwd_apply(xh, dy, m1, m2, scale), reps=5)
        plain = cuda_ms(lambda: conv3d_in.in_bwd_apply_plain(xh, dy, m1, m2, scale))
        e = lambda t: t.to(torch.bfloat16)[:, None, None, None]  # noqa: E731
        lib = cuda_ms(lambda: e(scale) * (torch.where(xh > 0, dy, 0) - e(m1) - xh * e(m2)))
        rows6.append(dict(site=c, max_abs_err=err6, ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by=by))
        print(f"K6 C={c}: max_abs_err {err6:.3e} (tol {tol:.3e}, bf16 rounding of four ops), "
              f"bitwise equal to the bf16 plain version: {exact}; time {ms:.3f} ms, plain "
              f"{plain:.3f} ms, eager bf16 {lib:.3f} ms, bound {bnd:.3f} ms ({by})", flush=True)
        del xh, dy, dc, want6
        torch.cuda.empty_cache()
    detail["in_bwd_stats"], detail["in_bwd_apply"] = rows5, rows6
    return rows5, rows6


def check_k7(torch, depthwise, g, detail):
    rows = []
    for c in K7_PER_STEP:
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        gr = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        got = depthwise.depthwise_grads(x, gr)
        torch.cuda.synchronize()
        want = depthwise.depthwise_grads_plain(x, gr)
        mag = depthwise.depthwise_grads_plain(x.abs(), gr.abs())
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - 1e-5 * mag).max().item()
        fail_if(not excess <= 1e-3, f"K7 C={c}: err {err} beyond 1e-5 of the magnitudes")
        bnd, by = bound_ms(2.0 * 28 * x.numel(), 4.0 * x.numel() + 4.0 * 28 * c, PEAK_F32)
        ms = cuda_ms(lambda: depthwise.depthwise_grads(x, gr), reps=5)
        plain = cuda_ms(lambda: depthwise.depthwise_grads_plain(x, gr), reps=1)
        xl, gl = x.permute(0, 4, 1, 2, 3), gr.permute(0, 4, 1, 2, 3)

        def lib_grads():
            dk = torch.nn.grad.conv3d_weight(xl, (c, 1, 3, 3, 3), gl, padding=1, groups=c)
            return dk, gr.sum(dim=(0, 1, 2, 3), dtype=torch.float32)

        lib = cuda_ms(lib_grads)
        rows.append(dict(site=c, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bnd, bound_by=by))
        print(f"K7 C={c}: max_abs_err {err:.3e} (tol 1e-5 of sum |x g| per tap); time "
              f"{ms:.3f} ms, plain {plain:.3f} ms, library weight-grad conv + sum {lib:.3f} ms, "
              f"bound {bnd:.3f} ms ({by})", flush=True)
        del x, gr, want, mag
        torch.cuda.empty_cache()
    detail["depthwise3_grads"] = rows
    return rows


def synthetic_inputs(tmp: Path, n: int, seed: int):
    """A blob-density map (n^3 at 1 A, density in a central ball, empty
    corners) and a docked model of random residues on the blobs."""
    from scipy.ndimage import gaussian_filter

    from mica_tpu_torch.io.mrc import write_mrc
    from mica_tpu_torch.io.pdb import AMINO_ACIDS

    rng = np.random.default_rng(seed)
    centre = np.full(3, n / 2.0)
    pts = rng.normal(size=(int(n ** 3 // 400), 3))
    pts = centre + pts / np.linalg.norm(pts, axis=1, keepdims=True) * (
        rng.random((len(pts), 1)) ** (1 / 3) * 0.3 * n)
    vol = np.zeros((n, n, n), np.float32)
    idx = np.clip(np.rint(pts).astype(int), 0, n - 1)
    np.add.at(vol, tuple(idx.T), 1.0)
    vol = gaussian_filter(vol, 1.5)
    map_path = tmp / "synthetic.mrc"
    write_mrc(map_path, np.transpose(vol, (2, 1, 0)).astype(np.float32), voxel_size=1.0)

    lines = []
    for i, p in enumerate(pts[: len(pts) // 4]):
        res = AMINO_ACIDS[rng.integers(len(AMINO_ACIDS))]
        for j, name in enumerate(("N", "CA", "C", "O")):
            q = p + 0.5 * j
            lines.append(f"ATOM  {(4 * i + j) % 100000:5d}  {name:<3s} {res} A"
                         f"{i % 10000:4d}    {q[0]:8.3f}{q[1]:8.3f}{q[2]:8.3f}"
                         f"  1.00  0.00           {name[0]}")
    pdb_path = tmp / "docked.pdb"
    pdb_path.write_text("\n".join(lines) + "\nEND\n")
    return map_path, pdb_path


def main_path(torch, args, detail):
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in, depthwise

    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(args.seed))
    with tempfile.TemporaryDirectory() as tmp:
        map_path, pdb_path = synthetic_inputs(Path(tmp), args.map_size, args.seed)
        _reset_counts()
        t0 = time.time()
        out = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path),
                          batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE,
                          core=48, halo=8)
        wall = time.time() - t0
        launches = {**conv3d_in.launches, **depthwise.launches}
    timing = out["timing"]
    n = args.map_size
    for key in ("backbone_probability", "carbon_alpha_probability"):
        v = out[key]
        fail_if(v.shape != (n, n, n), f"{key} shape {v.shape}")
        fail_if(not np.isfinite(v).all(), f"{key} not finite")
        fail_if(not (v.min() >= 0 and v.max() <= 1), f"{key} outside [0, 1]")
    aa = out["amino_acid_probability"]
    fail_if(aa.shape != (20, n, n, n) or not np.isfinite(aa).all(), "aa volume bad")
    aa_sum_err = float(np.abs(aa.sum(axis=0) - 1.0).max())
    fail_if(aa_sum_err > 1e-4, f"aa probabilities sum to 1 +- {aa_sum_err}")
    fw = timing["n_forwards"]
    per_forward = {"conv3d_stats": 13, "in_apply": 12, "depthwise3": 3}
    for k, per in per_forward.items():
        fail_if(launches[k] != per * fw,
                f"{k}: {launches[k]} launches for {fw} forwards, expected {per * fw}")
    computed = timing["n_windows"] - timing["n_empty"]
    wps = computed / timing["inference"]
    print(f"main path: map {n}^3, {timing['n_windows']} windows, {timing['n_empty']} empty, "
          f"{computed} computed in {fw} forwards (one is the all-zero window); "
          f"{wps:.3f} windows/s over the inference phase; predict_map wall {wall:.3f} s",
          flush=True)
    print(f"timing {json.dumps(timing)}", flush=True)
    print(f"launches {json.dumps(launches)} (13/12/3 per forward)", flush=True)
    print(f"volumes finite, bb/ca in [0, 1], aa sums to 1 within {aa_sum_err:.2e}", flush=True)
    detail["main_path"] = dict(timing=timing, launches=launches, windows_per_s=wps,
                               wall_s=wall, map_size=n)
    return launches, model


def small_reference(torch, model, seed, detail):
    """A small window batch through the card (bf16, kernels) against the
    same weights in f32 on the CPU (plain versions)."""
    import copy

    from mica_tpu_torch.infer.engine import postprocess_logits

    rng = np.random.default_rng(seed + 1)
    x = rng.random((2, 16, 16, 16, 1)).astype(np.float32)
    af = (rng.random((2, 16, 16, 16, 24)) < 0.03).astype(np.float32)
    af[0] = 0.0
    cpu = copy.deepcopy(model).cpu().float()
    cpu.dtype = torch.float32
    card = copy.deepcopy(model).cuda()
    card.dtype = torch.bfloat16
    with torch.no_grad():
        want = postprocess_logits(*cpu(torch.from_numpy(x), torch.from_numpy(af)))
        got = postprocess_logits(*card(torch.from_numpy(x).cuda(), torch.from_numpy(af).cuda()))
    errs = [(g.cpu() - w).abs().max().item() for g, w in zip(got, want)]
    print(f"small reference (2 x 16^3, bf16 card vs f32 CPU): max |dP| bb {errs[0]:.3e} "
          f"ca {errs[1]:.3e} aa {errs[2]:.3e} (tol 0.1)", flush=True)
    fail_if(max(errs) > 0.1, f"card vs CPU reference differs by {max(errs)}")
    detail["small_reference_max_abs_dp"] = errs


def _device_times(prof) -> dict:
    """ms of device time per kernel name in a torch.profiler run."""
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3
    return per_kernel


def profile_forward(torch, model, seed, detail):
    """Where one batch forward's device time goes: kernel times from
    torch.profiler, the forward's device span from CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    x = torch.rand(BATCH, WIN, WIN, WIN, 1, device="cuda", generator=g)
    af = (torch.rand(BATCH, WIN, WIN, WIN, 24, device="cuda", generator=g) < 0.02).float()
    sl = slice(8, 56)

    def fwd():
        with torch.no_grad():
            model(x, af, out_slice=sl)

    span = cuda_ms(fwd, reps=3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    per_kernel = _device_times(prof)
    busy = sum(per_kernel.values())
    groups = {"conv3d_stats (K1)": "conv3d_stats_kernel", "in_apply (K2)": "in_apply_kernel",
              "depthwise3 (K3)": "depthwise3_kernel"}
    shares = {}
    for label, pat in groups.items():
        shares[label] = sum(v for k, v in per_kernel.items() if pat in k)
    shares["other kernels"] = busy - sum(shares.values())
    print(f"profile of one forward (batch {BATCH}, {WIN}^3, AF on): device span {span:.3f} ms, "
          f"kernel time {busy:.3f} ms" + (f", idle share {1 - busy / span:.3f}" if busy else
                                          ": profiler saw no device time (not measured)"),
          flush=True)
    for label, v in shares.items():
        print(f"  {label}: {v:.3f} ms", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    for name, v in top:
        print(f"  {v:9.3f} ms  {name[:100]}", flush=True)
    detail["profile"] = dict(span_ms=span, kernel_ms=busy, shares_ms=shares,
                             top=[[n[:200], v] for n, v in top])


TRAIN_KERNELS = {"conv3d_stats": "conv3d_stats_kernel", "in_apply_ad": "in_apply_ad_kernel",
                 "in_bwd_stats": "in_bwd_stats_kernel", "in_bwd_apply": "in_bwd_apply_kernel",
                 "depthwise3": "depthwise3_kernel", "depthwise3_grads": "depthwise3_grads_kernel"}
# per training step at base 64 with recomputation: K1 12 forward + 9
# recomputed + 12 dx; K3 3 forward + 3 recomputed + 3 dx
TRAIN_PER_STEP = {"conv3d_stats": 33, "in_apply_ad": 21, "in_bwd_stats": 12,
                  "in_bwd_apply": 12, "depthwise3": 9, "depthwise3_grads": 3}


def training_path(torch, args, detail):
    """Trainer steps at the published width; returns the launch counts of
    the timed steps, the trainer, its state and the batch."""
    from mica_tpu_torch.models.mica import dropout_rate_for_epoch
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    trainer = Trainer(base_filters=BASE, dtype=torch.bfloat16, seed=args.seed)
    state = trainer.init_state()
    batch = [torch.as_tensor(b).cuda() for b in synthetic_batch(BATCH, WIN, args.seed)]
    lambdas, rate = task_lambdas(0), dropout_rate_for_epoch(0)
    for _ in range(2):
        trainer.train_step(state, batch, lambdas, rate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 5
    _reset_counts()
    t0 = time.time()
    mets = [trainer.train_step(state, batch, lambdas, rate) for _ in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / steps * 1e3
    counts = {k: v for c in _counters() for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["total_loss"]) for m in mets]
    norms = [float(m["gradient_norm"]) for m in mets]
    per_step = {k: counts[k] / steps for k in TRAIN_KERNELS}
    print(f"training: base {BASE}, bf16, batch {BATCH} x {WIN}^3, recomputation and "
          f"augmentation on, dropout {rate}: {step_ms:.3f} ms/step, "
          f"{BATCH / step_ms * 1e3:.3f} samples/s over {steps} steps; peak memory "
          f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"  launches per step {json.dumps(per_step)}", flush=True)
    print(f"  losses {losses}, gradient norms {norms}", flush=True)
    fail_if(not all(math.isfinite(v) for v in losses + norms), "training loss or norm not finite")
    for k, want in TRAIN_PER_STEP.items():
        fail_if(per_step[k] != want, f"{k}: {per_step[k]} launches per step, expected {want}")
    fail_if(counts["in_apply"] != 0, "training launched the inference-only K2")
    launches = {k: counts[k] for k in TRAIN_KERNELS}

    # one fixed batch, no augmentation or blanking: the loss must fall
    saved = trainer.use_augmentation, trainer.exp_only_prob
    trainer.use_augmentation, trainer.exp_only_prob = False, 0.0
    fixed = [float(trainer.train_step(state, batch, lambdas, rate)["total_loss"])
             for _ in range(8)]
    trainer.use_augmentation, trainer.exp_only_prob = saved
    print(f"fixed batch, 8 steps: losses {fixed}", flush=True)
    fail_if(not all(math.isfinite(v) for v in fixed), "fixed-batch loss not finite")
    fail_if(not fixed[-1] < fixed[0], f"fixed-batch loss did not fall: {fixed}")
    detail["training"] = dict(step_ms=step_ms, samples_per_s=BATCH / step_ms * 1e3,
                              peak_memory_bytes=peak, launches_per_step=per_step,
                              losses=losses, gradient_norms=norms, fixed_batch_losses=fixed)
    return launches, trainer, state, batch


# Limits of the bf16 card gradient against the f32 CPU gradient: (cosine
# of the whole vector, worst cosine of a tensor above 1e-4 of the largest
# reference norm) at weights initialised from the seed, and the whole
# vector's cosine at the trainer's weights.  At fresh weights bf16 itself
# is that far from f32: on the H100, seeds 0-3 read 0.883-0.894 whole and
# 0.769-0.795 worst, and the JAX package's own bf16 gradient is no closer
# to its f32 one (``test_bf16_gradient_no_farther_from_f32_than_jax``).
GRAD_FRESH_MIN = (0.85, 0.7)
GRAD_TRAINED_MIN = 0.9


def _grad_inputs(torch, seed):
    rng = np.random.default_rng(seed + 3)
    x = torch.from_numpy(rng.random((2, 16, 16, 16, 1)).astype(np.float32))
    af = torch.from_numpy((rng.random((2, 16, 16, 16, 24)) < 0.03).astype(np.float32))
    af[0] = 0.0
    tgt = [torch.from_numpy(rng.integers(0, k, (2, 16, 16, 16))) for k in (4, 4, 21)]
    return x, af, tgt


def _model_grad(torch, model, dev, inputs):
    from mica_tpu_torch.train.loss import multi_task_loss, task_lambdas

    x, af, tgt = inputs
    outs = model(x.to(dev), af.to(dev), train=True)
    loss, _ = multi_task_loss(outs, [t.to(dev) for t in tgt], task_lambdas(0))
    loss.backward()
    return {k: p.grad.detach().double().cpu().ravel() for k, p in model.named_parameters()}


def _grad_agreement(torch, card, ref, label, detail):
    """Whole-vector and per-tensor cosines of ``card`` against ``ref``
    over the tensors above 1e-4 of the largest reference norm."""
    cos_of = torch.nn.functional.cosine_similarity
    whole = cos_of(torch.cat(list(card.values())), torch.cat([ref[k] for k in card]), dim=0).item()
    gmax = max(v.norm().item() for v in ref.values())
    cos = {k: cos_of(card[k], ref[k], dim=0).item()
           for k in ref if ref[k].norm().item() >= 1e-4 * gmax}
    rel = {k: ((card[k] - ref[k]).norm() / ref[k].norm()).item() for k in cos}
    vals = sorted(cos.values())
    worst = min(cos, key=cos.get)
    print(f"gradient reference, {label}: cosine of the whole gradient {whole:.5f}; per tensor "
          f"over {len(vals)} of {len(ref)} tensors: worst {vals[0]:.5f} ({worst}), median "
          f"{vals[len(vals) // 2]:.5f}; relative L2 worst {max(rel.values()):.5f} "
          f"({max(rel, key=rel.get)})", flush=True)
    detail[label] = dict(whole_cosine=whole, worst=vals[0], worst_tensor=worst,
                         median=vals[len(vals) // 2], cosine=cos, relative_l2=rel)
    return whole, vals[0], worst


def gradient_reference(torch, seed, trained_state, detail):
    """2 x 16^3 gradients of the card (bf16, kernels) against the same
    weights in f32 on the CPU (plain versions), dropout off: at weights
    initialised from ``seed``, held to ``GRAD_FRESH_MIN`` on the whole
    vector and on every tensor, and at the trainer's weights
    (``trained_state``), held to ``GRAD_TRAINED_MIN`` on the whole vector."""
    from mica_tpu_torch.models.mica import MICA

    inputs = _grad_inputs(torch, seed)

    def agreement(state, label):
        grads = []
        for dtype, dev in ((torch.bfloat16, "cuda"), (torch.float32, "cpu")):
            model = MICA(base=BASE, dtype=dtype)
            model.load_state_dict(state)
            grads.append(_model_grad(torch, model.to(dev), dev, inputs))
        return _grad_agreement(torch, *grads, f"{label}, bf16 card vs f32 CPU", detail)

    fresh = MICA(base=BASE, dtype=torch.float32).init_weights(torch.Generator().manual_seed(seed))
    whole, worst, name = agreement(fresh.state_dict(), f"seed {seed} weights")
    fail_if(not whole >= GRAD_FRESH_MIN[0],
            f"gradient cosine {whole} < {GRAD_FRESH_MIN[0]} at the seed's weights")
    fail_if(not worst >= GRAD_FRESH_MIN[1],
            f"gradient of {name}: cosine {worst} < {GRAD_FRESH_MIN[1]} at the seed's weights")
    whole, _, _ = agreement(trained_state, "trained weights")
    fail_if(not whole >= GRAD_TRAINED_MIN,
            f"gradient cosine {whole} < {GRAD_TRAINED_MIN} at the trained weights")
    print(f"gradients within their limits: {GRAD_FRESH_MIN} (whole, worst tensor) at the "
          f"seed's weights, {GRAD_TRAINED_MIN} (whole) at the trained weights", flush=True)


def profile_train_step(torch, trainer, state, batch, detail):
    """Where one training step's device time goes: kernel times and the
    step's device span, both from one profiled step."""
    from torch.profiler import ProfilerActivity, profile

    from mica_tpu_torch.train.loss import task_lambdas

    def step():
        trainer.train_step(state, batch, task_lambdas(0), 0.01)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # the span of the profiled step itself: a training step's host work
    # (the augmentation's choices are read back once) is part of its idle
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end)
    per_kernel = _device_times(prof)
    busy = sum(per_kernel.values())
    shares = {k: sum(v for n, v in per_kernel.items() if pat in n)
              for k, pat in TRAIN_KERNELS.items()}
    shares["other kernels"] = busy - sum(shares.values())
    print(f"profile of one training step: device span {span:.3f} ms, kernel time "
          f"{busy:.3f} ms" + (f", idle share {1 - busy / span:.3f}" if busy else
                              ": profiler saw no device time (not measured)"), flush=True)
    for label, v in shares.items():
        print(f"  {label}: {v:.3f} ms", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    for name, v in top:
        print(f"  {v:9.3f} ms  {name[:100]}", flush=True)
    detail["train_profile"] = dict(span_ms=span, kernel_ms=busy, shares_ms=shares,
                                   top=[[n[:200], v] for n, v in top])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--map-size", type=int, default=160)
    ap.add_argument("--out", default="build/chip_smoke.json",
                    help="where the detailed JSON record is written")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from mica_tpu_torch.ops import _build, conv3d_in, depthwise

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    per_source = _build.build()
    print(f"build: {time.time() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items())})",
          flush=True)

    detail = {"device": smi, "build_s": per_source}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows["conv3d_stats"] = check_k1(torch, F, conv3d_in, g, detail)
    check_k1_dx(torch, F, conv3d_in, g, detail)
    rows["in_apply"] = check_k2(torch, conv3d_in, g, detail)
    rows["depthwise3"] = check_k3(torch, F, depthwise, g, detail)
    rows["in_apply_ad"] = check_k4(torch, conv3d_in, g, detail)
    rows["in_bwd_stats"], rows["in_bwd_apply"] = check_k5_k6(torch, conv3d_in, g, detail)
    rows["depthwise3_grads"] = check_k7(torch, depthwise, g, detail)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    out.write_text(json.dumps(detail, indent=1))

    predict_launches, model = main_path(torch, args, detail)
    profile_forward(torch, model, args.seed, detail)
    small_reference(torch, model, args.seed, detail)
    del model
    torch.cuda.empty_cache()
    out.write_text(json.dumps(detail, indent=1))

    train_launches, trainer, state, batch = training_path(torch, args, detail)
    profile_train_step(torch, trainer, state, batch, detail)
    trained = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    del trainer, state, batch
    torch.cuda.empty_cache()
    gradient_reference(torch, args.seed, trained, detail)
    out.write_text(json.dumps(detail, indent=1))

    def entry(name, route, source, replaces, launches, sites):
        """``sites``: launches of the path's run per site of ``rows[name]``,
        so each time is the kernel's share of one forward (prediction) or
        one step (training)."""
        by_site = {r["site"]: r for r in rows[name]}
        tot = lambda k: sum(by_site[s][k] * n for s, n in sites.items())  # noqa: E731
        bound_by = ("operations" if all(by_site[s]["bound_by"] == "operations" for s in sites)
                    else "bytes")
        return dict(name=name, route=route, source=source, replaces=replaces,
                    launches=launches[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows[name]),
                    ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    bound_by=bound_by, library_ms=tot("library_ms"))

    k1_sites = {f"{cis}->{co}": 1 for cis, co, _ in k1_sites_of()}
    k2_sites = {}
    for cis, co, st in k1_sites_of():
        if st:
            k2_sites[f"C={co}"] = k2_sites.get(f"C={co}", 0) + 1
    pl = predict_launches
    kernels = [
        entry("conv3d_stats", "cuda", "mica_tpu_torch/csrc/conv3d_stats.cu",
              "mica_tpu/ops/wino_pallas.py:309", pl, k1_sites),
        entry("in_apply", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:378", pl, k2_sites),
        entry("depthwise3", "cuda", "mica_tpu_torch/csrc/depthwise3.cu",
              "mica_tpu/ops/depthwise_pallas.py:147", pl, {"C=64": 1, "C=128": 1, "C=256": 1}),
        entry("in_apply_ad", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:493", train_launches, K4_PER_STEP),
        entry("in_bwd_stats", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:546", train_launches, K56_PER_STEP),
        entry("in_bwd_apply", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:582", train_launches, K56_PER_STEP),
        entry("depthwise3_grads", "cuda", "mica_tpu_torch/csrc/depthwise3_grads.cu",
              "mica_tpu/ops/depthwise_pallas.py:233", train_launches, K7_PER_STEP),
    ]
    detail["kernels"] = kernels
    detail["launches"] = {"predict": predict_launches, "train": train_launches}
    out.write_text(json.dumps(detail, indent=1))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
