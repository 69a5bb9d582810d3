#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--map-size 160]

Phases, each printing what it found; any failure ends the run non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``mica_tpu_torch/csrc`` (one ``nvcc`` per
     source, all at once) and, beside them, the all-atom tool from
     ``mica_tpu_torch/tools/allatom_src`` (``g++``), then K1's, K3's, K7's
     and K8's ``-Xptxas -v`` report (registers, barriers, spills per
     kernel);
  3. hold every kernel against its plain PyTorch version at the shapes of
     its path (batch 8, 64^3 windows, the widths of MICA at base 64; for
     K1 also every dx geometry of a training step; K8 also at an odd
     size; K9/K10 with and without the AF words, at unaligned starts and
     with a skipped tail), in f32 from the same bf16 inputs (K9/K10: to
     the bit), and time kernel, plain version and one library call (a
     yardstick the port never calls); K1 also prints each site's share of
     the bf16 peak and its ratio to cuDNN, and the sums over a forward and
     over a training step's dx convs, and at each forward site must give
     the same bits (out and statistics) over two calls and for sample 0
     at batch 1, its second kernel (the statistics' fixed-order sum) held
     to the bit against its plain version and timed alone; K3 runs in the
     forward and in the dx form, on odd shapes too, with its share of the
     bound and its tile plan; ``in_sums`` at each width of the forward's 19
     sites and C 16 within 1e-5 of the magnitudes, to the bit from call to
     call and from batch 8 to batch 1, with its plan, registers and the
     sum over a forward;
     K7 (20 launches a site) on K3's odd shapes too, with its share of the
     bound (>= 50 % at each training site) and its tile plan, and two calls
     on the same inputs must agree to the bit; K4-K6 over 20 launches a
     site, K5 with its plan, registers and spills, to the bit from call to
     call and at >= 70 % of its bound at each training width (its 20
     launches enqueued one by one; the same replayed from a CUDA graph
     printed beside them); K8 over 20
     launches with its plan, its share of the bound and the MMAs it issues
     over the real taps' (<= 1.2x at the main path's shape); K9 with the
     words it moves at each site (16-byte words at the engine's frame and
     starts, 4-byte words on a frame whose rows are not 16-byte aligned),
     its device time from a CUDA graph's replay of 20 launches walking the
     frame's batches at >= 50 % of its bound, the eager time beside it, and
     the host's time to enqueue a call in turns with PR 3's wrapper;
  4. the prediction path: ``predict_map`` on a synthetic map written to an
     MRC, with a docked model for the AF3 encoding, random weights from
     ``--seed``, bf16, batch 8, core 48 / halo 8, twice: the process's
     first call (one-off costs) and the measured one, with the launch
     counts of that run alone, the two equal to the bit; a profile of one
     batch forward; then a small window batch against the f32 network on
     the CPU;
  5. the modelling path: a synthetic scenario (map, FASTA, AF3 template,
     docked model) written to disk and the ``Solver`` behind
     ``mica_tpu_torch.cli.run`` driven on it at the same width:
     ``check_seq``, prediction with the volumes kept on the card, device
     candidate extraction on them (random weights: only what it returned
     is recorded), the launch counts of that run alone; then, from the
     scenario's perfect volumes put on the card, device extraction held
     against the host's (and whether two more give the same bits),
     fragments, AF3 alignment, the initial model, gap filling, the
     all-atom rebuild (``--run_pulchra``: every residue with N, CA, C, O
     and its type's side chain, finite coordinates; its host seconds)
     and PHENIX's command (``--run_phenix``; PHENIX is not
     installed), and the CA model held against the scenario's chain;
  6. the training path: ``Trainer`` at base 64, bf16, batch 8 of 64^3
     ``synthetic_batch`` windows, recomputation and augmentation on, the
     epoch-0 dropout rate; 2 warm-up and 5 timed steps with the launch
     counts of those 5 alone; 8 steps on one fixed batch whose loss must
     fall; a profile of one step; 2 x 16^3 gradients against the f32
     network on the CPU, at weights initialised from ``--seed`` (held on
     the whole vector and on every tensor) and at the trained weights;
  7. f32 on the card (``f32_path``): the route the JAX package's f32
     takes, library convs with TF32 off and no K1-K8 launch, against the
     f32 CPU at 1e-4: ``predict_map``, ``python -m
     mica_tpu_torch.cli.predict --float32`` as a subprocess, ``cli.run
     --float32``'s solver through its network stage, the f32 gradient
     (cosine >= 0.9999), two ``Trainer`` steps and ``cli.train --dtype
     float32`` for one epoch, at base 64 on a 16^3 map (about half a
     minute);
  8. the prep phase (``prep_path``): random Merizo shards from ``--seed``
     under ``MICA_MERIZO_WEIGHTS``; Merizo on a 1000-residue chain on the
     card against the CPU (logits within ``MERIZO_TOL``; ms a forward,
     peak memory, forwards on the card); ``cli.prep af3-results`` on two
     AF3 models of two chains (one of 520 residues in two domains): every
     chain converted, domain files inside their chains, Merizo on the card
     for every chain of >= 50 CAs; ``cli.prep af3-json``; ``cli.prep dock
     --dry_run`` and its PHENIX commands (PHENIX is not installed);
  9. the dumps phase (``dumps_path``): ``predict_map`` and ``cli.predict
     --npz_dir`` at base 64, bf16, on a 96^3 map with empty windows: four
     files a window, the volumes rebuilt from them equal to the returned
     and written ones (Dice 1), K9 and K10 once a computed batch; several
     maps with ``--npz_dir`` refused;
 10. the learned phase (``learned_path``, about seven minutes):
     ``cli.makedata`` in this process on 8 synthetic (map, model) pairs at
     144^3, the fixture's base-16 bf16 training on those windows
     (``mica_tpu_torch.scripts.train_synth_fixture``: batch 8, lr 3e-4,
     ``LEARNED_STEPS``) with its launches a step (K1 only where
     ``k1_takes`` accepts the widths) and a falling loss, the weights kept
     by their validation Dice, their held-out backbone Dice against the
     initial weights' (gain >= 0.1), then on the last step's weights a profile
     of one base-16 step, a base-16 forward's launches (K1 5, K2 14, K3 3,
     K8 1, ``in_sums`` 19) within 0.1 of the f32 CPU, ``cli.predict`` on the
     exported original-format ``.pth`` and on a one-epoch ``cli.train`` ``.pt``,
     and the synthetic demo's ``cli.run --run_pulchra`` on the learned
     weights: the CA and all-atom models, coverage of the true chain at
     or above ``DEMO_COVERAGE_FLOOR``;
 11. the scripts: K11 and K12 in each of ``distill_ew_crash``'s ten
     variants at its shapes (K11 to the bit, K12 within 1e-5 of the
     terms' magnitudes and to the bit from call to call, its second pass
     timed alone) and K13 at the layout probe's, to the bit in both
     layouts, at an unaligned start and with a tail, each timed beside its
     plain version and one library call (K13 in turns with it);
     then the ``main`` of ``mica_tpu_torch.scripts.distill_ew_crash``,
     ``bench_in_apply`` (K2) and ``probe_layout_boundary`` in this
     process, with the launch counts of those three runs alone;
 12. the multi-GPU phase (``multigpu_path``, about 75 s): NCCL at world
     size 1 in this process, ``predict_map`` with the mesh at base 64 on
     the prediction phase's map, twice, each equal to the bit to a
     single-process run (two of which are equal to the bit too),
     windows/s, K9/K10 once a batch, and a data-parallel f32 ``Trainer``
     step (cuDNN deterministic) against two plain ones; two rank processes
     at world size 2 (gloo with both ranks on ``cuda:0``: NCCL refuses two
     ranks on one card), the replicated engine within ``MGPU_WORLD2_TOL``
     of world 1 (whether to the bit is printed) and equal on both ranks,
     the ``shard_volumes`` engine and a second replicated run equal to the
     bit to the first, at <= 0.55x its bytes a rank, the f32 step against
     world 1 (loss, gradient cosine, parameters equal on both ranks) and a
     bf16 step's launches on each rank; then ``dryrun_multigpu(2)``.

The kernels' JSON record and the card's name come before the last line,
``{"ok": true, "device": {...}}``.  Details go to ``--out`` (default
``build/chip_smoke.json``, git-ignored).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import os
import platform
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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


def graph_ms(fn, reps: int = 20) -> float:
    """ms per call of ``reps`` calls captured in one CUDA graph and replayed:
    the device's time for back-to-back launches, without the host's time to
    enqueue them (a training step queues them behind its other work)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=3) / reps


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _counters():
    """The kernel wrappers' launch counts (module dicts, mutable)."""
    from mica_tpu_torch.ops import conv3d_in, depthwise, ew_rows, scale, stem, window_copy

    return (conv3d_in.launches, depthwise.launches, stem.launches, window_copy.launches,
            ew_rows.launches, scale.launches)


def _reset_counts():
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    return {k: v for counts in _counters() for k, v in counts.items()}


def _kernel_name(mangled: str) -> str:
    """``foo_kernel`` out of a mangled name: the identifier ending in
    ``_kernel`` that its length prefix announces."""
    head = mangled[:mangled.find("_kernel") + 7]
    for n in range(8, len(head)):
        if head[:-n].endswith(str(n)):
            return head[-n:]
    return mangled


def ptxas_report(log: str) -> list:
    """One line per kernel of an ``-Xptxas -v`` log: template arguments
    (BN, MT for K1), registers, barriers, spills."""
    import re

    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            name = "<" + ", ".join(args) + ">" if args else _kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return lines


def k1_plan_line(conv3d_in, cis, co) -> str:
    """K1's tile plan at the main path's shape, with its shared memory."""
    p = conv3d_in.k1_plan(cis, co, (BATCH, WIN, WIN, WIN))
    return (f"plan BK {p.bk}, BN {p.bn} x {p.n_tiles}, MT {p.mt} (brick "
            f"{'x'.join(map(str, p.brick))}), {p.stages} stages, {p.smem} B shared, "
            f"{p.tiles} tiles on {p.ctas} CTAs")


def check_k1(torch, F, conv3d_in, g, detail):
    """K1 at every site, stats on and off, against the plain version in f32;
    at the forward's setting, a second call and sample 0 alone at batch 1
    must give the same bits (out and statistics), and the second kernel
    alone is held to the bit against its plain version and timed."""
    rows = []
    for cis, co, main_stats in conv3d_in.k1_sites(BASE):
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
            # a second call, and sample 0 alone, must give the same bits
            out2, st2 = conv3d_in.conv3d(parts, w, bias, with_stats=stats)
            out1, st1 = conv3d_in.conv3d([p[:1].contiguous() for p in parts], w, bias,
                                         with_stats=stats)
            fail_if(not torch.equal(out, out2) or (stats and not torch.equal(st, st2)),
                    f"K1 {cis}->{co}: two calls on the same inputs differ")
            fail_if(not torch.equal(out[:1], out1) or (stats and not torch.equal(st[:1], st1)),
                    f"K1 {cis}->{co}: sample 0 at batch {BATCH} differs from it at batch 1")
            del out2, st2, out1, st1
            sum_ms = None
            if stats:
                plan = conv3d_in.k1_plan(cis, co, (BATCH, WIN, WIN, WIN))
                part = torch.randn(plan.partials, device="cuda", generator=g)
                fail_if(not torch.equal(conv3d_in.sum_partials(part),
                                        conv3d_in.sum_partials_plain(part)),
                        f"K1 {cis}->{co}: the second kernel's sums differ from its plain "
                        "version's")
                sum_ms = cuda_ms(lambda: conv3d_in.sum_partials(part), reps=20)
                del part
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
            share = flops / (ms * 1e-3) / PEAK_BF16
            rows.append(dict(site=f"{cis}->{co}", max_abs_err=err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=bnd, bound_by=by, sum_ms=sum_ms,
                             tflops=flops / ms / 1e9, peak_share=share, vs_library=ms / lib))
            print(f"  time {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * share:.1f} % of "
                  f"the bf16 peak; "
                  + ("" if sum_ms is None else f"of it the second kernel alone {sum_ms:.4f} ms; ")
                  + f"bitwise equal over two calls and at batch 1), plain {plain:.3f} ms, library "
                  f"conv3d {lib:.3f} ms (K1 {ms / lib:.3f}x), bound {bnd:.3f} ms ({by}); "
                  f"{k1_plan_line(conv3d_in, cis, co)}", flush=True)
        del parts, ref, ref_st
        torch.cuda.empty_cache()
    k1, lib = sum(r["ms"] for r in rows), sum(r["library_ms"] for r in rows)
    sums = sum(r["sum_ms"] or 0.0 for r in rows)
    print(f"K1 forward, {len(rows)} sites: {k1:.3f} ms (the second kernel {sums:.4f} ms of it), "
          f"library conv3d {lib:.3f} ms (K1 {k1 / lib:.3f}x), bound "
          f"{sum(r['bound_ms'] for r in rows):.3f} ms", flush=True)
    detail["conv3d_stats"] = rows
    return rows


def check_k1_dx(torch, F, conv3d_in, g, detail):
    """K1 at every dx geometry of a training step, with the flipped and
    transposed weight the backward passes, against the plain version in f32."""
    rows = []
    for (ci, co), per_step in conv3d_in.k1_dx_sites(BASE).items():
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
        share = flops / (ms * 1e-3) / PEAK_BF16
        rows.append(dict(site=f"{ci}->{co}", launches_per_step=per_step, max_abs_err=err,
                         ms=ms, library_ms=lib, bound_ms=bnd, bound_by=by,
                         tflops=flops / ms / 1e9, peak_share=share, vs_library=ms / lib))
        print(f"K1 dx {ci}->{co} (x{per_step} per step): max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"time {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, {100 * share:.1f} % of the "
              f"bf16 peak), library conv3d {lib:.3f} ms (K1 {ms / lib:.3f}x), bound {bnd:.3f} ms "
              f"({by}); {k1_plan_line(conv3d_in, [ci], co)}", flush=True)
        del dc, want, out
        torch.cuda.empty_cache()
    k1 = sum(r["ms"] * r["launches_per_step"] for r in rows)
    lib = sum(r["library_ms"] * r["launches_per_step"] for r in rows)
    print(f"K1 dx per training step ({sum(r['launches_per_step'] for r in rows)} launches): "
          f"{k1:.3f} ms, library conv3d {lib:.3f} ms (K1 {k1 / lib:.3f}x)", flush=True)
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


def in_sums_sites(base: int) -> dict:
    """{C: launches} of ``in_sums`` in one inference forward: the stem's
    pool (2 base); per stage the SE pool, the DualAttention's norm and
    pool; per head two norms (64, 32) and the calibration's pool (32)."""
    sites = {2 * base: 1}
    for i in range(3):
        sites[base * 2 ** i] = sites.get(base * 2 ** i, 0) + 3
    for c, n in ((64, 3), (32, 6)):
        sites[c] = sites.get(c, 0) + n
    return sites


def in_relu_sites(base: int) -> dict:
    """{C: launches} of K2 after ``in_sums`` in one inference forward: the
    DualAttention's norm at each stage, the heads' two norms."""
    sites = {32: 3, 64: 3}
    for i in range(3):
        sites[base * 2 ** i] = sites.get(base * 2 ** i, 0) + 1
    return sites


def check_in_sums(torch, conv3d_in, g, detail):
    """``in_sums`` at each width of the forward's sites (and C 16, the
    base-16 model's) at batch 8: against the plain version within 1e-5 of
    the sum of the terms' magnitudes, equal to the bit from call to call,
    and sample 0 at batch 1 equal to the bit to sample 0 at batch 8."""
    from mica_tpu_torch.ops import _build

    rows = []
    for c in sorted({16} | set(in_sums_sites(BASE))):
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        got = conv3d_in.in_sums(x)
        again = conv3d_in.in_sums(x)
        one = conv3d_in.in_sums(x[:1].contiguous())
        torch.cuda.synchronize()
        want = conv3d_in.in_sums_plain(x)
        mag = conv3d_in.in_sums_plain(x.abs())
        err = (got - want).abs().max().item()
        excess = ((got - want).abs() - 1e-5 * mag).max().item()
        fail_if(not excess <= 1e-3, f"in_sums C={c}: err {err} beyond 1e-5 of the magnitudes")
        fail_if(not torch.equal(got, again), f"in_sums C={c}: two calls differ")
        fail_if(not torch.equal(got[:1], one), f"in_sums C={c}: batch 1 differs from batch 8")
        bnd, by = bound_ms(3.0 * x.numel(), 2.0 * x.numel() + 8.0 * BATCH * c, PEAK_F32)
        ms = cuda_ms(lambda: conv3d_in.in_sums(x), reps=20)
        plain = cuda_ms(lambda: conv3d_in.in_sums_plain(x))

        def lib_sums():
            return torch.stack([
                x.sum(dim=(1, 2, 3), dtype=torch.float32),
                torch.linalg.vector_norm(x, dim=(1, 2, 3), dtype=torch.float32) ** 2], 1)

        lib = cuda_ms(lib_sums)
        rows.append(dict(site=f"C={c}", max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=bnd, bound_by=by, bound_share=bnd / ms))
        p = conv3d_in.in_sums_plan(x.shape, _build.sm_count(x.device))
        main, summed = next(v[:2] for k, v in conv3d_in.in_sums_kernels.items() if k[0] == p)
        print(f"in_sums C={c}: max_abs_err {err:.3e} (tol 1e-5 of sum |x|, sum x^2), bitwise "
              f"equal from call to call and batch 1 to batch 8; time {ms:.4f} ms "
              f"({100 * bnd / ms:.1f} % of its bound), plain {plain:.3f} ms, torch.sum and "
              f"vector_norm in f32 {lib:.3f} ms, bound {bnd:.4f} ms ({by}); plan tile "
              f"{p.block_s} x {p.block_c}, chunk {p.chunk} voxels, grid {p.grid} = "
              f"{p.programs} programs; in_stats_sum {main.n_regs} registers, {main.n_spills} "
              f"spills, in_bwd_stats_sum {summed.n_regs} registers, {summed.n_spills} spills",
              flush=True)
        del x
    sites = in_sums_sites(BASE)
    by_site = {r["site"]: r for r in rows}
    fwd = sum(by_site[f"C={c}"]["ms"] * n for c, n in sites.items())
    bnd = sum(by_site[f"C={c}"]["bound_ms"] * n for c, n in sites.items())
    print(f"in_sums, a forward's {sum(sites.values())} launches: {fwd:.4f} ms against a bound "
          f"of {bnd:.4f} ms ({100 * bnd / fwd:.1f} %)", flush=True)
    detail["in_sums"] = rows
    return rows


def k3_plan_line(depthwise, shape, c) -> str:
    """K3's tile plan for x of ``shape`` (B, D, H, W) and C channels."""
    p = depthwise.k3_plan(shape, c)
    return (f"plan TY {p.ty}, TX {p.tx}, CG {p.cg}, z segments of {p.seg} ({p.grid[3]} a "
            f"sample), {p.threads} threads, {p.blocks} blocks, {p.smem} B shared")


# K3's shapes off the main path: batch 1 (the all-zero window; z cut into
# segments), H and W not multiples of the tile with C 16, C 24 and a
# single row, D = 1, and a short batch of 16^3 windows
K3_ODD = ((1, 64, 64, 64, 64), (3, 5, 7, 9, 16), (1, 3, 1, 130, 24), (2, 1, 13, 21, 64),
          (3, 16, 16, 16, 128))


def check_k3(torch, F, depthwise, g, detail):
    """K3 at the three DualAttention widths of the main path, in the
    forward and in the dx form of the training backward (zyx-flipped taps,
    zero bias), then on odd shapes, against the plain version in f32 from
    the same bf16 inputs.  Tolerance 1e-2 of the largest reference value:
    27 f32 products summed in another order, one bf16 rounding."""
    rows, dx_rows = [], []
    for c in (64, 128, 256):
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=g) * 0.2
        b = torch.randn(c, device="cuda", generator=g) * 0.1
        xf = x.float()
        xl = x.permute(0, 4, 1, 2, 3)
        for form, wt, bt, out in (("forward", w, b, rows),
                                  ("dx", w.flip(2, 3, 4), torch.zeros_like(b), dx_rows)):
            want = depthwise.depthwise_conv3_plain(xf, wt, bt)
            got = depthwise.depthwise_conv3(x, wt, bt)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            tol = 1e-2 * want.abs().max().item()
            fail_if(not err <= tol, f"K3 {form} C={c}: err {err} > {tol}")
            del want, got
            nbytes = 2.0 * 2 * x.numel() + 4.0 * 28 * c
            bnd, by = bound_ms(2.0 * 27 * x.numel(), nbytes, PEAK_F32)
            ms = cuda_ms(lambda: depthwise.depthwise_conv3(x, wt, bt), reps=20)
            plain = cuda_ms(lambda: depthwise.depthwise_conv3_plain(xf, wt, bt), reps=1)
            wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            bl = bt.to(torch.bfloat16)
            lib = cuda_ms(lambda: F.conv3d(xl, wl, bl, padding=1, groups=c))
            out.append(dict(site=f"C={c}", max_abs_err=err, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=bnd, bound_by=by, bound_share=bnd / ms))
            print(f"K3 {form} C={c}: max_abs_err {err:.3e} (tol {tol:.3e}); time {ms:.4f} ms "
                  f"({100 * bnd / ms:.1f} % of its bound), plain {plain:.3f} ms, library "
                  f"grouped conv3d {lib:.3f} ms, bound {bnd:.4f} ms ({by}); "
                  f"{k3_plan_line(depthwise, x.shape[:4], c)}", flush=True)
        del x, xf, xl
        torch.cuda.empty_cache()
    fwd = sum(r["ms"] for r in rows)
    dx = sum(r["ms"] for r in dx_rows)
    bnd = sum(r["bound_ms"] for r in rows)
    print(f"K3 forward, 3 sites: {fwd:.4f} ms against a bound of {bnd:.4f} ms "
          f"({100 * bnd / fwd:.1f} %); a training step's 9 launches (forward, "
          f"recomputation, dx): {2 * fwd + dx:.4f} ms against {3 * bnd:.4f} ms; each site "
          f"at >= 50 % of its bound: {all(r['bound_share'] >= 0.5 for r in rows + dx_rows)}",
          flush=True)
    odd = []
    for shape in K3_ODD:
        c = shape[-1]
        x = torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=g) * 0.2
        b = torch.randn(c, device="cuda", generator=g) * 0.1
        want = depthwise.depthwise_conv3_plain(x.float(), w, b)
        got = depthwise.depthwise_conv3(x, w, b)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        site = "x".join(str(v) for v in shape)
        fail_if(not err <= tol, f"K3 {site}: err {err} > {tol}")
        odd.append(dict(site=site, max_abs_err=err))
        print(f"K3 {site}: max_abs_err {err:.3e} (tol {tol:.3e}); "
              f"{k3_plan_line(depthwise, shape[:4], c)}", flush=True)
    detail["depthwise3"], detail["depthwise3_dx"], detail["depthwise3_odd"] = rows, dx_rows, odd
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
        ms = cuda_ms(lambda: conv3d_in.in_apply_ad(buf, mean, scale), reps=20)
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
    from mica_tpu_torch.ops import _build

    rows5, rows6 = [], []
    for c in K56_PER_STEP:
        xh = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        dy = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        n = WIN ** 3
        # K5: f32 sums against the plain version's; tolerance 1e-5 of the
        # sum of the terms' magnitudes (f32 sums in another order); two
        # calls equal to the bit (fixed chunks summed in a fixed order)
        st = conv3d_in.in_bwd_stats(xh, dy)
        again = conv3d_in.in_bwd_stats(xh, dy)
        torch.cuda.synchronize()
        want = conv3d_in.in_bwd_stats_plain(xh, dy)
        mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
        err5 = (st - want).abs().max().item()
        excess = ((st - want).abs() - 1e-5 * mag).max().item()
        fail_if(not excess <= 1e-3, f"K5 C={c}: err {err5} beyond 1e-5 of the magnitudes")
        fail_if(not torch.equal(st, again), f"K5 C={c}: two calls differ (not deterministic)")
        bnd, by = bound_ms(4.0 * xh.numel(), 4.0 * xh.numel() + 8.0 * BATCH * c, PEAK_F32)
        # timed as every kernel is, 20 calls enqueued one by one; beside it
        # the same 20 calls replayed from a CUDA graph, without the host
        ms = cuda_ms(lambda: conv3d_in.in_bwd_stats(xh, dy), reps=20)
        graph = graph_ms(lambda: conv3d_in.in_bwd_stats(xh, dy), reps=20)
        plain = cuda_ms(lambda: conv3d_in.in_bwd_stats_plain(xh, dy))

        def lib_sums():
            gg = torch.where(xh > 0, dy, 0)
            return torch.stack([gg.sum(dim=(1, 2, 3), dtype=torch.float32),
                                (gg * xh).sum(dim=(1, 2, 3), dtype=torch.float32)], 1)

        lib = cuda_ms(lib_sums)
        rows5.append(dict(site=c, max_abs_err=err5, ms=ms, graph_ms=graph, plain_ms=plain,
                          library_ms=lib, bound_ms=bnd, bound_by=by, bound_share=bnd / ms))
        p = conv3d_in.k5_plan(xh.shape, _build.sm_count(xh.device))
        main, summed = next(v[:2] for k, v in conv3d_in.k5_kernels.items() if k[0] == p)
        regs = (f"in_bwd_stats {main.n_regs} registers, {main.n_spills} spills, "
                f"in_bwd_stats_sum {summed.n_regs} registers, {summed.n_spills} spills")
        print(f"K5 C={c}: max_abs_err {err5:.3e} (tol 1e-5 of sum |g|, sum |g x^|), bitwise "
              f"equal from call to call; time {ms:.4f} ms ({100 * bnd / ms:.1f} % of its bound; "
              f"20 launches enqueued one by one, {graph:.4f} ms replayed from a CUDA graph), "
              f"plain {plain:.3f} ms, torch.sum of the products {lib:.3f} ms, bound {bnd:.4f} ms "
              f"({by}); plan tile {p.block_s} x {p.block_c}, chunk {p.chunk} voxels, grid "
              f"{p.grid} = {p.programs} programs, {p.n_chunks} x 2 x {c} f32 partials a "
              f"sample; {regs}", flush=True)

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
        ms = cuda_ms(lambda: conv3d_in.in_bwd_apply(xh, dy, m1, m2, scale), reps=20)
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
    step = sum(r["ms"] * K56_PER_STEP[r["site"]] for r in rows5)
    bnd = sum(r["bound_ms"] * K56_PER_STEP[r["site"]] for r in rows5)
    print(f"K5, a training step's {sum(K56_PER_STEP.values())} launches: {step:.4f} ms against "
          f"a bound of {bnd:.4f} ms ({100 * bnd / step:.1f} %)", flush=True)
    for r in rows5:
        fail_if(r["bound_share"] < 0.7, f"K5 C={r['site']}: {100 * r['bound_share']:.1f} % "
                "of its bound, short of 70 %")
    detail["in_bwd_stats"], detail["in_bwd_apply"] = rows5, rows6
    return rows5, rows6


def k7_plan_line(depthwise, shape, c) -> str:
    """K7's tile plan for x and g of ``shape`` (B, D, H, W) and C channels."""
    p = depthwise.k7_plan(shape, c)
    return (f"plan TY {p.ty}, TX {p.tx}, CG {p.cg}, z segments of {p.seg} ({p.grid[3]} a "
            f"sample), {p.threads} threads, {p.blocks} blocks, {p.smem} B shared, "
            f"{p.rows} x 28 x {c} f32 partials")


def _k7_held(torch, depthwise, x, gr, site):
    """K7 against its plain version within 1e-5 of sum |x g| per tap, and
    a second call on the same inputs equal to the bit."""
    got = depthwise.depthwise_grads(x, gr)
    again = depthwise.depthwise_grads(x, gr)
    torch.cuda.synchronize()
    want = depthwise.depthwise_grads_plain(x, gr)
    mag = depthwise.depthwise_grads_plain(x.abs(), gr.abs())
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - 1e-5 * mag).max().item()
    fail_if(not excess <= 1e-3, f"K7 {site}: err {err} beyond 1e-5 of the magnitudes")
    fail_if(not torch.equal(got, again), f"K7 {site}: two calls differ (not deterministic)")
    return err


def check_k7(torch, depthwise, g, detail):
    """K7 at the three DualAttention widths of a training step and on K3's
    odd shapes, against the plain version in f32 from the same bf16 inputs
    (within 1e-5 of the sum of the terms' magnitudes per tap), bitwise
    equal from call to call, each main-path site at >= 50 % of its bound."""
    rows = []
    for c in K7_PER_STEP:
        x = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        gr = torch.randn(BATCH, WIN, WIN, WIN, c, device="cuda", generator=g).to(torch.bfloat16)
        err = _k7_held(torch, depthwise, x, gr, f"C={c}")
        bnd, by = bound_ms(2.0 * 28 * x.numel(), 4.0 * x.numel() + 4.0 * 28 * c, PEAK_F32)
        ms = cuda_ms(lambda: depthwise.depthwise_grads(x, gr), reps=20)
        plain = cuda_ms(lambda: depthwise.depthwise_grads_plain(x, gr), reps=1)
        xl, gl = x.permute(0, 4, 1, 2, 3), gr.permute(0, 4, 1, 2, 3)

        def lib_grads():
            dk = torch.nn.grad.conv3d_weight(xl, (c, 1, 3, 3, 3), gl, padding=1, groups=c)
            return dk, gr.sum(dim=(0, 1, 2, 3), dtype=torch.float32)

        lib = cuda_ms(lib_grads)
        rows.append(dict(site=c, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bnd, bound_by=by, bound_share=bnd / ms))
        print(f"K7 C={c}: max_abs_err {err:.3e} (tol 1e-5 of sum |x g| per tap), bitwise "
              f"equal from call to call; time {ms:.4f} ms ({100 * bnd / ms:.1f} % of its bound), "
              f"plain {plain:.3f} ms, library weight-grad conv + sum {lib:.3f} ms, bound "
              f"{bnd:.4f} ms ({by}); {k7_plan_line(depthwise, x.shape[:4], c)}", flush=True)
        del x, gr
        torch.cuda.empty_cache()
    step = sum(r["ms"] * K7_PER_STEP[r["site"]] for r in rows)
    bnd = sum(r["bound_ms"] * K7_PER_STEP[r["site"]] for r in rows)
    print(f"K7, a training step's {sum(K7_PER_STEP.values())} launches: {step:.4f} ms against "
          f"a bound of {bnd:.4f} ms ({100 * bnd / step:.1f} %)", flush=True)
    for r in rows:
        fail_if(r["bound_share"] < 0.5, f"K7 C={r['site']}: {100 * r['bound_share']:.1f} % "
                "of its bound, short of 50 %")
    odd = []
    for shape in K3_ODD:
        c = shape[-1]
        site = "x".join(str(v) for v in shape)
        x = torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
        gr = torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
        err = _k7_held(torch, depthwise, x, gr, site)
        odd.append(dict(site=site, max_abs_err=err))
        print(f"K7 {site}: max_abs_err {err:.3e}, bitwise equal from call to call; "
              f"{k7_plan_line(depthwise, shape[:4], c)}", flush=True)
    detail["depthwise3_grads"], detail["depthwise3_grads_odd"] = rows, odd
    return rows


def check_k8(torch, F, g, detail):
    """K8 at the main path's shape and at an odd size against the plain 9^3
    conv in f32 from the same bf16 inputs.  Tolerance 1e-2 of the largest
    reference value: up to 729 f32 products summed in another order, then
    one bf16 rounding of the output (2^-9 relative)."""
    from mica_tpu_torch.models.mica import _fold_kernel_s2d, _fold_s2d, _unfold_s2d
    from mica_tpu_torch.ops import _build, stem

    c = 2 * BASE
    rows = []
    for shape in ((BATCH, WIN, WIN, WIN), (2, 33, 35, 37)):
        x = torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
        ws = [torch.randn(c // 4, 1, k, k, k, device="cuda", generator=g) * k ** -1.5
              for k in stem.KS]
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        packed = stem.pack_weight(ws, torch.bfloat16)
        want = stem.stem_conv_plain(x.float(), packed.float(), bias)
        got = stem.stem_conv(x, packed, bias)
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        site = "x".join(str(v) for v in shape)
        fail_if(not err <= tol, f"K8 {site}: err {err} > {tol}")
        del want, got
        # the function's operations: each of the four c/4-channel convs
        # has k^3 taps a voxel (39168 MACs at C 128); the kernel issues
        # K_TOTAL padded taps for every voxel of every tile
        plan = stem.k8_plan(shape, c, _build.sm_count(x.device))
        m = x.numel()
        flops = 2.0 * m * sum(w.shape[0] * w.shape[-1] ** 3 for w in ws)
        mma_flops = flops * plan.mma_ratio
        # at the main path's shape (whole tiles); odd sizes add the tiles' overhang
        fail_if(shape[1:] == (WIN,) * 3 and plan.mma_ratio > 1.2,
                f"K8 {site}: {plan.mma_ratio:.3f}x the real taps' MMAs")
        nbytes = 2.0 * m + 2.0 * m * c + 2.0 * packed.numel() + 4.0 * c
        bnd, by = bound_ms(flops, nbytes, PEAK_BF16)
        ms = cuda_ms(lambda: stem.stem_conv(x, packed, bias), reps=20)
        plain = cuda_ms(lambda: stem.stem_conv_plain(x, packed, bias), reps=1)
        # the library conv this kernel took the place of, in TF32 as the
        # model ran it: the space-to-depth form at even sizes, else the 9^3
        xin = x.float()[:, None]
        w9 = stem.combine_weights(stem.unpack_weight(packed, c)).float()
        if all(v % 2 == 0 for v in shape[1:]):
            wf = _fold_kernel_s2d(w9)
            conv = lambda: _unfold_s2d(F.conv3d(_fold_s2d(xin), wf, padding=2))  # noqa: E731
            lib_name = "TF32 s2d conv3d"
        else:
            conv = lambda: F.conv3d(xin, w9, padding=4)  # noqa: E731
            lib_name = "TF32 9^3 conv3d"
        torch.backends.cudnn.allow_tf32 = True
        lib = cuda_ms(lambda: (conv().permute(0, 2, 3, 4, 1) + bias).to(torch.bfloat16))
        torch.backends.cudnn.allow_tf32 = False
        rows.append(dict(site=site, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
                         tflops=flops / ms / 1e9, mma_tflops=mma_flops / ms / 1e9,
                         mma_ratio=plan.mma_ratio))
        print(f"K8 {site} -> C={c}: max_abs_err {err:.3e} (tol {tol:.3e}); time {ms:.4f} ms "
              f"({100 * bnd / ms:.1f} % of its bound; {flops / ms / 1e9:.1f} TFLOP/s of the "
              f"function's {flops:.4e} operations, {mma_flops / ms / 1e9:.1f} issued, "
              f"{plan.mma_ratio:.3f}x the real taps' MMAs), plain {plain:.3f} ms, {lib_name} "
              f"{lib:.3f} ms, bound {bnd:.4f} ms ({by}); plan tile "
              f"{'x'.join(map(str, stem.TILE))}, NG {plan.ng} x {plan.passes} passes, "
              f"{plan.n_tiles} tiles on {plan.ctas} CTAs, 2 halo slots, {plan.smem} B shared",
              flush=True)
        del x, xin
        torch.cuda.empty_cache()
    detail["stem9"] = rows
    return rows


# The learned phase's kernel shapes: its training steps and held-out
# evaluation at batch 8 x 64^3, its forward check at 2 x 32^3, at base 16
LEARNED_BASE = 16
LEARNED_SHAPES = ((BATCH, WIN, WIN, WIN), (2, 32, 32, 32))


def check_learned_sites(torch, conv3d_in, depthwise, g, detail) -> dict:
    """Each kernel of the learned phase at its base-16 sites, against the
    plain versions and tolerances of the base-64 rows: K1 (statistics on)
    at the sites K1 takes, and as the dx conv of each; K2, K4, K5 and K6 at
    those sites' Co; K3 forward and dx and K7 at the DualAttention widths
    16, 32 and 64; K8 at C 32.  K1, K2, K3 and K8 at both shapes, the
    training kernels at the training shape.  Correctness only, no timing.
    Returns {kernel: [max_abs_err of each site]}."""
    from mica_tpu_torch.ops import stem

    errs, rows = {}, []
    rnd = lambda shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731

    def held(name, site, shape, err, tol):
        """``tol``: the bound on ``err``, or the text of a bound checked before."""
        where = "x".join(map(str, shape))
        fail_if(not isinstance(tol, str) and not err <= tol,
                f"{name} {site} at {where} (base {LEARNED_BASE}): err {err} > {tol}")
        errs.setdefault(name, []).append(err)
        rows.append(dict(kernel=name, site=site, shape=where, max_abs_err=err,
                         tol=tol if isinstance(tol, str) else f"{tol:.3e}"))

    taken = [(cis, co) for cis, co, st in conv3d_in.k1_sites(LEARNED_BASE)
             if st and conv3d_in.k1_takes(cis, co)]
    widths = sorted({co for _, co in taken})
    dw_widths = [LEARNED_BASE * 2 ** i for i in range(3)]
    for shape in LEARNED_SHAPES:
        for cis, co in taken:
            parts = [rnd(shape + (c,)).to(torch.bfloat16) for c in cis]
            ci = sum(cis)
            w = rnd((co, ci, 3, 3, 3)) * math.sqrt(2.0 / (27 * (ci + co)))
            b = rnd((co,)) * 0.1
            ref, ref_st = conv3d_in.conv3d_plain([p.float() for p in parts],
                                                 w.to(torch.bfloat16).float(), b)
            out, st = conv3d_in.conv3d(parts, w, b, with_stats=True)
            torch.cuda.synchronize()
            site = f"{cis}->{co}"
            held("conv3d_stats", site, shape, (out.float() - ref).abs().max().item(),
                 1e-2 * ref.abs().max().item())
            s_err = (st - ref_st).abs()
            abs_sum = ref.abs().sum(dim=(1, 2, 3))
            fail_if(bool((s_err[:, 0] > 1e-4 * abs_sum + 1e-3).any())
                    or bool((s_err[:, 1] > 1e-4 * ref_st[:, 1] + 1e-3).any()),
                    f"K1 {site} at base {LEARNED_BASE}: statistics off by {s_err.max().item()}")
            del parts, ref, out
        for c in widths:
            y = rnd(shape + (c,)).to(torch.bfloat16)
            mean, scale = rnd((shape[0], c)) * 0.1, torch.rand(
                shape[0], c, device="cuda", generator=g) * 0.5 + 0.5
            want = conv3d_in.in_apply_plain(y.float(), mean.to(torch.bfloat16).float(),
                                             scale.to(torch.bfloat16).float())
            got = conv3d_in.in_apply(y, mean, scale)
            held("in_apply", f"C={c}", shape, (got.float() - want).abs().max().item(),
                 1e-2 * want.abs().max().item())
        for c in dw_widths:
            x = rnd(shape + (c,)).to(torch.bfloat16)
            w, b = rnd((c, 1, 3, 3, 3)) * 0.2, rnd((c,)) * 0.1
            for form, wt, bt in (("forward", w, b), ("dx", w.flip(2, 3, 4), torch.zeros_like(b))):
                want = depthwise.depthwise_conv3_plain(x.float(), wt, bt)
                got = depthwise.depthwise_conv3(x, wt, bt)
                held("depthwise3", f"{form} C={c}", shape, (got.float() - want).abs().max().item(),
                     1e-2 * want.abs().max().item())
        c = 2 * LEARNED_BASE
        x = rnd(shape).to(torch.bfloat16)
        ws = [rnd((c // 4, 1, k, k, k)) * k ** -1.5 for k in stem.KS]
        bias = rnd((c,)) * 0.1
        packed = stem.pack_weight(ws, torch.bfloat16)
        want = stem.stem_conv_plain(x.float(), packed.float(), bias)
        got = stem.stem_conv(x, packed, bias)
        held("stem9", f"C={c}", shape, (got.float() - want).abs().max().item(),
             1e-2 * want.abs().max().item())
        torch.cuda.empty_cache()

    shape, n = LEARNED_SHAPES[0], WIN ** 3
    for ci, co in sorted({(co, sum(cis)) for cis, co in taken}):
        dc = rnd(shape + (ci,)).to(torch.bfloat16)
        w = (rnd((ci, co, 3, 3, 3)) * math.sqrt(2.0 / (27 * (ci + co)))).flip(2, 3, 4).transpose(0, 1)
        want, _ = conv3d_in.conv3d_plain([dc.float()], w.to(torch.bfloat16).float(), None, False)
        out, _ = conv3d_in.conv3d([dc], w, None, with_stats=False)
        held("conv3d_stats", f"dx {ci}->{co}", shape, (out.float() - want).abs().max().item(),
             1e-2 * want.abs().max().item())
    for c in widths:
        x = rnd(shape + (c,)).to(torch.bfloat16)
        mean = _bf16_table(torch, g, c, -0.1, 0.1)
        scale = _bf16_table(torch, g, c, 0.5, 1.5)
        want_y, want_xh = conv3d_in.in_apply_ad_plain(
            x.float(), mean.to(torch.bfloat16).float(), scale.to(torch.bfloat16).float())
        y, xh = conv3d_in.in_apply_ad(x.clone(), mean, scale)
        held("in_apply_ad", f"C={c}", shape, max((y.float() - want_y).abs().max().item(),
                                                  (xh.float() - want_xh).abs().max().item()),
             1e-2 * want_xh.abs().max().item())
        dy = rnd(shape + (c,)).to(torch.bfloat16)
        st = conv3d_in.in_bwd_stats(xh, dy)
        want = conv3d_in.in_bwd_stats_plain(xh, dy)
        mag = conv3d_in.in_bwd_stats_plain(xh.abs(), dy.abs())
        excess = ((st - want).abs() - 1e-5 * mag).max().item()
        fail_if(not excess <= 1e-3, f"K5 C={c} at base {LEARNED_BASE}: beyond 1e-5 of the "
                "magnitudes")
        held("in_bwd_stats", f"C={c}", shape, (st - want).abs().max().item(),
             "1e-5 of sum |g|, sum |g x^|")
        m1, m2 = st[:, 0] / n, st[:, 1] / n
        scale = _bf16_table(torch, g, c, 0.5, 1.5)
        dc = conv3d_in.in_bwd_apply(xh, dy, m1, m2, scale)
        r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
        want6 = conv3d_in.in_bwd_apply_plain(xh.float(), dy.float(), r(m1), r(m2), r(scale))
        held("in_bwd_apply", f"C={c}", shape, (dc.float() - want6).abs().max().item(),
             2e-2 * want6.abs().max().item())
        del x, y, xh, dy, dc, want_y, want_xh, want6
    for c in dw_widths:
        x = rnd(shape + (c,)).to(torch.bfloat16)
        gr = rnd(shape + (c,)).to(torch.bfloat16)
        held("depthwise3_grads", f"C={c}", shape, _k7_held(torch, depthwise, x, gr, f"C={c}"),
             "1e-5 of sum |x g| per tap, bitwise repeat")
    torch.cuda.empty_cache()
    for r in rows:
        print(f"learned site {r['kernel']} {r['site']} at {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {r['tol']})", flush=True)
    detail["learned_sites"] = rows
    return errs


def host_ms(torch, fn, reps: int = 200) -> float:
    """ms of host time per call of ``fn`` enqueued ``reps`` times in a row
    (after a synchronize, before the one that ends the run)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def k9_path(extent, w, starts) -> str:
    """What K9's word kernel does with these windows: a window's rows move
    in 16-byte words where its source and output rows are 16-byte aligned
    (Z, w and its z start multiples of 4 words), in 4-byte words else."""
    wide = sum(extent[2] % 4 == 0 and w % 4 == 0 and z % 4 == 0 for _, _, z in starts)
    return (f"path: word kernel, {len(starts) * w} x 4 blocks of 256 threads, {wide} of "
            f"{len(starts)} windows in 16-byte words, {len(starts) - wide} in 4-byte words")


def k9_pr3_wrapper(torch, _build, wc):
    """PR 3's K9 wrapper, timed beside today's for its host cost: the same
    checks, allocations and launch, but the C function looked up and
    declared on every call.  It counts no launch."""
    def call(pm, af, st, w):
        dev, n = pm.device, int(st.shape[0])
        wc._check(pm, torch.float32, None, dev, "gather_windows map")
        if pm.dim() != 3 or n < 1 or min(pm.shape) < w:
            raise ValueError(f"gather_windows: map {tuple(pm.shape)}, {n} starts, window {w}")
        wc._check(st, torch.int32, (n, 3), dev, "gather_windows starts")
        wins = torch.empty((n, w, w, w), dtype=torch.float32, device=dev)
        afs = None
        if af is not None:
            wc._check(af, torch.int32, pm.shape, dev, "gather_windows af")
            afs = torch.empty((n, w, w, w), dtype=torch.int32, device=dev)
        fn = getattr(_build.load("window_copy"), "gather_windows_u32")
        fn.argtypes = wc._GATHER_ARGS
        fn.restype = ctypes.c_int
        x, y, z = pm.shape
        err = fn(pm.data_ptr(), None if af is None else af.data_ptr(), st.data_ptr(),
                 wins.data_ptr(), None if afs is None else afs.data_ptr(), n, x, y, z, w,
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "gather_windows")
        return wins if afs is None else (wins, afs)

    return call


def k9_host_parts(torch, _build, wc, pm, pa, st, w) -> dict:
    """The host's time of the parts of a K9 call with AF, each enqueued 200
    times in a row: the C entry (the launch), the two outputs' allocation,
    one int32 buffer's for both with its views (a design tried and
    dropped), the C function's lookup (cached today, looked up and
    declared by PR 3's wrapper) and the current stream's lookup."""
    n = int(st.shape[0])
    shape = (n, w, w, w)
    wins = torch.empty(shape, dtype=torch.float32, device=pm.device)
    afs = torch.empty(shape, dtype=torch.int32, device=pm.device)
    entry = _build.function("window_copy", "gather_windows_u32", wc._GATHER_ARGS)
    stream = torch.cuda.current_stream(pm.device).cuda_stream
    args = (pm.data_ptr(), pa.data_ptr(), st.data_ptr(), wins.data_ptr(), afs.data_ptr(),
            n, *pm.shape, w, stream)

    def one_buffer():
        buf = torch.empty((2,) + shape, dtype=torch.int32, device=pm.device)
        return buf[0].view(torch.float32), buf[1]

    def declare():
        fn = getattr(_build.load("window_copy"), "gather_windows_u32")
        fn.argtypes = wc._GATHER_ARGS
        fn.restype = ctypes.c_int

    return {"C entry": host_ms(torch, lambda: entry(*args)),
            "two torch.empty": host_ms(torch, lambda: (
                torch.empty(shape, dtype=torch.float32, device=pm.device),
                torch.empty(shape, dtype=torch.int32, device=pm.device))),
            "one torch.empty and two views": host_ms(torch, one_buffer),
            "function, cached": host_ms(torch, lambda: _build.function(
                "window_copy", "gather_windows_u32", wc._GATHER_ARGS)),
            "function, looked up and declared (PR 3)": host_ms(torch, declare),
            "current_stream": host_ms(
                torch, lambda: torch.cuda.current_stream(pm.device).cuda_stream)}


def check_k9_k10(torch, g, seed, detail):
    """K9 and K10 at the engine's geometry on a 160^3 map (4 cores of 48 an
    axis: volumes 192^3, the padded map 208^3), n 8, w 64, c 48, A 20, to
    the bit against their plain versions: with and without the AF words, at
    the engine's aligned starts (timed) and at arbitrary ones, and with a
    tail that must be neither read nor written.  K9 also on a frame whose
    rows are not 16-byte aligned, and the words it moves at each site
    printed.  K9's device time is a CUDA graph's replay of 20 launches, on
    the same starts and walking the frame's 64 windows in the engine's 8
    batches (the source then comes from device memory, not the L2 cache),
    the latter at >= 50 % of its bound; beside it the eager time (20
    launches enqueued one by one) and the host's time to enqueue a call,
    in turns with PR 3's wrapper, and by part."""
    from mica_tpu_torch.ops import _build, window_copy as wc

    n, w, c, a, per_axis = BATCH, WIN, 48, 20, 4
    vol, ext = per_axis * c, per_axis * c + (w - c)
    rng = np.random.default_rng(seed + 4)
    grid = c * np.stack(np.meshgrid(*[np.arange(per_axis)] * 3, indexing="ij"), -1).reshape(-1, 3)
    starts = grid[rng.choice(len(grid), n, replace=False)]
    host = [tuple(r) for r in starts.tolist()]
    pm = torch.rand((ext,) * 3, device="cuda", generator=g)
    pa = torch.randint(0, 2 ** 24, (ext,) * 3, device="cuda", generator=g, dtype=torch.int32)
    # the frame's 64 windows in the engine's 8 batches of 8
    walk = wc.starts_tensor(grid[rng.permutation(len(grid))], pm.shape, w, "cuda")
    batches = [walk[k:k + n] for k in range(0, len(grid), n)]
    pr3 = k9_pr3_wrapper(torch, _build, wc)

    def worst(got, want):
        """Largest |difference| over the tensors of ``got`` and ``want``, in
        f64 (the AF words are integers); a nan counts as infinite."""
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        return max((x.double() - y.double()).abs().nan_to_num(nan=math.inf).max().item()
                   for x, y in zip(got, want))

    rows9 = []
    for with_af in (True, False):
        af = pa if with_af else None
        site = "af" if with_af else "no_af"
        srcs = (pm, pa) if with_af else (pm,)
        err, paths = 0.0, {}
        for label, pts in (("aligned", starts),
                           ("unaligned", rng.integers(0, ext - w + 1, size=(n, 3)))):
            st = wc.starts_tensor(pts, pm.shape, w, "cuda")
            paths[label] = k9_path(pm.shape, w, pts.tolist())
            want = wc.gather_windows_plain(pm, af, st, w)
            err = max(err, worst(wc.gather_windows(pm, af, st, w), want))
            fail_if(err != 0.0, f"K9 {site}, {label} starts: differs from its plain version "
                                f"by {err}")
            fail_if(worst(pr3(pm, af, st, w), want) != 0.0, f"K9 {site}, {label} starts: PR 3's "
                                                            f"wrapper differs")
        st = wc.starts_tensor(starts, pm.shape, w, "cuda")
        nbytes = 2.0 * 4 * n * w ** 3 * len(srcs) + 12.0 * n
        bnd, by = bound_ms(0.0, nbytes, PEAK_F32)
        it = iter(batches * 3)
        walk_ms = graph_ms(lambda: wc.gather_windows(pm, af, next(it), w), reps=20)
        same_ms = graph_ms(lambda: wc.gather_windows(pm, af, st, w), reps=20)
        ms = cuda_ms(lambda: wc.gather_windows(pm, af, st, w), reps=20)
        enq = {"today": [], "PR 3": []}
        for _ in range(4):                           # in turns
            enq["today"].append(host_ms(torch, lambda: wc.gather_windows(pm, af, st, w)))
            enq["PR 3"].append(host_ms(torch, lambda: pr3(pm, af, st, w)))
        med = {k: float(np.median(v)) for k, v in enq.items()}
        plain = cuda_ms(lambda: wc.gather_windows_plain(pm, af, st, w), reps=5)
        lib = cuda_ms(lambda: [torch.stack([s[x:x + w, y:y + w, z:z + w] for x, y, z in host])
                               for s in srcs], reps=5)
        rows9.append(dict(site=site, max_abs_err=err, ms=ms, graph_walk_ms=walk_ms,
                          graph_ms=same_ms, host_ms=med["today"], host_ms_pr3=med["PR 3"],
                          host_readings=enq, paths=paths, plain_ms=plain, library_ms=lib,
                          bound_ms=bnd, bound_by=by, bound_share=bnd / walk_ms,
                          gbytes_per_s=nbytes / walk_ms / 1e6))
        print(f"K9 {site} (n {n}, w {w}, map {ext}^3): aligned starts {paths['aligned']}; "
              f"unaligned starts {paths['unaligned']}; bitwise equal at both; device time (a "
              f"CUDA graph's replay of 20 launches) {walk_ms:.4f} ms walking the frame's 8 "
              f"batches ({100 * bnd / walk_ms:.1f} % of its bound, "
              f"{nbytes / walk_ms / 1e6:.1f} GB/s), {same_ms:.4f} ms on the same starts; eager "
              f"{ms:.4f} ms (20 launches enqueued one by one); host ms to enqueue a call, "
              f"median of 4 readings in turns: {med['today']:.4f} (readings "
              f"{', '.join(f'{v:.4f}' for v in enq['today'])}), PR 3's wrapper "
              f"{med['PR 3']:.4f} ({', '.join(f'{v:.4f}' for v in enq['PR 3'])}); plain "
              f"{plain:.4f} ms, torch.stack of slices {lib:.4f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
        fail_if(bnd / walk_ms < 0.5, f"K9 {site}: {100 * bnd / walk_ms:.1f} % of its bound, "
                                     f"short of 50 %")
        if with_af:
            rows9[-1]["host_parts_ms"] = parts = k9_host_parts(torch, _build, wc, pm, pa, st, w)
            print("K9 af, host ms a call by part: " + ", ".join(
                f"{k} {v:.4f}" for k, v in parts.items()), flush=True)

    # a frame whose rows are not 16-byte aligned: z-rows of 45 words
    odd, ow = (41, 43, 45), 16
    om = torch.rand(odd, device="cuda", generator=g)
    oa = torch.randint(0, 2 ** 24, odd, device="cuda", generator=g, dtype=torch.int32)
    opts = np.array([[0, 0, 0], [25, 27, 29], [3, 5, 7], [13, 1, 22]])
    ost = wc.starts_tensor(opts, odd, ow, "cuda")
    oerr = worst(wc.gather_windows(om, oa, ost, ow), wc.gather_windows_plain(om, oa, ost, ow))
    fail_if(oerr != 0.0, f"K9 {odd}: differs from its plain version by {oerr}")
    opath = k9_path(odd, ow, opts.tolist())
    print(f"K9 odd frame {'x'.join(map(str, odd))}, w {ow}, AF: {opath}; bitwise equal",
          flush=True)
    detail["gather_windows_odd"] = dict(extent=odd, w=ow, path=opath, max_abs_err=oerr)

    vols = (torch.rand((vol,) * 3, device="cuda", generator=g),
            torch.rand((vol,) * 3, device="cuda", generator=g),
            torch.rand((vol,) * 3 + (a,), device="cuda", generator=g))
    cores = (torch.rand((n, c, c, c), device="cuda", generator=g),
             torch.rand((n, c, c, c), device="cuda", generator=g),
             torch.rand((n, c, c, c, a), device="cuda", generator=g))
    st = wc.starts_tensor(starts, vols[0].shape, c, "cuda")
    rows10 = []
    for site, n_valid in (("full", n), ("tail", n - 3)):
        blocks = tuple(t.clone() for t in cores)
        for t in blocks:
            t[n_valid:] = float("nan")      # a skipped entry is not read
        # unaligned cores must not overlap either: distinct cells of a
        # 3-per-axis grid, all shifted by the same 1..3 voxels
        cells = np.stack(np.unravel_index(rng.choice(27, n, replace=False), (3, 3, 3)), -1)
        err = 0.0
        for label, pts in (("aligned", starts),
                           ("unaligned", c * cells + rng.integers(1, 4, size=3))):
            stp = wc.starts_tensor(pts, vols[0].shape, c, "cuda")
            want = wc.scatter_cores_plain(tuple(v.clone() for v in vols), blocks, stp, n_valid, c)
            got = wc.scatter_cores(tuple(v.clone() for v in vols), blocks, stp, n_valid, c)
            err = max(err, worst(got, want))
            fail_if(err != 0.0, f"K10 {site}, {label} starts: differs from its plain version "
                                f"by {err}")
            fail_if(any(bool(torch.isnan(t).any()) for t in got), f"K10 {site}: read its tail")
        nbytes = 2.0 * 4 * n_valid * c ** 3 * (2 + a) + 12.0 * n_valid
        bnd, by = bound_ms(0.0, nbytes, PEAK_F32)
        ms = cuda_ms(lambda: wc.scatter_cores(vols, blocks, st, n_valid, c), reps=20)
        plain = cuda_ms(lambda: wc.scatter_cores_plain(vols, blocks, st, n_valid, c), reps=5)

        def lib_paste():
            for i, (x, y, z) in enumerate(host[:n_valid]):
                for v, blk in zip(vols, blocks):
                    v[x:x + c, y:y + c, z:z + c] = blk[i]

        lib = cuda_ms(lib_paste, reps=5)
        rows10.append(dict(site=site, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bnd, bound_by=by, gbytes_per_s=nbytes / ms / 1e6))
        print(f"K10 {site} (n {n}, n_valid {n_valid}, c {c}, A {a}, volumes {vol}^3): bitwise "
              f"equal at aligned and unaligned starts, tail untouched; time {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, slice assignments "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    detail["gather_windows"], detail["scatter_cores"] = rows9, rows10
    del pm, pa, vols, cores
    torch.cuda.empty_cache()
    return rows9, rows10


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
    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(args.seed))
    kw = dict(batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE, core=48, halo=8)
    with tempfile.TemporaryDirectory() as tmp:
        map_path, pdb_path = synthetic_inputs(Path(tmp), args.map_size, args.seed)
        # the process's first call pays one-off costs (library heuristics,
        # Triton specialisations at the short batch's shapes) that vary from
        # run to run; the second call is the one measured and counted
        t0 = time.time()
        cold = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
        cold_wall = time.time() - t0
        cold_wps = (cold["timing"]["n_windows"] - cold["timing"]["n_empty"]) / cold["timing"]["inference"]
        cold = _probs(cold)
        _reset_counts()
        t0 = time.time()
        out = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
        wall = time.time() - t0
        launches = _read_counts()
    # bf16 runs repeat to the bit (K1's statistics are summed in a fixed order)
    repeat = _vol_dist(_probs(out), cold)
    fail_if(repeat != 0.0, f"two predict_map runs on one map differ by {repeat:.3e}")
    del cold
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
    computed = check_predict_launches(launches, timing)
    fw = timing["n_forwards"]
    wps = computed / timing["inference"]
    print(f"main path: map {n}^3, {timing['n_windows']} windows, {timing['n_empty']} empty, "
          f"{computed} computed in {fw} forwards (one is the all-zero window); "
          f"{wps:.3f} windows/s over the inference phase; predict_map wall {wall:.3f} s "
          f"(the process's first call: {cold_wps:.3f} windows/s, wall {cold_wall:.3f} s)",
          flush=True)
    print(f"timing {json.dumps(timing)}", flush=True)
    print(f"launches {json.dumps(launches)} (K1/K2/K3/K8/in_sums 13/21/3/1/19 per forward, "
          "K9/K10 1 per computed batch)", flush=True)
    print(f"volumes finite, bb/ca in [0, 1], aa sums to 1 within {aa_sum_err:.2e}; equal to "
          "the bit to the first call's", flush=True)
    detail["main_path"] = dict(timing=timing, launches=launches, windows_per_s=wps,
                               wall_s=wall, map_size=n, first_call_windows_per_s=cold_wps,
                               first_call_wall_s=cold_wall)
    return launches, model


def check_predict_launches(launches: dict, timing: dict) -> int:
    """The launch gate of one ``predict_volume`` run in core blend with a
    packed AF encoding: K1/K2/K3/K8 13/21/3/1 per forward (K2 after 12 K1
    sites and 9 ``in_sums`` ones), ``in_sums`` 19 (those 9 norms and 10
    average pools), K9 and K10 one per computed batch (the all-zero
    window's forward needs neither), no training kernel.  Returns the
    number of computed windows."""
    fw = timing["n_forwards"]
    computed = timing["n_windows"] - timing["n_empty"]
    batches = -(-computed // BATCH)
    fail_if(fw != batches + 1, f"{fw} forwards for {batches} batches and the all-zero window")
    want = {"conv3d_stats": 13 * fw, "in_apply": 21 * fw, "in_sums": 19 * fw,
            "depthwise3": 3 * fw, "stem9": fw, "gather_windows": batches,
            "scatter_cores": batches}
    for k, v in launches.items():
        fail_if(v != want.get(k, 0), f"{k}: {v} launches for {fw} forwards and {batches} "
                                     f"batches, expected {want.get(k, 0)}")
    return computed


N_RES = 400     # residues of the modelling scenario's chain


def modelling_path(torch, args, model, detail):
    """Map + FASTA + AF3 template + docked model on disk -> CA model, through
    the ``Solver`` that ``mica_tpu_torch.cli.run`` builds from its flags, on
    the card.  Returns the launch counts of prediction and extraction on
    the predicted volumes."""
    from mica_tpu_torch.cli import run as cli_run
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.io.mrc import write_mrc
    from mica_tpu_torch.trace.candidates import extract_candidates
    from mica_tpu_torch.trace.candidates_device import extract_candidates_device
    from mica_tpu_torch.utils.synthetic import make_scenario, random_rigid

    n = args.map_size
    ca, seq, perfect = make_scenario(n_res=N_RES, shape=(n, n, n), seed=args.seed)
    res3 = [pdb_io.ONE_TO_THREE.get(ch, "ALA") for ch in seq]
    keys = ("carbon_alpha_probability", "backbone_probability", "amino_acid_probability")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        inp = root / "input"
        template = inp / "AF3_structures" / "synth"
        template.mkdir(parents=True)
        # the density is the protein-shaped backbone volume; the template
        # is the chain moved rigidly, the docked model the chain in place
        write_mrc(root / "emd_0001.mrc",
                  np.transpose(perfect["backbone_probability"], (2, 1, 0)), voxel_size=1.0)
        (root / "0001.fasta").write_text(f">synth|Chains A\n{seq}\n")
        rot, shift = random_rigid(args.seed + 7)
        pdb_io.write_ca_pdb(template / "ranked_0.pdb", [ca @ rot.T + shift],
                            res_names_by_chain=[res3])
        pdb_io.write_ca_pdb(inp / "input_af3_docked.pdb", [ca], res_names_by_chain=[res3])
        # the solver as ``cli.run.main`` builds it from its flags (core 48,
        # halo 8 and bf16 are its defaults), the weights read from a .pth
        torch.save({"model_state_dict": model.state_dict()}, root / "weights.pth")
        sol = cli_run.build_solver(cli_run.build_parser().parse_args([
            "-m", str(root / "emd_0001.mrc"), "-f", str(root / "0001.fasta"), "-i", str(inp),
            "-o", str(root / "out"), "--model_path", str(root / "weights.pth"),
            "--batch_size", str(BATCH), "--base_filters", str(BASE), "--seed", str(args.seed),
            "--run_pulchra", "--run_phenix"]))
        cfg = sol.config
        fail_if((cfg.protocol, cfg.window_core, cfg.window_halo, cfg.dtype, cfg.device,
                 cfg.run_pulchra, cfg.run_phenix)
                != ("AF3_struct", 48, 8, torch.bfloat16, "cuda", True, True),
                f"unexpected config {cfg}")
        res = sol.check_seq()
        fail_if(res != "success", f"check_seq: {res}")

        # the network stage and extraction on what it predicted
        _reset_counts()
        sol.predict()
        stats = {}
        t0 = time.time()
        found = extract_candidates_device(*(sol.volumes[k] for k in keys), stats=stats)
        torch.cuda.synchronize()
        extract_s = time.time() - t0
        launches = _read_counts()
        vols, timing = sol.volumes, sol.predictor_timing
        fail_if(sol.prepared.volume.shape != (n, n, n), f"map {sol.prepared.volume.shape}")
        for k, v in vols.items():
            fail_if(not (isinstance(v, torch.Tensor) and v.is_cuda), f"{k} left the card")
        for k in keys[:2]:
            v = vols[k]
            fail_if(tuple(v.shape) != (n, n, n), f"{k} shape {tuple(v.shape)}")
            fail_if(not bool(torch.isfinite(v).all()), f"{k} not finite")
            fail_if(not (v.min().item() >= 0 and v.max().item() <= 1), f"{k} outside [0, 1]")
        aa = vols["amino_acid_probability"]
        fail_if(tuple(aa.shape) != (20, n, n, n) or not bool(torch.isfinite(aa).all()),
                "aa volume bad")
        aa_sum_err = (aa.sum(dim=0) - 1.0).abs().max().item()
        fail_if(aa_sum_err > 1e-4, f"aa probabilities sum to 1 +- {aa_sum_err}")
        pred = vols["amino_acid_prediction"]
        fail_if(not (pred.min().item() >= 0 and pred.max().item() <= 19), "aa prediction bad")
        computed = check_predict_launches(launches, timing)
        kept_bytes = sum(v.numel() * v.element_size() for v in vols.values())
        print(f"modelling path: map {n}^3, chain of {N_RES} residues; getData "
              f"{sol.time_cost['getData']:.3f} s, nnPred {sol.time_cost['nnPred']:.3f} s "
              f"({computed} windows computed in {timing['n_forwards']} forwards, "
              f"{computed / timing['inference']:.3f} windows/s over the inference phase); the "
              f"four volumes stay on the card: {kept_bytes} bytes not copied to the host",
              flush=True)
        print(f"  launches {json.dumps(launches)}", flush=True)
        print(f"  device extraction on the predicted volumes (random weights): "
              + ("None (over a cap), " if found is None else f"{len(found['coords'])} "
                 "candidates, ") + f"{extract_s:.3f} s, stats {json.dumps(stats)}", flush=True)
        detail["modelling_predict"] = dict(
            time_cost=dict(sol.time_cost), timing=timing, launches=launches,
            kept_on_device_bytes=kept_bytes, extraction_s=extract_s, extraction_stats=stats,
            extraction_candidates=None if found is None else len(found["coords"]))

        # the modelling stages from the scenario's perfect volumes on the card
        sol.set_volumes({k: torch.from_numpy(v).cuda() for k, v in perfect.items()},
                        prepared=sol.prepared)
        # ``Solver.run`` is ``check_seq``, ``predict`` and this call
        sol.extraction_stats = {}
        res = sol.model_from_volumes()
        fail_if(res != "success", f"model_from_volumes: {res}")
        t0 = time.time()
        host = extract_candidates(*(perfect[k] for k in keys), perfect["amino_acid_prediction"],
                                  cluster_method="morphology")
        host_s = time.time() - t0
        fail_if(not sol.extraction_stats.get("n_candidates"),
                "the device extraction did not run or found nothing")
        fail_if(len(sol.cands) != len(host), f"{len(sol.cands)} candidates, host {len(host)}")
        fail_if(not np.array_equal(sol.cands.aa_pred, host.aa_pred),
                "device candidates differ from the host's in order or prediction")
        d_xyz = float(np.abs(sol.cands.coords - host.coords).max())
        d_aa = float(np.abs(sol.cands.aa_prob - host.aa_prob).max())
        fail_if(d_xyz > 1e-12 or d_aa > 1e-12, f"device candidates off by {d_xyz}, {d_aa}")
        # two more extractions on the same volumes (the per-cluster sums are
        # index_add_ on the card): whether they return the same bits
        twice = [extract_candidates_device(*(sol.volumes[k] for k in keys)) for _ in range(2)]
        extract_repeat = all(np.array_equal(twice[0][k], twice[1][k]) for k in twice[0])
        del twice
        placed = pdb_io.select(pdb_io.parse_pdb(sol.ca_model_path), name="CA")
        fail_if(not len(placed) > 0.6 * len(ca), f"{len(placed)} of {len(ca)} residues placed")
        dist = np.linalg.norm(pdb_io.coords(placed)[:, None, :] - ca[None, :, :],
                              axis=-1).min(axis=1)
        median = float(np.median(dist))
        fail_if(not median < 1.5, f"median distance to the chain {median} A")
        all_atom = check_all_atom(pdb_io, sol, placed)
    print(f"  perfect volumes on the card: {len(sol.cands)} candidates, equal to the host "
          f"extraction in order and prediction, coords within {d_xyz:.1e}, aa within "
          f"{d_aa:.1e} (tol 1e-12); device {sol.time_cost['clustering']:.3f} s "
          f"({json.dumps(sol.extraction_stats)}), host {host_s:.3f} s; two more device "
          f"extractions equal to the bit: {extract_repeat}", flush=True)
    print(f"  stages (s): {json.dumps(sol.time_cost)}", flush=True)
    print(f"  CA model: {len(placed)} of {len(ca)} residues placed (> 60 %), median distance "
          f"to the chain {median:.3f} A (< 1.5)", flush=True)
    print(f"  all-atom model (cli.run --run_pulchra): {all_atom['atoms']} atoms in "
          f"{all_atom['residues']} residues, each with N, CA, C, O and its type's side chain, "
          f"coordinates finite; run_pulchra {sol.time_cost['run_pulchra']:.3f} s on the host "
          f"({platform.node()}, {os.cpu_count()} CPUs; the tool built from "
          f"mica_tpu_torch/tools/allatom_src)", flush=True)
    print(f"  PHENIX (--run_phenix, not installed: the command only): {sol.phenix_command}",
          flush=True)
    detail["modelling"] = dict(time_cost=dict(sol.time_cost), extraction_stats=sol.extraction_stats,
                               host_extraction_s=host_s, extraction_repeats=extract_repeat,
                               placed=int(len(placed)),
                               residues=int(len(ca)), median_distance=median,
                               all_atom=all_atom, host=platform.node(),
                               phenix_command=sol.phenix_command)
    return launches


# heavy atoms of each residue type's side chain, CB included, as the
# all-atom tool writes them (no hydrogens, no OXT)
SIDE_CHAIN_ATOMS = {"ALA": 1, "ARG": 7, "ASN": 4, "ASP": 4, "CYS": 2, "GLN": 5, "GLU": 5,
                    "GLY": 0, "HIS": 6, "ILE": 4, "LEU": 4, "LYS": 5, "MET": 4, "PHE": 7,
                    "PRO": 3, "SER": 2, "THR": 3, "TRP": 10, "TYR": 8, "VAL": 3}


def check_all_atom(pdb_io, sol, placed) -> dict:
    """The all-atom model ``Solver.run`` wrote from the CA model: a residue
    for each placed CA, each with N, CA, C and O and as many heavy atoms as
    its type has, every coordinate finite."""
    path = Path(sol.ca_model_path.replace("_ca_model.pdb", "_all_atom_model.pdb"))
    fail_if("run_pulchra" not in sol.time_cost or not path.exists(),
            f"no all-atom model at {path}")
    fail_if("phenix_refine" not in sol.time_cost or not sol.phenix_command,
            "the PHENIX stage did not run")
    atoms = pdb_io.parse_pdb(path)
    fail_if(not np.isfinite(pdb_io.coords(atoms)).all(), "all-atom coordinates not finite")
    residues = {}
    for at in atoms:
        key = (str(at["chain"]), int(at["res_id"]))
        residues.setdefault(key, (str(at["res_name"]), set()))[1].add(str(at["name"]))
    want = {(str(at["chain"]), int(at["res_id"])) for at in placed}
    fail_if(set(residues) != want, f"{len(residues)} all-atom residues for {len(want)} CAs")
    for key, (res, names) in residues.items():
        fail_if(not {"N", "CA", "C", "O"} <= names, f"residue {key} {res}: backbone {names}")
        fail_if(len(names) != 4 + SIDE_CHAIN_ATOMS[res],
                f"residue {key} {res}: {len(names)} atoms, expected {4 + SIDE_CHAIN_ATOMS[res]}")
    return dict(path=path.name, atoms=int(len(atoms)), residues=len(residues))


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
    groups = {"conv3d_stats (K1)": ("conv3d_stats_kernel",),
              "in_apply (K2)": ("in_apply_kernel",),
              "in_sums": ("in_stats_sum_kernel", "in_bwd_stats_sum_kernel"),
              "depthwise3 (K3)": ("depthwise3_kernel",), "stem9 (K8)": ("stem9_kernel",)}
    shares = {}
    for label, pats in groups.items():
        shares[label] = sum(v for k, v in per_kernel.items() if any(p in k for p in pats))
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
                 "in_bwd_stats": "in_bwd_stats", "in_bwd_apply": "in_bwd_apply_kernel",
                 "depthwise3": "depthwise3_kernel", "depthwise3_grads": "depthwise3_grads"}
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
    counts = _read_counts()
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
    for k in ("in_apply", "in_sums", "stem9", "gather_windows", "scatter_cores"):
        fail_if(counts[k] != 0, f"training launched the inference-only {k}")
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
# f32 on the card against f32 on the CPU: the same formulas, summed in
# another order; the whole gradient's cosine
F32_GRAD_MIN = 0.9999


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


def profile_train_step(torch, trainer, state, batch, detail, key="train_profile"):
    """Where one training step's device time goes: kernel times and the
    step's device span, both from one profiled step, kept under ``key``."""
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
    print(f"profile of one training step (base {trainer.model.base}): device span "
          f"{span:.3f} ms, kernel time "
          f"{busy:.3f} ms" + (f", idle share {1 - busy / span:.3f}" if busy else
                              ": profiler saw no device time (not measured)"), flush=True)
    for label, v in shares.items():
        print(f"  {label}: {v:.3f} ms", flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]
    for name, v in top:
        print(f"  {v:9.3f} ms  {name[:100]}", flush=True)
    detail[key] = dict(span_ms=span, kernel_ms=busy, shares_ms=shares,
                       top=[[n[:200], v] for n, v in top])


F32_MAP, F32_CORE = 16, 16    # the f32 phase's map (voxels an axis) and window core
F32_KERNELS = ("conv3d_stats", "in_apply", "in_sums", "in_apply_ad", "in_bwd_stats",
               "in_bwd_apply", "depthwise3", "depthwise3_grads", "stem9")


def f32_path(torch, args, detail):
    """f32 on the card, the route the JAX package's f32 takes: library
    convs with TF32 off, no K1-K8 launch.  At base 64 on a small map (one
    32^3 window) so that the CPU reference is quick: ``predict_map`` on the
    card against the same weights on the CPU (atol 1e-4), TF32 read inside
    the forward; ``python -m mica_tpu_torch.cli.predict --float32`` as a
    subprocess (exit 0, its volumes against the CPU's); ``cli.run
    --float32``'s solver through its network stage, volumes kept on the
    card (against the CPU's); the f32 gradient of the card against the
    CPU's at the seed's weights; two ``Trainer`` steps; and ``cli.train
    --dtype float32`` for one epoch in this process."""
    from mica_tpu_torch.cli import run as cli_run
    from mica_tpu_torch.cli import train as cli_train
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io.mrc import read_mrc
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.train import data as data_mod
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default, on around the phase
    keys = ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability")
    kw = dict(batch_size=BATCH, dtype=torch.float32, base_filters=BASE, core=F32_CORE, halo=8)
    model = MICA(base=BASE, dtype=torch.float32).init_weights(
        torch.Generator().manual_seed(args.seed + 5))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    tf32_seen = []
    model.input_processing.register_forward_hook(
        lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))
    res = {}

    def worst(got, want):
        return max(float(np.abs(np.asarray(got[k], np.float64) - want[k]).max()) for k in keys)

    def no_kernels(counts, what):
        launched = {k: counts[k] for k in F32_KERNELS if counts[k]}
        fail_if(bool(launched), f"f32 {what} launched kernels {launched}")

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        map_path, pdb_path = synthetic_inputs(root, F32_MAP, args.seed + 5)
        t0 = time.time()
        ref = predict_map(str(map_path), state, docked_pdb_path=str(pdb_path), device="cpu", **kw)
        cpu_s = time.time() - t0
        _reset_counts()
        t0 = time.time()
        card = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
        card_s = time.time() - t0
        counts = _read_counts()
        no_kernels(counts, "predict_map")
        fail_if(not tf32_seen or any(tf32_seen), f"cuDNN TF32 inside the f32 forward: {tf32_seen}")
        fail_if(not torch.backends.cudnn.allow_tf32, "the f32 forward did not restore TF32")
        res["predict_map"] = worst(card, ref)
        print(f"f32 predict_map on the card ({F32_MAP}^3 map, core {F32_CORE}, base {BASE}): "
              f"max |dP| {res['predict_map']:.3e} against the CPU (tol 1e-4), {card_s:.1f} s "
              f"(CPU {cpu_s:.1f} s); cuDNN TF32 inside the forward: {sorted(set(tf32_seen))}, "
              f"after it: {torch.backends.cudnn.allow_tf32}; K1-K8 launches "
              f"{ {k: counts[k] for k in F32_KERNELS} }", flush=True)

        # the CLI, as a user runs it: on the card by default
        torch.save({"model_state_dict": state}, root / "weights.pth")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "mica_tpu_torch.cli.predict", "-m", str(map_path), "-o",
             str(root / "cli"), "--docked_model", str(pdb_path), "--model_checkpoint",
             str(root / "weights.pth"), "--float32", "--window_core", str(F32_CORE),
             "--batch_size", str(BATCH)],
            capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent)
        cli_s = time.time() - t0
        fail_if(proc.returncode != 0,
                f"cli.predict --float32 exited {proc.returncode}: {proc.stderr[-2000:]}")
        vols = {k: read_mrc(root / "cli" / f"{k}.mrc").to_xyz()[0] for k in keys[:2]}
        aa16 = np.load(root / "cli" / "amino_acid_probability.npz")["data"]
        res["cli_predict"] = max(float(np.abs(vols[k].astype(np.float64) - ref[k]).max())
                                 for k in keys[:2])
        res["cli_predict_aa_f16"] = float(np.abs(aa16.astype(np.float64)
                                                 - ref["amino_acid_probability"]).max())
        print(f"python -m mica_tpu_torch.cli.predict --float32 (subprocess, device cuda by "
              f"default): exit 0 in {cli_s:.1f} s; bb/ca max |dP| {res['cli_predict']:.3e} "
              f"against the CPU (tol 1e-4), aa stored in float16 {res['cli_predict_aa_f16']:.3e} "
              f"(tol 1e-3)", flush=True)

        # cli.run --float32: the solver the CLI builds, through its network stage
        inp = root / "input"
        inp.mkdir()
        (inp / "input_af3_docked.pdb").write_text(pdb_path.read_text())
        (root / "seq.fasta").write_text(">synth|Chains A\nACDEFGHIKLMNPQRSTVWY\n")
        sol = cli_run.build_solver(cli_run.build_parser().parse_args([
            "-m", str(map_path), "-f", str(root / "seq.fasta"), "-i", str(inp), "-o",
            str(root / "out"), "--model_path", str(root / "weights.pth"), "--float32",
            "--protocol", "AF3_struct_free", "--window_core", str(F32_CORE),
            "--batch_size", str(BATCH), "--base_filters", str(BASE)]))
        fail_if((sol.config.dtype, sol.config.device) != (torch.float32, "cuda"),
                f"cli.run --float32 built {sol.config}")
        fail_if(sol.check_seq() != "success", "cli.run --float32: check_seq failed")
        _reset_counts()
        sol.predict()
        counts = _read_counts()
        no_kernels(counts, "cli.run")
        fail_if(not all(sol.volumes[k].is_cuda for k in keys), "cli.run volumes left the card")
        res["cli_run"] = worst({k: sol.volumes[k].cpu().numpy() for k in keys}, ref)
        print(f"cli.run --float32 (solver on the card, network stage): max |dP| "
              f"{res['cli_run']:.3e} against the CPU (tol 1e-4), K1-K8 launches 0", flush=True)
        del sol

        # training: the card's f32 gradient against the CPU's, then steps
        inputs = _grad_inputs(torch, args.seed)
        fresh = MICA(base=BASE, dtype=torch.float32).init_weights(
            torch.Generator().manual_seed(args.seed)).state_dict()
        grads = []
        _reset_counts()
        for dev in ("cuda", "cpu"):
            m = MICA(base=BASE, dtype=torch.float32)
            m.load_state_dict(fresh)
            grads.append(_model_grad(torch, m.to(dev), dev, inputs))
        whole, worst_t, name = _grad_agreement(torch, *grads, "f32 card vs f32 CPU", detail)
        fail_if(not whole >= F32_GRAD_MIN, f"f32 gradient cosine {whole} < {F32_GRAD_MIN}")
        trainer = Trainer(base_filters=BASE, dtype=torch.float32, seed=args.seed)
        tstate = trainer.init_state()
        tf32_seen.clear()
        trainer.model.input_processing.register_forward_hook(
            lambda *_: tf32_seen.append(torch.backends.cudnn.allow_tf32))
        batch = [torch.as_tensor(b).cuda() for b in data_mod.synthetic_batch(2, 2 * F32_CORE,
                                                                                 args.seed)]
        losses = [float(trainer.train_step(tstate, batch, task_lambdas(0), 0.01)["total_loss"])
                  for _ in range(2)]
        fail_if(not all(math.isfinite(v) for v in losses), f"f32 Trainer losses {losses}")
        fail_if(not tf32_seen or any(tf32_seen), f"cuDNN TF32 inside an f32 step: {tf32_seen}")
        data_mod.ArrayDataset(*data_mod.synthetic_batch(4, 2 * F32_CORE, args.seed + 1)).save(
            str(root / "grids.npz"))
        code = cli_train.main(["--data_path", str(root / "grids.npz"), "--output_path",
                               str(root / "trained"), "--batch_size", "2", "--num_epochs", "1",
                               "--val_fraction", "0.5", "--dtype", "float32",
                               "--base_filters", str(BASE), "--log_dir", str(root / "logs"),
                               "--seed", str(args.seed)])
        counts = _read_counts()
        fail_if(code != 0, f"cli.train --dtype float32 exited {code}")
        ckpt = sorted((root / "trained").glob("mica_epoch_0*.pt"))
        fail_if(len(ckpt) != 1, f"cli.train wrote {ckpt}")
        val = float(torch.load(ckpt[0], map_location="cpu", weights_only=False)["val_loss"])
        fail_if(not math.isfinite(val), f"cli.train validation loss {val}")
        no_kernels(counts, "training")
        print(f"f32 training on the card: gradient cosine {whole:.6f} against the CPU (min "
              f"{F32_GRAD_MIN}; worst tensor {worst_t:.6f}, {name}); Trainer base {BASE}, "
              f"batch 2 x {2 * F32_CORE}^3, 2 steps: losses {losses}, cuDNN TF32 inside the "
              f"steps {sorted(set(tf32_seen))}; cli.train --dtype float32: exit 0, validation "
              f"loss {val:.5f}; K1-K8 launches 0", flush=True)
        del trainer, tstate, batch
    for k in ("predict_map", "cli_predict", "cli_run"):
        fail_if(not res[k] <= 1e-4, f"f32 {k} differs from the CPU by {res[k]}")
    fail_if(not res["cli_predict_aa_f16"] <= 1e-3, "cli.predict's float16 aa probabilities off")
    torch.cuda.empty_cache()
    detail["f32"] = dict(max_abs_dp=res, cpu_s=cpu_s, card_s=card_s, cli_predict_s=cli_s,
                         gradient_cosine=whole, trainer_losses=losses, cli_train_val_loss=val)


# The prep phase: Merizo on the card and ``cli.prep``'s four preparation
# steps but the EMDB lookup (it needs the network).
MERIZO_RES = 1000       # residues of the chain Merizo runs on, card against CPU
MERIZO_TOL = 1e-3       # card against CPU, mask and background logits (f32, TF32 off)
PREP_CHAINS = {"fold_a": {"A": (260, 260), "B": (80,)},     # residues per domain
               "fold_b": {"A": (150,), "B": (40,)}}


def helix_chain(n: int, seed: int):
    """A helix-like CA walk with N and C atoms offset from each CA."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) * (100.0 * np.pi / 180.0)
    ca = np.stack([2.3 * np.cos(t), 2.3 * np.sin(t), 1.5 * np.arange(n)], 1)
    ca += rng.normal(0, 0.2, ca.shape)
    n_xyz = ca + rng.normal([-1.2, 0.3, -0.5], 0.05, ca.shape)
    c_xyz = ca + rng.normal([1.2, -0.4, 0.4], 0.05, ca.shape)
    return rng.integers(0, 20, n), n_xyz, ca, c_xyz


def write_backbone_cif(path: Path, chains: dict, seed: int) -> None:
    """An AF3-style mmCIF of chains {id: (n, 3) CA coords}: N, CA, C and O
    in every residue, random residue types."""
    from mica_tpu_torch.io.pdb import AMINO_ACIDS

    rng = np.random.default_rng(seed)
    fields = ("group_PDB id type_symbol label_atom_id label_alt_id label_comp_id "
              "label_asym_id label_entity_id label_seq_id auth_seq_id auth_asym_id "
              "Cartn_x Cartn_y Cartn_z occupancy B_iso_or_equiv").split()
    rows, serial = [], 1
    for cid, ca in chains.items():
        for r, xyz in enumerate(ca):
            res = AMINO_ACIDS[rng.integers(len(AMINO_ACIDS))]
            for name, ofs in (("N", (-1.2, 0.3, -0.5)), ("CA", (0, 0, 0)),
                              ("C", (1.2, -0.4, 0.4)), ("O", (2.2, -1.1, 0.2))):
                x, y, z = np.asarray(xyz) + ofs
                rows.append(f"ATOM {serial} {name[0]} {name} . {res} {cid} 1 {r + 1} {r + 1} "
                            f"{cid} {x:.3f} {y:.3f} {z:.3f} 1.00 80.00")
                serial += 1
    path.write_text("data_af3\n#\nloop_\n" + "".join(f"_atom_site.{f}\n" for f in fields)
                    + "\n".join(rows) + "\n#\n")


def prep_path(torch, args, detail):
    """Random Merizo shards from ``--seed`` under ``MICA_MERIZO_WEIGHTS``;
    Merizo on the card against the CPU on a ``MERIZO_RES``-residue chain;
    ``cli.prep af3-results`` (Merizo on the card for every chain of >= 50
    CAs), ``af3-json`` and ``dock --dry_run`` in this process."""
    import contextlib
    import io

    from mica_tpu_torch.cli import prep as cli_prep
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.io.mrc import read_mrc, write_mrc
    from mica_tpu_torch.models import merizo
    from mica_tpu_torch.utils.synthetic import make_chain

    t_phase, res = time.time(), {}
    saved_env = os.environ.get("MICA_MERIZO_WEIGHTS")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        torch.manual_seed(args.seed)
        sd = merizo.Merizo().state_dict()
        wdir = root / "merizo_weights"
        wdir.mkdir()
        keys = list(sd)
        for i in range(3):
            torch.save({k: sd[k] for k in keys[i::3]}, wdir / f"weights_part_{i}.pt")
        os.environ["MICA_MERIZO_WEIGHTS"] = str(wdir)
        try:
            # Merizo on the card against its CPU forward
            aa, n_xyz, ca, c_xyz = helix_chain(MERIZO_RES, args.seed)
            rot, trans = merizo.gram_schmidt_frames(n_xyz, ca, c_xyz)
            feats = {"s": np.eye(20, dtype=np.float32)[aa],
                     "z": np.linalg.norm(ca[:, None] - ca[None], axis=-1).astype(np.float32),
                     "rot": rot.astype(np.float32), "trans": trans.astype(np.float32),
                     "ri": np.arange(1, MERIZO_RES + 1, dtype=np.float32), "ca_xyz": ca}
            card, host = merizo.load_weights(str(wdir)), merizo.load_weights(str(wdir), "cpu")
            merizo.forwards.update(cuda=0, cpu=0)
            got = merizo._forward(card, feats)            # the first call: one-off costs
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            reps = 5
            for _ in range(reps):
                got = merizo._forward(card, feats)
            ms = (time.time() - t0) / reps * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            cuda_forwards = merizo.forwards["cuda"]
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                merizo._forward(card, feats)
            per_kernel = _device_times(prof)
            busy = sum(per_kernel.values())
            gru = sum(v for k, v in per_kernel.items() if "rnn" in k.lower() or "gru" in k.lower())
            top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
            print(f"prep: profile of one Merizo forward: kernel time {busy:.3f} ms of its "
                  f"{ms:.3f} ms, cuDNN's GRU kernels {gru:.3f} ms; top: "
                  + "; ".join(f"{v:.3f} ms {k[:60]}" for k, v in top), flush=True)
            t0 = time.time()
            want = merizo._forward(host, feats)
            cpu_s = time.time() - t0
            errs = [float(np.abs(g - w).max()) for g, w in zip(got, want)]
            top2 = np.sort(want[0], axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > MERIZO_TOL
            ids_agree = bool((np.argmax(got[0], -1) == np.argmax(want[0], -1))[clear].all())
            print(f"prep: Merizo on {MERIZO_RES} residues, f32 (TF32 off): {ms:.3f} ms a "
                  f"forward on the card (host clock over {reps}, results on the host), peak "
                  f"{peak:.3f} GiB, {cuda_forwards} forwards on the card; the CPU's "
                  f"{cpu_s:.3f} s; card against CPU: mask logits {errs[0]:.3e}, bg logits "
                  f"{errs[1]:.3e} (gate {MERIZO_TOL:g}), argmax equal at the "
                  f"{int(clear.sum())} residues whose top two are more than {MERIZO_TOL:g} "
                  f"apart: {ids_agree}", flush=True)
            fail_if(max(errs) > MERIZO_TOL, f"Merizo card against CPU: {errs}")
            fail_if(not ids_agree, "Merizo's domain argmax differs between card and CPU")
            fail_if(cuda_forwards != reps + 1, f"{cuda_forwards} Merizo forwards on the card")
            res["merizo"] = dict(residues=MERIZO_RES, ms_per_forward=ms, peak_gib=peak,
                                 cuda_forwards=cuda_forwards, cpu_s=cpu_s, kernel_ms=busy,
                                 gru_ms=gru, top=[[k[:200], v] for k, v in top],
                                 max_abs_err_masks=errs[0], max_abs_err_bg=errs[1],
                                 tolerance=MERIZO_TOL)

            # cli.prep af3-results: two models, two chains each
            inp = root / "inputs" / "synth"
            results = inp / "AF3_results"
            chain_sizes = {}
            for m, (fold, chains) in enumerate(PREP_CHAINS.items()):
                coords = {}
                for c, (cid, doms) in enumerate(chains.items()):
                    parts = [make_chain(n, (60, 60, 60), args.seed + 10 * m + 3 * c + d)
                             + np.array([70.0 * d, 0, 0]) for d, n in enumerate(doms)]
                    coords[cid] = np.concatenate(parts)
                    chain_sizes[f"{fold}_model_0_chain_{cid}"] = len(coords[cid])
                (results / fold).mkdir(parents=True)
                write_backbone_cif(results / fold / f"{fold}_model_0.cif", coords, args.seed + m)
            calls = []
            segment = merizo.segment_chain_atoms

            def recorded(atoms, *a, **kw):
                before = dict(merizo.forwards)
                out = segment(atoms, *a, **kw)
                calls.append(dict(cas=int(len(pdb_io.select(atoms, name="CA"))),
                                  **{k: merizo.forwards[k] - before[k] for k in before},
                                  domains=int(len(np.unique(out[0][out[0] > 0])))))
                return out

            merizo.segment_chain_atoms = recorded
            try:
                t0 = time.time()
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli_prep.main(["af3-results", "-a", str(results)])
                af3_s = time.time() - t0
            finally:
                merizo.segment_chain_atoms = segment
            counts = json.loads(buf.getvalue().strip().splitlines()[-1])
            print(f"prep: cli.prep af3-results: exit {rc}, {counts} in {af3_s:.3f} s; Merizo "
                  f"calls (CAs, card forwards, CPU forwards, domains found): "
                  f"{[(c['cas'], c['cuda'], c['cpu'], c['domains']) for c in calls]}",
                  flush=True)
            fail_if(rc != 0, f"cli.prep af3-results exited {rc}")
            fail_if(counts != {"converted": 2, "failed": 0, "chains": 4,
                               "domains": counts["domains"]} or counts["domains"] < 4,
                    f"cli.prep af3-results counts {counts}")
            long = sorted(n for n in chain_sizes.values() if n >= 50)
            fail_if(sorted(c["cas"] for c in calls) != long,
                    f"Merizo ran on chains of {[c['cas'] for c in calls]} CAs, expected {long}")
            fail_if(any(c["cuda"] < 1 or c["cpu"] for c in calls),
                    "Merizo did not run on the card for every chain")
            for stem, n in chain_sizes.items():
                chain_pdb = inp / "AF3_chains" / f"{stem}.pdb"
                fail_if(not chain_pdb.exists(), f"{chain_pdb.name} missing")
                chain_res = set(pdb_io.parse_pdb(chain_pdb)["res_id"].tolist())
                fail_if(len(chain_res) != n, f"{chain_pdb.name}: {len(chain_res)} residues of {n}")
                doms = sorted((inp / "AF3_domains").glob(f"{stem}_domain_*.pdb"))
                fail_if(not doms, f"no domain file of {stem}")
                for d in doms:
                    dres = set(pdb_io.parse_pdb(d)["res_id"].tolist())
                    fail_if(not dres or not dres <= chain_res, f"{d.name} leaves its chain")
                res.setdefault("domains", {})[stem] = len(doms)
            print(f"prep: domain files per chain {res['domains']}, residues inside their chain",
                  flush=True)
            res["af3_results"] = dict(counts=counts, seconds=af3_s, merizo_calls=calls)

            # cli.prep af3-json
            fasta = root / "synth.fasta"
            fasta.write_text(">synth_1|Chains A, B\nMKTAYIAKQRQISFVKSHFSRQLEERLG\n"
                             ">synth_2|Chain C\nMSXXKLLVAGHX\n>dna\nACGTACGTACGT\n")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_prep.main(["af3-json", "-f", str(fasta), "-i", str(root / "inputs")])
            jdir = root / "inputs" / "synth" / "AF3_JSON"
            files = sorted(p.name for p in jdir.glob("*.json"))
            j1 = json.loads((jdir / "synth_1.json").read_text())[0]
            j2 = json.loads((jdir / "synth_2.json").read_text())[0]
            fail_if(rc != 0 or files != ["synth_1.json", "synth_2.json"],
                    f"cli.prep af3-json: exit {rc}, files {files}")
            fail_if([s["proteinChain"]["id"] for s in j1["sequences"]] != ["A", "B"]
                    or j2["sequences"][0]["proteinChain"]["sequence"] != "MSKLLVAGH"
                    or j1["dialect"] != "alphafold3", f"cli.prep af3-json payloads {j1} {j2}")
            print(f"prep: cli.prep af3-json: exit {rc}, {files} (the DNA entry skipped, X "
                  "removed)", flush=True)

            # cli.prep dock --dry_run: PHENIX is absent, its commands are made
            data = np.zeros((64, 64, 64), np.float32)
            data[8:56, 8:56, 8:56] = np.random.default_rng(args.seed).random((48, 48, 48))
            write_mrc(root / "map.mrc", data, voxel_size=1.0)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_prep.main(["dock", "-m", str(root / "map.mrc"), "-i", str(inp),
                                    "--resolution", "3.5", "--contour_level", "0.5",
                                    "--dry_run"])
            dock_out = json.loads(buf.getvalue().strip().splitlines()[-1])
            n_dom = len(list((inp / "AF3_domains").glob("*.pdb")))
            thr = read_mrc(inp / "docking_work" / "docking_map_0.mrc").data
            fail_if(rc != 0 or dock_out != {"docked": 0, "merged": None, "commands": n_dom},
                    f"cli.prep dock: exit {rc}, {dock_out} for {n_dom} domains")
            fail_if(bool(((thr > 0) & (thr < 0.5)).any()), "dock's map not thresholded")
            from mica_tpu_torch.prep.dock import dock_structures

            cmds = dock_structures(str(root / "map.mrc"),
                                   sorted(str(p) for p in (inp / "AF3_domains").glob("*.pdb")),
                                   3.5, 0.5, str(root / "dock_check"), dry_run=True)["commands"]
            fail_if(len(cmds) != n_dom or not all(
                "phenix.dock_in_map search_model=" in c and "resolution=3.5" in c
                and f"map_file={root / 'dock_check' / 'docking_map_0.mrc'}" in c
                for c in cmds), f"dock commands {cmds[:2]}")
            print(f"prep: cli.prep dock --dry_run: exit {rc}, {dock_out}; the map thresholded "
                  f"at 0.5; e.g. {cmds[0].split(' && ')[-1][:160]}...", flush=True)
        finally:
            if saved_env is None:
                os.environ.pop("MICA_MERIZO_WEIGHTS", None)
            else:
                os.environ["MICA_MERIZO_WEIGHTS"] = saved_env
    merizo._load_weights_cached.cache_clear()
    res["phase_s"] = time.time() - t_phase
    detail["prep"] = res
    return res["phase_s"]


# The dumps phase: ``cli.predict --npz_dir`` at base 64, bf16.
DUMP_MAP = 96            # voxels an axis: 8 windows of core 48


def rebuild_from_dumps(files, halo: int):
    """A volume from reference-layout dumps: each window's core, cropped to
    the volume by its di/dj/dk, pasted at its i/j/k."""
    vol = None
    for f in files:
        z = np.load(f, allow_pickle=True)
        data, m = z["data"], z["metadata"].item()
        if vol is None:
            vol = np.zeros(data.shape[:-3] + tuple(int(s) for s in m["orig_shape"]), data.dtype)
        i, j, k, di, dj, dk = (m[c] for c in ("i", "j", "k", "di", "dj", "dk"))
        vol[..., i:i + di, j:j + dj, k:k + dk] = data[..., halo:halo + di, halo:halo + dj,
                                                      halo:halo + dk]
    return vol


def dumps_path(torch, args, detail):
    """``predict_map`` and ``cli.predict --npz_dir`` with reference-layout
    dumps on a ``DUMP_MAP``^3 map with empty windows: four files a window,
    the volumes rebuilt from them equal to the returned (and written) ones,
    K9 and K10 once a computed batch."""
    from scipy.ndimage import gaussian_filter

    from mica_tpu_torch.cli import predict as cli_predict
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io.mrc import read_mrc, write_mrc
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.utils.parity import mask_dice_report

    keys = ("backbone_probability", "carbon_alpha_probability", "amino_acid_probability",
            "amino_acid_prediction")
    t_phase, res = time.time(), {}
    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(args.seed + 7))
    n = DUMP_MAP
    vol = np.zeros((n, n, n), np.float32)
    vol[10:70, 12:40, 14:38] = gaussian_filter(
        np.random.default_rng(args.seed).random((60, 28, 24)).astype(np.float32), 1.0)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_mrc(root / "map.mrc", np.transpose(vol, (2, 1, 0)), voxel_size=1.0)
        torch.save(model.state_dict(), root / "ck.pth")

        def check(dump_dir, launches, timing, what):
            computed = timing["n_windows"] - timing["n_empty"]
            batches = -(-computed // BATCH)
            files = sorted(dump_dir.glob("grid_i*_j*_k*_*.npz"))
            fail_if(timing["n_windows"] != 8 or timing["n_empty"] < 1,
                    f"{what}: {timing['n_windows']} windows, {timing['n_empty']} empty")
            fail_if(len(files) != 4 * timing["n_windows"],
                    f"{what}: {len(files)} files for {timing['n_windows']} windows")
            fail_if(launches["gather_windows"] != batches or launches["scatter_cores"] != batches,
                    f"{what}: K9/K10 {launches['gather_windows']}/{launches['scatter_cores']} "
                    f"launches for {batches} batches")
            return {k: rebuild_from_dumps(sorted(dump_dir.glob(f"*_{k}.npz")), 8) for k in keys}

        _reset_counts()
        t0 = time.time()
        out = predict_map(str(root / "map.mrc"), model, batch_size=BATCH, dtype=torch.bfloat16,
                          base_filters=BASE, core=48, halo=8, dump_windows_dir=str(root / "d1"),
                          dump_format="reference")
        wall = time.time() - t0
        launches = _read_counts()
        timing = out["timing"]
        rebuilt = check(root / "d1", launches, timing, "predict_map")
        for k in keys:
            fail_if(not np.array_equal(rebuilt[k], out[k]), f"rebuilt {k} differs from returned")
        report = mask_dice_report(rebuilt, out)
        fail_if(report["min_dice"] != 1.0 or report["amino_acid_agreement"] != 1.0,
                f"Dice report of rebuilt against returned {report}")
        print(f"dumps: predict_map, {n}^3, {timing['n_windows']} windows ({timing['n_empty']} "
              f"empty), {len(list((root / 'd1').iterdir()))} files in {wall:.3f} s; launches "
              f"K9/K10 {launches['gather_windows']}/{launches['scatter_cores']}; rebuilt "
              f"volumes equal the returned ones; Dice report {report}", flush=True)

        _reset_counts()
        t0 = time.time()
        rc = cli_predict.main(["-m", str(root / "map.mrc"), "-o", str(root / "out"),
                               "--npz_dir", str(root / "d2"), "--model_checkpoint",
                               str(root / "ck.pth"), "--batch_size", str(BATCH),
                               "--base_filters", str(BASE)])
        cli_s = time.time() - t0
        cli_launches = _read_counts()
        fail_if(rc != 0, f"cli.predict --npz_dir exited {rc}")
        rebuilt2 = check(root / "d2", cli_launches, timing, "cli.predict")
        for k in ("backbone_probability", "carbon_alpha_probability", "amino_acid_prediction"):
            written = np.transpose(read_mrc(root / "out" / f"{k}.mrc").data, (2, 1, 0))
            fail_if(not np.array_equal(rebuilt2[k].astype(np.float32), written),
                    f"cli.predict: rebuilt {k} differs from the written volume")
        aa_written = np.load(root / "out" / "amino_acid_probability.npz")["data"]
        fail_if(not np.array_equal(rebuilt2["amino_acid_probability"].astype(np.float16),
                                   aa_written), "cli.predict: rebuilt aa differs from written")
        report2 = mask_dice_report(rebuilt2, out)
        try:
            cli_predict.main(["-m", str(root / "map.mrc"), str(root / "map.mrc"), "-o",
                              str(root / "o3"), "--npz_dir", str(root / "d3")])
            refused = False
        except SystemExit as e:
            refused = e.code == 2
        fail_if(not refused or (root / "d3").exists(), "--npz_dir with two maps not refused")
        print(f"dumps: cli.predict --npz_dir: exit {rc} in {cli_s:.3f} s, K9/K10 "
              f"{cli_launches['gather_windows']}/{cli_launches['scatter_cores']}; rebuilt "
              f"volumes equal the written ones; against predict_map's {report2}; two maps "
              "refused", flush=True)
    res.update(timing=timing, launches=launches, wall_s=wall, dice=report, cli_s=cli_s,
               cli_launches=cli_launches, cli_vs_predict_map=report2)
    res["phase_s"] = time.time() - t_phase
    detail["dumps"] = res
    return res["phase_s"]


# The learned phase: the fixture's training (``scripts/train_synth_fixture``:
# base 16, bf16, batch 8, 144^3 scenarios of 170 residues, lr 3e-4) for
# LEARNED_STEPS of its 1200 steps, on LEARNED_SCENARIOS of its 8 scenarios,
# keeping the weights with the best mean validation backbone Dice
# (LEARNED_VAL scenarios, seeds 54321 on, measured every
# LEARNED_SELECT_EVERY steps).  The held-out backbone Dice is that of the
# kept weights, the mean over LEARNED_HELD_OUT 96^3 scenarios (seeds 12345
# on; the JAX script takes the first alone).  The Dice (P > 0.5) of one
# step's weights wanders: on the card it rose from < 0.01 at step 400 to
# 0.08-0.15 at step 600 in four runs of the same code, fell to 0.07-0.09
# over steps 700-900 as the task weights left the backbone, and came back
# to 0.12-0.18 by 1000-1200 (PERF.md); the training is not bitwise
# repeatable (K1's statistics, cuDNN), so no single step is safe.  The
# demo runs on the last step's weights, as the fixture exports them: on
# the kept weights of two runs (steps 950 and 1100) it covered 0.84 and
# 0 of the chain, on the last step's of five runs 0.98-1.00 (PERF.md).
LEARNED_STEPS = 1200
LEARNED_SCENARIOS = 8
LEARNED_HELD_OUT = 4
LEARNED_VAL = 4
LEARNED_SELECT_EVERY = 50
DICE_GAIN_MIN = 0.1         # held-out backbone Dice over the initial weights'
# the demo's CA coverage (< 3 A) on this phase's weights: the floor PERF.md
# records from this phase's first card run (1.000 there; the fixture's
# full run 0.990)
DEMO_COVERAGE_FLOOR = 0.9
# launches at base 16, where K1 takes 5 of the 13 sites (PERF.md): a
# training step (recomputation on) and an inference forward
LEARNED_PER_STEP = {"conv3d_stats": 13, "in_apply_ad": 8, "in_bwd_stats": 5, "in_bwd_apply": 5,
                    "depthwise3": 9, "depthwise3_grads": 3}
LEARNED_PER_FORWARD = {"conv3d_stats": 5, "in_apply": 14, "in_sums": 19, "depthwise3": 3,
                       "stem9": 1}


def batching_ab(torch, fx, trainer, state, ds, batch_iterator, batch: int,
                steps: int = 8) -> dict:
    """ms a step of the fixture's batches gathered on the card against
    ``batch_iterator``'s host batches, which the trainer copies over: runs
    of ``steps`` in turns (host, card, card, host), after the gated
    training."""
    arrays = fx.to_device(ds, trainer.device)
    kinds = {"host": lambda e: batch_iterator(ds, batch, seed=e),
             "card": lambda e: fx.device_batches(arrays, batch, e)}
    lambdas, times = (1.0 / 3,) * 3, {"host": [], "card": []}
    for turn, kind in enumerate(("host", "card", "card", "host")):
        batches = kinds[kind](turn)
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(steps):
            trainer.train_step(state, next(batches), lambdas, 0.01)
        torch.cuda.synchronize()
        times[kind].append(1e3 * (time.time() - t) / steps)
    ms = {k: ", ".join(f"{t:.3f}" for t in v) for k, v in times.items()}
    print(f"  batching in turns ({steps} steps a run): host batches through the trainer "
          f"{ms['host']} ms a step, gathered on the card {ms['card']}", flush=True)
    return times


def learned_path(torch, args, detail):
    """Training data from (map, model) pairs, a base-16 MICA trained on the
    card, its checkpoints through the CLIs and the synthetic demo on its
    weights.  Returns the launch counts of the training run."""
    from mica_tpu_torch.cli import makedata
    from mica_tpu_torch.cli import predict as cli_predict
    from mica_tpu_torch.cli import train as cli_train
    from mica_tpu_torch.infer.engine import postprocess_logits
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.io import mrc as mrc_io
    from mica_tpu_torch.io import pdb as pdb_io
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in
    from mica_tpu_torch.scripts import synthetic_demo as demo
    from mica_tpu_torch.scripts import train_synth_fixture as fx
    from mica_tpu_torch.train.data import ArrayDataset, batch_iterator
    from mica_tpu_torch.train.trainer import Trainer

    base, bf16 = LEARNED_BASE, torch.bfloat16
    fixture = fx.build_parser().parse_args([])
    shape = (fixture.shape,) * 3
    print(f"learned phase: the fixture's training (base {base}, bf16, batch {fixture.batch}, "
          f"{fixture.shape}^3 scenarios of {fixture.n_res} residues, lr {fixture.lr}) for "
          f"{LEARNED_STEPS} of its {fixture.steps} steps on {LEARNED_SCENARIOS} of its "
          f"{fixture.n_scenarios} scenarios", flush=True)
    out, t_phase = {}, time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # data: cli.makedata in this process over the scenarios' (map, model) pairs
        pairs = [fx.write_scenario(seed, shape, fixture.n_res, root / "pairs")
                 for seed in range(LEARNED_SCENARIOS)]
        (root / "pairs.csv").write_text("".join(f"{m},{p}\n" for m, p in pairs))
        t0 = time.time()
        rc = makedata.main(["--pairs", str(root / "pairs.csv"), "--output", str(root / "packed")])
        data_s = time.time() - t0
        fail_if(rc != 0, f"cli.makedata exited {rc}")
        packs = sorted((root / "packed").glob("*.npz"))
        fail_if(len(packs) != LEARNED_SCENARIOS, f"cli.makedata wrote {len(packs)} files")
        ds = fx.concat([ArrayDataset.load(str(p)) for p in packs])
        print(f"  cli.makedata: {len(ds)} windows of 64^3 from {len(packs)} pairs in "
              f"{data_s:.3f} s ({data_s / len(packs):.3f} s a pair)", flush=True)

        # training, launches read over the run alone
        trainer = Trainer(base_filters=base, lr=fixture.lr, dtype=bf16, seed=args.seed)
        state = trainer.init_state()
        held_outs = [fx.held_out(seed=fx.EVAL_SEED + i) for i in range(LEARNED_HELD_OUT)]
        held = held_outs[0]
        val = [fx.held_out(seed=fx.VAL_SEED + i) for i in range(LEARNED_VAL)]
        select = fx.Selection(trainer, base, bf16, "cuda", val, LEARNED_SELECT_EVERY)
        init = fx.evaluate(fx.state_dict_of(trainer), base, bf16, "cuda", held_outs)
        aside = dict.fromkeys(_read_counts(), 0)

        def select_aside(step):
            # the selection's forwards are left out of the training's launches
            before = _read_counts()
            select(step)
            for k, v in _read_counts().items():
                aside[k] += v - before[k]

        _reset_counts()
        res = fx.train(trainer, state, ds, LEARNED_STEPS, fixture.batch, log_every=100,
                       on_step=select_aside)
        counts = {k: v - aside[k] for k, v in _read_counts().items()}
        t0 = time.time()
        select.measure(LEARNED_STEPS)
        kept, val_dice, kept_sd = select.best
        select_s = res["aside_s"] + time.time() - t0
        losses = res["losses"]
        first, last = float(losses[:50].mean()), float(losses[-50:].mean())
        per_step = {k: counts[k] / LEARNED_STEPS for k in TRAIN_KERNELS}
        want = LEARNED_PER_STEP
        print(f"  training: {LEARNED_STEPS} steps ({res['epochs']} epochs), first step "
              f"{res['first_step_s']:.3f} s, then {1e3 * res['step_s']:.3f} ms a step; loss "
              f"{first:.4f} over the first 50 steps, {last:.4f} over the last 50", flush=True)
        print(f"  launches per step {json.dumps(per_step)} (expected {json.dumps(want)})",
              flush=True)
        fail_if(not np.isfinite(losses).all(), "a training loss is not finite")
        fail_if(not last < first, f"the loss did not fall: {first} -> {last}")
        for k, v in want.items():
            fail_if(per_step[k] != v, f"{k}: {per_step[k]} launches a step, expected {v}")
        for k in ("in_apply", "in_sums", "stem9", "gather_windows", "scatter_cores"):
            fail_if(counts[k] != 0, f"training launched the inference-only {k}")
        print(f"  validation backbone Dice, mean of {LEARNED_VAL} 96^3 scenarios (seeds "
              f"{fx.VAL_SEED}-{fx.VAL_SEED + LEARNED_VAL - 1}), by step: "
              + ", ".join(f"{n} {b:.4f}" for n, b in select.curve)
              + f"; kept step {kept} ({val_dice:.4f}); {len(select.curve)} measurements "
              f"in {select_s:.3f} s", flush=True)
        # the gate reads the kept weights; the exported .pth holds the last
        # step's, as the fixture exports them, and the forward check, the
        # CLIs and the demo run on it
        sd = fx.state_dict_of(trainer)
        last_dice = fx.evaluate(sd, base, bf16, "cuda", held_outs)
        trained = fx.evaluate(kept_sd, base, bf16, "cuda", held_outs)
        gain = trained["backbone"] - init["backbone"]
        each = ", ".join(f"{b:.4f}" for b, _ in trained["each"])
        print(f"  held-out Dice, mean of {LEARNED_HELD_OUT} 96^3 scenarios (seeds "
              f"{fx.EVAL_SEED}-{fx.EVAL_SEED + LEARNED_HELD_OUT - 1}), of the kept weights: "
              f"backbone {trained['backbone']:.4f} (each {each}) CA {trained['ca']:.4f}; at "
              f"the initial weights backbone {init['backbone']:.4f} CA {init['ca']:.4f}: gain "
              f"{gain:.4f} (>= {DICE_GAIN_MIN}); the last step's weights backbone "
              f"{last_dice['backbone']:.4f} CA {last_dice['ca']:.4f}", flush=True)
        fail_if(not gain >= DICE_GAIN_MIN, f"held-out backbone Dice gained {gain}")
        batch = next(batch_iterator(ds, fixture.batch, seed=0))
        profile_train_step(torch, trainer, state, batch, detail, key="learned_train_profile")
        batching = batching_ab(torch, fx, trainer, state, ds, batch_iterator, fixture.batch)
        del trainer, state, batch

        # inference at base 16 on the card: launches of one forward, and the
        # same weights in f32 on the CPU
        x = torch.from_numpy(np.stack([held["density"][:32, :32, :32],
                                       held["density"][40:72, 40:72, 40:72]]))[..., None]
        af = torch.from_numpy(np.stack([np.zeros((32, 32, 32, 24), np.float32),
                                        np.moveaxis(held["af3"][:, 40:72, 40:72, 40:72], 0, -1)]))
        card = MICA(base=base, dtype=bf16)
        card.load_state_dict(sd)
        card.cuda().eval()
        cpu = MICA(base=base, dtype=torch.float32)
        cpu.load_state_dict(sd)
        _reset_counts()
        with torch.no_grad():
            got = postprocess_logits(*card(x.cuda(), af.cuda()))
        torch.cuda.synchronize()
        fwd = _read_counts()
        with torch.no_grad():
            ref = postprocess_logits(*cpu(x, af))
        errs = [(g.cpu() - w).abs().max().item() for g, w in zip(got, ref)]
        taken = sum(conv3d_in.k1_takes(cis, co) for cis, co, _ in conv3d_in.k1_sites(base))
        print(f"  inference (2 x 32^3, the last step's weights): launches {json.dumps(fwd)}; "
              f"k1_takes "
              f"accepts {taken} of 13 sites; max |dP| to the f32 CPU bb {errs[0]:.3e} ca "
              f"{errs[1]:.3e} aa {errs[2]:.3e} (tol 0.1)", flush=True)
        for k, v in fwd.items():
            fail_if(v != LEARNED_PER_FORWARD.get(k, 0),
                    f"{k}: {v} launches a forward at base {base}")
        fail_if(max(errs) > 0.1, f"base-{base} card vs CPU differs by {max(errs)}")

        # checkpoints through the CLIs: the exported .pth and a cli.train .pt
        pth = root / "fixture.pth"
        fx.export_pth(pth, sd, res["epochs"], last)
        rc = cli_train.main(["--data_path", str(packs[0]), "--output_path", str(root / "ck"),
                             "--batch_size", "4", "--num_epochs", "1", "--base_filters",
                             str(base), "--log_dir", str(root / "logs"), "--seed", str(args.seed)])
        fail_if(rc != 0, f"cli.train exited {rc}")
        (pt,) = sorted((root / "ck").glob("mica_epoch_0*.pt"))
        held_map = root / "heldout.mrc"
        mrc_io.write_mrc(held_map, np.transpose(held["density"], (2, 1, 0)), voxel_size=1.0)
        ckpt = {"pth": (pth, sd),
                "pt": (pt, torch.load(pt, map_location="cpu", weights_only=True)["model"])}
        for name, (path, weights) in ckpt.items():
            dest = root / f"predict_{name}"
            rc = cli_predict.main(["-m", str(held_map), "-o", str(dest), "--model_checkpoint",
                                   str(path), "--base_filters", str(base)])
            fail_if(rc != 0, f"cli.predict on the {name} exited {rc}")
            bb = mrc_io.read_mrc(dest / "backbone_probability.mrc").to_xyz()[0]
            ref = predict_map(str(held_map), weights, batch_size=8, dtype=bf16,
                              base_filters=base)["backbone_probability"]
            d = float(np.abs(bb - ref).max())
            print(f"  cli.predict --model_checkpoint {path.name}: volumes {bb.shape}, finite, "
                  f"within {d:.3e} of predict_map on the checkpoint's weights (tol 0.05)",
                  flush=True)
            fail_if(bb.shape != held["density"].shape or not np.isfinite(bb).all(),
                    f"cli.predict on the {name}: volume {bb.shape}")
            fail_if(d > 0.05, f"cli.predict on the {name} differs from predict_map by {d}")

        # the demo: cli.run --run_pulchra on this phase's weights
        r = demo.run(demo.build_parser().parse_args(["--model_path", str(pth),
                                                     "--out", str(root / "demo")]))
        atoms = pdb_io.parse_pdb(r["all_atom_model"])
        ca = pdb_io.parse_pdb(r["ca_model"])
        fail_if(len(atoms) == 0 or not np.isfinite(pdb_io.coords(atoms)).all(),
                "the demo's all-atom model is empty or not finite")
        names = {}
        for at in atoms:
            names.setdefault((str(at["chain"]), int(at["res_id"])), set()).add(str(at["name"]))
        fail_if(any(not {"N", "CA", "C", "O"} <= v for v in names.values()),
                "an all-atom residue lacks its backbone")
        print(f"  demo (cli.run --run_pulchra, 96^3, 100 residues): CA model {len(ca)} atoms, "
              f"all-atom model {len(atoms)} atoms in {len(names)} residues; coverage (< 3 A) "
              f"{r['coverage']:.4f} (>= {DEMO_COVERAGE_FLOOR}), median distance "
              f"{r['median']:.4f} A; cli.run wall "
              f"{r['wall_s']:.3f} s, stages {json.dumps(r['stages'])}", flush=True)
        fail_if(not r["coverage"] >= DEMO_COVERAGE_FLOOR,
                f"demo coverage {r['coverage']} < {DEMO_COVERAGE_FLOOR}")
        out = dict(windows=len(ds), makedata_s=data_s, steps=LEARNED_STEPS,
                   scenarios=LEARNED_SCENARIOS, step_ms=1e3 * res["step_s"],
                   first_step_s=res["first_step_s"], loss_first50=first, loss_last50=last,
                   launches_per_step=per_step, dice=trained, init_dice=init,
                   last_step_dice=last_dice, kept_step=kept, val_curve=select.curve,
                   select_s=select_s,
                   forward_launches=fwd, max_abs_dp=errs, demo=r, batching_ms=batching)
    out["phase_s"] = time.time() - t_phase
    print(f"learned phase: {out['phase_s']:.1f} s", flush=True)
    detail["learned"] = out
    return {k: counts[k] for k in TRAIN_KERNELS}


def check_scripts_kernels(torch, g, detail):
    """K11 and K12 in each variant of ``distill_ew_crash`` at its shapes, x
    and dy (64, 64, 512, 128) bf16: K11 bitwise against its plain version,
    K12 within 1e-5 of the sums of the terms' magnitudes (f32 sums in
    another order) and bitwise from call to call, its second pass timed
    alone; K13 bitwise at the layout probe's (8,
    64^3, 256) and its transpose.  Each timed beside its plain version and
    one library call: the eager bf16 expression with in-place ops, a
    ``torch.sum`` of g and g^2 (K12), ``torch.mul(out=)`` (K13)."""
    from mica_tpu_torch.ops import ew_rows, scale
    from mica_tpu_torch.scripts import distill_ew_crash as de
    from mica_tpu_torch.scripts import probe_layout_boundary as probe

    shape = (de.D, de.H, de.R, de.C)
    inputs = {"x": torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16),
              "dy": torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16),
              "ms2": torch.randn(2, de.R, de.C, device="cuda", generator=g),
              "ms3": torch.randn(3, de.R, de.C, device="cuda", generator=g)}
    x, dy = inputs["x"], inputs["dy"]
    numel = x.numel()
    rows11, rows12 = [], []
    for v in de.VARIANTS:
        body, write, h_block = de.SPEC[v]
        args = de.args_of(v, inputs)
        fn = de.build(v, "cuda")
        scratch = list(args)
        if write is not None:
            scratch[write] = args[write].clone()
        if body == "k5":
            got = de.run_variant(v, inputs, "cuda")
            fail_if(not torch.equal(got, de.run_variant(v, inputs, "cuda")),
                    f"K12 {v}: two calls on the same inputs differ")
            torch.cuda.synchronize()
            plan = ew_rows.k12_plan(shape, de.B_SZ)
            blocks = torch.randn((1 + plan["partials"], de.B_SZ, 2, de.C), device="cuda",
                                 generator=g)
            sum_ms = cuda_ms(lambda: ew_rows.sum_partial_blocks(blocks), reps=20)
            del blocks
            want = ew_rows.masked_sq_stats_plain(x, dy)
            mag = ew_rows.masked_sq_stats_plain(x, dy.abs())
            err = (got - want).abs().max().item()
            excess = ((got - want).abs() - 1e-5 * mag).max().item()
            fail_if(not excess <= 1e-3, f"K12 {v}: err {err} beyond 1e-5 of the magnitudes")
            bnd, by = bound_ms(3.0 * numel, 4.0 * numel + 8.0 * de.B_SZ * de.C, PEAK_F32)
            plain = cuda_ms(lambda: ew_rows.masked_sq_stats_plain(x, dy))
            grp = (-1, de.R // de.B_SZ, de.B_SZ, de.C)

            def lib():
                gg = torch.where(x > 0, dy, 0).float()
                return torch.stack([gg.view(grp).sum(dim=(0, 1)),
                                    gg.square().view(grp).sum(dim=(0, 1))], dim=1)

            lib_name, rows = "torch.sum of g and g^2", rows12
            tol = (f"1e-5 of the magnitudes; bitwise equal over two calls; of the time the "
                   f"second pass over {plan['partials']} partials alone {sum_ms:.4f} ms")
        else:
            got = de.run_variant(v, inputs, "cuda")
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            want = ew_rows.rows_ew_plain(x, args[-1], body, dy if body == "k4" else None)
            want = want if isinstance(want, tuple) else (want,)
            fail_if(not all(torch.equal(a, b) for a, b in zip(got, want)),
                    f"K11 {v}: differs from its bf16 plain version")
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            moved = (2 + (body in ("k2", "k4"))) * 2.0 * numel + 4.0 * args[-1].numel()
            bnd, by = bound_ms((2 + (body == "k3")) * float(numel), moved, PEAK_F32)
            plain = cuda_ms(lambda: ew_rows.rows_ew_plain(*((x, args[-1], body, dy) if body == "k4"
                                                             else (x, args[-1], body))))
            t = args[-1].to(torch.bfloat16)
            lib = {"k1": lambda: torch.sub(x, t[0]).mul_(t[1]).relu_(),
                   "k2": lambda: (lambda xh: (torch.relu(xh), xh))(torch.sub(x, t[0]).mul_(t[1])),
                   "k3": lambda: torch.sub(x, t[0]).mul_(t[1]).add_(t[2]),
                   "k4": lambda: torch.where(x > 0, dy, 0).sub_(t[0]).mul_(t[1])}[body]
            lib_name, rows, tol = "eager bf16", rows11, "bitwise"
        ms = cuda_ms(lambda: fn(*scratch), reps=5)
        lib_ms = cuda_ms(lib)
        rows.append(dict(site=v, body=body, h_block=h_block, max_abs_err=err, ms=ms,
                         sum_ms=sum_ms if body == "k5" else None,
                         plain_ms=plain, library_ms=lib_ms, bound_ms=bnd, bound_by=by))
        print(f"{'K12' if body == 'k5' else 'K11'} {v} ({body}{', h_block 8' if h_block else ''}"
              f"{', in place' if write is not None else ''}): max_abs_err {err:.3e} ({tol}); "
              f"time {ms:.4f} ms, plain {plain:.4f} ms, {lib_name} {lib_ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
        del got, want, scratch
    del inputs, x, dy
    torch.cuda.empty_cache()

    y = torch.randn(probe.B, probe.D, probe.H, probe.W, probe.CO, device="cuda",
                    generator=g).to(torch.bfloat16)
    err = 0.0
    # both layouts; then a view that starts 2 bytes past an aligned address
    # (the kernel's element path) and one with a tail of 3 elements
    flat = y.view(-1)
    for label, t in (("(B, D, H, W, C)", y),
                     ("(D, H, W, B, C)", y.permute(1, 2, 3, 0, 4).contiguous()),
                     ("an unaligned start", flat[1:1 + (1 << 24)]),
                     ("a tail of 3", flat[:(1 << 24) + 3])):
        got = scale.scale2(t)
        torch.cuda.synchronize()
        fail_if(not torch.equal(got, scale.scale2_plain(t)), f"K13 on {label}: differs from x * 2")
        err = max(err, (got.float() - 2.0 * t.float()).abs().max().item())
        del got, t
    del flat
    bnd, by = bound_ms(float(y.numel()), 4.0 * y.numel(), PEAK_F32)
    plain = cuda_ms(lambda: scale.scale2_plain(y))
    buf = torch.empty_like(y)
    # in turns with the library call; each the median of 5 runs of 20 (a
    # run's first launch waits for the host, which the wrapper's Python
    # keeps longer than torch.mul's: 20 launches make that wait small)
    turns = [(cuda_ms(lambda: scale.scale2(y), reps=20),
              cuda_ms(lambda: torch.mul(y, 2, out=buf), reps=20)) for _ in range(5)]
    ms, lib_ms = (sorted(t[i] for t in turns)[2] for i in range(2))
    site = "x".join(str(v) for v in y.shape)
    rows13 = [dict(site=site, max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                   bound_ms=bnd, bound_by=by, gbytes_per_s=4.0 * y.numel() / ms / 1e6)]
    print(f"K13 {site} bf16: bitwise equal to x * 2 in both layouts, at an unaligned start "
          f"and with a tail; time {ms:.4f} ms ({100 * bnd / ms:.1f} % of its bound, "
          f"{ms / lib_ms:.4f}x torch.mul) "
          f"({4.0 * y.numel() / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, torch.mul(out=) "
          f"{lib_ms:.4f} ms, bound {bnd:.4f} ms ({by})", flush=True)
    del y, buf
    torch.cuda.empty_cache()
    detail["rows_ew"], detail["masked_sq_stats"], detail["scale2"] = rows11, rows12, rows13
    return rows11, rows12, rows13


def scripts_path(torch, detail):
    """The three ported scripts' ``main`` in this process, nothing caught;
    returns the launch counts of those runs alone."""
    from mica_tpu_torch.scripts import bench_in_apply, distill_ew_crash, probe_layout_boundary

    _reset_counts()
    t0 = time.time()
    codes = {}
    for mod in (distill_ew_crash, bench_in_apply, probe_layout_boundary):
        name = mod.__name__.rsplit(".", 1)[1]
        print(f"--- python -m mica_tpu_torch.scripts.{name}", flush=True)
        codes[name] = mod.main([])
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = _read_counts()
    wall = time.time() - t0
    print(f"scripts: exit codes {json.dumps(codes)} in {wall:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    for name, code in codes.items():
        fail_if(code != 0, f"{name} exited {code}")
    n_k11 = sum(1 for body, _, _ in distill_ew_crash.SPEC.values() if body != "k5")
    fail_if(launches["rows_ew"] != n_k11,
            f"rows_ew: {launches['rows_ew']} launches, expected {n_k11}")
    fail_if(launches["masked_sq_stats"] != 1, "masked_sq_stats: not one launch")
    for k in ("in_apply", "scale2"):
        fail_if(launches[k] == 0, f"the scripts never launched {k}")
    detail["scripts"] = dict(exit_codes=codes, launches=launches, wall_s=wall)
    return launches


# ---------------------------------------------------------------------------
# the multi-GPU phase
# ---------------------------------------------------------------------------

# Gates of the multi-GPU phase, set before its first card run.  World 2
# (gloo, both ranks on one card, 4 windows a rank a batch) against world 1
# (8 windows a batch): the probabilities; the batch composition differs,
# and not every library op gives a sample the same bits at every batch
# size, so not to the bit.  Runs of one batch composition are equal to the
# bit.
MGPU_WORLD2_TOL = 0.05
# the sharded volumes' bytes a rank over the replicated ones'
MGPU_SHARD_BYTES_MAX = 0.55
# the data-parallel f32 step at world 2 against world 1: relative loss,
# cosine of the whole gradient
DP_LOSS_REL = 1e-5
DP_GRAD_COS = 0.9999
DP_BASE, DP_BATCH, DP_WIN = 16, 4, 32
DP_KERNELS = ("conv3d_stats", "depthwise3", "in_apply_ad", "in_bwd_stats", "in_bwd_apply",
              "depthwise3_grads")


def _probs(out) -> tuple:
    return tuple(np.asarray(out[k]) for k in (
        "backbone_probability", "carbon_alpha_probability", "amino_acid_probability"))


def _vol_dist(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _dp_step(torch, sd, seed, **mesh_kw):
    """One f32 base-16 ``Trainer`` step (augmentation, AF3 blanking and the
    epoch-0 dropout on) from the weights ``sd`` on ``synthetic_batch``, with
    cuDNN's deterministic algorithms: (loss, the whole gradient, the
    parameters after the step)."""
    from mica_tpu_torch.models.mica import dropout_rate_for_epoch
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    tr = Trainer(base_filters=DP_BASE, dtype=torch.float32, seed=seed, **mesh_kw)
    state = tr.init_state()
    tr.model.load_state_dict(sd)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        met = tr.train_step(state, synthetic_batch(DP_BATCH, DP_WIN, seed), task_lambdas(0),
                            dropout_rate_for_epoch(0))
    finally:
        torch.backends.cudnn.deterministic = saved
    params = list(tr.model.parameters())
    grads = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).reshape(-1)
                       for p in params]).double().cpu().numpy()
    return (float(met["total_loss"]), grads,
            torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy())


def _mgpu_rank(map_path: str, pdb_path: str, seed: int, workdir: str) -> dict:
    """One rank of the phase's world of 2 (``parallel.dryrun.spawn``): the
    replicated engine through ``predict_map``, the sharded one, the
    replicated one again; the f32 data-parallel step, then a bf16 one with
    its launches."""
    import torch

    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.infer.pipeline import build_af3_encoding, predict_map
    from mica_tpu_torch.models.mica import MICA, dropout_rate_for_epoch
    from mica_tpu_torch.parallel import distributed
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    wd = Path(workdir)
    mesh = distributed.global_mesh()
    model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(seed))
    kw = dict(batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE, core=48, halo=8,
              mesh=mesh)
    rep = SlidingWindowPredictor(model, **kw)
    _reset_counts()
    first = predict_map(map_path, model, docked_pdb_path=pdb_path, predictor=rep)
    launches = _read_counts()
    timing = dict(first["timing"])
    prepared = first["prepared_map"]
    enc = build_af3_encoding(prepared, pdb_path)
    rep_vols = _probs(first)
    del first
    world1 = np.load(wd / "world1.npz")
    world1_err = _vol_dist(rep_vols, tuple(world1[k] for k in ("bb", "ca", "aa")))
    digest = hashlib.sha256(b"".join(v.tobytes() for v in rep_vols)).hexdigest()
    sv = SlidingWindowPredictor(model, shard_volumes=True, **kw)
    shard_err = _vol_dist(_probs(sv.predict_volume(prepared.volume, enc)), rep_vols)
    rep_spread = _vol_dist(_probs(rep.predict_volume(prepared.volume, enc)), rep_vols)
    del rep_vols
    loss, grads, params = _dp_step(torch, torch.load(wd / "dp_init.pt"), seed, mesh=mesh)
    np.savez(wd / f"dp_{mesh.rank}.npz", grads=grads, params=params)
    tr = Trainer(base_filters=DP_BASE, seed=seed, mesh=mesh)
    state = tr.init_state()
    _reset_counts()
    met = tr.train_step(state, synthetic_batch(DP_BATCH, DP_WIN, seed), task_lambdas(0),
                        dropout_rate_for_epoch(0))
    torch.cuda.synchronize()
    bf16_launches = {k: v for k, v in _read_counts().items() if k in DP_KERNELS}
    return dict(rank=mesh.rank, device=str(mesh.device),
                backend=torch.distributed.get_backend(), launches=launches, timing=timing,
                world1_err=world1_err, digest=digest, shard_err=shard_err,
                rep_spread=rep_spread, acc_bytes_rep=rep.timing["acc_bytes_per_device"],
                acc_bytes_shard=sv.timing["acc_bytes_per_device"], dp_f32_loss=loss,
                dp_bf16_loss=float(met["total_loss"]), dp_bf16_launches=bf16_launches)


def multigpu_path(torch, args, detail, smi: str) -> float:
    """The data-parallel paths on the card: NCCL at world size 1 in this
    process (engine and ``Trainer`` against the plain ones), gloo at world
    size 2 with both ranks on ``cuda:0`` (NCCL refuses two ranks on one
    card), then ``dryrun_multigpu(2)``.  Returns the phase's seconds."""
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.infer.pipeline import build_af3_encoding, predict_map
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.parallel import distributed, dryrun
    from mica_tpu_torch.train.trainer import Trainer

    t_phase = time.time()
    res = {}
    kw = dict(batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE, core=48, halo=8)
    with tempfile.TemporaryDirectory() as tmp:
        wd = Path(tmp)
        map_path, pdb_path = synthetic_inputs(wd, args.map_size, args.seed)
        model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(args.seed))

        # one process, no group: two runs of one predictor
        plain = SlidingWindowPredictor(model, **kw)
        first = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path),
                            predictor=plain)
        prepared = first["prepared_map"]
        enc = build_af3_encoding(prepared, str(pdb_path))
        ref = _probs(first)
        del first
        again = _probs(plain.predict_volume(prepared.volume, enc))
        res["single_spread"] = _vol_dist(again, ref)
        res["single_windows_per_s"] = ((plain.timing["n_windows"] - plain.timing["n_empty"])
                                       / plain.timing["inference"])
        fail_if(res["single_spread"] != 0.0, f"two single-process runs differ by "
                                             f"{res['single_spread']:.3e}")
        np.savez(wd / "world1.npz", bb=ref[0], ca=ref[1], aa=ref[2])
        init = Trainer(base_filters=DP_BASE, dtype=torch.float32, seed=args.seed,
                       use_mesh=False)
        init.init_state()
        sd = {k: v.cpu() for k, v in init.model.state_dict().items()}
        torch.save(sd, wd / "dp_init.pt")
        dp_plain = [_dp_step(torch, sd, args.seed, use_mesh=False) for _ in range(2)]

        # NCCL, world size 1, in this process
        distributed.initialize(init_method=f"file://{wd}/nccl_rendezvous", world_size=1,
                               rank=0, backend="nccl", local_rank=0, timeout_seconds=300)
        try:
            mesh = distributed.global_mesh()
            fail_if(str(mesh.device) != "cuda:0" or not mesh.distributed,
                    f"the NCCL world's device is {mesh.device}")
            nccl = SlidingWindowPredictor(model, mesh=mesh, **kw)
            _reset_counts()
            out = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path),
                              predictor=nccl)
            torch.cuda.synchronize()
            launches = _read_counts()
            computed = check_predict_launches(launches, out["timing"])
            res["nccl_err"] = _vol_dist(_probs(out), ref)
            res["nccl_launches"] = launches
            del out
            res["nccl_again_err"] = _vol_dist(_probs(nccl.predict_volume(prepared.volume, enc)),
                                              ref)
            res["nccl_windows_per_s"] = computed / nccl.timing["inference"]
            loss_m, _, params_m = _dp_step(torch, sd, args.seed, mesh=mesh)
        finally:
            torch.distributed.destroy_process_group()
        for key in ("nccl_err", "nccl_again_err"):
            fail_if(res[key] != 0.0, f"NCCL world 1 volumes {res[key]:.3e} from the "
                                     "single-process run's")
        res["plain_step_loss_spread"] = abs(dp_plain[1][0] - dp_plain[0][0])
        res["plain_step_params_spread"] = float(np.abs(dp_plain[1][2] - dp_plain[0][2]).max())
        res["nccl_step_loss_err"] = abs(loss_m - dp_plain[0][0])
        res["nccl_step_params_err"] = float(np.abs(params_m - dp_plain[0][2]).max())
        for what in ("loss", "params"):
            err, spread = res[f"nccl_step_{what}_err"], res[f"plain_step_{what}_spread"]
            fail_if(err > spread, f"NCCL world 1 step: {what} {err:.3e} from the plain "
                                  f"step's, over two plain steps' spread {spread:.3e}")
        print(f"multi-GPU, NCCL world 1 (in this process): {res['nccl_windows_per_s']:.3f} "
              f"windows/s against {res['single_windows_per_s']:.3f} in one process; volumes of "
              f"two runs equal to the bit to a single-process run's (two single-process runs "
              f"equal to the bit too); launches {json.dumps(launches)}; the f32 step "
              f"(cuDNN deterministic) {res['nccl_step_loss_err']:.3e} in loss and "
              f"{res['nccl_step_params_err']:.3e} in parameters from the plain step's (two "
              f"plain steps: {res['plain_step_loss_spread']:.3e}, "
              f"{res['plain_step_params_spread']:.3e})", flush=True)
        del model, ref, again, nccl, plain
        torch.cuda.empty_cache()

        # world size 2: two rank processes
        t0 = time.time()
        ranks = dryrun.spawn("chip_smoke:_mgpu_rank", 2,
                             dict(map_path=str(map_path), pdb_path=str(pdb_path),
                                  seed=args.seed, workdir=str(wd)),
                             timeout=400, group_timeout=300)
        res["world2_s"] = time.time() - t0
        dp = [np.load(wd / f"dp_{r}.npz") for r in range(2)]
        loss1, grads1 = dp_plain[0][0], dp_plain[0][1]
    for r in ranks:
        fail_if(r["world1_err"] > MGPU_WORLD2_TOL,
                f"rank {r['rank']}: world 2 volumes {r['world1_err']:.3e} from world 1's")
        fail_if(r["shard_err"] != 0.0,
                f"rank {r['rank']}: shard_volumes {r['shard_err']:.3e} from the replicated run")
        fail_if(r["rep_spread"] != 0.0,
                f"rank {r['rank']}: two replicated runs differ by {r['rep_spread']:.3e}")
        fail_if(r["acc_bytes_shard"] > MGPU_SHARD_BYTES_MAX * r["acc_bytes_rep"],
                f"rank {r['rank']}: sharded volumes {r['acc_bytes_shard']} bytes against "
                f"{r['acc_bytes_rep']} replicated")
        w = r["timing"]
        batches = -(-(w["n_windows"] - w["n_empty"]) // BATCH)
        fail_if(r["launches"]["scatter_cores"] != batches
                or not 0 < r["launches"]["gather_windows"] <= batches,
                f"rank {r['rank']}: K9/K10 {r['launches']['gather_windows']}/"
                f"{r['launches']['scatter_cores']} launches for {batches} batches")
        fail_if(not math.isfinite(r["dp_bf16_loss"]), f"rank {r['rank']}: bf16 loss not finite")
        for k in DP_KERNELS:
            fail_if(r["dp_bf16_launches"][k] == 0, f"rank {r['rank']}: bf16 step never "
                                                  f"launched {k}")
        rel = abs(r["dp_f32_loss"] - loss1) / abs(loss1)
        r["dp_loss_rel"] = rel
        fail_if(rel > DP_LOSS_REL, f"rank {r['rank']}: world 2 loss {r['dp_f32_loss']} against "
                                   f"world 1's {loss1} ({rel:.2e} relative)")
    fail_if(ranks[0]["digest"] != ranks[1]["digest"], "the ranks' volumes differ")
    g = dp[0]["grads"]
    cos = float(g @ grads1 / (np.linalg.norm(g) * np.linalg.norm(grads1)))
    fail_if(cos < DP_GRAD_COS, f"world 2 gradient at cosine {cos} to world 1's")
    fail_if(not np.array_equal(dp[0]["params"], dp[1]["params"]),
            "the ranks' parameters differ after the step")
    res["dp_grad_cos"] = cos
    res["world2"] = ranks
    t = ranks[0]["timing"]
    res["world2_windows_per_s"] = (t["n_windows"] - t["n_empty"]) / t["inference"]
    res["world2_equals_world1"] = all(r["world1_err"] == 0.0 for r in ranks)
    print(f"multi-GPU, world 2 ({ranks[0]['backend']}, ranks on {ranks[0]['device']} and "
          f"{ranks[1]['device']}; {res['world2_s']:.1f} s): volumes within "
          f"{max(r['world1_err'] for r in ranks):.3e} of world 1's (gate {MGPU_WORLD2_TOL}; "
          f"equal to the bit: {res['world2_equals_world1']}; a rank forwards 4 windows a "
          f"batch, world 1 8), equal on both ranks; shard_volumes and a second replicated "
          f"run equal to the bit to the replicated run; bytes a rank "
          f"{ranks[0]['acc_bytes_shard']} sharded / {ranks[0]['acc_bytes_rep']} replicated "
          f"({ranks[0]['acc_bytes_shard'] / ranks[0]['acc_bytes_rep']:.3f}x); "
          f"{res['world2_windows_per_s']:.3f} windows/s replicated; K9/K10 "
          f"{[(r['launches']['gather_windows'], r['launches']['scatter_cores']) for r in ranks]}",
          flush=True)
    print(f"multi-GPU, data-parallel f32 step at world 2 against world 1 (base {DP_BASE}, "
          f"{DP_BATCH} x {DP_WIN}^3, augmentation, blanking, dropout): loss "
          f"{max(r['dp_loss_rel'] for r in ranks):.2e} relative, gradient cosine {cos:.7f}, "
          f"parameters equal on both ranks; bf16 step losses "
          f"{[r['dp_bf16_loss'] for r in ranks]}, launches "
          f"{[r['dp_bf16_launches'] for r in ranks]}", flush=True)
    t0 = time.time()
    dry = dryrun.dryrun_multigpu(2, timeout=300)
    res["dryrun_s"] = time.time() - t0
    res["dryrun"] = dry
    phase_s = time.time() - t_phase
    res["phase_s"] = phase_s
    detail["multigpu"] = res
    print(f"multi-GPU phase: {phase_s:.1f} s (dry run {res['dryrun_s']:.1f} s; card: {smi})",
          flush=True)
    return phase_s

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

    from mica_tpu_torch.tools import allatom

    def build_allatom():
        t = time.time()
        allatom.ensure_built()
        return time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:      # g++ beside the nvcc builds
        allatom_build = pool.submit(build_allatom)
        per_source = _build.build()
        per_source["mica_allatom (g++)"] = allatom_build.result()
    print(f"build: {time.time() - t0:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items())})",
          flush=True)
    for name in ("conv3d_stats", "depthwise3", "depthwise3_grads", "stem9"):
        for line in ptxas_report(_build.logs.get(name, "")):
            print(f"  {name} ptxas: {line}", flush=True)
    for line in _build.logs.get("stem9", "").splitlines():
        if "wgmma" in line:
            print(f"  stem9 ptxas: {line.strip()}", flush=True)

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
    rows["in_sums"] = check_in_sums(torch, conv3d_in, g, detail)
    rows["depthwise3"] = check_k3(torch, F, depthwise, g, detail)
    rows["in_apply_ad"] = check_k4(torch, conv3d_in, g, detail)
    rows["in_bwd_stats"], rows["in_bwd_apply"] = check_k5_k6(torch, conv3d_in, g, detail)
    rows["depthwise3_grads"] = check_k7(torch, depthwise, g, detail)
    rows["stem9"] = check_k8(torch, F, g, detail)
    learned_errs = check_learned_sites(torch, conv3d_in, depthwise, g, detail)
    rows["gather_windows"], rows["scatter_cores"] = check_k9_k10(torch, g, args.seed, detail)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()
    out.write_text(json.dumps(detail, indent=1))

    predict_launches, model = main_path(torch, args, detail)
    profile_forward(torch, model, args.seed, detail)
    small_reference(torch, model, args.seed, detail)
    out.write_text(json.dumps(detail, indent=1))

    model_launches = modelling_path(torch, args, model, detail)
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

    f32_path(torch, args, detail)
    out.write_text(json.dumps(detail, indent=1))

    prep_s = prep_path(torch, args, detail)
    print(f"prep phase: {prep_s:.1f} s (card: {smi})", flush=True)
    dumps_s = dumps_path(torch, args, detail)
    print(f"dumps phase: {dumps_s:.1f} s (card: {smi})", flush=True)
    torch.cuda.empty_cache()
    out.write_text(json.dumps(detail, indent=1))

    learned_launches = learned_path(torch, args, detail)
    torch.cuda.empty_cache()
    out.write_text(json.dumps(detail, indent=1))

    torch.backends.cudnn.allow_tf32 = False
    rows["rows_ew"], rows["masked_sq_stats"], rows["scale2"] = check_scripts_kernels(
        torch, g, detail)
    torch.backends.cudnn.allow_tf32 = True
    script_launches = scripts_path(torch, detail)
    out.write_text(json.dumps(detail, indent=1))

    multigpu_path(torch, args, detail, smi)
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
                    max_abs_err=max([r["max_abs_err"] for r in rows[name]]
                                    + learned_errs.get(name, [])),
                    ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    bound_by=bound_by, library_ms=tot("library_ms"))

    k1_sites = {f"{cis}->{co}": 1 for cis, co, _ in conv3d_in.k1_sites(BASE)}
    k2_sites = {f"C={c}": n for c, n in in_relu_sites(BASE).items()}
    for cis, co, st in conv3d_in.k1_sites(BASE):
        if st:
            k2_sites[f"C={co}"] = k2_sites.get(f"C={co}", 0) + 1
    pl = predict_launches
    kernels = [
        entry("conv3d_stats", "cuda", "mica_tpu_torch/csrc/conv3d_stats.cu",
              "mica_tpu/ops/wino_pallas.py:309", pl, k1_sites),
        entry("in_apply", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:378", pl, k2_sites),
        # XLA reductions in the JAX package, no Pallas kernel
        entry("in_sums", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/models/mica.py:71,97", pl,
              {f"C={c}": n for c, n in in_sums_sites(BASE).items()}),
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
        # K8: ms per forward; K9, K10: ms per batch; launches of the
        # modelling path's run
        entry("stem9", "cuda", "mica_tpu_torch/csrc/stem9.cu",
              "mica_tpu/ops/stem_pallas.py:91", model_launches,
              {f"{BATCH}x{WIN}x{WIN}x{WIN}": 1}),
        entry("gather_windows", "cuda", "mica_tpu_torch/csrc/window_copy.cu",
              "mica_tpu/ops/window_dma.py:94", model_launches, {"af": 1}),
        entry("scatter_cores", "cuda", "mica_tpu_torch/csrc/window_copy.cu",
              "mica_tpu/ops/window_dma.py:153", model_launches, {"full": 1}),
        # K11-K13: ms per run of the script's variants (one launch each) or
        # per call; launches of the three scripts' runs
        entry("rows_ew", "triton", "mica_tpu_torch/ops/ew_rows.py",
              "scripts/distill_ew_crash.py:56-131", script_launches,
              {r["site"]: 1 for r in rows["rows_ew"]}),
        entry("masked_sq_stats", "triton", "mica_tpu_torch/ops/ew_rows.py",
              "scripts/distill_ew_crash.py:162", script_launches, {"accum3": 1}),
        entry("scale2", "cuda", "mica_tpu_torch/csrc/scale2.cu",
              "scripts/probe_layout_boundary.py:42,57", script_launches,
              {rows["scale2"][0]["site"]: 1}),
    ]
    detail["kernels"] = kernels
    detail["launches"] = {"predict": predict_launches, "model": model_launches,
                          "train": train_launches, "learned": learned_launches,
                          "scripts": script_launches}
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
