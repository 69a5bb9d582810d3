#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--map-size 160]

Phases, each printing what it found; any failure ends the run non-zero:

  1. the card's name and power limit (``nvidia-smi``);
  2. build the CUDA kernels from ``mica_tpu_torch/csrc`` (one ``nvcc`` per
     source, all at once);
  3. hold every kernel against its plain PyTorch version at the main
     path's shapes (batch 8, 64^3 windows, the widths of MICA at
     base 64), in f32 from the same bf16 inputs, and time kernel, plain
     version and one library call (a yardstick the port never calls);
  4. the main path: ``predict_map`` on a synthetic map written to an MRC,
     with a docked model for the AF3 encoding, random weights from
     ``--seed``, bf16, batch 8, core 48 / halo 8; the launch counts of
     that run alone; a profile of one batch forward; then a small window
     batch against the f32 network on the CPU.

The line before the last is the kernels' JSON record, the last line
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


def k1_sites(base: int = BASE):
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
    for cis, co, main_stats in k1_sites():
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
        for counts in (conv3d_in.launches, depthwise.launches):
            for k in counts:
                counts[k] = 0
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
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t and getattr(e, "device_type", None) is not None and "CUDA" in str(e.device_type):
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + t / 1e3
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
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1 = check_k1(torch, F, conv3d_in, g, detail)
    k2 = check_k2(torch, conv3d_in, g, detail)
    k3 = check_k3(torch, F, depthwise, g, detail)
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()

    launches, model = main_path(torch, args, detail)
    profile_forward(torch, model, args.seed, detail)
    small_reference(torch, model, args.seed, detail)

    def entry(name, route, source, replaces, rows, sites):
        """One forward's worth of launches: K1's 13 sites, K2 at the 12
        widths of the RDB/transition outputs, K3 at its three widths."""
        by_site = {r["site"]: r for r in rows}
        sel = [by_site[s] for s in sites]
        tot = lambda k: sum(r[k] for r in sel)
        bound_by = "operations" if all(r["bound_by"] == "operations" for r in sel) else "bytes"
        return dict(name=name, route=route, source=source, replaces=replaces,
                    launches=launches[name], max_abs_err=max(r["max_abs_err"] for r in rows),
                    ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
                    bound_by=bound_by, library_ms=tot("library_ms"))

    k1_site_names = [f"{cis}->{co}" for cis, co, _ in k1_sites()]
    k2_sites = [f"C={co}" for cis, co, st in k1_sites() if st]
    kernels = [
        entry("conv3d_stats", "cuda", "mica_tpu_torch/csrc/conv3d_stats.cu",
              "mica_tpu/ops/wino_pallas.py:309", k1, k1_site_names),
        entry("in_apply", "triton", "mica_tpu_torch/ops/conv3d_in.py",
              "mica_tpu/ops/wino_pallas.py:378", k2, k2_sites),
        entry("depthwise3", "cuda", "mica_tpu_torch/csrc/depthwise3.cu",
              "mica_tpu/ops/depthwise_pallas.py:147", k3, ["C=64", "C=128", "C=256"]),
    ]
    detail["kernels"] = kernels
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
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
