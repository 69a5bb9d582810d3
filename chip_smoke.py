#!/usr/bin/env python3
"""How fast each of the port's hand-written kernels is, on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--out build/chip_smoke.json]

Prints the card and its power limit; builds ``mica_tpu_torch/csrc`` with
K1's, K3's, K7's and K8's ``-Xptxas -v`` report.  Counts each kernel's
launches by site on the main path: ``predict_map`` (bf16, base 64, batch
8, core 48, halo 8, a docked model's AF3 words) on a 160^3 map from
``benchmark.gen``, and a base-64 ``Trainer`` step (batch 8 of 64^3).
Times each kernel at those sites (K9, K10 at that map's frame, K11-K13
at the scripts' shapes): ms a launch, its plan, its bound (operations at
the bf16 tensor-core peak for K1 and K8, the f32 CUDA-core peak for the
rest, or bytes at the HBM rate, whichever is longer), the ms of its plain
version and of a library call, each output held against the plain one's
with the card tests' limits.  Then runs ``pytest -m cuda
tests/test_torch_cuda_paths.py``, every path of the port (~10 minutes).

Exit 1 on an output beyond its limit, counters that disagree with the
count by site, a launched site not timed, a failing path test, or a speed
floor missed: K5 >= 70 % of its bound and K7 >= 50 % at each training
width, K9 >= 50 %, K8 at most 1.2x the real taps' MMAs at 8 x 64^3.  The
last lines: the kernels JSON line (ms, bound, plain and library ms summed
over the launches counted in one forward, training step, batch, script
run or call; the largest error) and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from benchmark import counts

ROOT = Path(__file__).resolve().parent
BASE, BATCH, WIN, MAP = 64, 8, 64, 160
SHAPE = (BATCH, WIN, WIN, WIN)
PEAK_F32 = 67e12        # f32 FLOP/s on the CUDA cores, H100 SXM data sheet


def k1_site(cis, co) -> str:
    return f"{list(cis)}->{co}"


def c_site(x, *_, **__) -> str:
    return f"C={x.shape[-1]}"


# kernel: (module of mica_tpu_torch.ops, its wrapper, a launch's site from the wrapper's arguments)
WRAPPERS = {
    "conv3d_stats": ("conv3d_in", "conv3d",
                     lambda parts, w, *_, **__: k1_site([p.shape[-1] for p in parts], w.shape[0])),
    **{k: ("conv3d_in", k, c_site)
       for k in ("in_apply", "in_sums", "in_apply_ad", "in_bwd_stats", "in_bwd_apply")},
    "depthwise3": ("depthwise", "depthwise_conv3", c_site),
    "depthwise3_grads": ("depthwise", "depthwise_grads", c_site),
    "stem9": ("stem", "stem_conv", lambda x, *_, **__: "x".join(map(str, x.shape[1:]))),
    "gather_windows": ("window_copy", "gather_windows",
                       lambda pm, af, *_, **__: "no_af" if af is None else "af"),
    "scatter_cores": ("window_copy", "scatter_cores",
                      lambda v, cores, st, n, *_, **__: "full" if n == len(cores[0]) else "tail"),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, reps: int = 3) -> float:
    """ms a call of ``reps`` calls enqueued one by one after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = 20) -> float:
    """ms a call of ``reps`` calls replayed from one CUDA graph: the
    device's time for back-to-back launches, not the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay) / reps


def host_ms(torch, fn, reps: int = 200) -> float:
    """ms of host time a call of ``fn`` enqueued ``reps`` times in a row."""
    cuda_ms(torch, fn)              # warm-up, then the queue empty
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def launch_counts() -> dict:
    """Every kernel wrapper's launches so far, by kernel."""
    from mica_tpu_torch.ops import conv3d_in, depthwise, ew_rows, scale, stem, window_copy

    return {k: v for m in (conv3d_in, depthwise, ew_rows, scale, stem, window_copy)
            for k, v in m.launches.items()}


@contextlib.contextmanager
def counted(seen: dict):
    """Within it each wrapper of ``WRAPPERS``, wherever a module of the
    port holds it, adds its calls to ``seen[kernel][site]``; the run fails
    unless these are the launches that the wrappers' counters read."""
    before, patched = launch_counts(), []
    for kernel, (mod, name, site) in WRAPPERS.items():
        orig = getattr(sys.modules[f"mica_tpu_torch.ops.{mod}"], name)

        def rec(*a, _f=orig, _k=kernel, _s=site, **kw):
            by, key = seen.setdefault(_k, {}), _s(*a, **kw)
            by[key] = by.get(key, 0) + 1
            return _f(*a, **kw)

        for m in [m for n, m in list(sys.modules.items())
                  if n.startswith("mica_tpu_torch") and m is not None]:
            for attr in [a for a, v in vars(m).items() if v is orig]:
                setattr(m, attr, rec)
                patched.append((m, attr, orig))
    try:
        yield seen
    finally:
        for m, attr, orig in patched:
            setattr(m, attr, orig)
    ran = {k: v - before[k] for k, v in launch_counts().items()}
    check(all(ran[k] == sum(seen.get(k, {}).values()) for k in WRAPPERS),
          f"launches by site {seen}, by the wrappers' counters {ran}")


def main_path(torch, seed: int) -> dict:
    """{per: {kernel: {site: launches}}} of ``predict_map`` (the map one
    domain, a residue per 1600 voxels, in an empty box) a forward and a
    batch, and of a ``Trainer`` step after a warm-up step."""
    from benchmark import gen
    from mica_tpu_torch.infer.pipeline import predict_map
    from mica_tpu_torch.models.mica import MICA, dropout_rate_for_epoch
    from mica_tpu_torch.train.data import synthetic_batch
    from mica_tpu_torch.train.loss import task_lambdas
    from mica_tpu_torch.train.trainer import Trainer

    traffic = dict(box=MAP, voxel_size=1.0, residues=MAP ** 3 // 1600, domains=[1, 1, 1],
                   envelope=[0.0, 0.0, 0.0], sigma_a=1.5, noise=0.0, masked=False, maps=1)
    pred, step = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        map_path, pdb_path = gen.map_pair(seed, traffic, Path(tmp), "cuda")[0]
        model = MICA(base=BASE).init_weights(torch.Generator().manual_seed(seed))
        with counted(pred):
            t = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path),
                            batch_size=BATCH, dtype=torch.bfloat16, base_filters=BASE,
                            core=48, halo=8)["timing"]
    trainer = Trainer(base_filters=BASE, dtype=torch.bfloat16, seed=seed)
    args = (trainer.init_state(), [torch.as_tensor(b).cuda() for b in
                                   synthetic_batch(BATCH, WIN, seed)],
            task_lambdas(0), dropout_rate_for_epoch(0))
    trainer.train_step(*args)
    with counted(step):
        trainer.train_step(*args)
    del model, trainer, args
    torch.cuda.empty_cache()
    runs = {"forward": (pred, t["n_forwards"]), "training step": (step, 1),
            "batch": (pred, -(-(t["n_windows"] - t["n_empty"]) // BATCH))}
    return {per: {k: {s: n / div for s, n in by.items()} for k, by in seen.items()}
            for per, (seen, div) in runs.items()}


def timed(torch, name, site, kernel, plain, lib, ops, nbytes, *, reps=20, plain_reps=3,
          tol=0.0, mag=None, got=None, want=None, ms=None, walk_ms=None, peak=PEAK_F32,
          extra="", **more) -> dict:
    """A kernel at a site: ms a launch, of its plain version and of
    ``lib`` (or its ms); the bound, ``ops`` at ``peak`` or ``nbytes`` at
    the HBM rate (its share of ``walk_ms`` where given).  The output
    (``got``/``want`` where it works in place) is held against the plain
    one's with the card tests' limits: with ``mag`` |got - want| <=
    tol·mag + 1e-4, else max |got - want| <= tol x max |want|, tol 0 to
    the bit.  Prints the row and ``extra(row)``."""
    ms = cuda_ms(torch, kernel, reps) if ms is None else ms
    bnd = max(ops / peak, nbytes / counts.PEAK_BYTES) * 1e3
    r = dict(site=site, ms=ms, plain_ms=cuda_ms(torch, plain, plain_reps),
             library_ms=lib if isinstance(lib, float) else cuda_ms(torch, lib), bound_ms=bnd,
             bound_by="operations" if ops / peak >= nbytes / counts.PEAK_BYTES else "bytes",
             bound_share=bnd / (walk_ms or ms), **more)
    got, want = kernel() if got is None else got, plain() if want is None else want
    pairs = list(zip(got, want)) if isinstance(got, (tuple, list)) else [(got, want)]
    errs = [(a.float() - b.float()).abs() for a, b in pairs]
    r["max_abs_err"] = max(e.max().item() for e in errs)
    if mag is not None:
        ok = bool((errs[0] <= tol * mag + 1e-4).all())
    elif tol == 0:
        ok = all(a.dtype == b.dtype and a.equal(b) for a, b in pairs)
    else:
        ok = all(e.max().item() <= tol * b.float().abs().max().item()
                 for e, (_, b) in zip(errs, pairs))
    print(f"{name} {site}: {ms:.4f} ms ({100 * r['bound_share']:.1f} % of its bound {bnd:.4f} "
          f"ms, {r['bound_by']}), plain {r['plain_ms']:.3f} ms, library {r['library_ms']:.3f} "
          f"ms, max_abs_err {r['max_abs_err']:.3e}" + (f"; {extra(r)}" if extra else ""),
          flush=True)
    check(ok, f"{name} {site}: {r['max_abs_err']:.3e} from its plain version")
    return r


def ptxas_report(log: str) -> list:
    """One line per kernel of an ``-Xptxas -v`` log: template arguments
    (BN, MT for K1) or the kernel's name, registers, barriers, spills."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(1))
            name = "<" + ", ".join(args) + ">" if args else (
                re.search(r"\d+(\w+?_kernel)", m.group(1)) or m).group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return lines


def time_k1(torch, F, conv3d_in, g) -> tuple:
    """K1 at each forward site (statistics as the forward takes them, the
    second kernel's share timed alone) and at each dx geometry of a
    training step, within 1e-2 of the f32 plain conv's largest value."""
    fwd, dx = [], []
    m = BATCH * WIN ** 3
    sites = [(cis, co, stats, False) for cis, co, stats in conv3d_in.k1_sites(BASE)]
    for cis, co, stats, flip in sites + [([ci], co, False, True)
                                         for ci, co in conv3d_in.k1_dx_sites(BASE)]:
        parts = [torch.randn(*SHAPE, c, device="cuda", generator=g).to(torch.bfloat16)
                 for c in cis]
        ci = sum(cis)
        w = torch.randn(co, ci, 3, 3, 3, device="cuda", generator=g) * math.sqrt(
            2.0 / (27 * (ci + co)))
        if flip:            # the dx form: the forward conv's weight flipped and transposed
            w = w.reshape(ci, co, 3, 3, 3).flip(2, 3, 4).transpose(0, 1)
        b = torch.randn(co, device="cuda", generator=g) * 0.1 if stats else None
        p = conv3d_in.k1_plan(cis, co, SHAPE)
        part = torch.randn(p.partials, device="cuda", generator=g) if stats else None
        sum_ms = cuda_ms(torch, lambda: conv3d_in.sum_partials(part), reps=20) if stats else None
        fparts, wf = [q.float() for q in parts], w.to(torch.bfloat16).float()
        xcat = torch.cat(parts, -1).permute(0, 4, 1, 2, 3)
        wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        bl = None if b is None else b.to(torch.bfloat16)
        ops = 2.0 * m * 27 * ci * co
        (dx if flip else fwd).append(timed(
            torch, "K1 dx" if flip else "K1", k1_site(cis, co),
            lambda: conv3d_in.conv3d(parts, w, b, with_stats=stats)[0],
            lambda: conv3d_in.conv3d_plain(fparts, wf, b, stats)[0],
            lambda: F.conv3d(xcat, wl, bl, padding=1), ops,
            2.0 * m * (ci + co) + 2.0 * w.numel() + (8.0 * BATCH * co if stats else 0),
            reps=3, plain_reps=1, tol=1e-2, peak=counts.PEAK_BF16, sum_ms=sum_ms,
            extra=lambda r: f"{ops / r['ms'] / 1e9:.1f} TFLOP/s, {r['ms'] / r['library_ms']:.3f}"
            "x the library; " + ("" if sum_ms is None else f"of it the second kernel alone "
                                 f"{sum_ms:.4f} ms; ")
            + f"plan BK {p.bk}, BN {p.bn} x {p.n_tiles}, MT {p.mt} (brick "
            f"{'x'.join(map(str, p.brick))}), {p.stages} stages, {p.smem} B shared, "
            f"{p.tiles} tiles on {p.ctas} CTAs"))
        del parts, fparts, xcat
        torch.cuda.empty_cache()
    return fwd, dx


def time_norms(torch, conv3d_in, _build, g, fw, step) -> dict:
    """K2 and ``in_sums`` (and C 16) at the forward's widths, K4-K6 at a
    step's; K2, K4, K6 to the bit,
    ``in_sums`` and K5 within 1e-5 of the terms' magnitudes."""
    out = {k: [] for k in ("in_apply", "in_sums", "in_apply_ad", "in_bwd_stats",
                           "in_bwd_apply")}
    want = {k: {int(s[2:]) for s in (fw if k in ("in_apply", "in_sums") else step).get(k, {})}
            for k in out}
    want["in_sums"].add(16)

    def table(c):
        return torch.rand(BATCH, c, device="cuda", generator=g) * 0.5 + 0.5

    def plan(p, kernels):
        main, summed = next(v[:2] for k, v in kernels.items() if k[0] == p)
        return (f"plan tile {p.block_s} x {p.block_c}, chunk {p.chunk} voxels, {p.programs} "
                f"programs; {main.n_regs} and {summed.n_regs} registers, {main.n_spills} and "
                f"{summed.n_spills} spills")

    for c in sorted(set().union(*want.values())):
        x = torch.randn(*SHAPE, c, device="cuda", generator=g).to(torch.bfloat16)
        n, sms = x.numel(), _build.sm_count(x.device)
        mean, scale = table(c) - 0.75, table(c)
        m16, s16 = (t.to(torch.bfloat16)[:, None, None, None] for t in (mean, scale))
        if c in want["in_apply"]:
            y = x.clone()             # K2 and the library's ops work in place
            out["in_apply"].append(timed(
                torch, "K2", f"C={c}", lambda: conv3d_in.in_apply(y, mean, scale),
                lambda: conv3d_in.in_apply_plain(x, mean, scale),
                lambda: y.sub_(m16).mul_(s16).relu_(), 2.0 * n, 4.0 * n + 8.0 * BATCH * c,
                reps=5, got=conv3d_in.in_apply(x.clone(), mean, scale)))
            del y
        if c in want["in_sums"]:
            out["in_sums"].append(timed(
                torch, "in_sums", f"C={c}", lambda: conv3d_in.in_sums(x),
                lambda: conv3d_in.in_sums_plain(x),
                lambda: torch.stack([x.sum(dim=(1, 2, 3), dtype=torch.float32), torch.linalg.
                                     vector_norm(x, dim=(1, 2, 3), dtype=torch.float32) ** 2], 1),
                3.0 * n, 2.0 * n + 8.0 * BATCH * c, tol=1e-5,
                mag=conv3d_in.in_sums_plain(x.abs()),
                extra=lambda r: plan(conv3d_in.in_sums_plan(x.shape, sms),
                                     conv3d_in.in_sums_kernels)))
        if c in want["in_apply_ad"]:
            buf = x.clone()
            out["in_apply_ad"].append(timed(
                torch, "K4", f"C={c}", lambda: conv3d_in.in_apply_ad(buf, mean, scale),
                lambda: conv3d_in.in_apply_ad_plain(x, mean, scale),
                lambda: torch.relu(torch.sub(x, m16).mul_(s16)), 3.0 * n,
                6.0 * n + 8.0 * BATCH * c, got=conv3d_in.in_apply_ad(x.clone(), mean, scale)))
            del buf
        if c in want["in_bwd_stats"] | want["in_bwd_apply"]:
            dy = torch.randn(*SHAPE, c, device="cuda", generator=g).to(torch.bfloat16)

            def lib5():
                gg = torch.where(x > 0, dy, 0)
                return torch.stack([gg.sum(dim=(1, 2, 3), dtype=torch.float32),
                                    (gg * x).sum(dim=(1, 2, 3), dtype=torch.float32)], 1)

            out["in_bwd_stats"].append(timed(
                torch, "K5", f"C={c}", lambda: conv3d_in.in_bwd_stats(x, dy),
                lambda: conv3d_in.in_bwd_stats_plain(x, dy), lib5, 4.0 * n,
                4.0 * n + 8.0 * BATCH * c, tol=1e-5,
                mag=conv3d_in.in_bwd_stats_plain(x.abs(), dy.abs()),
                extra=lambda r: plan(conv3d_in.k5_plan(x.shape, sms), conv3d_in.k5_kernels)))
            st = conv3d_in.in_bwd_stats(x, dy)
            args = (x, dy, st[:, 0] / WIN ** 3, st[:, 1] / WIN ** 3, scale)
            e = [t.to(torch.bfloat16)[:, None, None, None] for t in args[-1:] + args[2:4]]
            out["in_bwd_apply"].append(timed(
                torch, "K6", f"C={c}", lambda: conv3d_in.in_bwd_apply(*args),
                lambda: conv3d_in.in_bwd_apply_plain(*args),
                lambda: e[0] * (torch.where(x > 0, dy, 0) - e[1] - x * e[2]), 5.0 * n,
                6.0 * n + 12.0 * BATCH * c))
            del dy, args
        del x
        torch.cuda.empty_cache()
    return out


def time_depthwise(torch, F, depthwise, g, fw, step) -> tuple:
    """K3, forward and dx form, at the forward's widths within 1e-2; K7 at
    a step's within 1e-5 of the terms' magnitudes."""
    k3, k3_dx, k7 = [], [], []
    for c in sorted({int(s[2:]) for s in (*fw.get("depthwise3", {}),
                                          *step.get("depthwise3_grads", {}))}):
        x = torch.randn(*SHAPE, c, device="cuda", generator=g).to(torch.bfloat16)
        n = x.numel()
        w = torch.randn(c, 1, 3, 3, 3, device="cuda", generator=g) * 0.2
        b = torch.randn(c, device="cuda", generator=g) * 0.1
        xf, xl = x.float(), x.permute(0, 4, 1, 2, 3)
        p = depthwise.k3_plan(x.shape[:4], c)
        for form, wt, bt, rows in (("forward", w, b, k3),
                                   ("dx", w.flip(2, 3, 4), torch.zeros_like(b), k3_dx)):
            wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            bl = bt.to(torch.bfloat16)
            rows.append(timed(
                torch, f"K3 {form}", f"C={c}", lambda: depthwise.depthwise_conv3(x, wt, bt),
                lambda: depthwise.depthwise_conv3_plain(xf, wt, bt),
                lambda: F.conv3d(xl, wl, bl, padding=1, groups=c), 2.0 * 27 * n,
                4.0 * n + 4.0 * 28 * c, plain_reps=1, tol=1e-2,
                extra=lambda r: f"plan TY {p.ty}, TX {p.tx}, CG {p.cg}, z segments of {p.seg}, "
                f"{p.blocks} blocks, {p.smem} B shared"))
        gr = torch.randn(*SHAPE, c, device="cuda", generator=g).to(torch.bfloat16)
        gl = gr.permute(0, 4, 1, 2, 3)
        p7 = depthwise.k7_plan(x.shape[:4], c)
        k7.append(timed(
            torch, "K7", f"C={c}", lambda: depthwise.depthwise_grads(x, gr),
            lambda: depthwise.depthwise_grads_plain(x, gr),
            lambda: (torch.nn.grad.conv3d_weight(xl, (c, 1, 3, 3, 3), gl, padding=1, groups=c),
                     gr.sum(dim=(0, 1, 2, 3), dtype=torch.float32)),
            2.0 * 28 * n, 4.0 * n + 4.0 * 28 * c, plain_reps=1, tol=1e-5,
            mag=depthwise.depthwise_grads_plain(x.abs(), gr.abs()),
            extra=lambda r: f"plan TY {p7.ty}, TX {p7.tx}, CG {p7.cg}, z segments of {p7.seg}, "
            f"{p7.blocks} blocks, {p7.smem} B shared, {p7.rows} x 28 x {c} f32 partials"))
        del x, xf, xl, gr, gl
        torch.cuda.empty_cache()
    return k3, k3_dx, k7


def time_stem(torch, F, g) -> list:
    """K8 at the main path's shape (gated at <= 1.2x the real taps' MMAs)
    and an odd one, within 1e-2, against the library conv it replaced in
    TF32: the space-to-depth form at even sizes, else the 9^3."""
    from mica_tpu_torch.models.mica import _fold_kernel_s2d, _fold_s2d, _unfold_s2d
    from mica_tpu_torch.ops import _build, stem

    c, rows = 2 * BASE, []
    for shape in (SHAPE, (2, 33, 35, 37)):
        x = torch.randn(*shape, device="cuda", generator=g).to(torch.bfloat16)
        ws = [torch.randn(c // 4, 1, k, k, k, device="cuda", generator=g) * k ** -1.5
              for k in stem.KS]
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        packed = stem.pack_weight(ws, torch.bfloat16)
        # the function's operations: each c/4-channel conv's k^3 taps a
        # voxel; the kernel issues its padded taps for every voxel of a tile
        plan = stem.k8_plan(shape, c, _build.sm_count(x.device))
        m = x.numel()
        ops = 2.0 * m * sum(w.shape[0] * w.shape[-1] ** 3 for w in ws)
        xin = x.float()[:, None]
        w9 = stem.combine_weights(stem.unpack_weight(packed, c)).float()
        if all(v % 2 == 0 for v in shape[1:]):
            wf = _fold_kernel_s2d(w9)
            conv = lambda: _unfold_s2d(F.conv3d(_fold_s2d(xin), wf, padding=2))  # noqa: E731
        else:
            conv = lambda: F.conv3d(xin, w9, padding=4)  # noqa: E731
        torch.backends.cudnn.allow_tf32 = True
        lib = cuda_ms(torch, lambda: (conv().permute(0, 2, 3, 4, 1) + bias).to(torch.bfloat16))
        torch.backends.cudnn.allow_tf32 = False
        rows.append(timed(
            torch, "K8", "x".join(map(str, shape[1:])), lambda: stem.stem_conv(x, packed, bias),
            lambda: stem.stem_conv_plain(x, packed, bias), lib, ops,
            2.0 * m + 2.0 * m * c + 2.0 * packed.numel() + 4.0 * c, plain_reps=1, tol=1e-2,
            peak=counts.PEAK_BF16, batch=shape[0], mma_ratio=plan.mma_ratio,
            extra=lambda r: f"batch {shape[0]}, {ops / r['ms'] / 1e9:.1f} TFLOP/s of the "
            f"function's, {plan.mma_ratio:.3f}x the real taps' MMAs; plan NG {plan.ng} x "
            f"{plan.passes} passes, {plan.n_tiles} tiles on {plan.ctas} CTAs, {plan.smem} B "
            "shared"))
        del x, xin
        torch.cuda.empty_cache()
    check(rows[0]["mma_ratio"] <= 1.2, f"K8 {rows[0]['site']}: {rows[0]['mma_ratio']:.3f}x the "
                                       "real taps' MMAs")
    return rows


def time_windows(torch, g, seed) -> tuple:
    """K9 and K10 at the engine's geometry on a 160^3 map (volumes 192^3,
    the padded map 208^3), n 8, w 64, c 48, A 20, to the bit.  K9's bound
    share on a CUDA graph of 20 launches walking the frame's 8 batches
    (from device memory, not the L2 cache); beside it
    the eager time and the host's to enqueue a call (median of 4).  K10
    with all 8 cores and with a tail of 3 skipped."""
    from mica_tpu_torch.ops import window_copy as wc

    n, w, c, a, per_axis = BATCH, WIN, 48, 20, 4
    vol, ext = per_axis * c, per_axis * c + (w - c)
    rng = np.random.default_rng(seed + 4)
    grid = c * np.stack(np.meshgrid(*[np.arange(per_axis)] * 3, indexing="ij"), -1).reshape(-1, 3)
    starts = grid[rng.choice(len(grid), n, replace=False)]
    host = [tuple(r) for r in starts.tolist()]
    pm = torch.rand((ext,) * 3, device="cuda", generator=g)
    pa = torch.randint(0, 2 ** 24, (ext,) * 3, device="cuda", generator=g, dtype=torch.int32)
    walk = wc.starts_tensor(grid[rng.permutation(len(grid))], pm.shape, w, "cuda")
    batches = [walk[k:k + n] for k in range(0, len(grid), n)]
    st = wc.starts_tensor(starts, pm.shape, w, "cuda")
    wide = sum(ext % 4 == 0 and w % 4 == 0 and z % 4 == 0 for _, _, z in host)
    rows9 = []
    for af, srcs in ((pa, (pm, pa)), (None, (pm,))):
        it = iter(batches * 3)
        walk_ms = graph_ms(torch, lambda: wc.gather_windows(pm, af, next(it), w))
        hosts = [host_ms(torch, lambda: wc.gather_windows(pm, af, st, w)) for _ in range(4)]
        rows9.append(timed(
            torch, "K9", "af" if af is not None else "no_af",
            lambda: wc.gather_windows(pm, af, st, w),
            lambda: wc.gather_windows_plain(pm, af, st, w),
            lambda: [torch.stack([s[x:x + w, y:y + w, z:z + w] for x, y, z in host])
                     for s in srcs], 0.0, 2.0 * 4 * n * w ** 3 * len(srcs) + 12.0 * n,
            plain_reps=5, walk_ms=walk_ms, graph_walk_ms=walk_ms,
            host_ms=float(np.median(hosts)), host_readings=hosts,
            extra=lambda r: f"eager; device time (a CUDA graph's replay of 20 launches) "
            f"{walk_ms:.4f} ms walking the frame; host ms to enqueue a call {r['host_ms']:.4f} "
            f"(median of 4); the word kernel, {wide} of {n} windows in 16-byte words"))

    vols = (torch.rand((vol,) * 3, device="cuda", generator=g),
            torch.rand((vol,) * 3, device="cuda", generator=g),
            torch.rand((vol,) * 3 + (a,), device="cuda", generator=g))
    cores = (torch.rand((n, c, c, c), device="cuda", generator=g),
             torch.rand((n, c, c, c), device="cuda", generator=g),
             torch.rand((n, c, c, c, a), device="cuda", generator=g))
    st = wc.starts_tensor(starts, vols[0].shape, c, "cuda")
    rows10 = []
    for site, n_valid in (("full", n), ("tail", n - 3)):
        def lib_paste():
            for i, (x, y, z) in enumerate(host[:n_valid]):
                for v, blk in zip(vols, cores):
                    v[x:x + c, y:y + c, z:z + c] = blk[i]

        def pasted(fn):
            out = tuple(v.clone() for v in vols)
            fn(out, cores, st, n_valid, c)
            return out

        rows10.append(timed(
            torch, "K10", site, lambda: wc.scatter_cores(vols, cores, st, n_valid, c),
            lambda: wc.scatter_cores_plain(vols, cores, st, n_valid, c), lib_paste, 0.0,
            2.0 * 4 * n_valid * c ** 3 * (2 + a) + 12.0 * n_valid, plain_reps=5,
            got=pasted(wc.scatter_cores), want=pasted(wc.scatter_cores_plain),
            extra=lambda r: f"{n_valid} of {n} cores"))
    del pm, pa, vols, cores
    torch.cuda.empty_cache()
    return rows9, rows10


def time_scripts(torch, g, launched) -> tuple:
    """K11 and K12 (its second pass alone beside it) in each variant of
    ``distill_ew_crash``, x and dy (64, 64, 512, 128) bf16; K13 at the
    layout probe's (8, 64^3, 256) in turns with ``torch.mul(out=)``
    (medians of 5 runs of 20: a run's first launch waits for the host).
    K11, K13 to the bit, K12 within 1e-5 of the terms' magnitudes; the
    launches of a variant's run and of the probe's call into ``launched``."""
    from mica_tpu_torch.ops import ew_rows, scale
    from mica_tpu_torch.scripts import distill_ew_crash as de
    from mica_tpu_torch.scripts import probe_layout_boundary as probe

    shape = (de.D, de.H, de.R, de.C)
    inputs = de.make_inputs("cuda")
    x, dy = inputs["x"], inputs["dy"]
    numel = x.numel()
    rows11, rows12 = [], []
    runs = launched["script run"] = {"rows_ew": {}, "masked_sq_stats": {}}
    for v in de.VARIANTS:
        body, write, h_block = de.SPEC[v]
        args = list(de.args_of(v, inputs))
        if write is not None:
            args[write] = args[write].clone()
        fn = de.build(v, "cuda")
        kernel = "masked_sq_stats" if body == "k5" else "rows_ew"
        before = launch_counts()
        got = de.run_variant(v, inputs, "cuda")
        runs[kernel][v] = launch_counts()[kernel] - before[kernel]
        if body == "k5":
            grp = (-1, de.R // de.B_SZ, de.B_SZ, de.C)
            blocks = torch.randn((1 + ew_rows.k12_plan(shape, de.B_SZ)["partials"], de.B_SZ, 2,
                                  de.C), device="cuda", generator=g)
            sum_ms = cuda_ms(torch, lambda: ew_rows.sum_partial_blocks(blocks), reps=20)
            gg = lambda: torch.where(x > 0, dy, 0).float().view(grp)  # noqa: E731
            rows12.append(timed(
                torch, "K12", v, lambda: fn(*args), lambda: ew_rows.masked_sq_stats_plain(x, dy),
                lambda: torch.stack([gg().sum(dim=(0, 1)), gg().square().sum(dim=(0, 1))], 1),
                3.0 * numel, 4.0 * numel + 8.0 * de.B_SZ * de.C, reps=5, tol=1e-5,
                mag=ew_rows.masked_sq_stats_plain(x, dy.abs()), got=got, sum_ms=sum_ms,
                extra=lambda r: f"of it the second pass alone {sum_ms:.4f} ms"))
            del blocks
            continue
        t = args[-1].to(torch.bfloat16)
        lib = {"k1": lambda: torch.sub(x, t[0]).mul_(t[1]).relu_(),
               "k2": lambda: (lambda xh: (torch.relu(xh), xh))(torch.sub(x, t[0]).mul_(t[1])),
               "k3": lambda: torch.sub(x, t[0]).mul_(t[1]).add_(t[2]),
               "k4": lambda: torch.where(x > 0, dy, 0).sub_(t[0]).mul_(t[1])}[body]
        plain_args = (x, args[-1], body, dy) if body == "k4" else (x, args[-1], body)
        rows11.append(timed(
            torch, "K11", v, lambda: fn(*args), lambda: ew_rows.rows_ew_plain(*plain_args), lib,
            (2 + (body == "k3")) * float(numel),
            (2 + (body in ("k2", "k4"))) * 2.0 * numel + 4.0 * args[-1].numel(), reps=5,
            got=got, body=body, h_block=h_block,
            extra=lambda r: f"body {body}{', h_block 8' if h_block else ''}"
            f"{', in place' if write is not None else ''}"))
    del inputs, x, dy
    torch.cuda.empty_cache()

    y = torch.randn(probe.B, probe.D, probe.H, probe.W, probe.CO, device="cuda",
                    generator=g).to(torch.bfloat16)
    buf = torch.empty_like(y)
    turns = [(cuda_ms(torch, lambda: scale.scale2(y), reps=20),
              cuda_ms(torch, lambda: torch.mul(y, 2, out=buf), reps=20)) for _ in range(5)]
    ms, lib_ms = (sorted(t[i] for t in turns)[2] for i in range(2))
    site = "x".join(str(v) for v in y.shape)
    before = launch_counts()
    got = scale.scale2(y)
    launched["call"] = {"scale2": {site: launch_counts()["scale2"] - before["scale2"]}}
    rows13 = [timed(torch, "K13", site, lambda: scale.scale2(y), lambda: scale.scale2_plain(y),
                    lib_ms, float(y.numel()), 4.0 * y.numel(), ms=ms, got=got,
                    extra=lambda r: f"{ms / lib_ms:.4f}x torch.mul")]
    del y, buf
    torch.cuda.empty_cache()
    return rows11, rows12, rows13


def entry(rows, name, route, source, replaces, per, sites) -> dict:
    """A kernel's line of the table: ms, plain, library and bound summed
    over ``sites`` ({site: launches in one ``per``}, as a run counted
    them), and the largest error of its timed sites."""
    by_site = {r["site"]: r for r in rows}
    check(set(sites) <= set(by_site), f"{name}: launched at {set(sites) - set(by_site)}, "
                                      "which were not timed")
    tot = lambda k: sum(by_site[s][k] * n for s, n in sites.items())  # noqa: E731
    bound_by = ("operations" if all(by_site[s]["bound_by"] == "operations" for s in sites)
                else "bytes")
    return dict(name=name, route=route, source=source, replaces=replaces, per=per,
                launches=sum(sites.values()), ms=tot("ms"), plain_ms=tot("plain_ms"),
                bound_ms=tot("bound_ms"), bound_by=bound_by, library_ms=tot("library_ms"),
                max_abs_err=max((by_site[s]["max_abs_err"] for s in sites), default=None))


# name, route, file under mica_tpu_torch/, what it replaces (in_sums: XLA
# reductions, no Pallas kernel), the run its launches are counted in
KERNELS = [line.split(maxsplit=4) for line in """
conv3d_stats cuda csrc/conv3d_stats.cu mica_tpu/ops/wino_pallas.py:309 forward
in_apply triton ops/conv3d_in.py mica_tpu/ops/wino_pallas.py:378 forward
in_sums triton ops/conv3d_in.py mica_tpu/models/mica.py:71,97 forward
depthwise3 cuda csrc/depthwise3.cu mica_tpu/ops/depthwise_pallas.py:147 forward
in_apply_ad triton ops/conv3d_in.py mica_tpu/ops/wino_pallas.py:493 training step
in_bwd_stats triton ops/conv3d_in.py mica_tpu/ops/wino_pallas.py:546 training step
in_bwd_apply triton ops/conv3d_in.py mica_tpu/ops/wino_pallas.py:582 training step
depthwise3_grads cuda csrc/depthwise3_grads.cu mica_tpu/ops/depthwise_pallas.py:233 training step
stem9 cuda csrc/stem9.cu mica_tpu/ops/stem_pallas.py:91 forward
gather_windows cuda csrc/window_copy.cu mica_tpu/ops/window_dma.py:94 batch
scatter_cores cuda csrc/window_copy.cu mica_tpu/ops/window_dma.py:153 batch
rows_ew triton ops/ew_rows.py scripts/distill_ew_crash.py:56-131 script run
masked_sq_stats triton ops/ew_rows.py scripts/distill_ew_crash.py:162 script run
scale2 cuda csrc/scale2.cu scripts/probe_layout_boundary.py:42,57 call
""".strip().splitlines()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
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
    print(f"build: {time.time() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in per_source.items()) + ")", flush=True)
    for name in ("conv3d_stats", "depthwise3", "depthwise3_grads", "stem9"):
        for line in ptxas_report(_build.logs.get(name, "")):
            print(f"  {name} ptxas: {line}", flush=True)
    for line in _build.logs.get("stem9", "").splitlines():
        if "wgmma" in line:
            print(f"  stem9 ptxas: {line.strip()}", flush=True)

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    launched = main_path(torch, args.seed)
    print(f"main path launches: {json.dumps(launched)}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    fw, step = launched["forward"], launched["training step"]
    rows = {}
    rows["conv3d_stats"], rows["conv3d_stats_dx"] = time_k1(torch, F, conv3d_in, g)
    rows.update(time_norms(torch, conv3d_in, _build, g, fw, step))
    rows["depthwise3"], rows["depthwise3_dx"], rows["depthwise3_grads"] = time_depthwise(
        torch, F, depthwise, g, fw, step)
    rows["stem9"] = time_stem(torch, F, g)
    rows["gather_windows"], rows["scatter_cores"] = time_windows(torch, g, args.seed)
    rows["rows_ew"], rows["masked_sq_stats"], rows["scale2"] = time_scripts(torch, g, launched)
    for name, least in (("in_bwd_stats", 0.7), ("depthwise3_grads", 0.5), ("gather_windows", 0.5)):
        for r in rows[name]:        # the speed floors
            check(r["bound_share"] >= least, f"{name} {r['site']}: {100 * r['bound_share']:.1f} "
                                             f"% of its bound, short of {100 * least:.0f} %")
    kernels = [entry(rows[name], name, route, f"mica_tpu_torch/{src}", replaces, per,
                     launched[per].get(name, {}))
               for name, route, src, replaces, per in KERNELS]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, build_s=per_source, launched=launched, rows=rows,
                                   kernels=kernels), indent=1))
    torch.cuda.empty_cache()
    print("the port's paths end to end (tests/test_torch_cuda_paths.py):", flush=True)
    rc = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                         "-p", "no:cacheprovider", "tests/test_torch_cuda_paths.py"],
                        cwd=ROOT).returncode
    check(rc == 0, f"tests/test_torch_cuda_paths.py exited {rc}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
