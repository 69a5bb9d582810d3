"""A look at the training check's leaves, on the card: where the program's
first steps part from the reference's, leaf by leaf and element by element.

    python3 benchmark/looks/train_leaves.py --seeds 101 102 ... \\
        [--half-batch 4] [--fp8 2] --out <file.jsonl>

For each seed the train cell's set-up runs the program's first steps and
keeps each step's gradients as Adam received them; the reference works
the same steps out again.  Per leaf it prints the reference gradient's
norm and per-element RMS over the median leaf's, the gaps of norms the
check reads, and, for each step, the share of elements whose gradient
sign the two sides share, binned by |g| over the leaf's RMS, with the
rows (first axis) whose gradient is all zero on one side only.  The
first ``--half-batch`` seeds also read the half-batch fault and the first
``--fp8`` seeds the fp8 control, in the reference put in the program's
place, leaf by leaf as well.  One JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402
from benchmark.reference import mica as ref  # noqa: E402

EDGES = (0.0, 1e-3, 1e-2, 1e-1, 1.0, float("inf"))
WORKLOAD = "train-b8-af3"


def _sign_bins(gp: torch.Tensor, gr: torch.Tensor):
    """[[share of the leaf's elements, share of them whose signs agree], ...]
    over the bins of |g_ref| / RMS(g_ref)."""
    rms = gr.pow(2).mean().sqrt().clamp(min=1e-38)
    r = (gr.abs() / rms).flatten()
    agree = (torch.sign(gp) == torch.sign(gr)).flatten()
    out = []
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        sel = (r >= lo) & (r < hi)
        n = int(sel.sum())
        out.append([round(n / r.numel(), 5),
                    round(float(agree[sel].float().mean()), 5) if n else None])
    return out


def _zero_rows(gp: torch.Tensor, gr: torch.Tensor):
    """Rows whose gradient is all zero in the program only, in the
    reference only."""
    if gp.dim() < 2:
        return [0, 0]
    zp = (gp.flatten(1) == 0).all(1)
    zr = (gr.flatten(1) == 0).all(1)
    return [int((zp & ~zr).sum()), int((zr & ~zp).sum())]


def _update_bins(up: torch.Tensor, ur: torch.Tensor, g1: torch.Tensor):
    """The change's squared norm on each side, by the bin of the first
    step's |g_ref| / RMS: which elements make the gap of norms."""
    rms = g1.pow(2).mean().sqrt().clamp(min=1e-38)
    r = (g1.abs() / rms).flatten()
    up2, ur2 = up.flatten().pow(2), ur.flatten().pow(2)
    out = []
    for lo, hi in zip(EDGES[:-1], EDGES[1:]):
        sel = (r >= lo) & (r < hi)
        out.append([float(up2[sel].sum()), float(ur2[sel].sum())])
    return out


def leaf_table(got, want):
    """One row a leaf: name, elements, reference gradient norm / median
    norm, its RMS / median RMS, the gradient's and the change's norms
    (program, reference), the norm of the first gradient's difference, the
    gaps (each over max(its reference norm, the median's), as the check
    reads them), then per step the sign bins and the one-sided zero rows,
    and the change's squared norms by bin."""
    g_ref = want["grad_norms"]
    keys = list(g_ref)
    sizes = want["sizes"]
    med_norm = float(np.median([g_ref[k] for k in keys]))
    rms = {k: g_ref[k] / sizes[k] ** 0.5 for k in keys}
    med_rms = float(np.median(list(rms.values())))
    med_up = float(np.median([want["update_norms"][k] for k in keys]))
    rows = []
    for k in keys:
        gp = [g[k] for g in got["grads"]]
        gr = [g[k] for g in want["grads"]]
        rows.append({
            "leaf": k, "n": sizes[k],
            "norm_ratio": g_ref[k] / med_norm, "rms_ratio": rms[k] / med_rms,
            "g": [got["grad_norms"][k], g_ref[k]],
            "u": [got["update_norms"][k], want["update_norms"][k]],
            "d": got["grad_diff"][k],
            "grad_gap": abs(got["grad_norms"][k] - g_ref[k]) / max(g_ref[k], med_norm),
            "update_gap": abs(got["update_norms"][k] - want["update_norms"][k])
            / max(want["update_norms"][k], med_up),
            "signs": [_sign_bins(a, b) for a, b in zip(gp, gr)],
            "zero_rows": [_zero_rows(a, b) for a, b in zip(gp, gr)],
            "update_bins": _update_bins(got["updates"][k], want["updates"][k], gr[0]),
        })
    return rows


def _norms(d):
    """What the check keeps of a side: losses, norms, sizes, differences."""
    return {k: d[k] for k in ("losses", "grad_norms", "update_norms", "sizes", "grad_diff")
            if k in d}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--half-batch", type=int, default=0)
    ap.add_argument("--fp8", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    w, cfg, tr = harness.cell(WORKLOAD)
    dev = torch.device("cuda")
    out = open(args.out, "a")

    def emit(**row):
        out.write(json.dumps(row) + "\n")
        out.flush()
        brief = {k: v for k, v in row.items() if k not in ("leaves",)}
        print(json.dumps(brief), flush=True)

    with tempfile.TemporaryDirectory(prefix="mica-look-") as tmp:
        for i, seed in enumerate(args.seeds):
            drv = harness.driver_class(tr["driver"])(cfg, tr, seed, dev, Path(tmp))
            drv.setup(keep_grads=True)
            drv.release()
            want = drv.reference(keep_grads=True)
            got = drv.judged(drv.got, want)
            emit(seed=seed, side="program", clipped=got["clipped"],
                 numbers=compare.train_numbers(_norms(got), _norms(want)),
                 leaves=leaf_table(got, want))
            del got
            drv.got = None
            gc.collect()
            torch.cuda.empty_cache()
            for mode, n, kw in (("half_batch", args.half_batch, {"half_batch": True}),
                                ("fp8", args.fp8, {"q": ref.fp8})):
                if i < n:
                    ctl = drv.judged(drv.reference(keep_grads=True, **kw), want)
                    emit(seed=seed, side=mode,
                         numbers=compare.train_numbers(_norms(ctl), _norms(want)),
                         leaves=leaf_table(ctl, want))
                    del ctl
                    gc.collect()
                    torch.cuda.empty_cache()
            del want, drv
            gc.collect()
            torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
