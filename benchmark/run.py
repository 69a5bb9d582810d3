"""Run one cell of the benchmark once, on the card of the machine it is
started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each compared number beside its limit); the same numbers close standard
error.  Exits non-zero with no result where there is no CUDA device or
fewer than the cell asks for, or where ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded once the window has closed.

``--control fp8`` (and, for training, ``half_batch`` or ``frozen``) runs
the reference, in lower precision or with a fault planted, in the
program's place and prints the numbers it reads: the readings the limits
are set above.  Builds and kernel caches stay in ``build/`` of this
checkout; the maps go to a temporary directory under ``TMPDIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Triton reads its cache directory when it is first imported
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
# the checkout's root, not this directory, heads the path: the harness's
# modules must not shadow the standard library's
sys.path[0] = str(ROOT)

from benchmark import harness  # noqa: E402


def chips_for(workload: str) -> int:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next((int(w["chips"]) for w in spec["workloads"] if w["name"] == workload), 1)


def main(argv=None) -> int:
    started = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", default=None)
    args = ap.parse_args(argv)

    import torch

    need = chips_for(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: this cell needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="mica-bench-") as tmp:
        if args.control:
            w, cfg, tr = harness.cell(args.workload)
            drv = harness.driver_class(tr["driver"])(cfg, tr, args.seed, torch.device("cuda"),
                                                     Path(tmp))
            numbers = drv.control(args.control)
            print(json.dumps({"control": args.control, "workload": args.workload,
                              "seed": args.seed, "numbers": numbers,
                              "detail": getattr(drv, "detail", None)}), flush=True)
            return 0
        result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", Path(tmp), started=started)
    banned = harness.banned_modules()
    if banned:
        print(f"no result: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("records " + json.dumps(info["records"]), file=sys.stderr)
    if info["detail"]:
        print("worst leaves " + json.dumps(info["detail"]), file=sys.stderr)
    print("readings " + json.dumps(info["numbers"]), file=sys.stderr)
    for name, (value, limit) in info["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
