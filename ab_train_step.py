#!/usr/bin/env python3
"""Compare the port's training step between checkouts, in turns, on one card.

    python3 ab_train_step.py PARENT [CHANGE]

Runs PARENT, CHANGE, CHANGE, PARENT (CHANGE defaults to this checkout),
each in a process of its own that imports ``chip_smoke`` and
``mica_tpu_torch`` from that checkout and builds its kernels there.  A run
first times K4, K5 and K6 alone at each width of a training step (8 x
64^3 bf16) and K8 at 8 x 64^3 and 2 x 33 x 35 x 37 (C 128, the weight
packed by the checkout's own ``MultiScaleInput``), each the mean of 20
launches after a warm-up (``chip_smoke.cuda_ms``); then
``chip_smoke.py``'s training phase (``training_path``: batch 8 x 64^3 at
base 64, bf16, 2 warm-up steps, 5 timed, 8 on a fixed batch), then 3 more
rounds of 5 steps, each timed on the host clock up to a synchronize, then
its profile of one step (``profile_train_step``), device time by kernel.
The card's name and power limit come first: compare checkouts only within
one call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROUNDS, STEPS = 3, 5


def kernel_times(torch, chip_smoke) -> None:
    """K4-K6 and K8 alone, ms per launch, through the checkout's wrappers."""
    from mica_tpu_torch.models.mica import MultiScaleInput
    from mica_tpu_torch.ops import conv3d_in, stem

    g = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    for c in chip_smoke.K56_PER_STEP:
        shape = (chip_smoke.BATCH,) + (chip_smoke.WIN,) * 3 + (c,)
        xh = torch.randn(*shape, device="cuda", generator=g).to(bf)
        dy = torch.randn(*shape, device="cuda", generator=g).to(bf)
        m = torch.rand(shape[0], c, device="cuda", generator=g) * 0.2 - 0.1
        s = torch.rand(shape[0], c, device="cuda", generator=g) + 0.5
        buf = dy.clone()
        k4 = chip_smoke.cuda_ms(lambda: conv3d_in.in_apply_ad(buf, m, s), reps=20)
        k5 = chip_smoke.cuda_ms(lambda: conv3d_in.in_bwd_stats(xh, dy), reps=20)
        k6 = chip_smoke.cuda_ms(lambda: conv3d_in.in_bwd_apply(xh, dy, m, m, s), reps=20)
        print(f"  C={c}: K4 {k4:.4f} ms, K5 {k5:.4f} ms, K6 {k6:.4f} ms", flush=True)
        del xh, dy, buf
    torch.manual_seed(0)
    ms = MultiScaleInput(chip_smoke.BASE).cuda()
    with torch.no_grad():
        packed = ms._packed_stem_weight(bf)
        bias = torch.cat([conv.bias for conv in ms.exp_convs]).float()
        for shape in ((chip_smoke.BATCH,) + (chip_smoke.WIN,) * 3, (2, 33, 35, 37)):
            x = torch.randn(*shape, device="cuda", generator=g).to(bf)
            k8 = chip_smoke.cuda_ms(lambda: stem.stem_conv(x, packed, bias), reps=20)
            print(f"  {'x'.join(map(str, shape))}: K8 {k8:.4f} ms", flush=True)
    torch.cuda.empty_cache()


def one(root: str) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import chip_smoke
    from mica_tpu_torch.models.mica import dropout_rate_for_epoch
    from mica_tpu_torch.ops import _build
    from mica_tpu_torch.train.loss import task_lambdas

    print(f"checkout {root} ({chip_smoke.__file__})", flush=True)
    _build.build()
    kernel_times(torch, chip_smoke)
    detail = {}
    _, trainer, state, batch = chip_smoke.training_path(torch, argparse.Namespace(seed=0),
                                                        detail)
    lambdas, rate = task_lambdas(0), dropout_rate_for_epoch(0)
    for r in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(STEPS):
            trainer.train_step(state, batch, lambdas, rate)
        torch.cuda.synchronize()
        print(f"  round {r + 1}: {(time.time() - t0) / STEPS * 1e3:.3f} ms/step", flush=True)
    chip_smoke.profile_train_step(torch, trainer, state, batch, detail)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.parent)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_train_step: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {smi}", flush=True)
    for root in (args.parent, args.change, args.change, args.parent):
        subprocess.run([sys.executable, __file__, root, "--one"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
