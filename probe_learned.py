#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s learned phase alone, several times, on one card.

    python3 probe_learned.py [--runs 2] [--out build/probe_learned.json]

Builds the kernels, then runs ``chip_smoke.learned_path`` ``--runs``
times in this process (same seed: the training is not bitwise
repeatable, so the runs differ as two ``chip_smoke.py`` runs would).  At
each of the selection's marks it also prints the mean held-out backbone
Dice of the weights it measured beside their validation Dice, so that
the two can be compared mark by mark.  A run that fails a gate is
reported and the next one starts.  Each run's readings go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def held_out_beside(fx, held_outs):
    """``fx.Selection`` that also prints the held-out Dice at each mark."""

    class Selection(fx.Selection):
        def measure(self, step):
            n = len(self.curve)
            super().measure(step)
            if len(self.curve) > n:
                d = fx.evaluate(fx.state_dict_of(self.trainer), self.base, self.dtype,
                                self.device, held_outs)
                print(f"    mark {step}: validation {self.curve[-1][1]:.4f} held-out "
                      f"{d['backbone']:.4f}", flush=True)

    return Selection


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/probe_learned.json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_learned: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mica_tpu_torch.ops import _build
    from mica_tpu_torch.scripts import train_synth_fixture as fx
    from mica_tpu_torch.tools import allatom

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(allatom.ensure_built)
        _build.build()
        built.result()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    held_outs = [fx.held_out(seed=fx.EVAL_SEED + i) for i in range(cs.LEARNED_HELD_OUT)]
    fx.Selection = held_out_beside(fx, held_outs)
    torch.backends.cudnn.allow_tf32 = True    # as chip_smoke.main leaves it there
    out = {}
    for run in range(args.runs):
        detail = {}
        try:
            cs.learned_path(torch, args, detail)
        except cs.Failure as e:
            print(f"run {run}: failed: {e}", flush=True)
        out[run] = detail.get("learned", {})
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, default=str, indent=1))
    print(f"total {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
