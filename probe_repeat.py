#!/usr/bin/env python3
"""How far two runs of the same bf16 computation differ on the card.

    python3 probe_repeat.py [--runs 6] [--seed 0] [--map-size 160]

K1 (``csrc/conv3d_stats.cu``) four times on the same inputs (8 x 64^3,
64 -> 64 channels): whether its output and its InstanceNorm statistics
come back to the bit.  Then the engine at base 64, bf16, batch 8 on
``chip_smoke.py``'s synthetic map, ``--runs`` times: the first run
through ``predict_map``, then through the same predictor, the last two through
a second one, with the largest distance between each pair of runs and the
number of values that differ.  ``chip_smoke.py``'s multi-GPU phase bounds
runs that should be equal by this spread.  Needs the card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=6, help="engine runs (>= 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--map-size", type=int, default=160)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_repeat: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.infer.pipeline import build_af3_encoding, predict_map
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.ops import conv3d_in

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    x = torch.randn(8, 64, 64, 64, 64, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(64, 64, 3, 3, 3, device="cuda", generator=g) * 0.05
    bias = torch.zeros(64, device="cuda")
    k1 = [conv3d_in.conv3d([x], w, bias, with_stats=True) for _ in range(4)]
    for i in range(1, 4):
        print(f"K1 call {i + 1} against call 1: output equal "
              f"{torch.equal(k1[0][0], k1[i][0])}, statistics equal "
              f"{torch.equal(k1[0][1], k1[i][1])} (largest difference "
              f"{float((k1[0][1] - k1[i][1]).abs().max()):.4g}, largest value "
              f"{float(k1[0][1].abs().max()):.4g})", flush=True)
    del x, k1

    kw = dict(batch_size=cs.BATCH, dtype=torch.bfloat16, base_filters=cs.BASE, core=48,
              halo=8)
    with tempfile.TemporaryDirectory() as tmp:
        map_path, pdb_path = cs.synthetic_inputs(Path(tmp), args.map_size, args.seed)
        model = MICA(base=cs.BASE).init_weights(torch.Generator().manual_seed(args.seed))
        first = predict_map(str(map_path), model, docked_pdb_path=str(pdb_path), **kw)
        pred, prepared = first["predictor"], first["prepared_map"]
        enc = build_af3_encoding(prepared, str(pdb_path))
        runs = [("predictor 1, call 1", cs._probs(first))]
        del first
        for i in range(2, args.runs - 1):
            runs.append((f"predictor 1, call {i}",
                         cs._probs(pred.predict_volume(prepared.volume, enc))))
        second = SlidingWindowPredictor(model, **kw)
        for i in (1, 2):
            runs.append((f"predictor 2, call {i}",
                         cs._probs(second.predict_volume(prepared.volume, enc))))
        computed = pred.timing["n_windows"] - pred.timing["n_empty"]
        core_values = 48 ** 3 * 22
        print(f"engine runs on a {args.map_size}^3 map, {computed} computed windows "
              f"({core_values} values a window's core): largest distance / values that "
              f"differ", flush=True)
        for name_a, a in runs:
            cells = []
            for _, b in runs:
                d = [np.abs(u - v) for u, v in zip(a, b)]
                cells.append(f"{max(float(t.max()) for t in d):.3e}/"
                             f"{sum(int((t > 0).sum()) for t in d)}")
            print(f"  {name_a:<22s} " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
