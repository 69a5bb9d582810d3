#!/usr/bin/env python3
"""How far two runs of the same bf16 computation differ on the card.

    python3 probe_repeat.py [--runs 6] [--seed 0] [--map-size 160]

K1 (``csrc/conv3d_stats.cu``) four times on the same inputs (8 x 64^3,
64 -> 64 channels): whether its output and its InstanceNorm statistics
come back to the bit, and whether sample 0's come back at batch 1.  Then
the engine at base 64, bf16, batch 8 on ``chip_smoke.py``'s synthetic
map, ``--runs`` times: the first run through ``predict_map``, then through
the same predictor, the last two through a second one, with the largest
distance between each pair of runs and the number of values that differ
(one state: every distance 0).  Last, the network on windows split as
the engine splits a batch over two ranks (8 -> 4 + 4, 3 -> 2 + 1): every
aten op's output for a part's windows is fingerprinted (an exact integer
sum of its bits per window) and held against the whole batch's, and the
first op that differs is named with its module: the op that is not
batch-invariant.  Then the same windows in two rank processes of a world
of 2 on this card, as ``chip_smoke.py``'s world-2 engine runs them, held
against this process's.  Needs the card.
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
    one = conv3d_in.conv3d([x[:1]], w, bias, with_stats=True)
    print(f"K1 sample 0 at batch 1 against batch 8: output equal "
          f"{torch.equal(one[0], k1[0][0][:1])}, statistics equal "
          f"{torch.equal(one[1], k1[0][1][:1])}", flush=True)
    del x, k1, one

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
        states = len({tuple(hash(v.tobytes()) for v in r) for _, r in runs})
        print(f"  {states} state(s) over {len(runs)} runs", flush=True)
        batch_invariance(torch, second.model, args.seed)
        across_processes(torch, second.model, args.seed)
    return 0


def fingerprints(torch, model, x, af) -> list:
    """(module, op, per-window fingerprint) of every aten op in one forward
    of ``x``, ``af``, in the order they run; the fingerprint is an exact
    integer sum of the output's bits per window, or None where the output
    does not have the windows as its first axis or is an allocation
    (``empty``: the hand-written kernels fill it afterwards, and the next
    op that reads it shows what they wrote)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    n, stack, prints = len(x), ["MICA"], []
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            res = func(*args, **(kwargs or {}))
            t = res[0] if isinstance(res, (tuple, list)) else res
            fp = None
            if (isinstance(t, torch.Tensor) and t.is_cuda and t.dim() > 0 and t.shape[0] == n
                    and "empty" not in str(func)):
                bits = t.detach().contiguous().view(n, -1).view(ints[t.element_size()])
                fp = bits.long().sum(dim=1).tolist()
            prints.append((stack[-1], str(func), fp))
            return res

    def enter(name):
        def hook(_mod, _inp):
            stack.append(name or "MICA")
        return hook

    def leave(_mod, _inp, _out):
        stack.pop()        # returns None: the output is left as it is

    handles = []
    for name, m in model.named_modules():
        handles.append(m.register_forward_pre_hook(enter(name)))
        handles.append(m.register_forward_hook(leave))
    try:
        with torch.no_grad(), Record():
            model(x, af)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    return prints


def _windows(torch, seed: int):
    """8 random 64^3 windows with AF channels, the same in every process."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.rand(8, 64, 64, 64, 1, device="cuda", generator=g)
    af = (torch.rand(8, 64, 64, 64, 24, device="cuda", generator=g) < 0.03).float()
    return x, af


def _first_difference(got: list, ref: list, start: int, n: int):
    """(ops that differ, "module: op" of the first) of ``got``'s windows
    against windows ``start`` .. ``start + n - 1`` of ``ref``, the two
    forwards' ops paired in order."""
    if [tuple(g[:2]) for g in got] != [tuple(r[:2]) for r in ref]:
        return None, "the two forwards ran different ops"
    differ = [f"{g[0]}: {g[1]}" for g, r in zip(got, ref)
              if g[2] is not None and r[2] is not None and g[2] != r[2][start:start + n]]
    return len(differ), differ[0] if differ else None


def batch_invariance(torch, model, seed: int) -> None:
    """The network (bf16, the engine's cast) on random windows with AF
    channels, split as the engine splits a batch over two ranks (8 -> 4 +
    4, the last batch of 3 -> 2 + 1): for each part, the first op whose
    output for its windows differs from the whole batch's."""
    x, af = _windows(torch, seed)
    for whole, parts in ((8, ((0, 4), (4, 4))), (3, ((0, 2), (2, 1)))):
        ref = fingerprints(torch, model, x[:whole], af[:whole])
        for start, n in parts:
            got = fingerprints(torch, model, x[start:start + n], af[start:start + n])
            count, first = _first_difference(got, ref, start, n)
            print(f"windows {start}-{start + n - 1} at batch {n} against batch {whole}: "
                  f"{len(got)} ops fingerprinted, {count} differ; the first that differs: "
                  f"{first}", flush=True)


def _rank_prints(seed: int) -> dict:
    """One rank of a world of 2 (``parallel.dryrun.spawn``, both ranks on
    the card at once, as ``chip_smoke.py``'s world-2 engine runs them): the
    fingerprints of all 8 windows, then of its 4 of them at batch 4."""
    import torch

    from mica_tpu_torch.infer.engine import SlidingWindowPredictor
    from mica_tpu_torch.models.mica import MICA
    from mica_tpu_torch.parallel import distributed

    import chip_smoke as cs

    mesh = distributed.global_mesh()
    model = SlidingWindowPredictor(
        MICA(base=cs.BASE).init_weights(torch.Generator().manual_seed(seed)),
        batch_size=cs.BATCH, dtype=torch.bfloat16, base_filters=cs.BASE, core=48, halo=8,
        mesh=mesh).model
    x, af = _windows(torch, seed)
    r = mesh.rank
    # a process's first forward also packs the stem's weight, so its ops do
    # not pair with a later forward's: one forward first, unrecorded
    with torch.no_grad():
        model(x[:1], af[:1])
    whole = fingerprints(torch, model, x, af)
    part = fingerprints(torch, model, x[4 * r:4 * r + 4], af[4 * r:4 * r + 4])
    return {"rank": r, "part": part, "whole": whole}


def across_processes(torch, model, seed: int) -> None:
    """The same windows in two rank processes of a world of 2 on this card:
    each rank's 4 windows at batch 4, and all 8 at batch 8, against this
    process's batch of 8; names the first op that differs."""
    from mica_tpu_torch.parallel import dryrun

    x, af = _windows(torch, seed)
    ref = fingerprints(torch, model, x, af)
    for res in dryrun.spawn("probe_repeat:_rank_prints", 2, dict(seed=seed), timeout=400,
                            group_timeout=300):
        r = res["rank"]
        for what, got, start, n in (("its 4 windows at batch 4", res["part"], 4 * r, 4),
                                    ("all 8 at batch 8", res["whole"], 0, 8)):
            count, first = _first_difference(got, ref, start, n)
            print(f"rank {r} of a world of 2, {what}, against this process's batch of 8: "
                  f"{count} of {len(got)} ops differ; the first that differs: {first}",
                  flush=True)


if __name__ == "__main__":
    sys.exit(main())
