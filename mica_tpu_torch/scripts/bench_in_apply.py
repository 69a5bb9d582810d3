"""How far above the device-memory floor is the InstanceNorm apply + ReLU?

Counterpart of ``scripts/bench_in_apply.py``.  For C in 64, 128, 256, 512
at (8, 64, 64, 64, C) bf16 it times, each as a chain of 16 applications
(best of 3, divided by 16):

  * ``eager``: ``torch.clamp_min((x - m) * s, 0)`` in bf16 with m and s
    (B, 1, 1, 1, C) bf16, the counterpart of the TPU script's XLA apply;
  * ``K2``: ``conv3d_in.in_apply`` (Triton, in place) with m and s passed
    as their exact f32 (B, C) values, the counterpart of its Pallas
    ``kernel`` (the same function as ``_in_apply_T``);

against the floor of one read and one write of x at the H100's 3.35e12
B/s, and prints the largest difference between the two.

    python -m mica_tpu_torch.scripts.bench_in_apply [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

import torch

from ..device import resolve_device
from ..ops import conv3d_in

WIDTHS = (64, 128, 256, 512)
B, S = 8, 64
HBM_BYTES_PER_S = 3.35e12


def eager_apply(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The TPU script's ``xla_apply``: max((v - m) * s, 0) in v's dtype."""
    return torch.clamp_min((v - m) * s, 0)


def k2_apply(v: torch.Tensor, m: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The same function through K2 (in place on the card); m and s
    (B, 1, 1, 1, C) are handed over as their f32 (B, C) values."""
    b = v.shape[0]
    return conv3d_in.in_apply(v, m.reshape(b, -1).float(), s.reshape(b, -1).float())


def chain_ms(fn: Callable, x: torch.Tensor, m, s, iters: int = 3, k: int = 16) -> float:
    """ms of one application: the best of ``iters`` chains of ``k``
    applications, v = fn(v, m, s), timed with CUDA events."""
    def chain():
        v = x.clone()
        start.record()
        for _ in range(k):
            v = fn(v, m, s)
        end.record()
        return v

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    chain()
    best = float("inf")
    for _ in range(iters):
        chain()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / k


def inputs(c: int, device):
    """x (B, S^3, c), m, s (B, 1, 1, 1, c), all bf16 standard normals
    drawn on ``device``, seeded by the width."""
    g = torch.Generator(device=device).manual_seed(c)
    return tuple(torch.randn(*shape, device=device, generator=g).to(torch.bfloat16)
                 for shape in ((B, S, S, S, c), (B, 1, 1, 1, c), (B, 1, 1, 1, c)))


def measure(device=None) -> List[dict]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_in_apply times the card: it needs device='cuda'")
    rows = []
    for c in WIDTHS:
        x, m, s = inputs(c, dev)
        d = (eager_apply(x, m, s).float() - k2_apply(x.clone(), m, s).float()).abs().max().item()
        t_eager = chain_ms(eager_apply, x, m, s)
        t_k2 = chain_ms(k2_apply, x, m, s)
        floor = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        rows.append(dict(c=c, eager_ms=t_eager, k2_ms=t_k2, floor_ms=floor, maxdiff=d))
        del x
    return rows


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    for r in measure(dev):
        print(f"C={r['c']:3d}  eager {r['eager_ms']:6.3f} ms   K2 {r['k2_ms']:6.3f} ms   "
              f"floor {r['floor_ms']:5.3f} ms ({r['floor_ms'] / r['k2_ms']:.1%} of K2)   "
              f"maxdiff {r['maxdiff']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
