"""Build and launch each single-feature variant of the elementwise kernels.

Counterpart of ``scripts/distill_ew_crash.py``, which bisected a TPU
compiler crash over ten variants of one elementwise kernel.  Here each
variant is a launch of K11 ``rows_ew`` or K12 ``masked_sq_stats``
(``ops/ew_rows.py``) at the TPU script's shapes, x and dy (D, H, R, C) =
(64, 64, 512, 128) bf16 and (k, R, C) f32 tables:

  base        k1 written into x                  noalias   k1, new output
  twoout      k2 (relu(x̂), x̂), new outputs       twoout_al k2, relu(x̂) into x
  ms3         k3 with a (3, R, C) table          twoin     k4 (x, dy), new output
  twoin_al    k4 written into dy                 twoin_hblk k4, (C/128, D, H/8) grid
  hblk        k1, (C/128, D, H/8) grid           accum3    K12 (8, 2, C) sums

    python -m mica_tpu_torch.scripts.distill_ew_crash [variant ...] [--device cuda|cpu]

prints ``<variant> OK  build+first launch <s>s`` or ``<variant> CRASH
...`` per variant and exits 1 if any variant crashed.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import ew_rows

D, H, R, C = 64, 64, 512, 128
B_SZ = 8
H_BLOCK = 8
# variant -> (body, the argument written in place or None, h_block); the
# bodies are the TPU script's k1-k5, k5 being K12
SPEC = {"base": ("k1", 0, 0), "noalias": ("k1", None, 0), "twoout": ("k2", None, 0),
        "twoout_al": ("k2", 0, 0), "ms3": ("k3", None, 0), "twoin": ("k4", None, 0),
        "twoin_al": ("k4", 1, 0), "twoin_hblk": ("k4", None, H_BLOCK),
        "hblk": ("k1", None, H_BLOCK), "accum3": ("k5", None, 0)}
VARIANTS = tuple(SPEC)
# the inputs of each variant, as the TPU script passes them
ARGS = {"ms3": ("x", "ms3"), "twoin": ("x", "dy", "ms2"), "twoin_al": ("x", "dy", "ms2"),
        "twoin_hblk": ("x", "dy", "ms2"), "accum3": ("x", "dy")}


def make_inputs(device=None, d: int = D, h: int = H, r: int = R,
                c: int = C) -> Dict[str, torch.Tensor]:
    """x, ms2, ms3, dy from ``numpy.random.default_rng(0)`` in the TPU
    script's order: standard normals rounded to f32, then to bf16 for x
    and dy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    def draw(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dtype)

    x = draw((d, h, r, c), torch.bfloat16)
    ms2 = draw((2, r, c), torch.float32)
    ms3 = draw((3, r, c), torch.float32)
    dy = draw((d, h, r, c), torch.bfloat16)
    return {"x": x, "ms2": ms2, "ms3": ms3, "dy": dy}


def args_of(variant: str, inputs: Dict[str, torch.Tensor]) -> tuple:
    return tuple(inputs[k] for k in ARGS.get(variant, ("x", "ms2")))


def build(variant: str, device=None, b_sz: int = B_SZ) -> Callable:
    """The variant as a callable on the TPU script's arguments (``ARGS``).
    Its inputs must lie on ``device`` (the card unless told otherwise), so
    a CPU tensor never takes the plain version when the card was asked."""
    if variant not in SPEC:
        raise ValueError(f"unknown variant {variant!r}; one of {', '.join(VARIANTS)}")
    dev = resolve_device(device)
    body, write, h_block = SPEC[variant]

    def call(*args):
        for a in args:
            if a.device.type != dev.type:
                raise ValueError(f"{variant}: an input lies on {a.device}, not on {dev}")
        if body == "k5":
            return ew_rows.masked_sq_stats(*args, b_sz=b_sz)
        x, table = args[0], args[-1]
        return ew_rows.rows_ew(x, table, body, dy=args[1] if body == "k4" else None,
                               out=None if write is None else args[write], h_block=h_block)

    return call


def run_variant(variant: str, inputs: Dict[str, torch.Tensor], device=None):
    """One build and launch, the argument it writes cloned first so the
    shared inputs stay as drawn.  Returns the outputs."""
    args = list(args_of(variant, inputs))
    write = SPEC[variant][1]
    if write is not None:
        args[write] = args[write].clone()
    return build(variant, device)(*args)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help=f"any of {', '.join(VARIANTS)} (default: all)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.variants) - set(VARIANTS))
    if unknown:
        ap.error(f"unknown variants {unknown}")
    dev = resolve_device(args.device)
    inputs = make_inputs(dev)
    crashed = 0
    for v in args.variants or VARIANTS:
        # a variant that fails is reported and counted, never retried
        # another way: the exit code says that one crashed
        try:
            t0 = time.time()
            out = run_variant(v, inputs, dev)
            leaf = out[0] if isinstance(out, tuple) else out
            float(leaf.reshape(-1)[0])     # reads back: the launch has finished
            print(f"{v:10s} OK  build+first launch {time.time() - t0:.1f}s", flush=True)
        except Exception as e:  # noqa: BLE001
            crashed += 1
            print(f"{v:10s} CRASH {type(e).__name__}: {str(e)[:120]}", flush=True)
            traceback.print_exc()
    return 1 if crashed else 0


if __name__ == "__main__":
    sys.exit(main())
