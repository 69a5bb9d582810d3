"""What does a layout change around a hand-written kernel cost on the card?

Counterpart of ``scripts/probe_layout_boundary.py``, which asked whether
transposes around a Pallas call fold into XLA's layouts.  Between two
library 3x3x3 SAME convs on channels-last bf16 tensors, (B, D, H, W) =
(8, 64, 64, 64) and 256 channels in and out, it runs:

  f_direct      conv -> K13 ``scale2`` on (B, D, H, W, C) -> conv
  f_transposed  conv -> (D, H, W, B, C) made contiguous -> K13 -> back to
                (B, D, H, W, C), made contiguous -> conv
  f_noop        conv -> eager ``y * 2`` -> conv

and prints max |direct - transposed| (0, or the run fails), each
function's time (the three timed in turns, the best of 3 rounds of 5
calls), both boundary taxes (time minus f_noop's), and, in place
of the TPU script's count of transposes in XLA's HLO dump, the device
kernels of one call of each function by kind (copy or transpose, conv,
K13, other) from ``torch.profiler`` traces.

    python -m mica_tpu_torch.scripts.probe_layout_boundary [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.scale import scale2

B, D, H, W = 8, 64, 64, 64
CI, CO = 256, 256


def weight_from_dhwio(k: torch.Tensor) -> torch.Tensor:
    """A (3, 3, 3, Ci, Co) kernel as the library conv's (Co, Ci, 3, 3, 3)
    weight in the channels-last layout, made once outside the timed calls."""
    return k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)


def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3x3 SAME conv of (B, D, H, W, Ci) with ``weight_from_dhwio``'s
    weight: (B, D, H, W, Co), on the card contiguous (the library's
    channels-last output seen through a permute)."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)


def f_direct(x, w1, w2):
    return conv(scale2(conv(x, w1)), w2)


def f_transposed(x, w1, w2):
    yt = conv(x, w1).permute(1, 2, 3, 0, 4).contiguous()
    z = scale2(yt).permute(3, 0, 1, 2, 4).contiguous()
    return conv(z, w2)


def f_noop(x, w1, w2):
    return conv(conv(x, w1) * 2, w2)


FUNCTIONS = {"f_direct": f_direct, "f_transposed": f_transposed, "f_noop": f_noop}


def inputs(device):
    """x (B, D, H, W, CI) bf16 standard normal and the two convs' weights
    (normal, scaled by 1/sqrt(27 Ci) so the activations stay O(1)), seeded
    with 0, as ``weight_from_dhwio`` gives them."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(B, D, H, W, CI, device=device, generator=g).to(torch.bfloat16)
    ks = [torch.randn(3, 3, 3, ci, CO, device=device, generator=g) / (27 * ci) ** 0.5
          for ci in (CI, CO)]
    return x, *(weight_from_dhwio(k.to(torch.bfloat16)) for k in ks)


def kind_of(kernel: str) -> str:
    """The kind of a device kernel, by its name."""
    name = kernel.lower()
    if "scale2" in name:
        return "K13"
    if "memset" in name:
        return "other"
    if any(p in name for p in ("copy", "transpose", "memcpy", "nchwtonhwc", "nhwctonchw")):
        return "copy or transpose"
    if any(p in name for p in ("conv", "fprop", "xmma", "cutlass", "implicit", "cudnn", "sm90")):
        return "conv"
    return "other"


def _session(fn: Callable, *args) -> Dict[str, dict]:
    """{kind: {count, ms, names}} of the device kernels that one
    ``torch.profiler`` session of one call of ``fn`` saw."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kinds: Dict[str, dict] = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        k = kinds.setdefault(kind_of(e.key), {"count": 0, "ms": 0.0, "names": []})
        k["count"] += e.count
        k["ms"] += t / 1e3
        k["names"].append(e.key[:80])
    return kinds


def kernels_of(fns: Dict[str, Callable], *args, rounds: int = 3) -> Dict[str, Dict[str, dict]]:
    """The device kernels of one call of each function, by kind: a
    profiler session per call, ``rounds`` rounds with the functions in
    turns, and for each kind the most that one session saw.  (The
    profiler may drop records, never add them.  Run alone the script counts
    in full; run inside a long process that profiled other work first, as
    ``chip_smoke.py`` does, torch 2.11 on an H100 lost some or all of a
    session's records.)"""
    best: Dict[str, Dict[str, dict]] = {name: {} for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            for kind, v in _session(fn, *args).items():
                if v["count"] > best[name].get(kind, {"count": -1})["count"]:
                    best[name][kind] = v
    return best


def times_ms(fns: Dict[str, Callable], *args, n: int = 5, rounds: int = 3) -> Dict[str, float]:
    """ms per call of each function: ``rounds`` rounds in which each runs
    ``n`` calls in turn (CUDA events), the best round of each; one call of
    each warms up first."""
    for fn in fns.values():
        fn(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = {name: float("inf") for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            start.record()
            for _ in range(n):
                fn(*args)
            end.record()
            torch.cuda.synchronize()
            best[name] = min(best[name], start.elapsed_time(end) / n)
    return best


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("probe_layout_boundary times the card: it needs device='cuda'")
    x, w1, w2 = inputs(dev)
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    err = (f_direct(x, w1, w2).float() - f_transposed(x, w1, w2).float()).abs().max().item()
    print("max |direct - transposed| =", err, flush=True)
    ms = times_ms(FUNCTIONS, x, w1, w2)
    print(f"noop (eager y * 2)       : {ms['f_noop']:8.3f} ms", flush=True)
    for name, label in (("f_direct", "K13 direct  (B,...)"),
                        ("f_transposed", "K13 transposed (D..)")):
        print(f"{label:25s}: {ms[name]:8.3f} ms  (boundary tax "
              f"{ms[name] - ms['f_noop']:+.3f})", flush=True)
    for name, kinds in kernels_of(FUNCTIONS, x, w1, w2).items():
        if not kinds:
            print(f"kernels of {name}: not measured (the profiler saw no device kernel)")
            continue
        print(f"kernels of {name}: " + ", ".join(
            f"{k} {v['count']} ({v['ms']:.3f} ms)" for k, v in sorted(kinds.items())), flush=True)
        for k, v in sorted(kinds.items()):
            print(f"  {k}: {'; '.join(v['names'])}", flush=True)
    return 0 if err == 0.0 else 1


if __name__ == "__main__":
    sys.exit(main())
