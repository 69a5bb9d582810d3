"""Run one cell once: set up, measure the window, trace it where asked,
free the program, check its outputs against the reference, and assemble
the result line.

Everything a cell is, the harness finds by name: ``workloads/<cell>.json``
names a configuration (``configs/<name>.json``), a traffic mix
(``traffic/<name>.json``, whose ``driver`` names ``drivers/<driver>.py``)
and the limits of the check; each metric ``BENCHMARK.json`` lists for the
cell is ``metrics/<name>.py``, whose ``read(run)`` returns a number, or
None where it finds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import devtrace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "mica_tpu")


def load(kind: str, name: str) -> Dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def cell(name: str) -> Tuple[Dict, Dict, Dict]:
    """(the cell's file, its configuration, its traffic)."""
    w = load("workloads", name)
    return w, load("configs", w["config"]), load("traffic", w["traffic"])


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(kind: str):
    return _module(BENCH / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}").Driver


def metric_reader(name: str):
    return _module(BENCH / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_")).read


def metric_specs(workload: str, trace: bool) -> List[Dict]:
    """The metrics ``BENCHMARK.json`` gives this cell: end-to-end ones, or
    with ``trace`` the per-layer ones."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that no run may load, compared
    whole (``mica_tpu_torch`` is not ``mica_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def process_start() -> float:
    """The epoch time this process started (Linux), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        import os
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Run:
    """What the metrics read."""

    kind: str
    cfg: Dict
    traffic: Dict
    driver: object
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_window_bytes: int = 0
    profile: Optional[devtrace.Profile] = None


def spans_off(name):
    return contextlib.nullcontext()


def spans_on(name):
    return torch.profiler.record_function(name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _launch_counters():
    from mica_tpu_torch.ops import conv3d_in

    return (conv3d_in.launches,)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             workdir: Optional[Path] = None, overrides: Optional[Dict] = None,
             started: Optional[float] = None) -> Tuple[Dict, Dict[str, Tuple]]:
    """One run of ``workload``: (the result line's object, the compared
    numbers with their limits).  ``overrides``: {"config": {...},
    "traffic": {...}, "limits": {...}} merged over the files (tests use
    small sizes on the CPU)."""
    started = time.time() if started is None else started
    w, cfg, tr = cell(workload)
    ov = overrides or {}
    cfg, tr = {**cfg, **ov.get("config", {})}, {**tr, **ov.get("traffic", {})}
    limits = {**w["limits"], **ov.get("limits", {})}
    dev = torch.device(device)
    drv = driver_class(tr["driver"])(cfg, tr, seed, dev, Path(workdir))
    run = Run(drv.kind, cfg, tr, drv)

    drv.setup()
    _sync(dev)
    run.setup_s = time.time() - started
    setup_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv.run_window(seconds, spans_off)
    run.window_s = drv.window_s
    if dev.type == "cuda":
        run.peak_window_bytes = torch.cuda.max_memory_allocated()
    if trace and dev.type == "cuda":
        got: list = []
        with devtrace.traced(got, _launch_counters()):
            drv.trace_body(spans_on)
        run.profile = got[0]

    metrics = {}
    for m in metric_specs(workload, trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    drv.release()
    numbers = drv.check()
    checks = {k: (v, limits[k]) for k, v in numbers.items() if k in limits}
    correct = all(v <= lim for v, lim in checks.values()) and len(checks) == len(limits)
    result = {
        "correct": bool(correct),
        "attempted": int(drv.attempted()),
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, run.peak_window_bytes))},
    }
    if run.profile is not None:
        result["device"]["busy_s"] = run.profile.busy_s
        result["device"]["window_s"] = run.profile.window_s
        result["breakdown"] = devtrace.breakdown(run.profile)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, {"numbers": numbers, "checks": checks,
                    "detail": getattr(drv, "detail", None), "records": drv.records}
