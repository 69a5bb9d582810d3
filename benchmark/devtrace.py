"""Read a ``torch.profiler`` run of a traced window: device busy time (the
union of every device operation's interval), time by kernel name, and the
idle gaps labelled by what the host was doing."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

WINDOW_MARK = "bench.window"


@dataclasses.dataclass
class Profile:
    window_s: float                 # host clock over the traced window
    busy_s: float                   # union of device operations inside it
    by_name: Dict[str, float]       # device seconds by operation name
    idle_by_host: List[Tuple[str, float]]
    launches: Dict[str, int]        # the port's launch counters over the window

    def seconds(self, pick) -> float:
        return sum(v for k, v in self.by_name.items() if pick(k))


@contextlib.contextmanager
def traced(out: list, counters=()):
    """Profile the body (CPU and CUDA), synchronizing at both ends; append
    a ``Profile`` to ``out``.  ``counters``: dicts of launch counts whose
    growth over the body is kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    before = [dict(c) for c in counters]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW_MARK):
            yield
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    launches = {}
    for b, c in zip(before, counters):
        launches.update({k: c[k] - b.get(k, 0) for k in c})
    out.append(summarize(prof.events(), window_s, launches))


def summarize(events, window_s: float, launches=None) -> Profile:
    """``events``: the profiler's function events (device ones carry
    ``device_type`` CUDA; times in us)."""
    dev, cpu, mark = [], [], None
    for e in events:
        kind = str(getattr(e, "device_type", ""))
        start, end = e.time_range.start, e.time_range.end
        if "CUDA" in kind and (getattr(e, "is_user_annotation", False)
                               or e.name.startswith("bench.")):
            continue      # a host range mirrored on the device's timeline
        if "CUDA" in kind:
            dev.append((e.name, start, end))
        elif "CPU" in kind and end > start:
            if e.name == WINDOW_MARK:
                mark = (start, end)
            elif not e.name.startswith("ProfilerStep") and not e.name.startswith("["):
                cpu.append((e.name, start, end))
    lo, hi = mark if mark is not None else (min((d[1] for d in dev), default=0.0),
                                            max((d[2] for d in dev), default=0.0))
    by_name: Dict[str, float] = {}
    spans = []
    for name, s, t in dev:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-6
            spans.append((s, t))
    spans.sort()
    busy, gaps, cur_s, cur_t = 0.0, [], None, lo
    for s, t in spans:
        if cur_s is not None and s <= cur_t:
            cur_t = max(cur_t, t)
            continue
        if s > cur_t:
            gaps.append((cur_t, s))
        if cur_s is not None:
            busy += cur_t - cur_s
        cur_s, cur_t = s, t
    if cur_s is not None:
        busy += cur_t - cur_s
    if hi > cur_t:
        gaps.append((cur_t, hi))
    return Profile(window_s=window_s, busy_s=busy * 1e-6, by_name=by_name,
                   idle_by_host=label_gaps(gaps, cpu), launches=launches or {})


def label_gaps(gaps, cpu, min_us: float = 20.0) -> List[Tuple[str, float]]:
    """Idle seconds summed by the innermost host operation running at each
    gap's middle (gaps under ``min_us`` left out), largest first."""
    gaps = [(s, t) for s, t in gaps if t - s >= min_us]
    if not gaps:
        return []
    names = [c[0] for c in cpu]
    starts = np.array([c[1] for c in cpu], np.float64)
    ends = np.array([c[2] for c in cpu], np.float64)
    dur = ends - starts
    out: Dict[str, float] = {}
    for s, t in gaps:
        mid = 0.5 * (s + t)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        label = names[inside[np.argmin(dur[inside])]] if len(inside) else "(no host op)"
        out[label] = out.get(label, 0.0) + (t - s) * 1e-6
    return sorted(out.items(), key=lambda kv: -kv[1])


def breakdown(p: Profile, n: int = 10) -> Dict[str, list]:
    ops = sorted(p.by_name.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k[:120], v] for k, v in p.idle_by_host[:n]]}
