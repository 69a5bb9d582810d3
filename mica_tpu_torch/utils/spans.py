"""Spans and counters at the port's layer boundaries.

``span(name)`` times the block it wraps on ``time.perf_counter_ns``
whatever else is on, so callers read ``.seconds`` (the engine's
``timing``, ``Trainer.run_epoch``'s ``epoch_time``, the solver's
``time_cost``).  While ``torch.profiler`` runs, a span also opens
``torch.profiler.record_function(name)``, a host event in the profiler's
trace on the clock of the device's kernels and copies, and on leaving
appends a ``Record`` to the process's bounded recorder.  ``count(name,
n)`` adds to the innermost open recording span's counters.  With no
profiler a span costs one object, two clock reads and one flag check, and
``count`` returns at once: nothing is opened or kept.

Names are ``<layer>.<stage>`` (``engine.h2d``); counters are bytes handed
across (``h2d_bytes``, ``d2h_bytes``) or counts of a path taken
(``af_prepacked``, ``af_repacked``: whether ``engine.pack`` was handed the
AF3 encoding's bitfield or packed it itself).  The stack of open spans is a
thread's own; the records are the process's.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

MAX_RECORDS = 100_000


class Record(NamedTuple):
    name: str
    parent: Optional[str]          # the innermost recording span around it
    start_ns: int
    end_ns: int
    child_ns: int                  # time inside its child spans
    counters: Dict[str, int]

    @property
    def self_ns(self) -> int:
        return self.end_ns - self.start_ns - self.child_ns


_records: "collections.deque[Record]" = collections.deque(maxlen=MAX_RECORDS)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class span:
    """Time a block; record it as ``name`` while a profiler runs."""

    __slots__ = ("name", "start_ns", "end_ns", "counters", "child_ns", "_range", "_parent")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            stack = _stack()
            self._parent = stack[-1] if stack else None
            self.counters: Dict[str, int] = {}
            self.child_ns = 0
            stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._range is None:
            return
        _stack().pop()
        self._range.__exit__(*exc)
        parent = self._parent
        if parent is not None:
            parent.child_ns += self.end_ns - self.start_ns
        _records.append(Record(self.name, parent.name if parent is not None else None,
                               self.start_ns, self.end_ns, self.child_ns, self.counters))

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open recording span."""
    stack = getattr(_local, "stack", None)
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + int(n)


# ---- the recorder ---------------------------------------------------------
def recorded() -> List[Record]:
    return list(_records)


def clear() -> None:
    _records.clear()


def n_spans(name: str) -> int:
    return sum(r.name == name for r in _records)


def total_s(name: str) -> float:
    """Seconds inside spans ``name``."""
    return 1e-9 * sum(r.end_ns - r.start_ns for r in _records if r.name == name)


def self_s(name: str) -> float:
    """Seconds inside spans ``name`` and none of their child spans."""
    return 1e-9 * sum(r.self_ns for r in _records if r.name == name)


def counter(key: str) -> int:
    """Counter ``key`` summed over every record."""
    return sum(r.counters.get(key, 0) for r in _records)
