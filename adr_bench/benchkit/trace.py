"""A profiler slice of a traced run, and what the metrics read from it.

``Tracer.start(label)`` synchronizes, starts ``torch.profiler`` (CPU and
CUDA activity) and opens a range named ``slice``; ``stop()`` closes it,
synchronizes and keeps the slice's device operations (kernels, copies,
sets) and the harness's labelled host ranges (``label``), on the
profiler's one clock. The loop's CUDA graphs replay as one host call each,
so the host side of a slice stays small while its kernels are all kept.

From a slice: the seconds in which any device operation ran (the union
of their intervals), the slice's own seconds, the device seconds of the
operations whose names match a pattern, the operations that took most
time, and the idle gaps grouped by the innermost host range that holds
each gap's middle. The slice's events are read after the window
(``finish``): reading ~10^5 events takes seconds.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]  # seconds on the profiler's clock


def union_seconds(intervals: Sequence[Interval], lo: float,
                  hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals: Sequence[Interval], lo: float,
              hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def innermost(ranges: Sequence[Tuple[str, float, float]], t: float,
              default: str) -> str:
    """The label of the shortest range that holds time ``t``."""
    best, width = default, float("inf")
    for name, a, b in ranges:
        if a <= t < b and b - a < width:
            best, width = name, b - a
    return best


@dataclass
class Slice:
    """One traced slice: what the metrics read."""
    label: str
    lo: float
    hi: float
    ops: List[Tuple[str, float, float]]      # device operations
    ranges: List[Tuple[str, float, float]]   # labelled host ranges
    host_seconds: float                      # host clock, start to stop
    env_steps: int = 0                       # env steps the slice holds
    notes: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_seconds([(a, b) for _, a, b in self.ops], self.lo,
                             self.hi)

    def device_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for name, a, b in self.ops if rx.search(name))

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b in self.ops:
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], secs] for name, secs in top]

    def top_gaps(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for a, b in idle_gaps([(x, y) for _, x, y in self.ops], self.lo,
                              self.hi):
            name = innermost(self.ranges, 0.5 * (a + b), self.label)
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Tracer:
    """Takes at most one slice a run; a no-op when tracing is off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.slice: Optional[Slice] = None
        self._prof = None
        self._range = None
        self._label = None
        self._t0 = 0.0
        self.env_steps = 0
        # Seconds spent starting and stopping the profiler, which the
        # spans and the window's readers take out again.
        self.overhead_s = 0.0

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, label: str):
        if (not self.enabled or self.slice is not None or self.active
                or getattr(self, "_stopped", None) is not None):
            return
        import torch
        t = time.perf_counter()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._label = label
        self._range = torch.profiler.record_function("slice")
        self._range.__enter__()
        self._t0 = time.perf_counter()
        self.overhead_s += self._t0 - t

    def stop(self):
        """Ends the slice; its events are read by ``finish``, after the
        window, so that reading them costs the window nothing."""
        if not self.active:
            return
        import torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        host = t - self._t0
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self._stopped = (self._prof, self._label, host)
        self._prof = self._range = None
        self.overhead_s += time.perf_counter() - t

    def finish(self) -> Optional[Slice]:
        """Stops an open slice and reads the slice's events."""
        self.stop()
        stopped = getattr(self, "_stopped", None)
        if stopped is not None and self.slice is None:
            self.slice = read_slice(*stopped)
            self.slice.env_steps = self.env_steps
            self._stopped = None
        return self.slice

    def label(self, name: str):
        """A labelled host range while a slice is open, else nothing."""
        if not self.active:
            return _Null()
        import torch
        return torch.profiler.record_function("adr_bench:" + name)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def read_slice(prof, label: str, host_seconds: float) -> Slice:
    """The device operations and labelled ranges of a finished profile."""
    from torch.autograd import DeviceType
    ops, ranges, lo, hi = [], [], None, None
    for ev in prof.events():
        a, b = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        on_device = ev.device_type == DeviceType.CUDA
        # The harness's ranges appear twice: on the host, and as
        # annotations on the device's timeline, which are no operation.
        if ev.name == "slice":
            if not on_device:
                lo, hi = a, b
        elif ev.name.startswith("adr_bench:"):
            if not on_device:
                ranges.append((ev.name.split(":", 1)[1], a, b))
        elif on_device:
            ops.append((ev.name, a, b))
    if lo is None:
        lo = min((a for _, a, _ in ops), default=0.0)
        hi = max((b for _, _, b in ops), default=lo)
    return Slice(label=label, lo=lo, hi=hi, ops=ops, ranges=ranges,
                 host_seconds=host_seconds)
