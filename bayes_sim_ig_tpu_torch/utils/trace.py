"""Spans of the port's own layers, kept in memory, off unless enabled.

    from bayes_sim_ig_tpu_torch.utils import trace
    trace.enable()
    ...                      # the ADR loop, PPO.run, collect_trajectories
    torch.cuda.synchronize()
    spans = trace.records()  # [{"name", "id", "parent", "start_ns", ...}]
    trace.disable()
    trace.reset()

``span(name, **attrs)`` is a context manager around one call into a
layer. A span records its name, an id unique in the process, the id of
the span that was open around it (its parent, None at the top), its host
start and end (``time.perf_counter_ns()``) and its small attributes (the
ADR or PPO iteration, a program's phase, the episodes a collection
keeps). While a ``torch.profiler`` records, a span also opens a
``record_function`` range named ``PREFIX + name``: the profiler then
holds the port's spans on the clock of its device operations, and an
idle gap of the device can be put down to the innermost span open
around it.

``device_span`` is a span that also times the device: a pair of timing
``torch.cuda.Event``s, taken from a pool, recorded on the current stream
at its start and its end (``Graphed`` times each CUDA graph replay so).
Its ``device_ms`` (end less start) and ``device_start_ms`` (its start
less an event recorded before the first device span since the last
``reset``, so that the device spans' intervals share one time line) are
resolved by ``records()`` once the end event has completed: read the
records after a synchronize.

Off (the default), ``span`` and ``device_span`` return one shared no-op,
and the per-replay path reads ``ENABLED`` and nothing else. No span
synchronizes or copies to the host. The spans of this process form one
stack: the port's loop runs in one thread.

Counters live beside the work they count, as plain module dicts:
``utils/step_graph.py::STATS`` (captures, replays and capture seconds,
by phase), ``utils/collect.py::STATS`` (the env steps collection
steps and keeps), ``physics/dynamics.py::STATS`` (the mass-matrix solves
by route and kind, and the ``forward_kinematics`` calls),
``physics/contact.py::STATS`` (the pair-contact evaluations by kind) and
``sim/task.py::STATS`` (the ``env_step`` calls). A CUDA graph adds the
last three's capture counts at every replay, as it adds kernel launches
(``ops/launch.py::count_at_replay``).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional

import torch

PREFIX = "bsig."

# The one flag the per-replay path reads.
ENABLED = False

_records: List["Span"] = []
_open: List[int] = []           # the ids of the open spans, innermost last
_ids = itertools.count(1)
_events: List[torch.cuda.Event] = []  # free timing events
_POOL_CHUNK = 512
_base: Optional[torch.cuda.Event] = None  # recorded before the first pair


class Span:
    """One span; ``records()`` gives its fields as a dict."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "attrs",
                 "device_ms", "device_start_ms", "_range", "_pair")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)
        self.parent: Optional[int] = None
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.device_ms: Optional[float] = None
        self.device_start_ms: Optional[float] = None
        self._range = None
        self._pair = None

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        _records.append(self)
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(PREFIX + self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _open.pop()
        return False

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "attrs": dict(self.attrs), "device_ms": self.device_ms,
                "device_start_ms": self.device_start_ms}


class _DeviceSpan(Span):
    __slots__ = ()

    def __enter__(self):
        super().__enter__()
        self._pair = _take_pair()
        self._pair[0].record()
        return self

    def __exit__(self, *exc):
        self._pair[1].record()
        return super().__exit__(*exc)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def span(name: str, **attrs):
    """A span named ``name`` while tracing is on, else the shared no-op."""
    if not ENABLED:
        return _NOOP
    return Span(name, attrs)


def device_span(name: str, **attrs):
    """A span that also records a device interval on the current CUDA
    stream, while tracing is on; else the shared no-op."""
    if not ENABLED:
        return _NOOP
    return _DeviceSpan(name, attrs)


def _take_pair():
    global _base
    if len(_events) < 2:
        _events.extend(torch.cuda.Event(enable_timing=True)
                       for _ in range(_POOL_CHUNK))
    if _base is None:
        _base = torch.cuda.Event(enable_timing=True)
        _base.record()
    return _events.pop(), _events.pop()


def enable():
    global ENABLED
    ENABLED = True


def disable():
    global ENABLED
    ENABLED = False


def _resolve(s: Span):
    """Reads a device span's interval once its end event has completed,
    and gives its events back to the pool."""
    if s._pair is not None and s._pair[1].query():
        start, end = s._pair
        s.device_ms = start.elapsed_time(end)
        s.device_start_ms = _base.elapsed_time(start)
        _events.extend(s._pair)
        s._pair = None


def records() -> List[Dict]:
    """Every span since the last ``reset``, in the order they opened. A
    span still open has ``end_ns`` None; a device span whose end event
    has not completed has ``device_ms`` None (this never waits)."""
    for s in _records:
        _resolve(s)
    return [s.as_dict() for s in _records]


def reset():
    """Drops the records; the pool keeps the events of those resolved."""
    global _base
    for s in _records:
        _resolve(s)
    _records.clear()
    _base = None
