"""A benchmark cell's traced run read through the port's own spans and
counters (``bayes_sim_ig_tpu_torch/utils/trace.py``), with the port's
tracing on or off.

    python experiments/trace_readout.py --workload hand_more.adr \
        --seed 7 --seconds 51 --port-trace 1 [--harness-trace 0] \
        [--out <file.jsonl>]

One run a process, on the CUDA card. The cell runs as ``adr_bench/run.py
--trace 1`` runs it (``run_cell``: the harness's spans, its profiler
slice, its check), or with ``--harness-trace 0`` as ``--trace 0`` runs
it (no profiler, no harness spans), with the port's tracing on from the
process's start when ``--port-trace 1``. Prints one JSON line (and
appends it to ``--out``): the card and its power limit, ``correct``, the
cell's metrics as the harness reads them, and, with tracing on, what
the port's spans and counters give. These are readings outside the
benchmark, whose harness reads none of them but ``kept_steps_share``:

  * ADR cells, per window ADR iteration: each ``adr.*`` phase's host
    seconds, ``eval_s`` (``adr.evaluate``), ``eval_dev_s`` (the device
    seconds of the reset, collect and extract replays under it),
    ``frames_s`` (``collect.frames``), ``kept_steps_share``
    (``utils/collect.py::STATS``, percent);
  * every cell, per window PPO iteration: ``rollout_host_ms``,
    ``update_host_ms``, ``wait_ms`` and the iteration's ms (``ppo.*``),
    ``rollout_dev_ms`` and ``update_dev_ms`` (the device ms of the
    rollout's and the update's replays), ``replay_gap_ms`` and
    ``replay_gap_share`` (the device's time outside every replay, from
    an iteration's first replay to the next iteration's first, by the
    replays' CUDA events: idle, or eager work between the replays; it
    needs no profiler);
  * ``profiled_replay_gaps``: ``replay_gap_*`` and the rollout's host
    ms of the PPO iterations before, inside and after the harness's
    profiler slice;
  * from the profiler slice: the program's ``bsig.graph.replay`` ranges
    in it, and ``launch_idle_share``, the percent of the slice's
    device-idle time during which the host was inside one, with the idle
    seconds by the innermost program span.

The harness's files are read, not edited: in this process
``benchkit/trace.py::read_slice`` is wrapped so that a slice keeps the
program's ranges and counts none of the profiler's device annotations of
them as operations (``_tap_harness``), and the spans' host seconds leave
out the harness's profiler start and stop, as its own spans do.
Compare two settings only within one call: the host's speed differs
between machines.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(HERE, "adr_bench")

PREFIX = "bsig."
ADR_PHASES = ("adr.rl", "adr.evaluate", "adr.collect_train", "adr.fit",
              "adr.collect_real", "adr.posterior")
EVAL_PHASES = ("reset", "collect", "extract")


def union_seconds(intervals: Sequence[Tuple[float, float]], lo: float,
                  hi: float) -> float:
    """Length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], lo: float,
              hi: float) -> List[Tuple[float, float]]:
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
    """The name of the shortest range that holds time ``t``."""
    best, width = default, float("inf")
    for name, a, b in ranges:
        if a <= t < b and b - a < width:
            best, width = name, b - a
    return best


def _seconds(r: Dict, less: Sequence[Tuple[int, int]] = ()) -> float:
    """A span's host seconds, less the part of it that ``less`` covers
    (the profiler's own start and stop, which the harness's spans take
    out too)."""
    a, b = r["start_ns"], r["end_ns"]
    out = sum(max(0, min(b, y) - max(a, x)) for x, y in less)
    return (b - a - out) * 1e-9


def _under(records: Sequence[Dict], roots: Dict[int, Dict]):
    """(root id, record, names of the spans between them) for each record
    that has one of ``roots`` among its ancestors."""
    parent = {r["id"]: r["parent"] for r in records}
    name = {r["id"]: r["name"] for r in records}
    for r in records:
        p, path = r["parent"], []
        while p is not None and p not in roots:
            path.append(name.get(p))
            p = parent.get(p)
        if p is not None:
            yield p, r, path


def _closed(records, name, keep) -> Dict[int, Dict]:
    return {r["id"]: r for r in records
            if r["name"] == name and r["end_ns"] is not None
            and keep(r["attrs"])}


def _device_s(r: Dict) -> float:
    return math.nan if r["device_ms"] is None else r["device_ms"] * 1e-3


def _means(per: Dict[int, Dict[str, float]]) -> Dict[str, Optional[float]]:
    keys = sorted({k for v in per.values() for k in v})
    out = {}
    for k in keys:
        m = statistics.fmean(v.get(k, 0.0) for v in per.values())
        out[k] = None if math.isnan(m) else m
    return out


def adr_readout(records: Sequence[Dict], first: int, count: int,
                less: Sequence[Tuple[int, int]] = ()) -> Optional[Dict]:
    """Means over the ADR iterations ``first`` .. ``first + count - 1``:
    each ``adr.*`` phase's seconds, ``eval_s``, ``eval_dev_s`` and
    ``frames_s``, host seconds less ``less`` (``_seconds``); None where
    no such iteration was traced."""
    roots = _closed(records, "adr.iteration",
                    lambda a: first <= a["iteration"] < first + count)
    if not roots:
        return None
    per = {i: defaultdict(float) for i in roots}
    for root, r, path in _under(records, roots):
        if r["end_ns"] is None:
            continue
        n = r["name"]
        if n in ADR_PHASES:
            per[root][n.split(".", 1)[1] + "_s"] += _seconds(r, less)
        elif n == "collect.frames":
            per[root]["frames_s"] += _seconds(r, less)
        elif (n == "graph.replay" and "adr.evaluate" in path
              and r["attrs"]["phase"] in EVAL_PHASES):
            per[root]["eval_dev_s"] += _device_s(r)
    for v in per.values():
        v["eval_s"] = v.get("evaluate_s", 0.0)
        v.setdefault("eval_dev_s", 0.0)
        v.setdefault("frames_s", 0.0)
    out = _means(per)
    out["iterations"] = len(roots)
    return out


def ppo_readout(records: Sequence[Dict], first: int,
                less: Sequence[Tuple[int, int]] = (),
                within: Optional[Dict[int, Dict]] = None) -> Optional[Dict]:
    """Means over the PPO iterations from ``first`` on (those inside the
    spans ``within`` where given): the host ms of ``ppo.rollout``,
    ``ppo.update``, ``ppo.wait`` and the iteration (less ``less``), and
    the device ms of the rollout's and the update's replays; None where
    none was traced."""
    roots = _closed(records, "ppo.iteration",
                    lambda a: a["iteration"] >= first)
    if within is not None:
        inside = {r["id"] for _, r, _ in _under(records, within)}
        roots = {i: r for i, r in roots.items() if i in inside}
    if not roots:
        return None
    per = {i: defaultdict(float) for i in roots}
    for i, r in roots.items():
        per[i]["iteration_ms"] = 1e3 * _seconds(r, less)
    for root, r, path in _under(records, roots):
        if r["end_ns"] is None:
            continue
        n = r["name"]
        if n in ("ppo.rollout", "ppo.update", "ppo.wait"):
            key = {"ppo.rollout": "rollout_host_ms",
                   "ppo.update": "update_host_ms",
                   "ppo.wait": "wait_ms"}[n]
            per[root][key] += 1e3 * _seconds(r, less)
        elif n == "graph.replay":
            phase = r["attrs"]["phase"]
            if phase == "rollout" and "ppo.rollout" in path:
                per[root]["rollout_dev_ms"] += 1e3 * _device_s(r)
                per[root]["rollout_replays"] += 1
            elif phase == "update" and "ppo.update" in path:
                per[root]["update_dev_ms"] += 1e3 * _device_s(r)
                per[root]["update_replays"] += 1
    out = _means(per)
    out["iterations"] = len(roots)
    out.update(replay_gaps(records, roots) or {})
    return out


def replay_gaps(records: Sequence[Dict],
                roots: Dict[int, Dict]) -> Optional[Dict[str, float]]:
    """The device's ms outside every replay of the iterations ``roots``,
    from each iteration's first replay to the next iteration's first (to
    its own last replay's end where the next is not traced), by the
    replays' CUDA-event intervals: ``replay_gap_ms`` a iteration and
    ``replay_gap_share``, percent of those stretches. None where a
    replay's interval is not resolved or no replay was timed."""
    reps: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    for root, r, _ in _under(records, roots):
        if r["name"] != "graph.replay":
            continue
        if r["device_ms"] is None or r.get("device_start_ms") is None:
            return None
        a = r["device_start_ms"]
        reps[root].append((a, a + r["device_ms"]))
    if not reps:
        return None
    order = sorted(roots.values(), key=lambda r: r["start_ns"])
    gap = period = 0.0
    for k, it in enumerate(order):
        xs = sorted(reps.get(it["id"], ()))
        if not xs:
            continue
        nxt = order[k + 1] if k + 1 < len(order) else None
        if (nxt is not None and reps.get(nxt["id"])
                and nxt["parent"] == it["parent"]
                and nxt["attrs"]["iteration"] == it["attrs"]["iteration"]
                + 1):
            first = min(reps[nxt["id"]])[0]
            xs.append((first, first))
        end = xs[0][0]
        for a, b in xs:
            gap += max(0.0, a - end)
            end = max(end, b)
        period += end - xs[0][0]
    return {"replay_gap_ms": gap / len(order),
            "replay_gap_share": 100.0 * gap / period if period else None}


def profiled_replay_gaps(records: Sequence[Dict],
                         less: Sequence[Tuple[int, int]],
                         first: int = 0) -> Optional[Dict]:
    """The PPO iterations from ``first`` on, split at the harness's
    profiler slice (from the end of its start, the first of ``less``, to
    the start of its stop, the last): for those that ran whole before,
    inside and after it, their count, ``replay_gaps`` and the mean host
    ms of ``ppo.rollout``. The iteration the profiler starts or stops
    beside is linked to no iteration of another part, so the
    profiler's own start and stop are in none. None without a slice."""
    if len(less) < 2:
        return None
    lo, hi = less[0][1], less[-1][0]
    parts: Dict[str, Dict[int, Dict]] = {"before": {}, "inside": {},
                                         "after": {}}
    for i, r in _closed(records, "ppo.iteration",
                        lambda a: a["iteration"] >= first).items():
        if r["end_ns"] <= lo:
            parts["before"][i] = r
        elif lo <= r["start_ns"] and r["end_ns"] <= hi:
            parts["inside"][i] = r
        elif r["start_ns"] >= hi:
            parts["after"][i] = r
    out = {}
    for key, roots in parts.items():
        rollout = [_seconds(r) for _, r, _ in _under(records, roots)
                   if r["name"] == "ppo.rollout" and r["end_ns"] is not None]
        out[key] = {"iterations": len(roots),
                    "rollout_host_ms": (1e3 * statistics.fmean(rollout)
                                        if rollout else None),
                    **(replay_gaps(records, roots) or {})}
    return out


def _merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_seconds(xs: Sequence[Tuple[float, float]],
                    ys: Sequence[Tuple[float, float]]) -> float:
    """Seconds in both the union of ``xs`` and the union of ``ys``."""
    a, b = _merged(xs), _merged(ys)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def launch_idle_share(ops: Sequence[Tuple[str, float, float]],
                      ranges: Sequence[Tuple[str, float, float]],
                      lo: float, hi: float) -> Optional[float]:
    """Percent of [lo, hi]'s device-idle seconds (no device operation
    running) during which the host was inside a ``graph.replay`` range;
    None where the slice has no idle time or no such range."""
    gaps = idle_gaps([(a, b) for _, a, b in ops], lo, hi)
    idle = sum(b - a for a, b in gaps)
    replays = [(a, b) for n, a, b in ranges if n == "graph.replay"]
    if idle <= 0 or not replays:
        return None
    return 100.0 * overlap_seconds(gaps, replays) / idle


def idle_by_span(ops, ranges, lo, hi, n: int = 8) -> List[List]:
    """The slice's idle seconds by the innermost program range that holds
    each gap's middle ("none": outside every program range)."""
    by: Dict[str, float] = defaultdict(float)
    for a, b in idle_gaps([(x, y) for _, x, y in ops], lo, hi):
        by[innermost(ranges, 0.5 * (a + b), "none")] += b - a
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def program_ranges(prof) -> List[Tuple[str, float, float]]:
    """The port's host ranges (``PREFIX`` stripped) of a finished
    profile, in seconds on the profiler's clock."""
    from torch.autograd import DeviceType
    return [(ev.name[len(PREFIX):], ev.time_range.start * 1e-6,
             ev.time_range.end * 1e-6) for ev in prof.events()
            if ev.name.startswith(PREFIX)
            and ev.device_type != DeviceType.CUDA]


def _tap_harness() -> List[Tuple[int, int]]:
    """In this process only: each profiler slice keeps the program's host
    ranges (``slice.program_ranges``) and leaves the program's device
    annotations out of its operations (kept in ``slice.annotations``:
    the profiler draws a ``bsig.`` range a second time on the device's
    timeline, over the kernels launched inside it, and counted as an
    operation it would fill the idle gaps); the harness's profiler
    start and stop are timed. Returns the list those host intervals
    (``perf_counter_ns``) go into."""
    import time
    import benchkit.trace as bt
    read = bt.read_slice
    profiler: List[Tuple[int, int]] = []

    def read_slice(prof, label, host_seconds):
        s = read(prof, label, host_seconds)
        s.annotations = [op for op in s.ops if op[0].startswith(PREFIX)]
        s.ops = [op for op in s.ops if not op[0].startswith(PREFIX)]
        s.program_ranges = program_ranges(prof)
        return s
    bt.read_slice = read_slice

    def timed(fn, starts):
        """Times the calls that start (stop) the profiler; the harness
        calls ``stop`` again, and ``start`` untraced, to no effect."""
        def call(self, *args, **kwargs):
            was = self.active
            t0 = time.perf_counter_ns()
            try:
                return fn(self, *args, **kwargs)
            finally:
                if was != self.active and self.active == starts:
                    profiler.append((t0, time.perf_counter_ns()))
        return call
    bt.Tracer.start = timed(bt.Tracer.start, True)
    bt.Tracer.stop = timed(bt.Tracer.stop, False)
    return profiler


def readout(run, records, stepped: int, kept: int,
            less: Sequence[Tuple[int, int]] = ()) -> Dict:
    """What the port's spans and counters give over ``run``'s window,
    host seconds less ``less``."""
    out: Dict[str, object] = {}
    traffic = run.traffic
    warm = int(traffic["warmup_iterations"])
    if run.loop == "adr":
        out["adr"] = adr_readout(records, warm, run.units, less)
        out["kept_steps_share"] = (100.0 * kept / stepped if stepped
                                   else None)
        out["stepped"], out["kept"] = stepped, kept
        out["harness_frames_s"] = (
            statistics.fmean(v.get("frames", 0.0) for v in run.spans.values())
            if run.spans else None)
        # PPO's counter restarts each ADR iteration where RL is not
        # fine-tuned: the window's PPO iterations are those inside its ADR
        # iterations.
        window = _closed(records, "adr.iteration",
                         lambda a: warm <= a["iteration"] < warm + run.units)
        out["ppo"] = ppo_readout(records, 0, less, within=window)
    else:
        out["ppo"] = ppo_readout(records, warm, less)
    out["profiled_replay_gaps"] = profiled_replay_gaps(
        records, less, warm if run.loop != "adr" else 0)
    s = run.slice
    ranges = getattr(s, "program_ranges", None) if s is not None else None
    if ranges is not None:
        out["slice_replay_ranges"] = sum(1 for n, _, _ in ranges
                                         if n == "graph.replay")
        out["launch_idle_share"] = launch_idle_share(s.ops, ranges, s.lo,
                                                     s.hi)
        out["idle_by_span"] = idle_by_span(s.ops, ranges, s.lo, s.hi)
        # What the harness's slice reads when it counts the program's
        # device annotations as operations.
        busy = union_seconds([(a, b) for _, a, b in s.ops + s.annotations],
                             s.lo, s.hi)
        out["idle_share_with_annotations"] = 100.0 * (1.0 - busy
                                                      / s.window_s)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--port-trace", type=int, choices=(0, 1), required=True)
    p.add_argument("--harness-trace", type=int, choices=(0, 1), default=1,
                   help="1: the harness's traced run (profiler slice, "
                   "spans); 0: its untraced run")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (BENCH_DIR, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    import run as bench
    started = bench.process_start()
    bench._cache_dirs()
    import torch
    from benchkit import spec
    from bayes_sim_ig_tpu_torch.utils import collect, trace
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    profiler = _tap_harness()
    before = dict(collect.STATS)
    workdir = tempfile.mkdtemp(prefix="trace_readout.")
    if args.port_trace:
        trace.enable()
    try:
        out = bench.run_cell(cell, args.seed, args.seconds,
                             bool(args.harness_trace), "cuda:0", started,
                             workdir, io.StringIO())
    finally:
        trace.disable()
        shutil.rmtree(workdir, ignore_errors=True)
    run = out["run"]
    xs = sorted(run.ppo_iter_s)
    line = {"workload": args.workload, "seed": args.seed,
            "port_trace": args.port_trace,
            "harness_trace": args.harness_trace,
            "device": torch.cuda.get_device_name(0),
            "card": bench._card_state(), "correct": out["line"]["correct"],
            "metrics": {k: v["value"]
                        for k, v in out["line"]["metrics"].items()},
            "units": run.units, "window_s": run.window_s,
            "iter_s": run.iter_s,
            "ppo_iter_ms_p50": 1e3 * xs[len(xs) // 2] if xs else None,
            "breakdown": out["line"].get("breakdown")}
    if args.port_trace:
        torch.cuda.synchronize()
        line["readout"] = readout(
            run, trace.records(),
            collect.STATS["stepped"] - before["stepped"],
            collect.STATS["kept"] - before["kept"], profiler)
    text = json.dumps(line)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
