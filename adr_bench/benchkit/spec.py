"""Finds a cell's files by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each lives in a file of its own under the benchmark's folder:

  * the configuration: the file its ``configs`` entry names;
  * the traffic mix: ``traffic/<traffic>.json``;
  * the cell's limits on the numbers its check compares:
    ``cells/<workload>.json``;
  * each metric: ``metrics/<metric>.py``, a reader with ``read(run)``.

A later cell or metric is added by adding files and entries: nothing here
lists them.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH_DIR)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    path: str  # metrics/<name>.py, whose read(run) gives the value
    _read: Optional[Callable] = field(default=None, repr=False)

    def read(self, run) -> Optional[float]:
        """The metric's value in ``run``, or None where its reader finds
        nothing to read."""
        if self._read is None:
            spec = importlib.util.spec_from_file_location(
                "adr_bench_metric_" + self.name.replace(".", "_"), self.path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._read = module.read
        return self._read(run)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # the configuration file's contents
    config_entry: dict  # its entry in BENCHMARK.json
    traffic: dict       # the traffic file's contents
    traffic_name: str
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _applies(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    # A per-layer metric without the key: every cell that reports the
    # end-to-end metric it moves.
    return entry.get("moves") is None or entry["moves"] in e2e_names


def resolve(workload: str, benchmark_path: Optional[str] = None) -> Cell:
    """The cell named ``workload``, with every file it needs loaded."""
    bench = load_json(benchmark_path
                      or os.path.join(CHECKOUT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = load_json(os.path.join(CHECKOUT, entry["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     w["traffic"] + ".json"))
    limits = load_json(os.path.join(BENCH_DIR, "cells",
                                    workload + ".json"))["limits"]

    def metric(m):
        return Metric(name=m["name"], unit=m["unit"],
                      path=os.path.join(BENCH_DIR, "metrics",
                                        m["name"] + ".py"))
    e2e = [metric(m) for m in bench["end_to_end"]
           if _applies(m, workload, ())]
    names = {m.name for m in e2e}
    per_layer = [metric(m) for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                config_entry=entry, traffic=traffic,
                traffic_name=w["traffic"], limits=limits, end_to_end=e2e,
                per_layer=per_layer)
