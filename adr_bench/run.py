#!/usr/bin/env python3
"""The benchmark of ``bayes_sim_ig_tpu_torch``: runs one cell of
``BENCHMARK.json`` on the CUDA card and prints one JSON line.

    python3 adr_bench/run.py --workload hand_more.adr --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout. The cell's configuration, traffic mix,
limits and metric readers are found by name (``benchkit/spec.py``). The
port's loop runs over a window of ``--seconds`` after its set-up
(``benchkit/loops.py``); with ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read with
spans around the loop's calls and a profiler slice. Either way the
window's sampled rollout step, collection rounds, PPO update, MDN fit and
posterior are held to the plain reference (``benchkit/checks.py``), each
number beside its limit, last on standard error and last in the line.

Exits 3 without a result when there is no CUDA card, or fewer than the
cell asks for; 4 when the process holds the JAX package or JAX once the
window has closed; 1 when the loop or the check raised.
"""

from __future__ import annotations

import time

_T_START = time.time()

import argparse  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "bayes_sim_ig_tpu")


def process_start() -> float:
    """When this process started (epoch seconds), from /proc; the first
    line of this script where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_START


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def _cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (``build/`` is ignored by git). The port's own kernels build into
    ``build/torch_kernels``, fixed in its code."""
    root = os.path.join(CHECKOUT, "build", "adr_bench")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(root, sub)


def _card_state():
    """The card's power limit, SM clock, power draw and temperature, as
    ``nvidia-smi`` reads them after the window."""
    import subprocess
    keys = ("power.limit", "clocks.sm", "power.draw", "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        values = [float(x) for x in out.stdout.splitlines()[0].split(",")]
        return dict(zip(keys, values))
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             started: float, workdir: str, log) -> dict:
    """Runs ``cell``; returns {"line": the result line, "run": the
    ``Run``, "compared": each checked number with its limit and where it
    reads worst}."""
    from benchkit import checks
    from benchkit.loops import Run, drive
    run = Run(cell=cell.name, loop=cell.traffic["loop"], seed=seed,
              seconds=seconds, traced=trace, device=device,
              config=cell.config, traffic=cell.traffic,
              process_start=started)
    drive(run, workdir, log)
    missing = set(checks.expected(run.loop)) - set(cell.limits)
    if missing:
        raise ValueError(f"cells/{cell.name}.json sets no limit on "
                         f"{sorted(missing)}")
    got = checks.numbers(run)
    compared = {}
    for name in cell.limits:
        value, where = got.get(name, (math.nan, "not produced"))
        compared[name] = {"value": _finite(value),
                          "limit": cell.limits[name], "where": where}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu", "kind": _device_name(device),
           "count": cell.chips, "memory_peak_bytes": run.peak_mem_bytes}
    line = {"correct": bool(correct), "attempted": run.units,
            "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_s
        dev["window_s"] = run.slice.window_s
        line["breakdown"] = {"device_ops": run.slice.top_ops(),
                             "idle_gaps": run.slice.top_gaps()}
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in compared.items()}
    return {"line": line, "run": run, "compared": compared}


def _device_name(device: str) -> str:
    import torch
    if str(device).startswith("cuda"):
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def report(out: dict):
    """The result line, and the lines for standard error: a JSON line of
    notes (set-up and window seconds, captures, the kernels' build
    seconds, TF32, the card's power limit, the traced slice), then each
    compared number beside its limit, last."""
    from bayes_sim_ig_tpu_torch.ops import build
    run = out["run"]
    notes = {"setup_s": run.setup_s, "window_s": run.window_s,
             "units": run.units, "captures": run.captures,
             "matmul_tf32": run.tf32,
             "card": (_card_state()
                      if run.device.startswith("cuda") else None),
             "kernel_build_s": {k: v["seconds"]
                                for k, v in build.BUILD_LOG.items()}}
    if run.iter_s:
        notes["iter_s"] = run.iter_s
    if run.ppo_iter_s:
        xs = sorted(run.ppo_iter_s)
        notes["ppo_iter_s_p5_p50_p95_max"] = [
            xs[len(xs) // 20], xs[len(xs) // 2], xs[(19 * len(xs)) // 20],
            xs[-1]]
    if run.slice is not None:
        notes["slice"] = {"label": run.slice.label,
                          "host_s": run.slice.host_seconds,
                          "env_steps": run.slice.env_steps,
                          "device_ops": len(run.slice.ops)}
    lines = ["notes " + json.dumps(notes)]
    for name, c in out["compared"].items():
        lines.append(f"check {name} {c['value']!r} limit {c['limit']!r}"
                     + (f" (worst: {c['where']})" if c["where"] else ""))
    return out["line"], lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    started = process_start()
    for path in (BENCH_DIR, CHECKOUT):
        if path not in sys.path:
            sys.path.insert(0, path)
    _cache_dirs()
    import torch
    from benchkit import spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    workdir = os.path.join(tmp, "adr_bench", f"{args.workload}.{args.seed}")
    shutil.rmtree(workdir, ignore_errors=True)
    log = io.StringIO()
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", started, workdir, log)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        sys.stderr.write("\n--- the loop's output, last 4000 characters "
                         "---\n" + log.getvalue()[-4000:] + "\n")
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: the benchmark "
              f"runs the port alone", file=sys.stderr)
        return 4
    line, lines = report(out)
    for text in lines:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
