#!/usr/bin/env python3
"""The readings that set a cell's limits: for each seed, one run of the
cell (a short window: the check reads the window's first iteration), then
every number the harness compares (``step_gap_max`` too, where the
cell holds none) read five ways against the float32 reference:

  * ``program``: the port's own outputs (the lower readings);
  * ``control``: the reference computed with TF32 on, in the port's place
    (the precision just below the float32 the configurations state);
  * ``half``, ``altered``: the reference with a fault planted, in the
    port's place (each minibatch's loss over half its rows, the envs'
    second half left unstepped, the second half of the extracted rows left
    unpadded; one env's observations after a step or a reset, its first
    label, or the first minibatch's loss, wrong where they are produced);
  * ``unchanged``: the reference's state, weights and raw trajectories
    left as they were.

    python3 adr_bench/control.py --workload hand_more.adr \
        --seeds 11 12 13 --seconds 5

on the card, from the root of a checkout. Appends one JSON line a seed
to ``<out>/control_<workload>.jsonl`` (``--out``, default
``runs/adr_bench_control``) and prints them; the benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import sys
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
FAULTS = ("half", "altered", "unchanged")


def readings(run) -> dict:
    """Every compared number of ``run``, read the four ways."""
    from benchkit import checks
    ref = checks.Reference(run)
    run._reference = ref
    got = checks.numbers(run)
    out = {"program": {k: v for k, (v, _) in got.items()},
           "program_where": {k: w for k, (_, w) in got.items() if w}}
    base = ref.outputs("float32")
    out["control"] = {k: v for k, (v, _) in checks.numbers(
        run, prog=ref.outputs("tf32"), ref=base).items()}
    for fault in FAULTS:
        out[fault] = {k: v for k, (v, _) in checks.numbers(
            run, prog=ref.outputs("float32", fault), ref=base).items()}
    return out


def explain(run) -> dict:
    """Where the port's step gap comes from: for each leaf, the spread of
    its env-by-env gaps, the worst envs, and what those envs were doing
    (an episode's first step after a reset, the progress, the size of
    their change)."""
    import torch
    from benchkit import checks
    ref = run._reference.outputs("float32")["step"]
    snap = run.snapshots["step"]
    before = {"state": checks._snap_leaves(snap["state"]),
              "obs": snap["obs"]}
    gaps = checks.step_gaps_by_env(checks._prog_step(snap), ref, before)
    fields = snap["state"]["fields"]
    reset = fields["reset_buf"].cpu() > 0
    progress = fields["progress"].cpu()
    out = {}
    for k, g in gaps.items():
        q = torch.quantile(g.double(), torch.tensor(
            [0.5, 0.9, 0.99, 0.999, 1.0], dtype=torch.float64))
        worst = torch.argsort(g, descending=True)[:5]
        out[k] = {"q50_90_99_999_max": [float(x) for x in q],
                  "above_1e-4": int((g > 1e-4).sum()),
                  "worst": [[int(e), float(g[e]), bool(reset[e]),
                             int(progress[e])] for e in worst]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=os.path.join("runs",
                                                 "adr_bench_control"))
    p.add_argument("--explain", action="store_true",
                   help="add the port's step gap env by env")
    args = p.parse_args(argv)
    for path in (BENCH_DIR, CHECKOUT):
        if path not in sys.path:
            sys.path.insert(0, path)
    import run as bench_run
    bench_run._cache_dirs()
    from benchkit import spec
    cell = spec.resolve(args.workload)
    out_dir = os.path.join(CHECKOUT, args.out)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"control_{args.workload}.jsonl")
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    for seed in args.seeds:
        workdir = os.path.join(tmp, "adr_bench", f"control.{seed}")
        t0 = time.time()
        try:
            res = bench_run.run_cell(cell, seed, args.seconds, False,
                                     args.device, t0, workdir, io.StringIO())
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line = {"workload": args.workload, "seed": seed,
                "readings": readings(res["run"]),
                "seconds": time.time() - t0}
        if args.explain:
            line["explain"] = explain(res["run"])
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
