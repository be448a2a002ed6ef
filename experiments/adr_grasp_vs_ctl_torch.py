"""Grasp-excitation ADR against its 20-policy DR control, one seed, through
the PyTorch port: the counterpart of ``adr_grasp_vs_ctl.sh``.

    python experiments/adr_grasp_vs_ctl_torch.py SEED [EVALS]

The same protocol: the port's ``cfg/shadow_hand_grasp.yaml`` (2048 envs,
20 ADR iterations, ``ftuneRL: false``) with ``realEvals`` set to EVALS
(default 400), and its control arm, the same config with ``modelClass:
None`` (pure DR: 20 policies trained on the prior, no BayesSim). Both
configs are written as JSON into their run dirs; no shipped config is
edited. The arms run in turn through ``bayes_sim_main.main`` with ``--task
ShadowHand --max_iterations 300 --seed SEED --headless --rl_device
cuda:0``, logdirs ``runs/torch_shadowhand_{grasp,drctl}_sSEED``, each
arm's printing in ``<logdir>/loop.log``.

Each arm's surrogate-real series goes to
``experiments/data/torch_shadowhand_{grasp,drctl}_sSEED.json`` in the
schema of the JAX archive (``run``, ``tag``, ``real_rewards_mean``), so
that the pooled analysis reads the pair as it is::

    python experiments/adr_pooled_analysis.py \\
        experiments/data/torch_shadowhand_grasp_s7.json:\\
experiments/data/torch_shadowhand_drctl_s7.json

Beside the series the file holds the ``min`` and ``max`` series, the
card's name and power limit, the arm's seconds, ``iter_secs``, its peak
allocated and reserved memory, the graphs still live at its end, the
captures and replays by phase (``utils/step_graph.STATS``), the kernels'
launches, and one record
per ADR iteration, taken at its evaluation: seconds since the arm began,
allocated memory, the live captures by phase; and PPO's curves
(``ppo_log``: loss, approx KL, lr, mean reward, ... of each run
``rl_<iteration>``, every 50 PPO iterations). On a card each arm is also
timed by ``chip_smoke._PhaseTimer`` (``ppo.run``, the collections, the
MDN fits and the refit, ...), in total and at each iteration.

An arm that raises is recorded with its error and the series it reached;
the other arm still runs, and the script then exits 1.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bayes_sim_ig_tpu_torch import bayes_sim_main  # noqa: E402
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts  # noqa: E402
from bayes_sim_ig_tpu_torch.utils import step_graph  # noqa: E402
from bayes_sim_ig_tpu_torch.utils.args import load_config  # noqa: E402

TAG = "SurrogateReal/real_rewards_mean"
CFG = os.path.join(ROOT, "bayes_sim_ig_tpu_torch", "cfg",
                   "shadow_hand_grasp.yaml")


def arm_configs(evals=400, depth_edits=None):
    """{arm: config}: the grasp config with ``realEvals`` = ``evals`` and
    ``depth_edits`` ({section: {key: value}}) applied, and its copy with
    ``modelClass: None``."""
    grasp = load_config(CFG)
    grasp["bayessim"]["realEvals"] = int(evals)
    for section, edits in (depth_edits or {}).items():
        grasp[section].update(edits)
    ctl = copy.deepcopy(grasp)
    ctl["bayessim"]["modelClass"] = "None"
    return {"grasp": grasp, "drctl": ctl}


def card():
    """The card's name and power limit as nvidia-smi gives them (None
    without nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


class _Tap:
    """The loop's writer of run ``sub``, with each scalar also handed to
    ``on_scalar``."""

    def __init__(self, inner, sub, on_scalar):
        self._inner = inner
        self._sub = sub
        self._on_scalar = on_scalar

    def add_scalar(self, tag, value, step, *args, **kwargs):
        self._on_scalar(self._sub, tag, value, step)
        return self._inner.add_scalar(tag, value, step, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _ArmRecord:
    """Wraps ``bayes_sim_main._make_writer`` while an arm runs: keeps the
    surrogate-real series the loop logs, PPO's curves (``rl/*`` by run:
    ``rl_<iteration>``, every ``save_interval`` PPO iterations) and, at
    each iteration's mean, the seconds, memory and live captures of the
    arm so far."""

    def __init__(self, device, timer=None):
        self.device = torch.device(device)
        self.timer = timer
        self.series = collections.defaultdict(dict)
        self.ppo = collections.defaultdict(lambda: collections.defaultdict(
            list))
        self.iterations = []
        self.t0 = time.perf_counter()

    def _on_scalar(self, sub, tag, value, step):
        if tag.startswith("rl/"):
            self.ppo[sub][tag].append([int(step), float(value)])
        if not tag.startswith("SurrogateReal/real_rewards_"):
            return
        self.series[tag.rsplit("_", 1)[1]][int(step)] = float(value)
        if tag != TAG:
            return
        rec = {"iter": int(step),
               "secs": time.perf_counter() - self.t0,
               "live_graphs": dict(collections.Counter(
                   step_graph.live_graphs())),
               "captures": {k: int(v["captures"])
                            for k, v in step_graph.STATS.items()}}
        if self.device.type == "cuda":
            rec["allocated"] = torch.cuda.memory_allocated(self.device)
            rec["reserved"] = torch.cuda.memory_reserved(self.device)
        if self.timer is not None:
            rec["phase_secs"] = dict(self.timer.secs)
        self.iterations.append(rec)

    def __enter__(self):
        self._make_writer = make = bayes_sim_main._make_writer
        bayes_sim_main._make_writer = lambda logdir, sub="bsim": _Tap(
            make(logdir, sub), sub, self._on_scalar)
        return self

    def __exit__(self, *exc):
        bayes_sim_main._make_writer = self._make_writer

    def reached(self, fxn="mean"):
        """The series of ``fxn`` in iteration order."""
        s = self.series[fxn]
        return [s[i] for i in sorted(s)]


def run_arm(arm, cfg, seed, device="cuda:0", max_iterations=300,
            runs_dir=None):
    """One arm through ``bayes_sim_main.main``; returns (``main``'s dict or
    None if it raised, the arm's record)."""
    runs_dir = runs_dir or os.path.join(ROOT, "runs")
    logdir = os.path.join(runs_dir, f"torch_shadowhand_{arm}_s{seed}")
    os.makedirs(logdir, exist_ok=True)
    cfg_path = os.path.join(logdir, "cfg_env.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["--task", "ShadowHand", "--cfg_env", cfg_path, "--logdir",
            logdir, "--max_iterations", str(max_iterations), "--seed",
            str(seed), "--headless", "--rl_device", str(device)]
    dev = torch.device(device)
    timer = None
    if dev.type == "cuda":
        from chip_smoke import _PhaseTimer
        timer = _PhaseTimer("ShadowHand", cfg["env"]["numEnvs"])
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    step_graph.STATS.clear()
    launched = launch_counts()
    out, error = None, None
    t0 = time.perf_counter()
    with open(os.path.join(logdir, "loop.log"), "w") as log, \
            contextlib.redirect_stdout(log), \
            _ArmRecord(dev, timer) as rec, \
            timer or contextlib.nullcontext():
        try:
            out = bayes_sim_main.main(argv)
        except Exception:  # recorded, and the script exits 1
            error = traceback.format_exc()
            traceback.print_exc(file=log)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launched = {k: c - launched.get(k, 0) for k, c in launch_counts().items()}
    if out is not None:
        series = {k: [r[k] for r in out["real_rewards"]]
                  for k in ("mean", "min", "max")}
    else:
        series = {k: rec.reached(k) for k in ("mean", "min", "max")}
    record = {
        "run": os.path.relpath(logdir, ROOT), "tag": TAG,
        "real_rewards_mean": series["mean"],
        "real_rewards_min": series["min"],
        "real_rewards_max": series["max"],
        "arm": arm, "seed": int(seed),
        "model_class": cfg["bayessim"]["modelClass"],
        "real_evals": cfg["bayessim"]["realEvals"],
        "real_iters": cfg["bayessim"]["realIters"],
        "num_envs": cfg["env"]["numEnvs"],
        "max_iterations": int(max_iterations), "device": str(device),
        "card": card() if dev.type == "cuda" else None,
        "seconds": secs,
        "iter_secs": None if out is None else out["iter_secs"],
        "peak_allocated": (torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None),
        "peak_reserved": (torch.cuda.max_memory_reserved(dev)
                          if dev.type == "cuda" else None),
        "live_graphs": step_graph.live_graphs(),
        "graph_stats": {k: dict(v) for k, v in step_graph.STATS.items()},
        "launches": launched,
        "iterations": rec.iterations,
        "ppo_log": rec.ppo,
        "error": error,
    }
    if timer is not None:
        parts, replays, _ = timer.breakdown()
        record.update(phase_secs=dict(timer.secs), collect_parts=parts,
                      collect_replays=replays)
    return out, record


def run_pair(seed, evals=400, device="cuda:0", depth_edits=None,
             max_iterations=300, runs_dir=None, data_dir=None, keep=False):
    """Both arms of one seed, the grasp arm first; writes each arm's
    record to ``<data_dir>/torch_shadowhand_<arm>_s<seed>.json`` as soon
    as it ends (default experiments/data/). Returns {arm: (``main``'s dict
    or None, record, path)}; ``main``'s dict is kept only with ``keep``
    (else dropped before the next arm, with its env and graphs)."""
    data_dir = data_dir or os.path.join(ROOT, "experiments", "data")
    os.makedirs(data_dir, exist_ok=True)
    results = {}
    for arm, cfg in arm_configs(evals, depth_edits).items():
        out, record = run_arm(arm, cfg, seed, device, max_iterations,
                              runs_dir)
        path = os.path.join(data_dir, f"torch_shadowhand_{arm}_s{seed}.json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
        print(summary(record), flush=True)
        results[arm] = (out if keep else None, record, path)
        # The arm's env, trainer and models go before the next arm, so
        # that its peak memory is its own.
        del out
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return results


def summary(record):
    """One line of an arm's record."""
    mean = np.asarray(record["real_rewards_mean"], np.float64)
    peak = ("" if record["peak_allocated"] is None else
            f", peak {record['peak_allocated'] / 2**30:.2f} GiB allocated")
    head = (f"[{record['arm']} s{record['seed']}] "
            f"{len(mean)}/{record['real_iters']} iterations in "
            f"{record['seconds']:.1f} s{peak}, live graphs at the end "
            f"{record['live_graphs']}, captures "
            f"{ {k: v['captures'] for k, v in record['graph_stats'].items()} }")
    if record["error"]:
        return head + "; FAILED: " + record["error"].strip().splitlines()[-1]
    return (head + f"; surrogate-real mean {mean.mean():.1f}, median "
            f"{np.median(mean):.1f}, all finite "
            f"{bool(np.isfinite(mean).all())}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not 1 <= len(argv) <= 2:
        raise SystemExit(__doc__)
    seed = int(argv[0])
    evals = int(argv[1]) if len(argv) > 1 else 400
    print(f"[card] {card()}", flush=True)
    results = run_pair(seed, evals)
    return 1 if any(rec["error"] for _, rec, _ in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
