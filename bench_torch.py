"""The PyTorch port's benchmark, the counterpart of bench.py: the same rows
under the same names and at the same widths, measured on one CUDA card.

    python3 bench_torch.py                       # every row, on cuda:0
    python3 bench_torch.py --device cpu --tiny   # the rows' code at a few
                                                 # envs and steps (a check,
                                                 # not a measurement)

Rows (bench.py:278-365):
  * ``pendulum_env_steps_per_sec_4096envs``: 512 steps of the stochastic
    policy and ``env_step`` at 4096 envs (Pendulum, mass and length DR),
    through the collection's ``StepGraph`` (one replay a step);
  * ``<task>_env_steps_per_sec_<n>envs``: one collection round of 51
    (``utils/collect.py::_collect_round``: the reset, 50 step replays and
    the episode extraction, policy_random, the uniform prior) of ShadowHand
    at 16384 envs (shadow_hand.yaml), at 10000 (shadow_hand_more.yaml),
    and with the 211-dim full_state obs at 16384, and of Ant, Humanoid,
    Anymal (4096), FrankaCabinet (2048), Quadcopter (8192), Ingenuity
    (4096), Cartpole (512) and BallBalance (128), each from the port's
    copy of its config: (51 - 1) x envs / seconds of a round;
  * ``mdnn_train_samples_per_sec``: ``MDNN.run_training`` of (10000 x 40)
    -> 2, 10 components, [128, 128] tanh, 1000 updates of 100 (the
    ``_Fit`` graph): 100,000 / seconds of a call;
  * ``pendulum_adr_iteration_sec_warm``: ``bayes_sim_main.main`` on
    pendulum.yaml with realEvals 100 and 20 PPO iterations an ADR
    iteration; its ``iter_secs`` from the second iteration on.

Every timed repeat runs after warm-up calls (which capture the graphs) and
ends in ``torch.cuda.synchronize()``; a row reports the median of its
repeats (5) with their spread. Each row and the aggregate line
name the card and its power limit (``nvidia-smi``). A row that raises is
printed with its error, the others still run, the aggregate line
(``{"metric": "all", "rows": {...}, ...}``) is the last line of stdout,
and the exit code is then 1. The ADR loop's own printing goes to
runs/bench_torch/adr/loop.log.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CFG_DIR = os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg")
RUN_DIR = os.path.join(HERE, "runs", "bench_torch")

HAND_LEN = 51  # trainTrajLen 50 + 1: the collection episode length

# The widths of bench.py, and the tiny ones of ``--tiny`` (the rows' code
# on a few envs and steps).
# "task_envs": None keeps each task row's own count; "adr_cuts" edits the
# ADR row's config (the tiny env count and episodes, fewer trajectories).
FULL = {"pendulum_envs": 4096, "pendulum_steps": 512, "hand_envs": 16384,
        "hand_more_envs": 10000, "task_envs": None, "ep_len": HAND_LEN,
        "mdnn_rows": 10000, "mdnn_updates": 1000, "mdnn_batch": 100,
        "adr_evals": 100, "adr_ppo_iterations": 20, "adr_cuts": {},
        "repeats": 5, "warmup": 2}
TINY = {"pendulum_envs": 4, "pendulum_steps": 4, "hand_envs": 2,
        "hand_more_envs": 2, "task_envs": 2, "ep_len": 3, "mdnn_rows": 50,
        "mdnn_updates": 5, "mdnn_batch": 10, "adr_evals": 2,
        "adr_ppo_iterations": 1,
        "adr_cuts": {"env": {"numEnvs": 8, "episodeLength": 20},
                     "bayessim": {"trainTrajs": 16}},
        "repeats": 2, "warmup": 1}

# (row, task, config, env edits, the envs: bench.py's count or the key of
# FULL/TINY that holds it).
ARTICULATED = [
    ("shadowhand_full_env_steps_per_sec_16384envs", "ShadowHand",
     "shadow_hand.yaml", {}, "hand_envs"),
    ("shadowhand_full_env_steps_per_sec_10000envs", "ShadowHand",
     "shadow_hand_more.yaml", {}, "hand_more_envs"),
] + [(f"{name.lower()}_env_steps_per_sec_{n}envs", name, cfg_file, {}, n)
     for name, cfg_file, n in (
         ("Ant", "ant.yaml", 4096),
         ("Humanoid", "humanoid.yaml", 4096),
         ("Anymal", "anymal.yaml", 4096),
         ("FrankaCabinet", "franka_cabinet.yaml", 2048),
         ("Quadcopter", "quadcopter.yaml", 8192),
         ("Ingenuity", "ingenuity.yaml", 4096),
         ("Cartpole", "cartpole.yaml", 512),
         ("BallBalance", "ball_balance.yaml", 128))]
FULL_STATE = ("shadowhand_full_state_obs_env_steps_per_sec_16384envs",
              "ShadowHand", "shadow_hand.yaml",
              {"observationType": "full_state"}, "hand_envs")

# The rows in bench.py's order.
ROW_NAMES = (["pendulum_env_steps_per_sec_4096envs"]
             + [row[0] for row in ARTICULATED]
             + ["mdnn_train_samples_per_sec",
                "pendulum_adr_iteration_sec_warm", FULL_STATE[0]])


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device):
    """The card's name and power limit as nvidia-smi gives them, or the
    device's type where it is not a card."""
    if torch.device(device).type != "cuda":
        return f"{torch.device(device).type} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def timed_repeats(fn, device, repeats, warmup):
    """Seconds of each of ``repeats`` calls of ``fn`` after ``warmup``
    calls, each on the host clock between two synchronizes."""
    for _ in range(warmup):
        fn()
    secs = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        secs.append(time.perf_counter() - t0)
    return secs


def summary(secs, unit, work=None):
    """A row's numbers: the median of the repeats and their spread, as
    ``work`` / seconds, or as seconds where ``work`` is None."""
    vals = list(secs) if work is None else [work / s for s in secs]
    return {"value": statistics.median(vals), "unit": unit,
            "min": min(vals), "max": max(vals), "repeats": len(vals),
            "seconds": secs}


def _load_cfg(cfg_file):
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    return load_config(os.path.join(CFG_DIR, cfg_file))


def _ppo(env, name):
    from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
    return process_ppo(env, {"seed": 0, "learn": {}, "policy": {}},
                       logdir=os.path.join(RUN_DIR, name))


def _prior(env, device):
    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    spec = env.task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), device=device)
    env.set_distr(distr)
    return distr


def bench_pendulum(device, w):
    """bench.py's Pendulum row: ``pendulum_steps`` steps of the stochastic
    policy and ``env_step`` at ``pendulum_envs`` envs, episodes of 21,
    mass and length scaled in [0.01, 2]; a repeat loads the reset's state
    and replays the collection step graph once a step."""
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.sim.task import env_full_reset
    from bayes_sim_ig_tpu_torch.utils.collect import (
        collect_step_graph, policy_rl,
    )
    n, steps = w["pendulum_envs"], w["pendulum_steps"]
    scaled = {"range": [0.01, 2.0], "operation": "scaling",
              "distribution": "uniform"}
    cfg = {"env": {"numEnvs": n, "episodeLength": 21}, "bayessim": {},
           "task": {"randomize": True, "randomization_params": {
               "actor_params": {"pendulum": {
                   "rigid_body_properties": {"mass": dict(scaled)},
                   "rigid_shape_properties": {"length": dict(scaled)}}}}}}
    env = make_env("Pendulum", cfg, seed=0, device=device)
    distr = _prior(env, device)
    ppo = _ppo(env, "pendulum")
    state, obs = env_full_reset(env.task, distr, ppo.gen)
    graph = collect_step_graph(env, ppo.policy_apply, policy_rl,
                               env.task.max_episode_length, ppo.net, distr,
                               ppo.gen, state, obs, steps=steps)

    def chain():
        graph.load(state, obs, distr)
        for _ in range(steps):
            graph.step()
    try:
        secs = timed_repeats(chain, device, w["repeats"], w["warmup"])
    finally:
        env.free_step_graphs()
    return summary(secs, "env steps/s (policy + env_step, one graph replay "
                   "a step)", steps * n)


def bench_articulated(task_name, cfg_file, n_envs, ep_len, device, w,
                      env_over=None):
    """One collection round (reset, ``ep_len - 1`` step replays,
    extraction; policy_random, the prior) of ``task_name`` at ``n_envs``
    from the port's copy of ``cfg_file``: (ep_len - 1) x n_envs / seconds
    of a round."""
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.collect import (
        _collect_round, policy_random,
    )
    cfg = _load_cfg(cfg_file)
    cfg["env"]["numEnvs"] = n_envs
    cfg["env"].update(env_over or {})
    env = make_env(task_name, cfg, seed=0, device=device)
    distr = _prior(env, device)
    ppo = _ppo(env, task_name.lower())

    def round_():
        _collect_round(env, ppo.policy_apply, policy_random, ep_len,
                       ppo.net, distr, ppo.gen)
    try:
        secs = timed_repeats(round_, device, w["repeats"], w["warmup"])
    finally:
        env.free_step_graphs()
    return summary(secs, f"env steps/s (a collection round of {ep_len}: "
                   f"reset, {ep_len - 1} step replays, extraction)",
                   (ep_len - 1) * n_envs)


def bench_mdnn(device, w):
    """``MDNN.run_training`` of (rows x 40) -> 2 (10 components, [128,
    128] tanh, lr 1e-4), ``mdnn_updates`` updates of ``mdnn_batch``:
    samples (updates x batch) / seconds of a call."""
    import numpy as np

    from bayes_sim_ig_tpu_torch.models import MDNN
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(w["mdnn_rows"], 40), dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(rs.rand(w["mdnn_rows"], 2), dtype=torch.float32,
                        device=device)
    m = MDNN(input_dim=40, output_dim=2,
             output_lows=np.zeros(2, np.float32),
             output_highs=np.ones(2, np.float32), n_gaussians=10,
             full_covariance=False, hidden_layers=(128, 128),
             activation="tanh", lr=1e-4, device=device)
    n_updates, batch = w["mdnn_updates"], w["mdnn_batch"]
    try:
        secs = timed_repeats(lambda: m.run_training(x, y, n_updates, batch),
                             device, w["repeats"], w["warmup"])
    finally:
        m.free_graphs()
    return summary(secs, "samples/s (the fit graph's updates and its 6 test "
                   "losses)", n_updates * batch)


def bench_adr_iteration(device, w):
    """``bayes_sim_main.main`` on the port's pendulum.yaml, realEvals
    ``adr_evals``, ``adr_ppo_iterations`` PPO iterations an ADR iteration
    and 1 + repeats ADR iterations: the seconds of each from the second on
    (the first captures the graphs)."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(CFG_DIR, "pendulum.yaml"))
    cfg["bayessim"].update(realIters=1 + w["repeats"],
                           realEvals=w["adr_evals"])
    for section, edits in w["adr_cuts"].items():
        cfg[section].update(edits)
    run_dir = os.path.join(RUN_DIR, "adr")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, "pendulum.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["--task", "Pendulum", "--cfg_env", cfg_path, "--logdir",
            os.path.join(run_dir, "logs"), "--max_iterations",
            str(w["adr_ppo_iterations"]), "--seed", "0", "--rl_device",
            str(device), "--headless"]
    with open(os.path.join(run_dir, "loop.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        out = bayes_sim_main.main(argv)
    _sync(device)
    secs = out["iter_secs"]
    row = summary(secs[1:], "s an ADR iteration from the second on (the "
                  f"first: {secs[0]:.3f} s)")
    row["first_s"], row["second_s"] = secs[0], secs[1]
    return row


ROWS = {}


def emit(name, row, run):
    """Prints one row's JSON line, with ``run`` ({"card": ..., "widths":
    ...}), and keeps it for the aggregate."""
    row = {"metric": name, **row, **run}
    print(json.dumps(row), flush=True)
    ROWS[name] = row


def emit_error(name, exc, run):
    """A row that raised: printed with its error (the traceback on
    stderr)."""
    traceback.print_exc(file=sys.stderr)
    emit(name, {"err": f"{type(exc).__name__}: {exc}"[:400]}, run)


def emit_aggregate(run, device):
    """The last line of stdout: every row's median, unit and spread (or
    its error), the card and its power limit."""
    rows = {k: ({"err": v["err"]} if "err" in v else {
        "v": v["value"], "min": v["min"], "max": v["max"], "n": v["repeats"],
        "unit": v["unit"]}) for k, v in ROWS.items()}
    head = rows.get(ARTICULATED[0][0], {})
    print(json.dumps({
        "metric": "all", "value": head.get("v"),
        "unit": "env steps/s (ShadowHand, 16384 envs; rows = all metrics)",
        **run, "device": str(device),
        "failed": [k for k, v in rows.items() if "err" in v],
        "rows": rows}, separators=(",", ":")), flush=True)


def _row_fns(device, w):
    """{row: a function returning its numbers}, in bench.py's order."""
    fns = {"pendulum_env_steps_per_sec_4096envs":
           lambda: bench_pendulum(device, w)}
    for name, task, cfg_file, edits, envs in ARTICULATED + [FULL_STATE]:
        n = w[envs] if isinstance(envs, str) else (w["task_envs"] or envs)
        fns[name] = (lambda task=task, cfg_file=cfg_file, n=n, edits=edits:
                     bench_articulated(task, cfg_file, n, w["ep_len"],
                                       device, w, edits))
    fns["mdnn_train_samples_per_sec"] = lambda: bench_mdnn(device, w)
    fns["pendulum_adr_iteration_sec_warm"] = \
        lambda: bench_adr_iteration(device, w)
    return {name: fns[name] for name in ROW_NAMES}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--tiny", action="store_true",
                   help="a few envs and steps a row: a check of the rows' "
                        "code, not a measurement")
    args = p.parse_args(argv)
    ROWS.clear()
    device = torch.device(args.device)
    w = TINY if args.tiny else FULL
    run = {"card": None, "widths": (
        "tiny: a check of the rows' code, not a measurement" if args.tiny
        else "bench.py's")}
    if device.type == "cuda" and not torch.cuda.is_available():
        run["card"] = "no CUDA card"
        for name in ROW_NAMES:
            emit(name, {"err": "torch.cuda.is_available() is False"}, run)
        emit_aggregate(run, device)
        return 1
    run["card"] = card_name(device)
    if device.type == "cuda":
        # Full float32 products, as on the ADR path.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for name, fn in _row_fns(device, w).items():
        try:
            emit(name, fn(), run)
        except Exception as exc:  # the row's error is its result
            emit_error(name, exc, run)
    emit_aggregate(run, device)
    return 1 if any("err" in v for v in ROWS.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
