"""CLI args and config loading for BayesSim runs.

Replaces the reference's argparse-over-rlgpu shim
(``bayes_sim_ig/utils/args.py``): env yaml schema is
honored unchanged (env / sim / bayessim / task sections; the reference's
12 task configs parse as-is), train yaml carries our PPO hyperparameters
(the reference took them from Isaac Gym's rlpt config tree, args.py:46-58).
Function/class names in configs resolve through explicit registries, never
``eval``.
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

SUPPORTED_TASKS = ["Ant", "Anymal", "BallBalance", "Cartpole",
                   "FrankaCabinet", "Humanoid", "Ingenuity", "Pendulum",
                   "Quadcopter", "ShadowHand"]

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def snake_case(task_name: str) -> str:
    return "_".join(re.findall("[A-Z][^A-Z]*", task_name)).lower()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "BayesSimIG-TPU-Torch",
        description="Adaptive domain randomization in PyTorch")
    p.add_argument("--task", required=True,
                   help=f"one of {SUPPORTED_TASKS} or any task registered "
                        "via --task_module")
    p.add_argument("--task_module", default=None,
                   help="importable module that registers custom tasks "
                        "(calls bayes_sim_ig_tpu_torch.sim.register_task)")
    p.add_argument("--logdir", default="runs/bsim_torch")
    p.add_argument("--max_iterations", type=int, default=20,
                   help="RL learning iterations per ADR iteration")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--headless", action="store_true",
                   help="accepted for reference-CLI parity (rendering is "
                        "always offscreen on TPU)")
    p.add_argument("--cfg_env", default=None)
    p.add_argument("--cfg_train", default=None)
    p.add_argument("--num_envs", type=int, default=None,
                   help="override env count from the config")
    p.add_argument("--episode_length", type=int, default=None)
    # The reference's device flags (README.md:212-217) place every env and
    # model tensor. The env and the learners share one device.
    p.add_argument("--rl_device", default="cuda:0",
                   help="torch device of the models and the envs")
    p.add_argument("--sim_device", default=None,
                   help="torch device of the envs (default: --rl_device; "
                        "must equal it)")
    p.add_argument("--profile", action="store_true",
                   help="wrap the first ADR iteration in a torch.profiler "
                        "trace written to <logdir>/profile")
    p.add_argument("--resume", action="store_true",
                   help="resume the ADR loop from the latest checkpoint "
                        "in the run's logdir")
    return p


def init_args(argv=None):
    """Parses args, loads env/train configs, derives the run logdir
    (reference init_args, args.py:23-68)."""
    args = build_parser().parse_args(argv)
    if args.task_module:
        import importlib
        importlib.import_module(args.task_module)
    from ..sim import NOT_YET_PORTED, available_tasks
    if args.task in NOT_YET_PORTED:
        raise SystemExit(
            f"Task '{args.task}' is not yet ported to bayes_sim_ig_tpu_torch."
            f" Available: {available_tasks()}")
    if args.task not in available_tasks():
        raise SystemExit(
            f"Unknown task '{args.task}'. Available: {available_tasks()} "
            "(register custom tasks via --task_module)")
    pfx = snake_case(args.task)
    if args.cfg_env is None:
        args.cfg_env = os.path.join(_PKG_ROOT, "cfg", pfx + ".yaml")
    if args.cfg_train is None:
        default_train = os.path.join(_PKG_ROOT, "cfg", "train",
                                     "ppo_" + pfx + ".yaml")
        if not os.path.exists(default_train):
            default_train = os.path.join(_PKG_ROOT, "cfg", "train",
                                         "ppo_default.yaml")
        args.cfg_train = default_train
    if args.sim_device is None:
        args.sim_device = args.rl_device
    if args.sim_device != args.rl_device:
        raise SystemExit(f"--sim_device {args.sim_device} differs from "
                         f"--rl_device {args.rl_device}: the envs and the "
                         "learners share one device")
    cfg_env = load_config(args.cfg_env)
    cfg_train = load_config(args.cfg_train)
    assert "bayessim" in cfg_env, \
        f"Need BayesSim section in {args.cfg_env}"
    assert cfg_env["task"]["randomize"], \
        f"Need task.randomize==True in {args.cfg_env}"
    if args.num_envs is not None:
        cfg_env["env"]["numEnvs"] = args.num_envs
    if args.episode_length is not None:
        cfg_env["env"]["episodeLength"] = args.episode_length
    if args.seed is None:
        args.seed = cfg_train.get("seed", 0)
    cfg_train["seed"] = args.seed
    args.logdir = make_logdir_str(args.logdir, args.task, args.seed,
                                  args.max_iterations, cfg_env)
    return args, cfg_env, cfg_train


def load_config(path):
    """Reads a ``.json`` config with json and any other with yaml (imported
    only then, so a json config needs no yaml)."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml
        return yaml.safe_load(f)


def make_logdir_str(pfx, task_name, seed, rl_max_iter, cfg):
    """Self-describing run-dir name, same scheme as the reference
    (args.py:71-83): [Task]_[model]_[ftune]_[summarizer]_[policy]_rl<N>_
    nreal<N>_seed<N>."""
    bs = cfg["bayessim"]
    rest = "_".join([
        task_name, str(bs["modelClass"]),
        "ftune" if bs["ftune"] else "noftune",
        bs["summarizerFxn"], bs["collectPolicy"],
        "rl" + str(rl_max_iter), "nreal" + str(bs["realTrajs"]),
        "seed" + str(seed)])
    return os.path.join(pfx, rest)


def log_args(args, cfg_env, cfg_train, tb_writer):
    """Dumps configs + args as a TensorBoard text blob (args.py:86-107)."""
    lines = []
    for label, cfg in (("cfg_env", cfg_env), ("cfg_train", cfg_train)):
        lines.append(f"\n\n{label}=")
        for k, v in cfg.items():
            if isinstance(v, dict):
                lines.append(f"\n\n..{k}=")
                for k2, v2 in v.items():
                    lines.append(f"\n....{k2}={v2}")
            else:
                lines.append(f"\n\n..{k}={v}")
    lines.append("\n\nargs=")
    for member in vars(args):
        lines.append(f"\n...{member}={getattr(args, member)}")
    all_str = "  ".join(lines)
    print(all_str)
    if tb_writer is not None:
        tb_writer.add_text("BayesSim/cfg", all_str)
    return args


def load_real_params(cfg_env, params_dim):
    """Surrogate-real MoG from the env yaml's realParams section
    (args.py:110-122); scalar entries broadcast to the full param dim."""
    assert "realParams" in cfg_env["env"]
    rp = cfg_env["env"]["realParams"]
    weights = rp["weights"]
    means = [np.asarray(x, np.float64) for x in rp["means"]]
    stds = [np.diag(np.asarray(x, np.float64)) for x in rp["stds"]]
    for i in range(len(means)):
        if means[i].shape[0] == 1:
            means[i] = np.tile(means[i], params_dim)
    for i in range(len(stds)):
        if stds[i].shape[0] == 1:
            stds[i] = np.diag(np.tile(stds[i][0, 0], params_dim))
    return weights, means, stds


def check_distr(distr, lows, highs, msg):
    """Validates that all component means lie inside the param box
    (args.py:125-137)."""
    assert distr.components[0].m.shape[0] == lows.shape[0], \
        f"{msg} dim in yaml should be {lows.shape}, " \
        f"got {distr.components[0].m.shape}"
    for comp in distr.components:
        bad = (comp.m < lows) | (comp.m > highs)
        if bad.any():
            for i in np.nonzero(bad)[0]:
                print(f"{msg} dim {i} mean {comp.m[i]} "
                      f"low {lows[i]} high {highs[i]}")
            raise AssertionError(f"{msg} invalid mean")
