"""PPO on ShadowHand's grasp config in both packages from the same seeds,
at a depth the CPU can run: does the port's training learn what the JAX
package's does?

    python experiments/ppo_train_compare.py [--envs 256] [--iters 50] \\
        [--seeds 0 1 2] [--device cpu] [--episode_length N] \\
        [--out FILE.json]

For each package and seed: ShadowHand from the package's
``cfg/shadow_hand_grasp.yaml`` at ``--envs`` envs, params drawn from the
uniform prior (the control arm's training), the package's PPO
(``cfg/train/ppo_shadow_hand.yaml``) run for ``--iters`` iterations with
every iteration's metrics recorded (``rl/*``), then the ADR loop's
evaluation at ``realParams`` over one round of whole episodes. Prints
each run's mean reward a step at a few iterations and its evaluation,
and, pooled over the seeds, the two-sided Mann-Whitney U of the
packages' evaluation rewards, of their seeds' evaluation means (one
policy's episodes are not independent: this is the test by policy) and
of their seeds' mean reward a step over the last 10 iterations: the packages' random streams differ, so they are
compared by distribution. The JAX package runs on its default backend,
the port on ``--device``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from policy_cross_eval import grasp_configs  # noqa: E402


class _Curves:
    """A writer that keeps every scalar by tag."""

    def __init__(self):
        self.tags = collections.defaultdict(list)

    def add_scalar(self, tag, value, step, *args, **kwargs):
        self.tags[tag].append(float(value))

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def train(pkg, seed, envs, iters, device="cpu", episode_length=None):
    """(the ``rl/*`` curves, the evaluation's episode rewards, seconds);
    ``episode_length`` cuts the episodes (600 steps)."""
    if pkg == "torch":
        from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
        from bayes_sim_ig_tpu_torch.rl import process_ppo
        from bayes_sim_ig_tpu_torch.sim import make_env
        from bayes_sim_ig_tpu_torch.utils.args import load_real_params
        from bayes_sim_ig_tpu_torch.utils.collect import collect_trajectories
        place = {"device": device}
    else:
        from bayes_sim_ig_tpu.distributions import pdf, to_device_distr
        from bayes_sim_ig_tpu.rl import process_ppo
        from bayes_sim_ig_tpu.sim import make_env
        from bayes_sim_ig_tpu.utils.args import load_real_params
        from bayes_sim_ig_tpu.utils.collect import collect_trajectories
        place = {}
    cfg, cfg_train = grasp_configs(
        "bayes_sim_ig_tpu_torch" if pkg == "torch" else "bayes_sim_ig_tpu",
        envs, episode_length)
    cfg_train["seed"] = seed
    env = make_env("ShadowHand", cfg, seed=seed, **place)
    spec = env.task.params_spec
    env.set_distr(to_device_distr(pdf.Uniform(spec.lows, spec.highs),
                                  spec.lows, spec.highs, **place))
    curves = _Curves()
    ppo = process_ppo(env, cfg_train, os.path.join(
        ROOT, "runs", "ppo_train_compare", f"{pkg}_s{seed}"),
        writer=curves, seed=seed)
    t0 = time.perf_counter()
    ppo.run(num_learning_iterations=iters, log_interval=1)
    secs = time.perf_counter() - t0
    w, m, s = load_real_params(cfg, spec.dim)
    env.set_distr(to_device_distr(pdf.MoG(a=w, ms=m, Ss=s), spec.lows,
                                  spec.highs, **place))
    rewards = collect_trajectories(envs, ppo, None)[3]
    rewards = np.asarray(rewards.cpu() if pkg == "torch" else rewards,
                         np.float64)
    if pkg == "torch":
        env.free_step_graphs()
        ppo.free_update_graphs()
    return dict(curves.tags), rewards, secs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--device", default="cpu")
    p.add_argument("--episode_length", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from scipy.stats import mannwhitneyu
    runs = {}
    for pkg in ("torch", "jax"):
        for seed in args.seeds:
            curves, rewards, secs = train(pkg, seed, args.envs, args.iters,
                                          args.device, args.episode_length)
            runs[(pkg, seed)] = (curves, rewards)
            rew = curves["rl/mean_reward"]
            marks = sorted({0, len(rew) // 4, len(rew) // 2, len(rew) - 1})
            print(f"{pkg} seed {seed}: {args.iters} PPO iterations in "
                  f"{secs:.1f} s; mean reward a step "
                  + ", ".join(f"it {i + 1} {rew[i]:.3f}" for i in marks)
                  + f"; lr {curves['rl/lr'][-1]:.2e}; evaluation n="
                  f"{len(rewards)} mean={rewards.mean():.1f} "
                  f"med={np.median(rewards):.1f}", flush=True)
    for what, pick in (
            ("evaluation rewards", lambda c, r: r),
            ("evaluation means (one a seed)", lambda c, r: r.mean()[None]),
            ("last 10 iterations' mean reward a step (one a seed)",
             lambda c, r: np.mean(c["rl/mean_reward"][-10:])[None])):
        pooled = {pkg: np.concatenate([pick(*runs[(pkg, s)])
                                       for s in args.seeds])
                  for pkg in ("torch", "jax")}
        p_val = mannwhitneyu(pooled["torch"], pooled["jax"],
                             alternative="two-sided").pvalue
        print(f"pooled {what}: torch mean {pooled['torch'].mean():.3f}, "
              f"jax mean {pooled['jax'].mean():.3f}; MWU two-sided "
              f"p={p_val:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({f"{pkg}_s{seed}": {"curves": c,
                                          "rewards": r.tolist()}
                       for (pkg, seed), (c, r) in runs.items()}, f)
    return runs


if __name__ == "__main__":
    main()
