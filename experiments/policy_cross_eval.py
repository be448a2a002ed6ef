"""The surrogate-real evaluation of trained ShadowHand policies in both
packages' envs: does the port's env score a policy as the JAX package's
does?

    python experiments/policy_cross_eval.py CKPT [CKPT ...] \\
        [--envs 64] [--device cpu] [--distr real|prior] \\
        [--episode_length N] [--out FILE.json]

Each CKPT is a policy pickle in the JAX package's numpy layout, which both
packages write (``<logdir>/rl_<i>/model_<n>.ckpt``,
``checkpoints/policy_<i>.ckpt``). In each package the script builds ShadowHand from that package's ``cfg/shadow_hand_grasp.yaml`` at
``--envs`` envs, sets the surrogate-real distribution (``realParams``;
``--distr prior``: the uniform prior the control arm trains on), loads
the policy into the package's PPO and runs the ADR loop's evaluation:
one round of ``collect_trajectories(envs, ppo, None)``, whole episodes
(600 steps unless ``--episode_length`` cuts them). It prints each package's episode rewards (mean,
median, min, max) and the two-sided Mann-Whitney U between them: the two packages' noise streams differ, so they are
compared by distribution. The JAX package runs on its default backend,
the port on ``--device``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 0  # the env's and PPO's seed in both packages


def grasp_configs(pkg, envs, episode_length=None):
    """``pkg``'s grasp env config at ``envs`` envs (episodes cut to
    ``episode_length``) and its ShadowHand PPO config."""
    import yaml
    base = os.path.join(ROOT, pkg, "cfg")
    with open(os.path.join(base, "shadow_hand_grasp.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = envs
    if episode_length is not None:
        cfg["env"]["episodeLength"] = episode_length
    with open(os.path.join(base, "train", "ppo_shadow_hand.yaml")) as f:
        cfg_train = yaml.safe_load(f)
    return cfg, cfg_train


def eval_torch(ckpts, envs, device="cpu", prior=False, episode_length=None):
    """{ckpt: episode rewards} in the port's env on ``device``."""
    from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu_torch.rl import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.args import load_real_params
    from bayes_sim_ig_tpu_torch.utils.collect import collect_trajectories
    cfg, cfg_train = grasp_configs("bayes_sim_ig_tpu_torch", envs,
                                   episode_length)
    cfg_train["seed"] = SEED
    env = make_env("ShadowHand", cfg, seed=SEED, device=device)
    spec = env.task.params_spec
    w, m, s = load_real_params(cfg, spec.dim)
    distr = (pdf.Uniform(spec.lows, spec.highs) if prior
             else pdf.MoG(a=w, ms=m, Ss=s))
    env.set_distr(to_device_distr(distr, spec.lows, spec.highs,
                                  device=device))
    ppo = process_ppo(env, cfg_train, os.path.join(ROOT, "runs",
                                                   "policy_cross_eval"),
                      seed=SEED)
    out = {}
    for ckpt in ckpts:
        ppo.load(ckpt)
        rewards = collect_trajectories(envs, ppo, None)[3]
        out[ckpt] = rewards.cpu().numpy().astype(np.float64)
    env.free_step_graphs()
    ppo.free_update_graphs()
    return out


def eval_jax(ckpts, envs, prior=False, episode_length=None):
    """{ckpt: episode rewards} in the JAX package's env."""
    from bayes_sim_ig_tpu.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu.rl import process_ppo
    from bayes_sim_ig_tpu.sim import make_env
    from bayes_sim_ig_tpu.utils.args import load_real_params
    from bayes_sim_ig_tpu.utils.collect import collect_trajectories
    cfg, cfg_train = grasp_configs("bayes_sim_ig_tpu", envs, episode_length)
    cfg_train["seed"] = SEED
    env = make_env("ShadowHand", cfg, seed=SEED)
    spec = env.task.params_spec
    w, m, s = load_real_params(cfg, spec.dim)
    distr = (pdf.Uniform(spec.lows, spec.highs) if prior
             else pdf.MoG(a=w, ms=m, Ss=s))
    env.set_distr(to_device_distr(distr, spec.lows, spec.highs))
    ppo = process_ppo(env, cfg_train, os.path.join(ROOT, "runs",
                                                   "policy_cross_eval"),
                      seed=SEED)
    out = {}
    for ckpt in ckpts:
        ppo.load(ckpt)
        rewards = collect_trajectories(envs, ppo, None)[3]
        out[ckpt] = np.asarray(rewards, np.float64)
    return out


def _line(name, r):
    return (f"{name}: n={len(r)} mean={r.mean():.1f} med={np.median(r):.1f}"
            f" min={r.min():.1f} max={r.max():.1f}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpts", nargs="+")
    p.add_argument("--envs", type=int, default=64)
    p.add_argument("--device", default="cpu")
    p.add_argument("--distr", choices=("real", "prior"), default="real")
    p.add_argument("--episode_length", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from scipy.stats import mannwhitneyu
    prior = args.distr == "prior"
    results = {
        "torch": eval_torch(args.ckpts, args.envs, device=args.device,
                            prior=prior, episode_length=args.episode_length),
        "jax": eval_jax(args.ckpts, args.envs, prior=prior,
                        episode_length=args.episode_length)}
    for ckpt in args.ckpts:
        print(os.path.relpath(ckpt))
        for pkg, res in results.items():
            print("  " + _line(pkg, res[ckpt]))
        p_val = mannwhitneyu(results["torch"][ckpt], results["jax"][ckpt],
                             alternative="two-sided").pvalue
        print(f"  torch vs jax: MWU two-sided p={p_val:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({pkg: {k: v.tolist() for k, v in res.items()}
                       for pkg, res in results.items()}, f)
    return results


if __name__ == "__main__":
    main()
