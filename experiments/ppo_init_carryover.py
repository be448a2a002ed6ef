"""Does the PyTorch port's lower deterministic Pendulum PPO gain come from
its initial network draws?

    JAX_PLATFORMS=cpu python experiments/ppo_init_carryover.py [--seeds 0 1 2 3 4]

Runs the gain of tests/test_torch_pendulum.py::_ppo_gain (64 Pendulum
envs at params pinned to (1, 1); the deterministic policy's mean step
reward over 60 steps, after minus before 60 PPO iterations) on the port
twice per seed: with the port's own initial actor-critic, and with the
JAX package's initial params for the same seed (bayes_sim_ig_tpu/rl/
ppo.py draws them from PRNGKey(seed + 12345)), carried over with
utils/convert.py::actor_critic_params_from_jax. Everything else (env
resets, action noise, minibatch order) stays on the port's torch
generators. With --jax it runs the same gain on the JAX package itself
instead (its PPO, its env, its random streams). Prints one line per seed
and the median.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402

from bayes_sim_ig_tpu.rl import networks as jax_networks  # noqa: E402
from bayes_sim_ig_tpu_torch.distributions import (  # noqa: E402
    MoG, to_device_distr,
)
from bayes_sim_ig_tpu_torch.rl import process_ppo  # noqa: E402
from bayes_sim_ig_tpu_torch.sim import make_env  # noqa: E402
from bayes_sim_ig_tpu_torch.utils.convert import (  # noqa: E402
    actor_critic_params_from_jax,
)

CFG_ENV = {"env": {"numEnvs": 64, "episodeLength": 100},
           "task": {"randomize": True, "randomization_params": {
               "actor_params": {"pendulum": {
                   "rigid_body_properties": {"mass": {
                       "range": [0.01, 2.0], "operation": "scaling",
                       "distribution": "uniform"}},
                   "rigid_shape_properties": {"length": {
                       "range": [0.01, 2.0], "operation": "scaling",
                       "distribution": "uniform"}}}}}}}


def _cfg_train(seed):
    return {"seed": seed, "learn": {
        "nsteps": 64, "noptepochs": 5, "nminibatches": 4,
        "optim_stepsize": 1e-3, "desired_kl": 0.008, "gamma": 0.95,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [64, 64], "vf_hid_sizes": [64, 64]}}


def _gain(env, ppo) -> float:
    def eval_reward():
        obs = env.reset()
        tot = 0.0
        for _ in range(60):
            act, _ = ppo.act(obs, deterministic=True)
            obs, rew, _, _ = env.step(act)
            tot += float(np.asarray(rew).mean())
        return tot / 60

    before = eval_reward()
    ppo.run(num_learning_iterations=60, log_interval=1000)
    return eval_reward() - before


def jax_gain(seed: int, logdir: str) -> float:
    """The same gain on the JAX package (tests/test_ppo.py's setup)."""
    from bayes_sim_ig_tpu.distributions import MoG as JMoG
    from bayes_sim_ig_tpu.distributions import to_device_distr as jdistr
    from bayes_sim_ig_tpu.rl import process_ppo as jprocess_ppo
    from bayes_sim_ig_tpu.sim import make_env as jmake_env
    env = jmake_env("Pendulum", CFG_ENV, seed=seed)
    spec = env.task.params_spec
    env.set_distr(jdistr(JMoG(a=[1.0], ms=[np.ones(2)],
                              Ss=[np.eye(2) * 1e-10]),
                         spec.lows, spec.highs))
    return _gain(env, jprocess_ppo(env, _cfg_train(seed), logdir=logdir))


def gain(seed: int, jax_init: bool, logdir: str) -> float:
    env = make_env("Pendulum", CFG_ENV, seed=seed)
    spec = env.task.params_spec
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[np.ones(2)], Ss=[np.eye(2) * 1e-10]),
        spec.lows, spec.highs, device="cpu"))
    ppo = process_ppo(env, _cfg_train(seed), logdir=logdir)
    if jax_init:
        key = jax.random.split(jax.random.PRNGKey(seed + 12345))[1]
        params = jax_networks.init_actor_critic(
            key, env.task.obs_dim, env.task.act_dim, [64, 64], [64, 64], 1.0)
        ppo.net.load_state_dict(actor_critic_params_from_jax(
            jax.tree_util.tree_map(np.asarray, params)))
    return _gain(env, ppo)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--jax", action="store_true",
                    help="run the JAX package's own gain instead")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    own, carried = [], []
    with tempfile.TemporaryDirectory() as tmp:
        if args.jax:
            gains = [jax_gain(s, os.path.join(tmp, f"j{s}")) for s in args.seeds]
            for s, g in zip(args.seeds, gains):
                print(f"seed {s}: the JAX package's gain {g:.3f}", flush=True)
            print(f"median over seeds {args.seeds}: {np.median(gains):.3f}")
            return
        for seed in args.seeds:
            own.append(gain(seed, False, os.path.join(tmp, f"own{seed}")))
            carried.append(gain(seed, True, os.path.join(tmp, f"jax{seed}")))
            print(f"seed {seed}: gain with the port's init {own[-1]:.3f}, "
                  f"with the JAX package's init {carried[-1]:.3f}",
                  flush=True)
    print(f"median over seeds {args.seeds}: port's init "
          f"{np.median(own):.3f}, JAX package's init {np.median(carried):.3f}")


if __name__ == "__main__":
    main()
