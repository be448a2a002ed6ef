"""Does the PyTorch port's PPO learn like the JAX package's once both see
the same random numbers?

    JAX_PLATFORMS=cpu python experiments/ppo_stream_injection.py [--seeds 0 1 2]

Setup of tests/test_ppo.py::test_ppo_learns_pendulum (64 Pendulum envs at
params pinned to (1, 1), nsteps 64, 5 epochs x 4 minibatches, adaptive-KL
lr from 1e-3 with desired_kl 0.008), 60 PPO iterations per seed. The JAX
package runs its own jitted train iteration. The port runs with every
draw of that iteration injected:

  * the initial actor-critic (JAX's PRNGKey(seed + 12345) draw, converted
    with utils/convert.py);
  * the iteration keys: run() splits the trainer key per iteration
    (rl/ppo.py:339), train_iteration splits it into rollout and
    permutation keys (:314), the rollout into one key per step (:205) and
    each step key into the action-noise key and an env key (:187);
  * the action noise, jax.random.normal(k_act, (N, A)), fed to the port's
    networks.sample_action in place of its generator draw;
  * the minibatch permutations, jax.random.permutation(ep_key, n) per
    epoch (:262, keys from :291), given to the port's update_from_traj;
  * the env: both step the JAX package's Pendulum from the same reset, so
    the env's own resets and param draws (which live in its state key)
    are the same numbers too.

Per iteration it prints the lr of both, the mean approx KL of both, and
the largest |param difference|; at the end the deterministic gain of
both (tests/test_torch_pendulum.py's measure, on the JAX env) and their
medians over the seeds. Writes nothing.

--forced starts every port iteration from the JAX package's params, Adam
state, lr and env state before it, so each row is one iteration's
deviation rather than the drift. --control runs the JAX package against
itself with every initial weight moved by one float32 ulp (the same
draws): the drift that rounding alone grows to.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bayes_sim_ig_tpu.distributions import MoG as JMoG  # noqa: E402
from bayes_sim_ig_tpu.distributions import (  # noqa: E402
    to_device_distr as jdistr)
from bayes_sim_ig_tpu.rl import networks as jnetworks  # noqa: E402
from bayes_sim_ig_tpu.rl import process_ppo as jprocess_ppo  # noqa: E402
from bayes_sim_ig_tpu.sim import make_env as jmake_env  # noqa: E402
from bayes_sim_ig_tpu.sim.task import env_step as jenv_step  # noqa: E402
from bayes_sim_ig_tpu_torch.rl import networks  # noqa: E402
from bayes_sim_ig_tpu_torch.rl.ppo import PPO  # noqa: E402
from bayes_sim_ig_tpu_torch.utils.convert import (  # noqa: E402
    actor_critic_params_from_jax, actor_critic_params_to_jax)

CFG_ENV = {"env": {"numEnvs": 64, "episodeLength": 100},
           "task": {"randomize": True, "randomization_params": {
               "actor_params": {"pendulum": {
                   "rigid_body_properties": {"mass": {
                       "range": [0.01, 2.0], "operation": "scaling",
                       "distribution": "uniform"}},
                   "rigid_shape_properties": {"length": {
                       "range": [0.01, 2.0], "operation": "scaling",
                       "distribution": "uniform"}}}}}}}


def cfg_train(seed, nsteps=64, noptepochs=5):
    return {"seed": seed, "learn": {
        "nsteps": nsteps, "noptepochs": noptepochs, "nminibatches": 4,
        "optim_stepsize": 1e-3, "desired_kl": 0.008, "gamma": 0.95,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [64, 64], "vf_hid_sizes": [64, 64]}}


class _PortShell:
    """The port's PPO update and policy around an externally stepped env:
    PPO.__init__ reads only the task's dims and the device from the env."""

    class _Task:
        asymmetric_observations = False

    def __init__(self, obs_dim, act_dim, num_envs):
        task = self._Task()
        task.obs_dim, task.act_dim, task.num_envs = obs_dim, act_dim, num_envs
        self.task = task
        self.device = torch.device("cpu")


def _load_jax_state(tppo, train_state):
    """Writes the JAX package's params, Adam state and lr into the port
    trainer's tensors (optax chain state: clip, scale_by_adam, scale)."""
    tppo.net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, train_state.params)))
    adam = train_state.opt_state[1]
    names = [k for k, _ in tppo.net.named_parameters()]
    mu = actor_critic_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.mu))
    nu = actor_critic_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             adam.nu))
    # In place: the update's captured programs read these tensors.
    with torch.no_grad():
        tppo.adam.count.fill_(float(adam.count))
        for k, m, v in zip(names, tppo.adam.mu, tppo.adam.nu):
            m.copy_(mu[k])
            v.copy_(nu[k])
        tppo.lr.fill_(float(train_state.lr))


def paired_run(seed, iters, cfg_env=CFG_ENV, train=None, log=print,
               forced=False):
    """Runs the JAX PPO and the port's with JAX's draws injected for
    ``iters`` iterations; returns per-iteration rows (lr_j, lr_t, kl_j,
    kl_t, max |dparam|) and the two final param trees (numpy, JAX
    layout). ``forced``: each port iteration starts from the JAX
    package's params, Adam state, lr and env state before that iteration,
    so the rows measure one iteration's deviation, not the drift."""
    train = cfg_train(seed) if train is None else train
    env = jmake_env("Pendulum", cfg_env, seed=seed)
    spec = env.task.params_spec
    env.set_distr(jdistr(JMoG(a=[1.0], ms=[np.ones(2)],
                              Ss=[np.eye(2) * 1e-10]),
                         spec.lows, spec.highs))
    jppo = jprocess_ppo(env, train, logdir="")
    task = env.task
    n_envs, act_dim = task.num_envs, task.act_dim
    tppo = PPO(_PortShell(task.obs_dim, act_dim, n_envs), train, logdir="")
    tppo.net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jppo.train_state.params)))
    nsteps, noptepochs = jppo.nsteps, jppo.noptepochs
    step = jax.jit(jenv_step, static_argnames=("task",
                                               "max_episode_length"))
    train_iter = jppo._build_train_iteration()
    obs = env.reset()
    j_state, j_obs = env.state, obs
    t_state, t_obs = env.state, obs
    distr = env._distr
    key = jppo._key
    rows = []
    injected = {}

    def injected_draw(draw, shape, generator, env_dim=0, **kwargs):
        return injected.pop("eps")

    orig_draw = networks.env_draw
    networks.env_draw = injected_draw
    try:
        for it in range(iters):
            key, k = jax.random.split(key)
            if forced:
                _load_jax_state(tppo, jppo.train_state)
                t_state, t_obs = j_state, j_obs
            # The JAX package's own iteration.
            jppo.train_state, j_state, j_obs, jm = train_iter(
                jppo.train_state, distr, j_state, j_obs, k)
            # The port's, with the same draws.
            k_roll, k_perm = jax.random.split(k)
            steps = {x: [] for x in ("obs", "act", "logp", "val", "rew",
                                     "done")}
            for step_key in jax.random.split(k_roll, nsteps):
                k_act, _ = jax.random.split(step_key)
                obs_t = torch.from_numpy(np.asarray(t_obs))
                injected["eps"] = torch.from_numpy(np.asarray(
                    jax.random.normal(k_act, (n_envs, act_dim))))
                with torch.no_grad():
                    act, logp = networks.sample_action(tppo.net, obs_t,
                                                       None)
                    val = networks.value(tppo.net, obs_t)
                t_state, t_obs, rew, done = step(
                    task, distr, t_state, jnp.asarray(act.numpy()))
                for x, v in zip(steps, (obs_t, act, logp, val,
                                        torch.from_numpy(np.asarray(rew)),
                                        torch.from_numpy(np.asarray(
                                            done, np.float32)))):
                    steps[x].append(v)
            traj = {x: torch.stack(v) for x, v in steps.items()}
            with torch.no_grad():
                last_val = networks.value(
                    tppo.net, torch.from_numpy(np.asarray(t_obs)))
            n = nsteps * n_envs
            perms = torch.from_numpy(np.stack([
                np.asarray(jax.random.permutation(ep_key, n))
                for ep_key in jax.random.split(k_perm, noptepochs)]))
            tm = tppo.update_from_traj(traj, last_val, perms.long())
            tparams = actor_critic_params_to_jax(tppo.net)
            jparams = jax.tree_util.tree_map(np.asarray,
                                             jppo.train_state.params)
            dmax = max(float(np.abs(a - b).max()) for a, b in zip(
                jax.tree_util.tree_leaves(jparams),
                jax.tree_util.tree_leaves(tparams)))
            row = (float(jm["lr"]), float(tm["lr"]), float(jm["approx_kl"]),
                   float(tm["approx_kl"]), dmax)
            rows.append(row)
            log(f"  it {it + 1:2d}: lr jax {row[0]:.6g} port {row[1]:.6g}"
                f"  kl jax {row[2]:.6g} port {row[3]:.6g}"
                f"  max|dparam| {dmax:.3g}")
    finally:
        networks.env_draw = orig_draw
    return rows, jparams, tparams


def jax_control(seed, iters, log=print):
    """The JAX package against itself from initial weights one ulp apart,
    same keys and env; rows and final params as ``paired_run``'s."""
    train = cfg_train(seed)
    env = jmake_env("Pendulum", CFG_ENV, seed=seed)
    spec = env.task.params_spec
    env.set_distr(jdistr(JMoG(a=[1.0], ms=[np.ones(2)],
                              Ss=[np.eye(2) * 1e-10]),
                         spec.lows, spec.highs))
    jppo = jprocess_ppo(env, train, logdir="")
    train_iter = jppo._build_train_iteration()
    a = jppo.train_state
    b = a._replace(params=jax.tree_util.tree_map(
        lambda x: jnp.nextafter(x, jnp.inf), a.params))
    obs = env.reset()
    sa = sb = env.state
    oa = ob = obs
    distr, key, rows = env._distr, jppo._key, []
    for it in range(iters):
        key, k = jax.random.split(key)
        a, sa, oa, ma = train_iter(a, distr, sa, oa, k)
        b, sb, ob, mb = train_iter(b, distr, sb, ob, k)
        dmax = max(float(jnp.abs(x - y).max()) for x, y in zip(
            jax.tree_util.tree_leaves(a.params),
            jax.tree_util.tree_leaves(b.params)))
        row = (float(ma["lr"]), float(mb["lr"]), float(ma["approx_kl"]),
               float(mb["approx_kl"]), dmax)
        rows.append(row)
        log(f"  it {it + 1:2d}: lr {row[0]:.6g} / {row[1]:.6g}  kl "
            f"{row[2]:.6g} / {row[3]:.6g}  max|dparam| {dmax:.3g}")
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return rows, to_np(a.params), to_np(b.params)


def deterministic_gain(params, before_params, activation="elu", seed=0):
    """tests/test_torch_pendulum.py's measure on the JAX env: the mean step
    reward of the deterministic policy over 60 steps, after minus before.
    Both packages' params go through the same JAX policy here."""
    env = jmake_env("Pendulum", CFG_ENV, seed=seed)
    spec = env.task.params_spec
    env.set_distr(jdistr(JMoG(a=[1.0], ms=[np.ones(2)],
                              Ss=[np.eye(2) * 1e-10]),
                         spec.lows, spec.highs))

    def reward(p):
        obs = env.reset()
        tot = 0.0
        for _ in range(60):
            act = jnetworks.policy_mean(p, obs, activation)
            obs, rew, _, _ = env.step(act)
            tot += float(np.asarray(rew).mean())
        return tot / 60

    return reward(params) - reward(before_params)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--forced", action="store_true",
                    help="start every port iteration from the JAX state")
    ap.add_argument("--control", action="store_true",
                    help="the JAX package against itself, weights 1 ulp "
                         "apart")
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    other = "JAX, weights +1 ulp" if args.control else "port with JAX's draws"
    gains = []
    for seed in args.seeds:
        print(f"seed {seed}:", flush=True)
        if args.control:
            rows, jparams, tparams = jax_control(seed, args.iters)
        else:
            rows, jparams, tparams = paired_run(seed, args.iters,
                                                forced=args.forced)
        rows = np.asarray(rows)
        lr_same = int((rows[:, 0] == rows[:, 1]).sum())
        lr_rel = np.abs(rows[:, 1] / rows[:, 0] - 1.0).max()
        kl_rel = np.abs(rows[:, 2] - rows[:, 3]) / np.abs(rows[:, 2])
        print(f"seed {seed}: lr equal in {lr_same}/{len(rows)} iterations "
              f"(largest relative difference {lr_rel:.3g}); "
              f"KL relative difference max {kl_rel.max():.3g} (iteration "
              f"{int(kl_rel.argmax()) + 1}); max|dparam| first "
              f"{rows[0, 4]:.3g}, at 10 {rows[min(9, len(rows) - 1), 4]:.3g}"
              f", last {rows[-1, 4]:.3g}", flush=True)
        init = jax.tree_util.tree_map(
            np.asarray, jprocess_ppo(
                jmake_env("Pendulum", CFG_ENV, seed=seed), cfg_train(seed),
                logdir="").train_state.params)
        gains.append((deterministic_gain(jparams, init),
                      deterministic_gain(tparams, init)))
        print(f"seed {seed}: deterministic gain, JAX {gains[-1][0]:.4f}, "
              f"{other} {gains[-1][1]:.4f}", flush=True)
    g = np.asarray(gains)
    print(f"median gain over seeds {args.seeds}: JAX {np.median(g[:, 0]):.4f}"
          f", {other} {np.median(g[:, 1]):.4f}; median |difference| "
          f"{np.median(np.abs(g[:, 0] - g[:, 1])):.4f}", flush=True)


if __name__ == "__main__":
    main()
