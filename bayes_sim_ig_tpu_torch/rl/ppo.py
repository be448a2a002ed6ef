"""PPO trainer: clipped surrogate, GAE, adaptive-KL learning rate.

Port of ``bayes_sim_ig_tpu/rl/ppo.py`` (used surface: ``run``, ``load``,
``vec_env``, ``actor_critic.act(obs)``, ``current_learning_iteration``).
One learning iteration is an ``nsteps`` rollout over all envs, GAE, and
``noptepochs x nminibatches`` updates over explicit permutations.

The optimizer is the JAX package's chain written out
(``optax.chain(clip_by_global_norm, scale_by_adam, scale(-1))`` followed
by a multiply by the adaptive lr): ``torch.nn.utils.clip_grad_norm_`` adds
1e-6 to the norm and ``torch.optim.Adam`` folds the lr in, so neither
reproduces it. A minibatch whose loss or gradients are non-finite leaves
both the params and the Adam state unchanged.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from ..parallel.mesh import gather_envs, global_num_envs, is_main_process
from ..sim.task import env_step
from ..utils.convert import (actor_critic_params_from_jax,
                             actor_critic_params_to_jax)
from ..utils.step_graph import StepGraph, distr_key
from . import networks

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def gae_advantages(vals, rews, dones, last_val, gamma, lam):
    """Generalized advantage estimation over a (T, N) rollout with the IG
    done-on-last-step convention: done_t = 1 masks the bootstrap value of
    the post-episode state."""
    advs = torch.empty_like(vals)
    gae = torch.zeros_like(last_val)
    val_next = last_val
    for t in range(vals.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rews[t] + gamma * val_next * nonterminal - vals[t]
        gae = delta + gamma * lam * nonterminal * gae
        advs[t] = gae
        val_next = vals[t]
    return advs


class AdamState(NamedTuple):
    count: torch.Tensor       # () float32 number of applied updates
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


def adam_init(params) -> AdamState:
    return AdamState(
        count=torch.zeros((), device=params[0].device),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def apply_update(params, grads, loss, adam: AdamState, lr, max_grad_norm):
    """clip_by_global_norm -> scale_by_adam -> scale(-lr), in place on
    ``params``; skipped (params and Adam state kept) unless the loss and
    every gradient are finite. Returns the new AdamState."""
    ok = torch.isfinite(loss)
    for g in grads:
        ok = ok & torch.isfinite(g).all()
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = g_norm < max_grad_norm
    grads = [torch.where(clip, g, g / g_norm * max_grad_norm) for g in grads]
    count = adam.count + 1.0
    bc1 = 1.0 - torch.pow(ADAM_B1, count)
    bc2 = 1.0 - torch.pow(ADAM_B2, count)
    new_mu, new_nu = [], []
    for p, g, m, v in zip(params, grads, adam.mu, adam.nu):
        m2 = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v2 = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        p.copy_(torch.where(ok, p + (-upd) * lr, p))
        new_mu.append(torch.where(ok, m2, m))
        new_nu.append(torch.where(ok, v2, v))
    return AdamState(count=torch.where(ok, count, adam.count),
                     mu=new_mu, nu=new_nu)


class _ActorCriticHandle:
    """Exposes the reference's ``actor_critic.act(obs)`` call shape."""

    def __init__(self, ppo: "PPO"):
        self._ppo = ppo

    def act(self, obs, *args):
        return self._ppo.act(obs)

    def act_inference(self, obs):
        return self._ppo.act(obs, deterministic=True)[0]


class PPO:
    """Clipped-surrogate PPO with GAE and optional adaptive-KL LR. The
    policy, the Adam state and the lr live on the env's device."""

    def __init__(self, vec_env, cfg_train: Dict, logdir: str,
                 writer=None, seed: Optional[int] = None):
        self.vec_env = vec_env
        self.task = vec_env.task
        self.device = vec_env.device
        self.logdir = logdir
        self.writer = writer
        learn = cfg_train["learn"]
        policy_cfg = cfg_train.get("policy", {})
        self.gamma = float(learn.get("gamma", 0.99))
        self.lam = float(learn.get("lam", 0.95))
        self.cliprange = float(learn.get("cliprange", 0.2))
        self.ent_coef = float(learn.get("ent_coef", 0.0))
        self.vf_coef = float(learn.get("value_loss_coef", 1.0))
        self.nsteps = int(learn.get("nsteps", 16))
        self.noptepochs = int(learn.get("noptepochs", 8))
        self.nminibatches = int(learn.get("nminibatches", 4))
        self.max_grad_norm = float(learn.get("max_grad_norm", 1.0))
        self.init_lr = float(learn.get("optim_stepsize", 3e-4))
        self.desired_kl = learn.get("desired_kl", None)
        self.schedule = learn.get("schedule", "adaptive"
                                  if self.desired_kl else "fixed")
        self.save_interval = int(learn.get("save_interval", 50))
        self.activation = policy_cfg.get("activation", "elu")
        pi_hid = policy_cfg.get("pi_hid_sizes", [64, 64])
        vf_hid = policy_cfg.get("vf_hid_sizes", [64, 64])
        init_noise_std = float(policy_cfg.get("init_noise_std", 1.0))
        if seed is None:
            seed = int(cfg_train.get("seed", 0))
        # Asymmetric actor-critic (the env config's
        # `asymmetric_observations`): the critic reads the privileged
        # simulator state (task.privileged_state), the actor the
        # DR-noised observations.
        self.asymmetric = bool(getattr(self.task, "asymmetric_observations",
                                       False))
        self._state_dim = (int(self.task.state_dim) if self.asymmetric
                           else 0)
        self._net_spec = (self.task.obs_dim, self.task.act_dim, pi_hid,
                          vf_hid, init_noise_std)
        self.actor_critic = _ActorCriticHandle(self)
        self.reinit(seed)

    def reinit(self, seed: int, logdir: Optional[str] = None, writer=None):
        """Fresh policy/optimizer/iteration counter (the ADR loop restarts
        RL every iteration when ftuneRL is off). The fresh weights and the
        reseeded generator keep the tensors and the generator of the first
        init: the captured steps (``utils/step_graph.py``) read them in
        place."""
        init_gen = torch.Generator().manual_seed(int(seed) + 12345)
        # Every rank draws the same init from the same seed: the env axis
        # never splits the policy.
        net = networks.ActorCritic(
            init_gen, *self._net_spec, activation=self.activation,
            state_dim=self._state_dim).to(self.device)
        if getattr(self, "net", None) is None:
            self.net = net
            self.gen = torch.Generator(device=self.device)
        else:
            with torch.no_grad():
                for p, q in zip(self.net.parameters(), net.parameters()):
                    p.copy_(q)
        self.params = list(self.net.parameters())
        self.adam = adam_init(self.params)
        self.lr = torch.tensor(self.init_lr, device=self.device)
        self.gen.manual_seed(int(seed) + 12345)
        self.current_learning_iteration = 0
        if logdir is not None:
            self.logdir = logdir
        if writer is not None:
            self.writer = writer

    # ------------------------------------------------------------------ #
    def policy_apply(self, net, obs, gen):
        """(net, obs, gen) -> stochastic action: the collection policy."""
        return networks.sample_action(net, obs, gen)[0]

    @torch.no_grad()
    def act(self, obs, deterministic=False):
        """Policy action (unsquashed Gaussian, clipped by the env); returns
        (action, log_prob)."""
        if deterministic:
            return networks.policy_mean(self.net, obs), None
        return networks.sample_action(self.net, obs, self.gen)

    # ------------------------------------------------------------------ #
    def _critic_input(self, env_state, obs):
        """What the critic values: the observations, or the privileged
        state of the envs they came from (asymmetric)."""
        if self.asymmetric:
            return self.task.privileged_state(env_state.task_state,
                                              env_state.params)
        return obs

    @torch.no_grad()
    def rollout(self, distr, env_state, obs):
        """``nsteps`` steps of all envs under the current policy; returns
        (env_state, obs, traj, last_val) with traj a dict of (T, N, ...)
        tensors (with "cin", the critic's inputs, when asymmetric). The
        steps run the rollout's ``StepGraph`` (a CUDA graph replayed a
        step on the card): actions drawn from this trainer's generator,
        the env's draws from the env's."""
        graph = self.rollout_graph(distr, env_state, obs)
        graph.load(env_state, obs, distr)
        for _ in range(self.nsteps):
            graph.step()
        traj = {k: v.clone() for k, v in graph.traj.items()}
        env_state, obs = graph.snapshot()
        last_val = networks.value(self.net,
                                  self._critic_input(env_state, obs))
        return env_state, obs, traj, last_val

    def rollout_graph(self, distr, env_state, obs) -> StepGraph:
        """The rollout's step on static buffers, cached on the env by what
        it reads; ``env_state`` and ``obs`` give the buffers' shapes."""
        env_gen = self.vec_env.gen
        key = ("rollout", self.task.max_episode_length, self.net, self.gen,
               env_gen, self.asymmetric, distr_key(distr))
        graph = self.vec_env.step_graphs.get(key)
        if graph is not None:
            return graph

        def body(state, obs, distr):
            act, logp = networks.sample_action(self.net, obs, self.gen)
            cin = self._critic_input(state, obs)
            val = networks.value(self.net, cin)
            state, obs2, rew, done = env_step(self.task, distr, state, act,
                                              env_gen)
            outs = {"obs": obs, "act": act, "logp": logp, "val": val,
                    "rew": rew, "done": done.float()}
            if self.asymmetric:
                outs["cin"] = cin
            return state, obs2, outs
        n, f32 = self.task.num_envs, torch.float32
        outputs = {"obs": ((n, self.task.obs_dim), f32),
                   "act": ((n, self.task.act_dim), f32),
                   "logp": ((n,), f32), "val": ((n,), f32),
                   "rew": ((n,), f32), "done": ((n,), f32)}
        if self.asymmetric:
            outputs["cin"] = ((n, self._state_dim), f32)
        graph = self.vec_env.step_graphs[key] = StepGraph(
            "rollout", body, env_state, obs, distr, self.nsteps, outputs,
            [self.gen, env_gen])
        return graph

    def loss_fn(self, batch):
        """Clipped surrogate + clipped value loss - entropy bonus; returns
        (total, pg_loss, vf_loss, approx_kl)."""
        net, clip = self.net, self.cliprange
        mean = networks.policy_mean(net, batch["obs"])
        logp = networks.gaussian_logp(batch["act"], mean, net.log_std)
        log_ratio = logp - batch["logp"]
        ratio = torch.exp(log_ratio)
        adv = batch["adv"]
        pg1 = -adv * ratio
        pg2 = -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
        pg_loss = torch.maximum(pg1, pg2).mean()
        v = networks.value(net, batch.get("cin", batch["obs"]))
        val_old, ret = batch["val"], batch["ret"]
        v_clipped = val_old + torch.clamp(v - val_old, -clip, clip)
        vf_loss = 0.5 * torch.maximum((v - ret) ** 2,
                                      (v_clipped - ret) ** 2).mean()
        ent = networks.entropy(net.log_std)
        total = pg_loss + self.vf_coef * vf_loss - self.ent_coef * ent
        # log(ratio) taken as the log-ratio itself: the JAX package's
        # jitted loss gets the same from XLA's log(exp(x)) = x, and a ratio
        # that underflows to 0 then adds -1 - log_ratio, not inf.
        approx_kl = ((ratio - 1.0) - log_ratio).mean()
        return total, pg_loss, vf_loss, approx_kl

    def update_from_traj(self, traj, last_val, perms):
        """GAE, advantage normalization, then one epoch per row of
        ``perms`` ((noptepochs, nsteps * num_envs) permutations), each cut
        into ``nminibatches`` minibatches. Updates the policy, the Adam
        state and the lr in place; returns the iteration's metrics."""
        advs = gae_advantages(traj["val"], traj["rew"], traj["done"],
                              last_val, self.gamma, self.lam)
        rets = advs + traj["val"]
        n = traj["val"].shape[0] * traj["val"].shape[1]

        def flat(x):
            return x.reshape((n,) + x.shape[2:])

        adv = flat(advs)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        data = {"obs": flat(traj["obs"]), "act": flat(traj["act"]),
                "logp": flat(traj["logp"]), "val": flat(traj["val"]),
                "adv": adv, "ret": flat(rets)}
        if "cin" in traj:
            data["cin"] = flat(traj["cin"])
        mb = n // self.nminibatches
        metrics = []
        for perm in perms:
            epoch = []
            for i in range(self.nminibatches):
                ids = perm[i * mb:(i + 1) * mb]
                batch = {k: v[ids] for k, v in data.items()}
                out = self.loss_fn(batch)
                grads = torch.autograd.grad(out[0], self.params)
                self.adam = apply_update(self.params, grads, out[0].detach(),
                                         self.adam, self.lr,
                                         self.max_grad_norm)
                epoch.append(torch.stack([o.detach() for o in out]))
            metrics.append(torch.stack(epoch))
        metrics = torch.stack(metrics)  # (epochs, minibatches, 4)
        if self.schedule == "adaptive" and self.desired_kl is not None:
            kl_last = metrics[-1, :, 3].mean()
            kl = float(self.desired_kl)
            lr = self.lr
            lr = torch.where(kl_last > kl * 2.0,
                             torch.clamp(lr / 1.5, min=1e-6), lr)
            lr = torch.where(kl_last < kl / 2.0,
                             torch.clamp(lr * 1.5, max=1e-2), lr)
            self.lr = lr
        loss_m, pg_m, vf_m, kl_m = metrics.reshape(-1, 4).mean(dim=0)
        return {"loss": loss_m, "pg_loss": pg_m, "vf_loss": vf_m,
                "approx_kl": kl_m, "lr": self.lr,
                "mean_reward": traj["rew"].mean(),
                "mean_episode_done": traj["done"].mean()}

    def train_iteration(self, distr, env_state, obs):
        """Rollout of this rank's envs, all-gathered into the global
        (T, N) batch, then the update, replicated on every rank."""
        env_state, obs, traj, last_val = self.rollout(distr, env_state, obs)
        traj = gather_envs(traj, dim=1)
        last_val = gather_envs(last_val)
        n = self.nsteps * last_val.shape[0]
        perms = torch.stack([
            torch.randperm(n, generator=self.gen, device=self.device)
            for _ in range(self.noptepochs)])
        metrics = self.update_from_traj(traj, last_val, perms)
        return env_state, obs, metrics

    # ------------------------------------------------------------------ #
    def run(self, num_learning_iterations, log_interval=1):
        """Trains until ``current_learning_iteration`` reaches
        ``num_learning_iterations`` (the counter continues in ftuneRL
        mode)."""
        assert self.vec_env._distr is not None, \
            "set the env sampling distribution before training"
        obs = self.vec_env.reset()
        env_state = self.vec_env.state
        distr = self.vec_env._distr
        it = self.current_learning_iteration
        while it < num_learning_iterations:
            t0 = time.perf_counter()
            env_state, obs, metrics = self.train_iteration(distr, env_state,
                                                           obs)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            dt = time.perf_counter() - t0
            metrics["env_steps_per_sec"] = (
                self.nsteps * global_num_envs(self.task.num_envs) / dt)
            it += 1
            self.current_learning_iteration = it
            if self.writer is not None and (it % log_interval == 0
                                            or it == num_learning_iterations):
                for name, v in metrics.items():
                    self.writer.add_scalar(f"rl/{name}", v, it)
            if is_main_process() and (it % self.save_interval == 0
                                      or it == num_learning_iterations):
                self.save(os.path.join(self.logdir, f"model_{it}.ckpt"))
        self.vec_env.state = env_state  # hand the env back
        return self

    # ------------------------------------------------------------------ #
    def save(self, path):
        """Pickles the policy as numpy in the JAX package's layout."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {
            "params": actor_critic_params_to_jax(self.net),
            "lr": float(self.lr),
            "iteration": self.current_learning_iteration,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    def load(self, path):
        """Warm start from a checkpoint of either package
        (bayessim.policyCheckpt); the Adam state starts fresh."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self.net.load_state_dict(
            actor_critic_params_from_jax(payload["params"]))
        self.adam = adam_init(self.params)
        self.lr = torch.tensor(float(payload.get("lr", self.init_lr)),
                               device=self.device)
        self.current_learning_iteration = payload.get("iteration", 0)
        return self


def process_ppo(vec_env, cfg_train, logdir, writer=None, seed=None) -> PPO:
    """Factory matching the reference call shape."""
    return PPO(vec_env, cfg_train, logdir, writer=writer, seed=seed)
