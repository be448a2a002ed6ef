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

An iteration runs as programs on static buffers, as the JAX package's
one jitted iteration: the rollout's steps and the value of its last state
(a ``StepGraph`` and its ``finish``), then the update's three
(``_Update``): the epochs' permutations, GAE and the flat data
(``prepare``), one minibatch step (``minibatch``, called noptepochs x
nminibatches times, its row of the permutations chosen by a counter on
the device), and the adaptive lr (``finish``). ``act`` is one program per
row count (``_Act``). Each is a ``Graphed`` (``utils/step_graph.py``): a
CUDA graph replay on the card, the body on the CPU. The weights, the Adam
state and the lr are written in place, so the graphs keep reading the
trainer's tensors.

While tracing is on (``utils/trace.py``) ``run`` opens a ``ppo.iteration``
span an iteration, with ``ppo.rollout``, ``ppo.update`` and ``ppo.wait``
(the host blocked reading the metrics, the iteration's one sync) in it.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from ..parallel.mesh import gather_envs, global_num_envs, is_main_process
from ..sim.task import env_step
from ..utils import trace
from ..utils.convert import (actor_critic_params_from_jax,
                             actor_critic_params_to_jax)
from ..utils.step_graph import (Graphed, StepGraph, clone_tree, distr_key,
                                trajectory)
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
    ``params`` and on ``adam``'s tensors; skipped (params and Adam state
    kept) unless the loss and every gradient are finite."""
    ok = torch.isfinite(loss)
    for g in grads:
        ok = ok & torch.isfinite(g).all()
    g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = g_norm < max_grad_norm
    grads = [torch.where(clip, g, g / g_norm * max_grad_norm) for g in grads]
    count = adam.count + 1.0
    bc1 = 1.0 - torch.pow(ADAM_B1, count)
    bc2 = 1.0 - torch.pow(ADAM_B2, count)
    for p, g, m, v in zip(params, grads, adam.mu, adam.nu):
        m2 = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v2 = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        p.copy_(torch.where(ok, p + (-upd) * lr, p))
        m.copy_(torch.where(ok, m2, m))
        v.copy_(torch.where(ok, v2, v))
    adam.count.copy_(torch.where(ok, count, adam.count))


class _Update:
    """One update's static buffers and programs for a global (T, N)
    batch: the trajectory, ``last_val`` and the permutations, cut into
    (noptepochs x nminibatches, mb) minibatch rows, are copied in
    (``load``), the permutations drawn by ``prepare`` from the trainer's
    generator instead when ``draw``; ``prepare`` computes GAE, the returns
    and the normalized advantages; each ``minibatch`` call takes row ``t``
    (a counter on the device), its loss, gradients and in-place update,
    and writes ``metrics[t]``; ``finish`` adapts the lr in place and
    writes the iteration's means into ``summary``."""

    def __init__(self, ppo: "PPO", steps: int, envs: int, asymmetric: bool,
                 draw: bool):
        dev, f32 = ppo.device, torch.float32
        task = ppo.task
        self.ppo = ppo
        self.epochs, self.minibatches = ppo.noptepochs, ppo.nminibatches
        self.n = steps * envs
        self.mb = self.n // self.minibatches
        widths = {"obs": (task.obs_dim,), "act": (task.act_dim,),
                  "logp": (), "val": (), "rew": (), "done": ()}
        if asymmetric:
            widths["cin"] = (ppo._state_dim,)
        self.traj = {k: torch.empty((steps, envs) + w, dtype=f32, device=dev)
                     for k, w in widths.items()}
        self.last_val = torch.empty(envs, dtype=f32, device=dev)
        self._rows = torch.empty((self.epochs * self.minibatches, self.mb),
                                 dtype=torch.int64, device=dev)
        self.metrics = torch.empty((self.epochs, self.minibatches, 4),
                                   dtype=f32, device=dev)
        # loss, pg_loss, vf_loss, approx_kl, lr, mean_reward,
        # mean_episode_done
        self.summary = torch.empty(7, dtype=f32, device=dev)
        # The flat minibatch sources: views of the trajectory, and the
        # advantages and returns that prepare writes.
        self.data = {k: self.traj[k].view((self.n,) + widths[k])
                     for k in ("obs", "act", "logp", "val")
                     + (("cin",) if asymmetric else ())}
        self.data["adv"] = torch.empty(self.n, dtype=f32, device=dev)
        self.data["ret"] = torch.empty(self.n, dtype=f32, device=dev)
        self._t = torch.zeros(1, dtype=torch.int64, device=dev)
        self._host_t = 0
        self.draw = draw
        self.prepare = Graphed("update", self._prepare, dev,
                               [ppo.gen] if draw else [])
        self.minibatch = Graphed("update", self._minibatch, dev)
        self.finish = Graphed("update", self._finish, dev)

    def _set_rows(self, perms):
        # Minibatch i of epoch e is perms[e, i * mb:(i + 1) * mb].
        e, m, mb = self.epochs, self.minibatches, self.mb
        self._rows.view(e, m, mb).copy_(perms[:, :m * mb].view(e, m, mb))

    def load(self, traj, last_val, perms=None):
        """Copies the iteration's trajectory, ``last_val`` and, unless the
        update draws them, the permutations into the buffers."""
        for k, buf in self.traj.items():
            buf.copy_(traj[k])
        self.last_val.copy_(last_val)
        if not self.draw:
            self._set_rows(perms)
        self._t.zero_()
        self._host_t = 0

    def step(self):
        """One minibatch update (the graph's replay on a card)."""
        if self._host_t >= self.epochs * self.minibatches:
            raise IndexError(f"minibatch {self._host_t} of "
                             f"{self.epochs * self.minibatches}: load the "
                             f"next iteration first")
        self._host_t += 1
        self.minibatch()

    @torch.no_grad()
    def _prepare(self):
        ppo, tr = self.ppo, self.traj
        if self.draw:
            # The epochs' permutations, drawn first: the trainer's
            # generator draws nothing between the rollout and here.
            self._set_rows(torch.stack([
                torch.randperm(self.n, generator=ppo.gen, device=ppo.device)
                for _ in range(self.epochs)]))
        advs = gae_advantages(tr["val"], tr["rew"], tr["done"],
                              self.last_val, ppo.gamma, ppo.lam)
        adv = advs.reshape(self.n)
        self.data["adv"].copy_((adv - adv.mean())
                               / (adv.std(correction=0) + 1e-8))
        self.data["ret"].copy_((advs + tr["val"]).reshape(self.n))

    def _minibatch(self):
        ppo = self.ppo
        ids = self._rows.index_select(0, self._t).view(self.mb)
        out = ppo.loss_fn({k: v[ids] for k, v in self.data.items()})
        grads = torch.autograd.grad(out[0], ppo.params)
        apply_update(ppo.params, grads, out[0].detach(), ppo.adam, ppo.lr,
                     ppo.max_grad_norm)
        with torch.no_grad():
            self.metrics.view(-1, 4).index_copy_(
                0, self._t, torch.stack([o.detach() for o in out])[None])
            self._t.add_(1)

    @torch.no_grad()
    def _finish(self):
        ppo, metrics = self.ppo, self.metrics
        if ppo.schedule == "adaptive" and ppo.desired_kl is not None:
            kl_last = metrics[-1, :, 3].mean()
            kl = float(ppo.desired_kl)
            lr = ppo.lr
            lr = torch.where(kl_last > kl * 2.0,
                             torch.clamp(lr / 1.5, min=1e-6), lr)
            lr = torch.where(kl_last < kl / 2.0,
                             torch.clamp(lr * 1.5, max=1e-2), lr)
            ppo.lr.copy_(lr)
        self.summary.copy_(torch.cat([
            metrics.reshape(-1, 4).mean(dim=0), ppo.lr[None],
            self.traj["rew"].mean()[None], self.traj["done"].mean()[None]]))

    def free(self):
        for program in (self.prepare, self.minibatch, self.finish):
            program.free()


class _Act:
    """``PPO.act`` on static buffers for ``rows`` observations, as one
    program (phase "act"): the JAX package's ``_act_fn`` (an action drawn
    from the trainer's generator, and its log-probability) or, when
    ``deterministic``, its ``_mean_fn``. Returns copies."""

    def __init__(self, ppo: "PPO", rows: int, deterministic: bool):
        dev, task = ppo.device, ppo.task
        self._ppo = ppo
        self.obs = torch.zeros(rows, task.obs_dim, device=dev)
        self.act = torch.empty(rows, task.act_dim, device=dev)
        self.logp = None if deterministic else torch.empty(rows, device=dev)
        self._program = Graphed("act", self._run, dev,
                                [] if deterministic else [ppo.gen])

    def _run(self):
        with torch.no_grad():
            net = self._ppo.net
            if self.logp is None:
                self.act.copy_(networks.policy_mean(net, self.obs))
                return
            act, logp = networks.sample_action(net, self.obs, self._ppo.gen)
            self.act.copy_(act)
            self.logp.copy_(logp)

    def __call__(self, obs):
        self.obs.copy_(obs)
        self._program()
        return (self.act.clone(),
                None if self.logp is None else self.logp.clone())

    def free(self):
        self._program.free()


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
        init, and the fresh Adam state and lr are written into the first
        init's: the captured steps and updates (``utils/step_graph.py``)
        read them in place."""
        init_gen = torch.Generator().manual_seed(int(seed) + 12345)
        # Every rank draws the same init from the same seed: the env axis
        # never splits the policy.
        net = networks.ActorCritic(
            init_gen, *self._net_spec, activation=self.activation,
            state_dim=self._state_dim).to(self.device)
        if getattr(self, "net", None) is None:
            self.net = net
            self.gen = torch.Generator(device=self.device)
            self.params = list(self.net.parameters())
            self.adam = adam_init(self.params)
            self.lr = torch.tensor(self.init_lr, device=self.device)
            self._updates: Dict[tuple, _Update] = {}
            self._acts: Dict[tuple, _Act] = {}
        else:
            with torch.no_grad():
                for p, q in zip(self.net.parameters(), net.parameters()):
                    p.copy_(q)
            self._reset_optimizer(self.init_lr)
        self.gen.manual_seed(int(seed) + 12345)
        self.current_learning_iteration = 0
        if logdir is not None:
            self.logdir = logdir
        if writer is not None:
            self.writer = writer

    @torch.no_grad()
    def _reset_optimizer(self, lr: float):
        """A fresh Adam state and ``lr``, written into the trainer's
        tensors."""
        self.adam.count.zero_()
        for m in self.adam.mu + self.adam.nu:
            m.zero_()
        self.lr.fill_(lr)

    # ------------------------------------------------------------------ #
    def policy_apply(self, net, obs, gen):
        """(net, obs, gen) -> stochastic action: the collection policy."""
        return networks.sample_action(net, obs, gen)[0]

    def act(self, obs, deterministic=False):
        """Policy action (unsquashed Gaussian, clipped by the env); returns
        (action, log_prob), log_prob None when ``deterministic`` (the
        mean). One program for each row count (``_Act``)."""
        key = (obs.shape[0], bool(deterministic))
        if key not in self._acts:
            self._acts[key] = _Act(self, *key)
        return self._acts[key](obs)

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
        (env_state, obs, traj, last_val), copies of the rollout's buffers,
        with traj a dict of (T, N, ...) tensors (with "cin", the critic's
        inputs, when asymmetric)."""
        graph = self._rollout(distr, env_state, obs)
        env_state, obs = graph.snapshot()
        return (env_state, obs, {k: v.clone() for k, v in graph.traj.items()},
                graph.final["last_val"].clone())

    def _rollout(self, distr, env_state, obs) -> StepGraph:
        """The rollout's programs (CUDA graph replays on the card): the
        ``nsteps`` steps of its ``StepGraph`` (actions drawn from this
        trainer's generator, the env's draws from the env's), then the
        value of the last state (``final["last_val"]``). Returns the graph,
        whose buffers hold the rollout until the next one."""
        graph = self.rollout_graph(distr, env_state, obs)
        graph.load(env_state, obs, distr)
        for _ in range(self.nsteps):
            graph.step()
        graph.finish()
        return graph

    def rollout_graph(self, distr, env_state, obs) -> StepGraph:
        """The rollout's step and last value on static buffers, cached on
        the env by what they read; ``env_state`` and ``obs`` give the
        buffers' shapes."""
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

        def last_val(state, obs):
            return {"last_val": networks.value(self.net,
                                               self._critic_input(state, obs))}
        graph = self.vec_env.step_graphs[key] = StepGraph(
            "rollout", body, env_state, obs, distr,
            trajectory(self.nsteps, outputs, self.device),
            [self.gen, env_gen], finish=last_val,
            final={"last_val": ((n,), f32)})
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

    def update_from_traj(self, traj, last_val, perms=None):
        """GAE, advantage normalization, then one epoch per row of
        ``perms`` ((noptepochs, nsteps * num_envs) permutations; None:
        drawn from the trainer's generator by the update's first program),
        each cut into ``nminibatches`` minibatches. Updates the policy, the
        Adam state and the lr in place; returns the iteration's metrics.
        Runs ``update_program``'s programs (CUDA graph replays on the
        card)."""
        update = self.update_program(traj, last_val, draw=perms is None)
        update.load(traj, last_val, perms)
        update.prepare()
        for _ in range(self.noptepochs * self.nminibatches):
            update.step()
        update.finish()
        summary = update.summary.clone()
        return dict(zip(("loss", "pg_loss", "vf_loss", "approx_kl", "lr",
                         "mean_reward", "mean_episode_done"), summary))

    def update_program(self, traj, last_val, draw: bool = False) -> _Update:
        """The update's buffers and programs for this global batch shape,
        drawing the permutations or not, cached until
        ``free_update_graphs``."""
        steps, envs = traj["val"].shape
        key = (steps, envs, "cin" in traj, draw)
        if key not in self._updates:
            self._updates[key] = _Update(self, *key)
        return self._updates[key]

    def free_update_graphs(self):
        """Drops the update's and ``act``'s captured programs and their
        memory pools."""
        for program in [*self._updates.values(), *self._acts.values()]:
            program.free()
        self._updates.clear()
        self._acts.clear()

    def train_iteration(self, distr, env_state, obs):
        """Rollout of this rank's envs, all-gathered into the global
        (T, N) batch, then the update (its permutations drawn by its first
        program), replicated on every rank. Returns the rollout's state and
        observation buffers, which its next call overwrites, and the
        metrics."""
        with trace.span("ppo.rollout"):
            graph = self._rollout(distr, env_state, obs)
        with trace.span("ppo.update"):
            metrics = self.update_from_traj(
                gather_envs(graph.traj, dim=1),
                gather_envs(graph.final["last_val"]))
        return graph.state, graph.obs, metrics

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
            with trace.span("ppo.iteration", iteration=it):
                t0 = time.perf_counter()
                env_state, obs, metrics = self.train_iteration(
                    distr, env_state, obs)
                with trace.span("ppo.wait"):
                    metrics = {k: float(v)
                               for k, v in metrics.items()}  # syncs
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
        self.vec_env.state = clone_tree(env_state)  # hand the env back
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
        self._reset_optimizer(float(payload.get("lr", self.init_lr)))
        self.current_learning_iteration = payload.get("iteration", 0)
        return self


def process_ppo(vec_env, cfg_train, logdir, writer=None, seed=None) -> PPO:
    """Factory matching the reference call shape."""
    return PPO(vec_env, cfg_train, logdir, writer=writer, seed=seed)
