"""Round-based rollout collection for BayesSim training and evaluation.

Port of ``bayes_sim_ig_tpu/utils/collect.py``:

  * one "round" = full re-randomized reset of all envs + exactly
    ``max_episode_length - 1`` steps;
  * each env contributes its FIRST episode of the round; episodes that
    early-terminate at step t_done are padded by repeating their last
    state/action;
  * ground-truth param labels are the params sampled at the round's reset;
  * rounds repeat until ``num_trajs`` episodes are banked.

A round runs as programs on static buffers (``_collect_round``): the
reset, the steps and the extraction, each a CUDA graph replay on the card.

Trajectories are stored in float32. Returns (params, states, actions,
rewards, imgs) with states (N, L, S), actions (N, L, A),
L = max_episode_length.

While tracing is on (``utils/trace.py``) a call opens ``collect.round``
and ``collect.gather`` for each round and, when it renders, the copy of
env 0's states to the host (``collect.to_host``, which waits for the
rounds) and the frames (``collect.frames``, with the episode's
``frames`` and whether the task draws them ``batched``). ``STATS`` counts
the env steps every call steps and keeps, and the frames it renders,
tracing on or off.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, Optional

import numpy as np
import torch

from ..parallel.mesh import env_draw, gather_envs, global_num_envs
from ..sim.task import env_step
from . import trace
from .step_graph import Graphed, StepGraph, distr_key, trajectory

# The env steps of this process's ``collect_trajectories`` calls: every
# env of every round steps (``stepped``: rounds x envs x steps), the
# episodes returned keep theirs (``kept``: num_trajs x steps). The frames
# ``_render_env0`` renders (``frames``), and of them those a task's
# ``render_obs_frames`` draws as one batch (``frames_batched``).
STATS = {"stepped": 0, "kept": 0, "frames": 0, "frames_batched": 0}


# --------------------------------------------------------------------- #
# Collection policies: (act, gen) -> act transforms of the RL action.
# --------------------------------------------------------------------- #
def policy_ones(act, gen):
    return torch.ones_like(act)


def policy_random(act, gen):
    # NB: U[0, 1], not U[-1, 1], preserved from the reference.
    return env_draw(torch.rand, act.shape, gen, dtype=act.dtype,
                    device=act.device)


def policy_rl(act, gen):
    return act


def policy_rl_randomized(act, gen, frac_rnd=0.1):
    """With prob frac_rnd (one draw per step, whole batch) replace the
    action tensor with U[-1, 1]."""
    rnd = torch.rand((), generator=gen, device=act.device)
    random_act = env_draw(torch.rand, act.shape, gen, dtype=act.dtype,
                          device=act.device) * 2.0 - 1.0
    return torch.where(rnd < frac_rnd, random_act, act)


def policy_grasp(act, gen, excitation):
    """Drives the task-declared excitation dims to max while the other
    dims jitter around neutral (see the JAX package's policy_grasp).
    ``excitation`` is the (act_dim,) float mask of those dims, 1 on them
    and 0 elsewhere, on the actions' device."""
    jitter = env_draw(torch.rand, act.shape, gen, dtype=act.dtype,
                      device=act.device) * 0.6 - 0.3
    return torch.clamp(excitation + jitter, -1.0, 1.0)


_POLICY_REGISTRY = {
    "policy_ones": policy_ones,
    "policy_random": policy_random,
    "policy_rl": policy_rl,
    "policy_rl_randomized": policy_rl_randomized,
    "policy_grasp": policy_grasp,  # resolved per-task, see below
}


def get_collect_policy(name: Optional[str], task=None):
    """Resolves a collect-policy name to an (act, gen) -> act callable.
    `policy_grasp` reads ``task.grasp_excitation_dims`` and degrades to
    `policy_ones` with a warning for tasks that declare none."""
    if name is None or name == "None":
        return policy_rl
    if name not in _POLICY_REGISTRY:
        raise KeyError(f"Unknown collect policy '{name}'. "
                       f"Available: {sorted(_POLICY_REGISTRY)}")
    if name == "policy_grasp":
        dims = getattr(task, "grasp_excitation_dims", None)
        if dims is None:
            warnings.warn(
                "policy_grasp selected but the task declares no "
                "grasp_excitation_dims; falling back to policy_ones "
                "semantics (the reference's squeeze excitation).")
            return policy_ones
        # The mask is built once: a step indexes no host list.
        excitation = torch.zeros(task.act_dim, device=task.device)
        excitation[list(dims)] = 1.0
        return lambda act, gen: policy_grasp(act, gen, excitation)
    return _POLICY_REGISTRY[name]


# --------------------------------------------------------------------- #
def _postprocess_round(obs0, obs_seq, act_seq, rew_seq, done_seq, labels):
    """Episode extraction + repeat-last padding: x[t] -> x[min(t, t_done)]
    as one gather of the step-t_done slice and a select."""
    n_steps, n = done_seq.shape
    t_done = torch.argmax((done_seq > 0).to(torch.int32), dim=0)  # (N,)
    t_idx = torch.arange(n_steps, device=done_seq.device)[:, None]
    alive = t_idx <= t_done[None, :]  # (n_steps, N)
    env_ids = torch.arange(n, device=done_seq.device)

    def pad_last(x):
        x_done = x[t_done, env_ids]  # (N, D)
        return torch.where(alive[:, :, None], x, x_done[None])

    states = torch.cat([obs0[None], pad_last(obs_seq)], dim=0)
    acts = pad_last(act_seq)
    acts = torch.cat([acts, acts[-1:]], dim=0)
    rewards = (rew_seq * alive).sum(dim=0)
    return (labels, states.transpose(0, 1).contiguous(),
            acts.transpose(0, 1).contiguous(), rewards)


class CollectRound:
    """What a collection round of ``steps`` steps keeps between its
    programs, shared by the step graphs of every policy and distribution
    that collect rounds of that length: the trajectory buffers the steps
    write, the round's first observations and labels (copied from the
    reset's buffers), and the episode extraction (``_postprocess_round``
    as one program, phase "extract") into ``out``: (labels, states,
    actions, rewards). Cached on the env (``collect_round``)."""

    def __init__(self, task, steps: int, params: torch.Tensor):
        n, dev, f32 = task.num_envs, task.device, torch.float32
        self.traj = trajectory(steps, {
            "obs": ((n, task.obs_dim), f32), "act": ((n, task.act_dim), f32),
            "rew": ((n,), f32), "done": ((n,), torch.int32)}, dev)
        self.obs0 = torch.empty(n, task.obs_dim, device=dev)
        self.labels = torch.empty_like(params)
        self.out = (torch.empty_like(params),
                    torch.empty(n, steps + 1, task.obs_dim, device=dev),
                    torch.empty(n, steps + 1, task.act_dim, device=dev),
                    torch.empty(n, device=dev))
        self.extract = Graphed("extract", self._extract, dev)

    def _extract(self):
        with torch.no_grad():
            tr = self.traj
            out = _postprocess_round(self.obs0, tr["obs"], tr["act"],
                                     tr["rew"], tr["done"], self.labels)
            for dst, src in zip(self.out, out):
                dst.copy_(src)

    def free(self):
        self.extract.free()


def collect_round(vec_env, steps: int, params: torch.Tensor) -> CollectRound:
    """The env's ``CollectRound`` of ``steps`` steps; ``params`` gives the
    labels' shape."""
    key = ("round", steps)
    if key not in vec_env.step_graphs:
        vec_env.step_graphs[key] = CollectRound(vec_env.task, steps, params)
    return vec_env.step_graphs[key]


def collect_step_graph(vec_env, policy_apply, collect_policy,
                       max_episode_length, policy_params, distr, gen,
                       env_state, obs, steps=None) -> StepGraph:
    """The collection step (policy, collection policy, ``env_step``) on
    static buffers, cached on ``vec_env`` by what it reads; it writes the
    trajectory buffers of the env's ``CollectRound`` of ``steps`` steps
    (default ``max_episode_length - 1``, a round). ``env_state`` and
    ``obs`` give the buffers' shapes."""
    steps = max_episode_length - 1 if steps is None else steps
    key = ("collect", max_episode_length, steps, policy_apply,
           collect_policy, policy_params, gen, distr_key(distr))
    graph = vec_env.step_graphs.get(key)
    if graph is not None:
        return graph
    task = vec_env.task

    def body(state, obs, distr):
        act = collect_policy(policy_apply(policy_params, obs, gen), gen)
        state, obs, rew, done = env_step(task, distr, state, act, gen,
                                         max_episode_length)
        return state, obs, {"obs": obs, "act": act, "rew": rew,
                            "done": done}
    graph = vec_env.step_graphs[key] = StepGraph(
        "collect", body, env_state, obs, distr,
        collect_round(vec_env, steps, env_state.params).traj, [gen])
    return graph


@torch.no_grad()
def _collect_round(vec_env, policy_apply, collect_policy, max_episode_length,
                   policy_params, distr, gen):
    """One synchronized round; returns padded episodes for every env, as
    copies of the round's buffers.

    policy_apply: (policy_params, obs, gen) -> action (the RL policy).
    collect_policy: (act, gen) -> act transform.
    Three kinds of programs (on the card, CUDA graph replays), with no host
    sync from the reset to the copies: the reset (``VecEnv.reset_program``),
    the ``max_episode_length - 1`` steps of the round's ``StepGraph`` and
    the extraction of the round's ``CollectRound``.
    """
    env_state, obs0 = vec_env.reset_program(gen, distr)(distr)
    rnd = collect_round(vec_env, max_episode_length - 1, env_state.params)
    rnd.obs0.copy_(obs0)
    # The labels: the params drawn at the reset. A step redraws an env's
    # params when it resets inside the round.
    rnd.labels.copy_(env_state.params)
    graph = collect_step_graph(vec_env, policy_apply, collect_policy,
                               max_episode_length, policy_params, distr,
                               gen, env_state, obs0)
    graph.load(env_state, obs0, distr)
    for _ in range(max_episode_length - 1):
        graph.step()
    rnd.extract()
    return tuple(x.clone() for x in rnd.out)


def collect_trajectories(
        num_trajs: int,
        ppo,
        collect_policy_fxn: Optional[Callable] = None,
        max_traj_len: Optional[int] = None,
        gen: Optional[torch.Generator] = None,
        verbose: bool = False,
        visualize: bool = False,
):
    """Collects ``num_trajs`` episodes from ``ppo.vec_env`` (reference call
    shape). ``max_traj_len`` overrides episode length to max_traj_len + 1
    steps of bookkeeping. ``visualize`` renders env 0 of the first round
    (``_render_env0``). Draws come from ``gen`` (default:
    the PPO trainer's generator). Under a global env mesh each rank steps
    its envs and every rank returns the episodes of all envs."""
    vec_env = ppo.vec_env
    task = vec_env.task
    distr = vec_env._distr
    assert distr is not None, "set the env sampling distribution first"
    max_episode_length = (task.max_episode_length if max_traj_len is None
                          else max_traj_len + 1)
    if gen is None:
        gen = ppo.gen
    collect_policy = (policy_rl if collect_policy_fxn is None
                      else collect_policy_fxn)
    num_envs = global_num_envs(task.num_envs)
    n_rounds = -(-num_trajs // num_envs)  # ceil
    rounds = []
    for r in range(n_rounds):
        with trace.span("collect.round", round=r, num_trajs=num_trajs):
            part = _collect_round(vec_env, ppo.policy_apply, collect_policy,
                                  max_episode_length, ppo.net, distr, gen)
        # This rank's envs, all-gathered into the round of every env.
        with trace.span("collect.gather"):
            rounds.append(gather_envs(part))
        if verbose:
            done = min((r + 1) * num_envs, num_trajs)
            print(f"collected {done} trajs")
    steps = max_episode_length - 1
    STATS["stepped"] += n_rounds * num_envs * steps
    STATS["kept"] += num_trajs * steps
    params, states, actions, rewards = (
        torch.cat(parts, dim=0)[:num_trajs] for parts in zip(*rounds))
    imgs: List = []
    if visualize:
        with trace.span("collect.to_host"):
            obs_traj = states[0].cpu().numpy()
        with trace.span("collect.frames", frames=len(obs_traj),
                        batched=hasattr(task, "render_obs_frames")):
            imgs = _render_env0(task, obs_traj)
    return params, states, actions, rewards, imgs


def _render_env0(task, obs_traj: np.ndarray) -> List:
    """Renders one episode's frames from its observation stream: in one
    batch where the task draws a whole episode (``render_obs_frames``),
    else frame by frame (``render_obs_frame``)."""
    render_all = getattr(task, "render_obs_frames", None)
    if render_all is not None:
        imgs = list(render_all(obs_traj))
        STATS["frames_batched"] += len(imgs)
    else:
        render = getattr(task, "render_obs_frame", None)
        if render is None:
            return []
        imgs = [render(obs_traj[t]) for t in range(obs_traj.shape[0])]
    STATS["frames"] += len(imgs)
    return imgs
