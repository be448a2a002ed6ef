# Frozen copy of bayes_sim_ig_tpu_torch/sim/task.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Core vectorized-task abstraction: batched tensor functions over a state
tuple plus an (N, P) params tensor.

Port of ``bayes_sim_ig_tpu/sim/task.py``. Physics parameters are data: a
task is a set of functions over a batched state NamedTuple of tensors and
the params tensor, and stepping the whole env batch, per-env
re-randomization at episode resets included, is one call of ``env_step``.
Random draws come from an explicit ``torch.Generator`` on the env's device.

Step semantics (the IG convention): the reset/done bit is set on the LAST
step of an episode; envs whose bit is set are re-randomized and reset at
the START of the next step, which replaces their physics step. Reward
timing is per task (``Task.reward_post_step``). Observations are clipped to
+-100 and actions to +-1.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..distributions.device import DeviceDistr, sample_distr
from ..dr.noise import NoiseConfig, apply_noise
from ..utils.device import env_draw

CLIP_OBSERVATIONS = 100.0
CLIP_ACTIONS = 1.0


class Task:
    """Base class for vectorized tasks. Subclasses define the static spec
    attributes and the four batched functions below; ``device`` is the
    torch device of every tensor they make."""

    name: str = "Task"
    obs_dim: int
    act_dim: int
    num_envs: int
    max_episode_length: int
    params_spec: Any  # dr.ParamsSpec
    device: torch.device = torch.device("cpu")
    obs_noise: Optional[NoiseConfig] = None
    act_noise: Optional[NoiseConfig] = None
    # IG tasks reward the post-step state (post_physics_step semantics).
    reward_post_step: bool = True
    # Asymmetric actor-critic (the env config's `asymmetric_observations`,
    # set by make_env with `state_dim`): the PPO critic reads
    # `privileged_state`, the actor the observations.
    asymmetric_observations: bool = False
    state_dim: int = 0

    def setup_noise(self, randomization_params: dict):
        """Parses optional 'observations'/'actions' noise subtrees."""
        from ..dr.noise import make_noise_config
        if "observations" in randomization_params:
            self.obs_noise = make_noise_config(
                randomization_params["observations"])
        if "actions" in randomization_params:
            self.act_noise = make_noise_config(
                randomization_params["actions"])

    def init_state(self, gen: torch.Generator, params: torch.Tensor):
        """Fresh per-env state tuple given (N, P) params."""
        raise NotImplementedError

    def physics_step(self, state, actions, params, gen):
        """Advances physics one step. ``actions`` are in [-1, 1]."""
        raise NotImplementedError

    def observe(self, state, params) -> torch.Tensor:
        """(N, obs_dim) observations."""
        raise NotImplementedError

    def reward(self, state, actions, params) -> torch.Tensor:
        """(N,) rewards for taking ``actions``, evaluated at ``state``."""
        raise NotImplementedError

    def early_termination(self, state, params) -> torch.Tensor:
        """(N,) bool mask of envs that must terminate before timeout."""
        return torch.zeros(state_batch_size(state), dtype=torch.bool,
                           device=state[0].device)

    def privileged_state(self, task_state, params) -> torch.Tensor:
        """(N, state_dim) privileged state for the asymmetric critic: the
        noise-free simulator state, every field flattened per env."""
        n = state_batch_size(task_state)
        return torch.cat([x.reshape(n, -1).to(torch.float32)
                          for x in task_state], dim=1)


def state_batch_size(state) -> int:
    return state[0].shape[0]


def _tree_select(mask, a, b):
    """Per-env select between two equally-shaped state tuples."""
    def sel(x, y):
        m = mask.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(m, x, y)
    return type(a)(*[sel(x, y) for x, y in zip(a, b)])


class EnvState(NamedTuple):
    """The full mutable world state, every field a tensor on the env's
    device: the global frame count (the noise schedules' clock) too, so
    that a captured step advances it on the device."""
    task_state: Any           # task-specific tuple, leading dim N
    params: torch.Tensor      # (N, P) current per-env physics params
    progress: torch.Tensor    # (N,) int32 steps since episode start
    reset_buf: torch.Tensor   # (N,) int32; 1 on an episode's last step
    frame_count: torch.Tensor  # () int32 global frames
    obs_corr: torch.Tensor    # (N, obs_dim) correlated-noise draw
    act_corr: torch.Tensor    # (N, act_dim) correlated-noise draw


def env_full_reset(task: Task, distr: DeviceDistr, gen: torch.Generator,
                   frame_count=0):
    """Resets and re-randomizes ALL envs. Returns (EnvState, obs).
    ``frame_count`` (an int or a () tensor) starts the frame counter: a
    device fill or a device copy, never a copy from host data, so that a
    captured reset holds it."""
    n, dev = task.num_envs, task.device
    if isinstance(frame_count, torch.Tensor):
        frame = frame_count.to(dev, torch.int32, copy=True)
    else:
        frame = torch.full((), frame_count, dtype=torch.int32, device=dev)
    params = sample_distr(distr, gen, n)
    task_state = task.init_state(gen, params)
    state = EnvState(
        task_state=task_state,
        params=params,
        progress=torch.zeros(n, dtype=torch.int32, device=dev),
        reset_buf=torch.zeros(n, dtype=torch.int32, device=dev),
        frame_count=frame,
        obs_corr=env_draw(torch.randn, (n, task.obs_dim), gen, device=dev),
        act_corr=env_draw(torch.randn, (n, task.act_dim), gen, device=dev))
    obs = torch.clamp(task.observe(state.task_state, state.params),
                      -CLIP_OBSERVATIONS, CLIP_OBSERVATIONS)
    return state, obs


def env_step(task: Task, distr: DeviceDistr, state: EnvState,
             actions: torch.Tensor, gen: torch.Generator,
             max_episode_length: Optional[int] = None):
    """One synchronized step of all envs.

    Returns (new_state, obs, rew, done) with the IG done convention (done=1
    on an episode's last step; the env resets itself on the next call).
    ``max_episode_length`` overrides the task default (the collection path
    sets it to trainTrajLen + 1).
    """
    if max_episode_length is None:
        max_episode_length = task.max_episode_length
    n, dev = task.num_envs, task.device

    actions = torch.clamp(actions, -CLIP_ACTIONS, CLIP_ACTIONS)
    if task.act_noise is not None:
        actions = apply_noise(task.act_noise, gen, actions, state.act_corr,
                              state.frame_count)

    need_reset = state.reset_buf > 0
    # Re-randomize params and redraw correlated noise for resetting envs.
    new_params = sample_distr(distr, gen, n)
    params = torch.where(need_reset[:, None], new_params, state.params)
    obs_corr = torch.where(
        need_reset[:, None],
        env_draw(torch.randn, state.obs_corr.shape, gen, device=dev),
        state.obs_corr)
    act_corr = torch.where(
        need_reset[:, None],
        env_draw(torch.randn, state.act_corr.shape, gen, device=dev),
        state.act_corr)
    fresh = task.init_state(gen, params)
    state_begin = _tree_select(need_reset, fresh, state.task_state)
    # The reset replaces the physics step for resetting envs.
    stepped = task.physics_step(state_begin, actions, params, gen)
    task_state = _tree_select(need_reset, state_begin, stepped)
    rew = task.reward(task_state if task.reward_post_step else state_begin,
                      actions, params)

    # A physics blow-up in one env must not poison the batch: envs whose
    # state went non-finite are terminated (they re-randomize and reset on
    # the next step, like any done env) and their outputs sanitized.
    finite = torch.ones(n, dtype=torch.bool, device=dev)
    for leaf in task_state:
        finite &= torch.isfinite(leaf.reshape(n, -1)).all(dim=1)

    progress = torch.where(need_reset, torch.zeros_like(state.progress),
                           state.progress + 1)
    timeout = progress >= max_episode_length - 1
    early = task.early_termination(task_state, params)
    reset_buf = (timeout | early | ~finite).to(torch.int32)
    rew = torch.where(finite & torch.isfinite(rew), rew,
                      torch.zeros_like(rew))

    obs = task.observe(task_state, params)
    if task.obs_noise is not None:
        obs = apply_noise(task.obs_noise, gen, obs, obs_corr,
                          state.frame_count)
    obs = torch.clamp(obs, -CLIP_OBSERVATIONS, CLIP_OBSERVATIONS)
    obs = torch.where(finite[:, None] & torch.isfinite(obs), obs,
                      torch.zeros_like(obs))

    new_state = EnvState(
        task_state=task_state, params=params, progress=progress,
        reset_buf=reset_buf, frame_count=state.frame_count + 1,
        obs_corr=obs_corr, act_corr=act_corr)
    return new_state, obs, rew, reset_buf


