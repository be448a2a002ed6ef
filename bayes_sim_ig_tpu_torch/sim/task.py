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

import numpy as np
import torch

from ..distributions.device import DeviceDistr, sample_distr
from ..dr.noise import NoiseConfig, apply_noise
from ..ops.launch import count_at_replay
from ..parallel.mesh import env_draw
from ..utils.step_graph import (Graphed, StepGraph, clone_tree, distr_key,
                                tree_leaves, trajectory)

CLIP_OBSERVATIONS = 100.0
CLIP_ACTIONS = 1.0

# ``env_step`` calls of this process: the denominator of the physics'
# per-step counts (``physics/dynamics.py::STATS``). A CUDA graph adds what
# its capture counted at every replay (``count_at_replay``).
STATS = {"env_steps": 0}
count_at_replay("sim", STATS)


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

    def get_img(self, env_state: "EnvState", env_id: int = 0,
                height: int = 200, width: int = 200):
        """Optional single-env frame for TensorBoard videos."""
        return None

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
    STATS["env_steps"] += 1

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


class EnvReset:
    """``env_full_reset`` as one program on static buffers (phase "reset"
    in ``utils/step_graph.STATS``): the JAX package's ``_reset_jit`` and
    the reset that opens its collection round. It reads the distribution's
    values and the first frame from buffers, draws from ``gen`` and writes
    the ``state`` and ``obs`` buffers. Cached on the env by generator and
    distribution kind (``VecEnv.reset_program``), so that a collection
    round of the surrogate-real distribution replays the evaluation's."""

    def __init__(self, task: Task, distr: DeviceDistr, gen: torch.Generator):
        dev = task.device
        # The buffers' shapes, from a reset that draws from a generator of
        # its own: ``gen`` is untouched.
        self.state, self.obs = env_full_reset(
            task, distr, torch.Generator(device=dev).manual_seed(0))
        self.distr = clone_tree(distr)
        self.frame = torch.zeros((), dtype=torch.int32, device=dev)
        self._task, self._gen = task, gen
        self._program = Graphed("reset", self._run, dev, [gen])

    def _run(self):
        with torch.no_grad():
            out = env_full_reset(self._task, self.distr, self._gen,
                                 self.frame)
            for dst, src in zip(tree_leaves((self.state, self.obs)),
                                tree_leaves(out)):
                dst.copy_(src)

    def __call__(self, distr: DeviceDistr, frame=None):
        """Resets every env from ``distr``'s values, the frame counter at 0
        or at the () tensor ``frame``; returns the (state, obs) buffers,
        which the next call overwrites."""
        for dst, src in zip(tree_leaves(self.distr), tree_leaves(distr)):
            dst.copy_(src)
        if frame is None:
            self.frame.zero_()
        else:
            self.frame.copy_(frame)
        self._program()
        return self.state, self.obs

    def free(self):
        self._program.free()


class EnvStep:
    """``env_step`` as one program on static buffers (phase "step"): the
    JAX package's ``_step_jit``. ``step(state, distr, actions)`` copies its
    inputs into the buffers, replays the step and returns copies, so that
    what a caller holds never changes under it, as JAX's fresh arrays
    never do."""

    def __init__(self, task: Task, distr: DeviceDistr, state: EnvState,
                 gen: torch.Generator, max_episode_length: int):
        n, dev = task.num_envs, task.device
        self._act = torch.zeros(n, task.act_dim, device=dev)

        def body(state, obs, distr):
            state, obs, rew, done = env_step(task, distr, state, self._act,
                                             gen, max_episode_length)
            return state, obs, {"rew": rew, "done": done}
        self._graph = StepGraph(
            "step", body, state, torch.zeros(n, task.obs_dim, device=dev),
            distr, trajectory(1, {"rew": ((n,), torch.float32),
                                  "done": ((n,), torch.int32)}, dev), [gen])

    def __call__(self, state: EnvState, distr: DeviceDistr, actions):
        """(EnvState, obs, rew, done) after one step from ``state``."""
        g = self._graph
        g.load(state, g.obs, distr)
        self._act.copy_(actions)
        g.step()
        state, obs = g.snapshot()
        return state, obs, g.traj["rew"][0].clone(), g.traj["done"][0].clone()

    def free(self):
        self._graph.free()


class ParamsGeneratorFacade:
    """Reference-compatible view of a task's param spec (names/lows/highs/
    defaults/skip_ids + set_distr + sample). ``set_distr`` accepts host pdf
    objects and retargets the env's device sampler."""

    def __init__(self, spec, vec_env: "VecEnv"):
        self._spec = spec
        self._vec_env = vec_env
        self._host_distr = None

    names = property(lambda self: self._spec.names)
    lows = property(lambda self: self._spec.lows)
    highs = property(lambda self: self._spec.highs)
    defaults = property(lambda self: self._spec.defaults)
    skip_ids = property(lambda self: self._spec.skip_ids)

    def set_distr(self, distr):
        from ..distributions.device import to_device_distr
        self._host_distr = distr
        self._vec_env.set_distr(to_device_distr(
            distr, self._spec.lows, self._spec.highs,
            device=self._vec_env.device))

    def sample(self):
        """One flat host-side sample, clipped to bounds."""
        flat = self._host_distr.gen(n_samples=1)[0]
        return np.clip(flat, self._spec.lows, self._spec.highs)


class VecEnv:
    """Stateful wrapper over the env functions, exposing the surface the
    reference code uses (``reset()``, ``step(act)``), each one program
    (``EnvReset``, ``EnvStep``: a CUDA graph replay on the card). Its
    generator drives the env's own draws. ``step_graphs`` holds the
    programs of the env: these two, the collection rounds' and the PPO
    rollouts' (``utils/step_graph.py``), keyed by what each reads;
    ``free_step_graphs`` releases them. ``state`` is the env's own: the
    programs' buffers are copied into it and out of it."""

    def __init__(self, task: Task, seed: int = 0):
        self.task = task
        self.device = task.device
        self._distr: Optional[DeviceDistr] = None
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self.state: Optional[EnvState] = None
        self.max_episode_length = task.max_episode_length
        self.step_graphs: dict = {}
        task.actor_params_generator = ParamsGeneratorFacade(
            task.params_spec, self)

    def free_step_graphs(self):
        """Drops every captured step, with its graph's memory pool."""
        for graph in self.step_graphs.values():
            graph.free()
        self.step_graphs.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def set_distr(self, device_distr: DeviceDistr):
        """Sets the params sampling distribution."""
        self._distr = device_distr

    @property
    def num_envs(self):
        return self.task.num_envs

    @property
    def extern_params(self):
        """Ground-truth params of each env's current episode."""
        return self.state.params

    def reset_program(self, gen: torch.Generator,
                      distr: DeviceDistr) -> EnvReset:
        """The reset program that draws from ``gen``, for ``distr``'s kind
        and shapes."""
        key = ("reset", gen, distr_key(distr))
        if key not in self.step_graphs:
            self.step_graphs[key] = EnvReset(self.task, distr, gen)
        return self.step_graphs[key]

    def reset(self):
        assert self._distr is not None, "call set_distr first"
        state, obs = self.reset_program(self.gen, self._distr)(
            self._distr, None if self.state is None
            else self.state.frame_count)
        self.state = clone_tree(state)
        return obs.clone()

    def step(self, actions):
        key = ("step", self.max_episode_length, distr_key(self._distr))
        if key not in self.step_graphs:
            self.step_graphs[key] = EnvStep(self.task, self._distr,
                                            self.state, self.gen,
                                            self.max_episode_length)
        self.state, obs, rew, done = self.step_graphs[key](
            self.state, self._distr, actions)
        return obs, rew, done, {}

    def get_state(self):
        """(num_envs, state_dim) privileged state of the current episodes,
        the critic's input under `asymmetric_observations`."""
        return self.task.privileged_state(self.state.task_state,
                                          self.state.params)
