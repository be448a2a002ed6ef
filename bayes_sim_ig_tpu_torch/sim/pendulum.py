"""Vectorized Pendulum task, the README quick start.

Port of ``bayes_sim_ig_tpu/sim/pendulum.py``, itself the reference's
PendulumB (``openai_env_wrappers.py:24-177``) as batched functions.

Dynamics (openai_env_wrappers.py:159-171): torque u in [-2, 2] (actions in
[-1, 1] scaled by max_torque), g = 10, dt = 0.05,
  newthdot = thdot + (-3 g / (2 l) sin(th + pi) + 3 / (m l^2) u) dt
  newth    = th + newthdot dt;  thdot clipped to +-8.
Reward (openai_env_wrappers.py:173-177), on the pre-step state:
  -(angle_norm(th)^2 + 0.1 thdot^2 + 0.001 u^2).
Obs: [cos th, sin th, thdot]. Reset state: th ~ U[-pi, pi],
thdot ~ U[-1, 1] (openai_env_wrappers.py:82-86).

Randomized params: mass and length, bound by name from the flat param spec
(openai_env_wrappers.py:43-49).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..dr import TaskNames, build_params_spec
from ..parallel.mesh import env_draw
from ..utils.device import resolve_device
from .task import Task


class PendulumState(NamedTuple):
    th: torch.Tensor      # (N,)
    thdot: torch.Tensor   # (N,)


def angle_normalize(x):
    return ((x + math.pi) % (2 * math.pi)) - math.pi


class Pendulum(Task):
    name = "Pendulum"
    obs_dim = 3
    act_dim = 1
    # Classic gym semantics: the reward of the state the action was taken
    # in (PendulumB computes the cost before it steps), unlike the IG
    # tasks' post-step reward.
    reward_post_step = False
    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    gravity = 10.0

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg["episodeLength"])
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"pendulum": TaskNames(
                body_names=["pendulum"], shape_names=["pendulum"],
                dof_names=["pendulum"], tendon_names=[])},
            defaults_map={"pendulum": {
                "rigid_body_properties": {"mass": np.array([1.0])},
                "rigid_shape_properties": {"length": np.array([1.0])},
            }})
        self._mass_dim = self.params_spec.index_of("mass")
        self._length_dim = self.params_spec.index_of("length")
        self.setup_noise(cfg["task"]["randomization_params"])

    # ------------------------------------------------------------------ #
    def init_state(self, gen, params):
        n = params.shape[0]
        vals = env_draw(torch.rand, (2, n), gen, env_dim=1,
                        device=params.device)
        return PendulumState(th=(vals[0] * 2.0 - 1.0) * math.pi,
                             thdot=vals[1] * 2.0 - 1.0)

    def _torque(self, actions):
        return torch.clamp(actions[:, 0] * self.max_torque,
                           -self.max_torque, self.max_torque)

    def physics_step(self, state, actions, params, gen):
        u = self._torque(actions)
        m = params[:, self._mass_dim]
        l = params[:, self._length_dim]
        g, dt = self.gravity, self.dt
        newthdot = state.thdot + (
            -3.0 * g / (2.0 * l) * torch.sin(state.th + math.pi)
            + 3.0 / (m * l ** 2) * u) * dt
        newth = state.th + newthdot * dt
        newthdot = torch.clamp(newthdot, -self.max_speed, self.max_speed)
        return PendulumState(th=newth, thdot=newthdot)

    def observe(self, state, params):
        return torch.stack([torch.cos(state.th), torch.sin(state.th),
                            state.thdot], dim=-1)

    def reward(self, state, actions, params):
        u = self._torque(actions)
        costs = (angle_normalize(state.th) ** 2
                 + 0.1 * state.thdot ** 2 + 0.001 * u ** 2)
        return -costs

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Frame from one observation row [cos th, sin th, thdot], so the
        collector can render from its recorded obs stream."""
        th = float(np.arctan2(obs_row[1], obs_row[0]))
        return self._draw(th, height, width)

    def get_img(self, env_state, env_id=0, height=200, width=200):
        """Minimal rasterized frame (rod + pivot) of env ``env_id``,
        standing in for the reference's gym classic-control viewer
        (openai_env_wrappers.py:118-141)."""
        th = float(env_state.task_state.th[env_id])
        return self._draw(th, height, width)

    def _draw(self, th, height, width):
        """Rasterizes the rod at angle ``th``."""
        img = np.full((height, width, 3), 255, np.uint8)
        cx, cy = width // 2, height // 2
        # Rod tip; screen y grows downward. Reference rotates by th + pi/2.
        ang = th + np.pi / 2
        tip = (cx + int(0.4 * width * np.cos(ang)),
               cy - int(0.4 * height * np.sin(ang)))
        n_pts = max(abs(tip[0] - cx), abs(tip[1] - cy), 1)
        xs = np.linspace(cx, tip[0], n_pts).astype(int)
        ys = np.linspace(cy, tip[1], n_pts).astype(int)
        for dx in range(-2, 3):
            for dy in range(-2, 3):
                img[np.clip(ys + dy, 0, height - 1),
                    np.clip(xs + dx, 0, width - 1)] = (204, 77, 77)
        img[cy - 3:cy + 3, cx - 3:cx + 3] = 0
        return img
