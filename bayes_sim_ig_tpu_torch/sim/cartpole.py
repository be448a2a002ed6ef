"""Vectorized Cartpole task with randomized masses and joint properties.

Port of ``bayes_sim_ig_tpu/sim/cartpole.py``: an analytic cart-pole (the
Florian 2007 pole-on-cart equations) extended with the randomizable joint
stiffness/damping of the reference's DR config: per-body mass multipliers,
per-shape friction/restitution (no contact is modeled, so these dims are
intentionally non-identifiable), and additive stiffness/damping on the
slider and pole joints.

IG task conventions:
  obs = [cart_pos, cart_vel, pole_angle, pole_vel];
  reward = 1 - pole_angle^2 - 0.01 |cart_vel| - 0.005 |pole_vel|,
  -2 on the termination step; early termination when |cart_pos| >
  resetDist or |pole_angle| > pi/2; reset state U[-0.1, 0.1] on all four
  coordinates; max_episode_length 500.
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

BODY_NAMES = ["slider", "cart", "pole"]
DOF_NAMES = ["slider_to_cart", "cart_to_pole"]


class CartpoleState(NamedTuple):
    x: torch.Tensor       # cart position (N,)
    x_dot: torch.Tensor
    th: torch.Tensor      # pole angle from upright (N,)
    th_dot: torch.Tensor


class Cartpole(Task):
    name = "Cartpole"
    obs_dim = 4
    act_dim = 1
    gravity = 9.81
    pole_half_len = 0.45   # pole COM distance from the pivot
    cart_mass0 = 1.0       # default (unrandomized) cart mass
    pole_mass0 = 1.0       # default pole mass
    dt = 1.0 / 60.0
    substeps = 2

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.reset_dist = float(env_cfg.get("resetDist", 3.0))
        self.max_effort = float(env_cfg.get("maxEffort", 400.0))
        names = TaskNames(body_names=BODY_NAMES, shape_names=BODY_NAMES,
                          dof_names=DOF_NAMES, tendon_names=[])
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"cartpole": names},
            defaults_map={"cartpole": {
                "rigid_body_properties": {
                    "mass": np.array([1.0, self.cart_mass0,
                                      self.pole_mass0])},
                "rigid_shape_properties": {
                    "friction": np.array([1.0, 1.0, 1.0]),
                    "restitution": np.zeros(3)},
                "dof_properties": {
                    "stiffness": np.zeros(2),
                    "damping": np.zeros(2)},
            }},
            plot_names_skip_patterns=["slider"])
        s = self.params_spec
        self._cart_mass_dim = s.index_of("cart_mass")
        self._pole_mass_dim = s.index_of("pole_mass")
        self._stiff_dims = s.indices_of("dof_properties", "stiffness")
        self._damp_dims = s.indices_of("dof_properties", "damping")
        # Whole-actor 'scale' DR: for the analytic cart-pole the geometry
        # scale multiplies the pole length.
        self._scale_dims = s.indices_of("scale", "")
        self.setup_noise(cfg["task"]["randomization_params"])

    # ------------------------------------------------------------------ #
    def _dyn_params(self, params):
        cart_m = self.cart_mass0 * params[:, self._cart_mass_dim]
        pole_m = self.pole_mass0 * params[:, self._pole_mass_dim]
        if self._stiff_dims:
            k_cart = params[:, self._stiff_dims[0]]
            k_pole = params[:, self._stiff_dims[1]]
        else:
            k_cart = k_pole = torch.zeros_like(cart_m)
        if self._damp_dims:
            b_cart = params[:, self._damp_dims[0]]
            b_pole = params[:, self._damp_dims[1]]
        else:
            b_cart = b_pole = torch.zeros_like(cart_m)
        return cart_m, pole_m, k_cart, k_pole, b_cart, b_pole

    def init_state(self, gen, params):
        n = params.shape[0]
        vals = env_draw(torch.rand, (n, 4), gen, device=params.device)
        vals = vals * 0.2 - 0.1
        return CartpoleState(x=vals[:, 0], x_dot=vals[:, 1],
                             th=vals[:, 2], th_dot=vals[:, 3])

    def physics_step(self, state, actions, params, gen):
        force = torch.clamp(actions[:, 0], -1.0, 1.0) * self.max_effort
        cart_m, pole_m, k_c, k_p, b_c, b_p = self._dyn_params(params)
        g, l = self.gravity, self.pole_half_len
        if self._scale_dims:
            l = l * params[:, self._scale_dims[0]]
        total_m = cart_m + pole_m
        h = self.dt / self.substeps
        x, x_dot, th, th_dot = state
        for _ in range(self.substeps):
            sin, cos = torch.sin(th), torch.cos(th)
            # Generalized forces incl. joint spring/damper terms.
            f_eff = force - b_c * x_dot - k_c * x
            tau_joint = -(b_p * th_dot + k_p * th)
            temp = (f_eff + pole_m * l * th_dot ** 2 * sin) / total_m
            th_acc = ((g * sin - cos * temp + tau_joint / (pole_m * l))
                      / (l * (4.0 / 3.0 - pole_m * cos ** 2 / total_m)))
            x_acc = temp - pole_m * l * th_acc * cos / total_m
            # Semi-implicit Euler keeps the randomized spring terms stable.
            x_dot = x_dot + h * x_acc
            th_dot = th_dot + h * th_acc
            x = x + h * x_dot
            th = th + h * th_dot
        return CartpoleState(x=x, x_dot=x_dot, th=th, th_dot=th_dot)

    def observe(self, state, params):
        return torch.stack([state.x, state.x_dot, state.th, state.th_dot],
                           dim=-1)

    def _dead(self, state):
        return ((torch.abs(state.x) > self.reset_dist)
                | (torch.abs(state.th) > math.pi / 2))

    def reward(self, state, actions, params):
        rew = (1.0 - state.th ** 2 - 0.01 * torch.abs(state.x_dot)
               - 0.005 * torch.abs(state.th_dot))
        return torch.where(self._dead(state), torch.full_like(rew, -2.0),
                           rew)

    def early_termination(self, state, params):
        return self._dead(state)

    def render_obs_frame(self, obs_row, height=200, width=300):
        """Simple raster (track, cart, pole) from one observation row for
        TensorBoard videos."""
        x, th = float(obs_row[0]), float(obs_row[2])
        img = np.full((height, width, 3), 255, np.uint8)
        track_y = int(height * 0.7)
        img[track_y:track_y + 2, :] = 0
        scale = width / (2.2 * self.reset_dist)
        cx = int(np.clip(width / 2 + x * scale, 15, width - 15))
        img[track_y - 10:track_y, cx - 12:cx + 12] = (60, 60, 200)
        tip = (cx + int(60 * np.sin(th)),
               track_y - 10 - int(60 * np.cos(th)))
        n = 60
        xs = np.linspace(cx, tip[0], n).astype(int)
        ys = np.linspace(track_y - 10, tip[1], n).astype(int)
        for d in (-1, 0, 1):
            img[np.clip(ys, 0, height - 1),
                np.clip(xs + d, 0, width - 1)] = (200, 80, 60)
        return img
