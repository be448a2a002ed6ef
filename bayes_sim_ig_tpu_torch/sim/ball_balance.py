"""BallBalance task: keep a ball centered on a tray carried by a
three-legged table robot.

Port of ``bayes_sim_ig_tpu/sim/ball_balance.py``: two mechanisms in one
model, two free roots:

  * ``bbot``: a free-base tray with three two-segment legs (upper + lower
    revolute joints, 6 dofs) whose feet touch the ground. Actions (3)
    drive the lower leg joints; pushing against the ground tilts the tray.
  * ``ball``: a free body resting on the tray through a sphere-vs-body-
    plane pair contact.

DR layout (cfg/ball_balance.yaml): actor 'ball' with one mass multiplier,
then actor 'bbot' with 6 additive dof-friction dims, the 7-dim realParams
vector (under ``env:``, utils/args.py).

Obs (24): ball pos rel tray center in tray frame (3), ball vel (3), tray
up vector (3), tray angular vel (3), leg dof pos (6), leg dof vel (6).
Reward: products of closeness terms; termination when the ball falls off.

Each env step runs two physics substeps, each with a fresh factor of the
18-dof mass matrix: a forest of the tray's tree and the ball, whose
ancestor pairs fill 0.509 of the lower triangle (the branch-sparse tree
solve).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dr import TaskNames, build_params_spec
from ..parallel.mesh import env_draw
from ..physics import (
    ArticulatedModel, LinkSpec, Geom, DynParams,
    forward_kinematics, forward_dynamics, integrate_and_clamp,
    carried_mass_factor, ground_contact_forces, sphere_plane_pair_forces,
)
from ..physics.spatial import quat_to_rot
from ..utils.device import resolve_device
from .task import Task

TRAY_R = 0.5          # tray half-extent
TRAY_H = 0.7          # nominal tray height
BALL_R = 0.1
LEG_ANGLES = [0.0, 2.0 * np.pi / 3.0, 4.0 * np.pi / 3.0]


def build_bbot_model() -> ArticulatedModel:
    links = [LinkSpec("tray", parent=-1, joint_type="free", mass=3.0,
                      inertia=(0.15, 0.15, 0.3))]
    geoms = []
    for i, ang in enumerate(LEG_ANGLES):
        dx, dy = np.cos(ang), np.sin(ang)
        tangent = (-dy, dx, 0.0)
        upper = len(links)
        links.append(LinkSpec(
            f"upper_leg{i}", parent=0, joint_type="revolute",
            joint_axis=tangent,
            joint_pos=(0.4 * dx, 0.4 * dy, -0.02),
            mass=0.3, com=(0.0, 0.0, -0.15),
            inertia=(0.003, 0.003, 0.001), damping=2.0,
            limit_lower=-0.7, limit_upper=0.7, effort=20.0))
        lower = len(links)
        links.append(LinkSpec(
            f"lower_leg{i}", parent=upper, joint_type="revolute",
            joint_axis=tangent,
            joint_pos=(0.0, 0.0, -0.3),
            mass=0.3, com=(0.0, 0.0, -0.18),
            inertia=(0.004, 0.004, 0.001), damping=2.0,
            limit_lower=-0.9, limit_upper=0.9, effort=20.0))
        geoms.append(Geom(link=lower, kind="sphere", size=(0.05,),
                          offset=(0.0, 0.0, -0.36)))
    ball = len(links)
    links.append(LinkSpec("ball", parent=-1, joint_type="free", mass=0.5,
                          inertia=(0.002, 0.002, 0.002)))
    geoms.append(Geom(link=ball, kind="sphere", size=(BALL_R,)))
    return ArticulatedModel(links, geoms, fixed_base=False)


class BBotState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor


class BallBalance(Task):
    name = "BallBalance"
    obs_dim = 24
    act_dim = 3
    dt = 1.0 / 60.0
    substeps = 2

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.model = m = build_bbot_model()
        self._ball_idx = m.link_index["ball"]
        self._leg_links = [i for i in range(m.nb)
                           if m.joint_types[i] == "revolute"]
        self._leg_v_idx = [m.v_off[i] for i in self._leg_links]
        self._leg_q_idx = [m.q_off[i] for i in self._leg_links]
        # DR spec: actor 'ball' (mass), then 'bbot' (dof friction), in the
        # config's actor order (defines the flat layout).
        dof_names = []
        for i in range(3):
            dof_names += [f"upper_leg_joint{i}", f"lower_leg_joint{i}"]
        bbot_bodies = [m.body_names[i] for i in range(7)]
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={
                "ball": TaskNames(body_names=["ball"],
                                  shape_names=["ball"], dof_names=[],
                                  tendon_names=[]),
                "bbot": TaskNames(body_names=bbot_bodies,
                                  shape_names=bbot_bodies,
                                  dof_names=dof_names, tendon_names=[]),
            },
            defaults_map={
                "ball": {"rigid_body_properties": {
                    "mass": np.array([0.5])}},
                "bbot": {"dof_properties": {
                    "friction": np.zeros(6), "stiffness": np.zeros(6),
                    "damping": np.zeros(6)}},
            },
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        keys = self.params_spec.keys
        self._ball_mass_dims = [i for i, k in enumerate(keys)
                                if k[0] == "ball" and k[3] == "mass"]
        self._fric_dims = [i for i, k in enumerate(keys)
                           if k[0] == "bbot" and k[3] == "friction"]
        self.setup_noise(cfg["task"]["randomization_params"])
        # Whole-actor geometry scale DR.
        self._scale_dims = self.params_spec.indices_of("scale", "")
        self._base = DynParams.defaults(m, device=self.device)
        dev = self.device

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)
        self._leg_v = idx(self._leg_v_idx)
        self._leg_q = idx(self._leg_q_idx)
        self._lower_v = idx(self._leg_v_idx[1::2])
        self._fric_cols = idx(self._fric_dims)
        self._bq = m.q_off[self._ball_idx]
        self._bv = m.v_off[self._ball_idx]
        bq = self._bq
        # The reset pose, built once on the task's device.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=dev)
        self._q0[2] = TRAY_H
        self._q0[bq + 2] = TRAY_H + 0.02 + BALL_R

    # ------------------------------------------------------------------ #
    def _dyn_params(self, params) -> DynParams:
        """Every env's DynParams from its flat DR sample: the ball-mass dim
        multiplies, the dof-friction dims add."""
        base = self._base
        n = params.shape[0]
        fields = {}
        if self._ball_mass_dims:
            mass = base.mass.expand(n, -1).clone()
            mass[:, self._ball_idx] *= params[:, self._ball_mass_dims[0]]
            fields.update(mass=mass, inertia=base.inertia
                          * (mass / base.mass)[:, :, None])
        if self._fric_dims:
            friction = base.friction.expand(n, -1).clone()
            friction[:, self._leg_v] += params[:, self._fric_cols]
            fields["friction"] = friction
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(n, **fields)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        bq, bv = self._bq, self._bv
        q = self._q0.expand(n, -1).clone()
        q[:, bq:bq + 2] = (env_draw(torch.rand, (n, 2), gen, device=dev)
                           * 0.3 - 0.15)
        v = torch.zeros((n, m.nv), device=dev)
        v[:, bv + 3:bv + 5] = (env_draw(torch.rand, (n, 2), gen, device=dev)
                               * 0.4 - 0.2)
        return BBotState(q=q, v=v)

    def physics_step(self, state, actions, params, gen):
        m = self.model
        dp = self._dyn_params(params)
        h = self.dt / self.substeps
        # Actions drive the three lower-leg joints.
        tau = actions.new_zeros(actions.shape[0], m.nv)
        tau[:, self._lower_v] = torch.clamp(actions, -1, 1) * 20.0
        # A fresh factor on each substep (carried_mass_factor's default;
        # BSIM_FROZEN_MASS=1 forces the frozen-mass scheme).
        q, v, factor = state.q, state.v, None
        for _ in range(self.substeps):
            kin = forward_kinematics(m, q, v, dp)
            f_ext = ground_contact_forces(m, kin, dp, dt=h)
            f_ext = f_ext + sphere_plane_pair_forces(
                m, kin, dp, sphere_link=self._ball_idx,
                sphere_offset=(0, 0, 0), radius=BALL_R,
                plane_link=0, plane_point=(0, 0, 0.02),
                plane_normal=(0, 0, 1), mu=1.0, dt=h,
                plane_halfsize=TRAY_R)
            qdd, _, factor = forward_dynamics(
                m, q, v, tau, dp, f_ext, dt=h, kin=kin,
                factor=carried_mass_factor(factor), return_factor=True)
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        return BBotState(q=q, v=v)

    def _ball_rel(self, state, tray_R=None):
        """Ball position relative to the tray, in the tray frame."""
        if tray_R is None:
            tray_R = quat_to_rot(state.q[:, 3:7])
        bq = self._bq
        rel_w = state.q[:, bq:bq + 3] - state.q[:, 0:3]
        return (tray_R * rel_w[:, :, None]).sum(1)          # R^T @ rel

    def observe(self, state, params):
        bq, bv = self._bq, self._bv
        tray_R = quat_to_rot(state.q[:, 3:7])
        ball_R = quat_to_rot(state.q[:, bq + 3:bq + 7])
        ball_vel = (ball_R * state.v[:, None, bv + 3:bv + 6]).sum(-1)
        tray_w = (tray_R * state.v[:, None, 0:3]).sum(-1)
        return torch.cat([self._ball_rel(state, tray_R), ball_vel,
                          tray_R[:, :, 2], tray_w,
                          state.q[:, self._leg_q], state.v[:, self._leg_v]],
                         dim=-1)

    def reward(self, state, actions, params):
        bv = self._bv
        rel = self._ball_rel(state)
        dist = torch.linalg.norm(rel[:, :2], dim=-1)
        speed = torch.linalg.norm(state.v[:, bv + 3:bv + 6], dim=-1)
        pos_reward = 1.0 / (1.0 + dist ** 2 * 10.0)
        speed_reward = 1.0 / (1.0 + speed ** 2)
        rew = pos_reward + pos_reward * speed_reward
        return torch.where(self._fallen(state, rel), -2.0, rew)

    def _fallen(self, state, rel=None):
        if rel is None:
            rel = self._ball_rel(state)
        ball_z = state.q[:, self._bq + 2]
        tray_z = state.q[:, 2]
        off_tray = torch.linalg.norm(rel[:, :2], dim=-1) > TRAY_R
        return off_tray | (ball_z < tray_z - 0.1) | (tray_z < 0.3)

    def early_termination(self, state, params):
        return self._fallen(state)

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Top-down schematic from one observation row: tray disc, the ball
        at its tray-frame offset, and a tilt arrow from the tray up-vector's
        horizontal components."""
        obs = np.asarray(obs_row, np.float64)
        rel = obs[0:3]          # ball rel tray center, tray frame
        tray_up = obs[6:9]
        img = np.full((height, width, 3), 255, np.uint8)
        cx, cy = width // 2, height // 2
        r_tray = int(0.42 * min(height, width))
        yy, xx = np.ogrid[:height, :width]
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        img[d2 <= r_tray * r_tray] = (229, 229, 229)
        ring = (d2 <= r_tray * r_tray) & (d2 >= (r_tray - 2) ** 2)
        img[ring] = (120, 120, 120)
        # Tilt arrow: where the tray normal leans.
        tx = cx + int(3.0 * r_tray * tray_up[0])
        ty = cy - int(3.0 * r_tray * tray_up[1])
        n = max(abs(tx - cx), abs(ty - cy), 1)
        xs = np.linspace(cx, tx, n).astype(int)
        ys = np.linspace(cy, ty, n).astype(int)
        img[np.clip(ys, 0, height - 1), np.clip(xs, 0, width - 1)] = \
            (77, 121, 204)
        # Ball: position scaled by the tray radius, green when centered,
        # red toward the rim.
        bx = cx + int(r_tray * np.clip(rel[0] / TRAY_R, -1.2, 1.2))
        by = cy - int(r_tray * np.clip(rel[1] / TRAY_R, -1.2, 1.2))
        frac = float(np.clip(np.hypot(rel[0], rel[1]) / TRAY_R, 0, 1))
        color = (int(60 + 160 * frac), int(170 - 120 * frac), 60)
        rb = max(4, int(r_tray * BALL_R / TRAY_R))
        mask = (xx - bx) ** 2 + (yy - by) ** 2 <= rb * rb
        img[mask] = color
        return img
