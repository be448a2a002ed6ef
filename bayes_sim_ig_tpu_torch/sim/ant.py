"""Ant locomotion task on the articulated-physics engine.

Port of ``bayes_sim_ig_tpu/sim/ant.py``: a quadruped in the classic ant
morphology — a spherical torso on a free joint with four diagonal legs,
each a hip (z-axis) + ankle (horizontal-axis) revolute pair, capsule upper
legs and angled lower legs with foot spheres (nq = 15, nv = 14, nb = 9,
21 ground contact points).

DR layout matches the reference ant config (cfg/ant.yaml): 9 per-body mass
multipliers (tree order: torso, then per-leg upper/foot) and 8 additive dof
stiffness dims (hip_i, ankle_i per leg).

Reward follows the IG ant recipe with the config's constants: forward
progress + alive + heading/up bonuses - action/energy/joint-limit costs;
death (deathCost) below terminationHeight. Observation layout (29): [z,
quat(4), local linvel(3), local angvel(3), up_proj, heading_proj, dof_pos(8),
dof_vel(8)].

Each env step runs two physics substeps with the frozen-mass scheme: the
mass matrix is factored on the first substep and the factor is reused on
the second.
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
    ground_contact_forces,
)
from ..physics.spatial import quat_to_rot
from .render2d import draw_line
from ..utils.device import resolve_device
from .task import Task

LEG_DIRS = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]],
                    np.float64) / np.sqrt(2.0)
LEG_NAMES = ["front_left", "front_right", "left_back", "right_back"]
TORSO_R = 0.25
UPPER_LEN = 0.28
LOWER_LEN = 0.5
START_Z = 0.55


def build_ant_model() -> ArticulatedModel:
    links = [LinkSpec("torso", parent=-1, joint_type="free", mass=10.0,
                      inertia=(0.25, 0.25, 0.25))]
    geoms = [Geom(link=0, kind="sphere", size=(TORSO_R,))]
    for d, nm in zip(LEG_DIRS, LEG_NAMES):
        dx, dy = d
        hip_axis = (0.0, 0.0, 1.0)
        ankle_axis = (-dy, dx, 0.0)
        upper_idx = len(links)
        links.append(LinkSpec(
            f"{nm}_leg", parent=0, joint_type="revolute",
            joint_axis=hip_axis,
            joint_pos=(TORSO_R * dx, TORSO_R * dy, 0.0),
            mass=1.5, com=(UPPER_LEN / 2 * dx, UPPER_LEN / 2 * dy, 0.0),
            inertia=(0.012, 0.012, 0.012),
            stiffness=0.0, damping=1.0,
            limit_lower=-0.6, limit_upper=0.6, effort=30.0))
        geoms.append(Geom(link=upper_idx, kind="capsule", size=(0.08, 0.12),
                          offset=(UPPER_LEN / 2 * dx, UPPER_LEN / 2 * dy,
                                  0.0),
                          axis=(dx, dy, 0.0)))
        foot_idx = len(links)
        end = np.array([LOWER_LEN * 0.7 * dx, LOWER_LEN * 0.7 * dy,
                        -LOWER_LEN * 0.7])
        links.append(LinkSpec(
            f"{nm}_foot", parent=upper_idx, joint_type="revolute",
            joint_axis=ankle_axis,
            joint_pos=(UPPER_LEN * dx, UPPER_LEN * dy, 0.0),
            mass=1.0, com=tuple(end / 2),
            inertia=(0.02, 0.02, 0.02),
            stiffness=0.0, damping=1.0,
            limit_lower=-1.1, limit_upper=1.1, effort=30.0))
        geoms.append(Geom(link=foot_idx, kind="capsule",
                          size=(0.08, LOWER_LEN * 0.35),
                          offset=tuple(end / 2),
                          axis=tuple(end / np.linalg.norm(end))))
        geoms.append(Geom(link=foot_idx, kind="sphere", size=(0.08,),
                          offset=tuple(end)))
    return ArticulatedModel(links, geoms, fixed_base=False)


class AntState(NamedTuple):
    q: torch.Tensor   # (N, nq)
    v: torch.Tensor   # (N, nv)


class Ant(Task):
    name = "Ant"
    act_dim = 8
    obs_dim = 29
    dt = 1.0 / 60.0
    substeps = 2

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("episodeLength", 1000))
        self.power_scale = float(env_cfg.get("powerScale", 1.0))
        self.heading_weight = float(env_cfg.get("headingWeight", 0.5))
        self.up_weight = float(env_cfg.get("upWeight", 0.1))
        self.actions_cost = float(env_cfg.get("actionsCost", 0.005))
        self.energy_cost = float(env_cfg.get("energyCost", 0.05))
        self.dof_vel_scale = float(env_cfg.get("dofVelocityScale", 0.2))
        self.joints_at_limit_cost = float(
            env_cfg.get("jointsAtLimitCost", 0.1))
        self.death_cost = float(env_cfg.get("deathCost", -2.0))
        self.termination_height = float(
            env_cfg.get("terminationHeight", 0.31))
        self.model = build_ant_model()
        m = self.model
        # The dofs in tree order are (hip_i, ankle_i) per leg; the flat
        # spec's names follow that order.
        tree_dof_names = []
        for i in range(4):
            tree_dof_names += [f"hip_{i+1}", f"ankle_{i+1}"]
        names = TaskNames(body_names=m.body_names, shape_names=m.body_names,
                          dof_names=tree_dof_names, tendon_names=[])
        # Per-dof defaults aligned with the v-layout (skip the 6 free dofs).
        dof_defaults = np.zeros(8)
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"ant": names},
            defaults_map={"ant": {
                "rigid_body_properties": {"mass": m.mass0.copy()},
                "dof_properties": {"stiffness": dof_defaults,
                                   "damping": dof_defaults},
            }},
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        self._mass_dims = self.params_spec.indices_of(
            "rigid_body_properties", "mass")
        self._stiff_dims = self.params_spec.indices_of(
            "dof_properties", "stiffness")
        self._damp_dims = self.params_spec.indices_of(
            "dof_properties", "damping")
        # Whole-actor geometry scale (the engine scales link offsets, COMs,
        # inertias and contact geometry with it).
        self._scale_dims = self.params_spec.indices_of("scale", "")
        self.setup_noise(cfg["task"]["randomization_params"])
        # Actuated dof indices in the v-layout (after the 6 free dofs).
        self._act_v_idx = np.array(
            [m.v_off[i] for i in range(m.nb)
             if m.joint_types[i] == "revolute"])
        self._act_q_idx = np.array(
            [m.q_off[i] for i in range(m.nb)
             if m.joint_types[i] == "revolute"])
        self._base = DynParams.defaults(m, device=self.device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)
        self._act_v = idx(self._act_v_idx)
        self._act_q = idx(self._act_q_idx)
        self._mass_cols = idx(self._mass_dims)
        self._stiff_cols = idx(self._stiff_dims)
        self._damp_cols = idx(self._damp_dims)
        self._limits = torch.as_tensor(
            [m.limit_upper[i] for i in self._act_v_idx], dtype=torch.float32,
            device=self.device)
        # The reset pose, and the mask that jitters only the 1-dof joints.
        q0 = np.asarray(m.neutral_q(), np.float32)
        q0[2] = START_Z
        self._q0 = torch.as_tensor(q0, device=self.device)
        self._q_jitter = torch.as_tensor(
            (np.arange(m.nq) >= 7).astype(np.float32), device=self.device)

    # ------------------------------------------------------------------ #
    def _dyn_params(self, params) -> DynParams:
        """Builds every env's DynParams from its flat DR sample: (N, P)
        params -> fields with a leading N axis."""
        n = params.shape[0]
        base = self._base
        mass = base.mass.expand(n, -1)
        if self._mass_dims:
            mass = base.mass * params[:, self._mass_cols]
        stiffness = base.stiffness.expand(n, -1)
        if self._stiff_dims:
            stiffness = stiffness.clone()
            stiffness[:, self._act_v] += params[:, self._stiff_cols]
        damping = base.damping.expand(n, -1)
        if self._damp_dims:
            damping = damping.clone()
            damping[:, self._act_v] += params[:, self._damp_cols]
        fields = dict(mass=mass, stiffness=stiffness, damping=damping,
                      inertia=base.inertia * (mass / base.mass)[:, :, None])
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(n, **fields)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        dq = env_draw(torch.rand, (n, m.nq), gen, device=dev) * 0.16 - 0.08
        # Keep the base pose exact; jitter only the 1-dof joints.
        q = self._q0[None, :] + dq * self._q_jitter[None, :]
        v = env_draw(torch.rand, (n, m.nv), gen, device=dev) * 0.1 - 0.05
        return AntState(q=q, v=v)

    def physics_step(self, state, actions, params, gen):
        # The engine is natively batched: the whole env batch steps as one
        # set of tensor contractions.
        m = self.model
        dp = self._dyn_params(params)
        tau_act = actions.new_zeros(actions.shape[0], m.nv)
        tau_act[:, self._act_v] = (torch.clamp(actions, -1, 1) * 30.0
                                       * self.power_scale)
        h = self.dt / self.substeps
        # The frozen-mass substep scheme, for this sprawled, passively
        # stable task: the first substep's factor serves the second.
        q, v, factor = state.q, state.v, None
        for _ in range(self.substeps):
            kin = forward_kinematics(m, q, v, dp)
            f_ext = ground_contact_forces(m, kin, dp, dt=h)
            qdd, _, factor = forward_dynamics(
                m, q, v, tau_act, dp, f_ext, dt=h, kin=kin,
                factor=factor, return_factor=True)
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        return AntState(q=q, v=v)

    def observe(self, state, params):
        q, v = state.q, state.v
        quat = q[:, 3:7]
        R = quat_to_rot(quat)                    # body->world
        w_b, v_b = v[:, 0:3], v[:, 3:6]
        up_proj = R[:, 2, 2]
        vx_world = (R[:, 0] * v_b).sum(-1)
        heading = torch.tanh(vx_world / 3.0)
        dof_pos = q[:, self._act_q]
        dof_vel = v[:, self._act_v] * self.dof_vel_scale
        return torch.cat([
            q[:, 2:3], quat, v_b, w_b, up_proj[:, None],
            heading[:, None], dof_pos, dof_vel], dim=-1)

    def reward(self, state, actions, params):
        q, v = state.q, state.v
        R = quat_to_rot(q[:, 3:7])
        vx_world = (R[:, 0] * v[:, 3:6]).sum(-1)
        up_proj = R[:, 2, 2]
        heading_rew = self.heading_weight * torch.tanh(vx_world / 1.0)
        up_rew = torch.where(up_proj > 0.93, self.up_weight, 0.0)
        a = torch.clamp(actions, -1, 1)
        actions_cost = self.actions_cost * (a ** 2).sum(-1)
        dof_vel = v[:, self._act_v]
        energy_cost = self.energy_cost * torch.abs(
            a * dof_vel * self.dof_vel_scale).sum(-1)
        dof_pos = q[:, self._act_q]
        at_limit = (torch.abs(dof_pos) > 0.99 * self._limits).sum(-1)
        limit_cost = self.joints_at_limit_cost * at_limit
        alive = 0.5
        rew = (vx_world + alive + heading_rew + up_rew
               - actions_cost - energy_cost - limit_cost)
        dead = q[:, 2] < self.termination_height
        return torch.where(dead, self.death_cost, rew)

    def early_termination(self, state, params):
        return state.q[:, 2] < self.termination_height

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Top-down schematic from one observation row: torso disc sized by
        height, heading arrow from the base quaternion's yaw, four legs bent
        by their hip/ankle angles."""
        obs = np.asarray(obs_row, np.float64)
        z, quat = obs[0], obs[1:5]
        dof_pos = obs[13:21]  # (hip_i, ankle_i) x 4 legs
        img = np.full((height, width, 3), 255, np.uint8)
        cx, cy = width // 2, height // 2
        w, x, y_, zq = quat
        yaw = np.arctan2(2 * (w * zq + x * y_),
                         1 - 2 * (y_ * y_ + zq * zq))

        def line(x0, y0, x1, y1, color, thick=1):
            draw_line(img, x0, y0, x1, y1, color, thick)

        r = max(6, int(0.10 * width * np.clip(z / START_Z, 0.2, 1.5)))
        yy, xx = np.ogrid[:height, :width]
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = (150, 111, 214)
        for leg_i, d in enumerate(LEG_DIRS):
            base = yaw + np.arctan2(d[1], d[0]) + dof_pos[2 * leg_i]
            bend = dof_pos[2 * leg_i + 1]
            ux, uy = np.cos(base), np.sin(base)
            kx = cx + int((r + 0.12 * width) * ux)
            ky = cy - int((r + 0.12 * width) * uy)
            line(cx + int(r * ux), cy - int(r * uy), kx, ky,
                 (80, 80, 80), 1)
            fx = kx + int(0.10 * width * np.cos(base + bend))
            fy = ky - int(0.10 * width * np.sin(base + bend))
            line(kx, ky, fx, fy, (40, 40, 40), 1)
        line(cx, cy, cx + int(1.6 * r * np.cos(yaw)),
             cy - int(1.6 * r * np.sin(yaw)), (204, 77, 77), 1)
        return img
