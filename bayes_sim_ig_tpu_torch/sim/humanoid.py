"""Humanoid locomotion task (16 bodies, 21 actuated dofs) on the
articulated-physics engine.

Port of ``bayes_sim_ig_tpu/sim/humanoid.py``: the classic MuJoCo-humanoid
morphology — a free torso root; a fixed head; a 2-dof waist and 1-dof
abdomen to the pelvis; 3-dof hips, knees and 2-dof ankles; 2-dof shoulders
and elbows. Multi-dof joints are chains through massless phantom links,
which the model collapses into joint chains on the real end links (16
effective bodies; nq = 28, nv = 27). Its dof tree fills 243 of the 378
lower-triangle pairs, so the physics solves with the branch-sparse tree
LTDL (``ops/tree_solve.py``).

DR layout matches the reference config (cfg/humanoid.yaml): 16 body-mass
multipliers (torso, head, lower_waist, pelvis, right/left thigh-shin-foot,
right/left upper_arm-lower_arm-hand) and 21 dof-stiffness SCALING dims
(defaults 1.0) = 37 params, plus gaussian additive action noise
(randomization_params.actions, applied by ``env_step``).

Torque control with MuJoCo-style gears; reward follows the IG humanoid
recipe with the config's constants (forward progress + alive +
heading/up - action/energy costs, deathCost below terminationHeight).
Obs (55): [z, quat(4), local linvel(3), local angvel(3), up_proj, heading,
dof_pos(21), dof_vel(21)].

Each env step runs two physics substeps and factors the mass matrix fresh
on each (a frozen-mass Humanoid never learns to run in the JAX package's
PPO A/B).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dr import TaskNames, build_params_spec
from ..parallel.mesh import env_draw
from ..physics import (
    ArticulatedModel, LinkSpec, Geom, DynParams,
    forward_dynamics, forward_kinematics, integrate_and_clamp,
    ground_contact_forces,
)
from ..physics.spatial import quat_to_rot
from .render2d import draw_lines, fill_discs
from ..utils.device import resolve_device
from .task import Task

START_Z = 1.34
# Phantom connector links: collapsed out of the link-axis tensors at model
# build, exactly massless so the collapse is exact.
PHANTOM = dict(mass=0.0, inertia=(0.0, 0.0, 0.0), phantom=True)

REAL_BODIES = ["torso", "head", "lower_waist", "pelvis",
               "right_thigh", "right_shin", "right_foot",
               "left_thigh", "left_shin", "left_foot",
               "right_upper_arm", "right_lower_arm", "right_hand",
               "left_upper_arm", "left_lower_arm", "left_hand"]

DOF_GEARS = {
    "abdomen_z": 40.0, "abdomen_y": 40.0, "abdomen_x": 40.0,
    "hip_x": 40.0, "hip_z": 40.0, "hip_y": 120.0, "knee": 80.0,
    "ankle_y": 20.0, "ankle_x": 20.0,
    "shoulder1": 20.0, "shoulder2": 20.0, "elbow": 25.0,
}


def build_humanoid_model() -> ArticulatedModel:
    links = [LinkSpec("torso", parent=-1, joint_type="free", mass=8.3,
                      inertia=(0.1, 0.1, 0.1))]
    geoms = [Geom(link=0, kind="capsule", size=(0.11, 0.07),
                  axis=(0, 1, 0))]
    idx = {"torso": 0}

    def add(name, parent_name, jt, axis=(0, 0, 1), pos=(0, 0, 0),
            mass=0.01, com=(0, 0, 0), inertia=(1e-4,) * 3, lo=-1e9,
            hi=1e9, damping=1.0, stiffness=1.0, geom=None,
            phantom=False):
        i = len(links)
        links.append(LinkSpec(
            name, parent=idx[parent_name], joint_type=jt,
            joint_axis=axis, joint_pos=pos, mass=mass, com=com,
            inertia=inertia, limit_lower=lo, limit_upper=hi,
            damping=damping, stiffness=stiffness, phantom=phantom))
        idx[name] = i
        if geom is not None:
            geoms.append(Geom(link=i, **geom))
        return i

    add("head", "torso", "fixed", pos=(0, 0, 0.19), mass=2.0,
        inertia=(0.01, 0.01, 0.01),
        geom=dict(kind="sphere", size=(0.09,), offset=(0, 0, 0.06)))
    # Waist chain: abdomen_z -> abdomen_y -> lower_waist; abdomen_x ->
    # pelvis.
    add("p_abd_z", "torso", "revolute", axis=(0, 0, 1),
        pos=(-0.01, 0, -0.195), lo=-0.79, hi=0.79, **PHANTOM)
    add("lower_waist", "p_abd_z", "revolute", axis=(0, 1, 0),
        pos=(0, 0, 0), mass=2.0, com=(0, 0, -0.065),
        inertia=(0.01, 0.01, 0.01), lo=-1.3, hi=0.52)
    add("pelvis", "lower_waist", "revolute", axis=(1, 0, 0),
        pos=(0, 0, -0.13), mass=6.0, com=(0, 0, -0.08),
        inertia=(0.03, 0.03, 0.03), lo=-0.61, hi=0.61,
        geom=dict(kind="capsule", size=(0.09, 0.07), axis=(0, 1, 0),
                  offset=(0, 0, -0.08)))
    for side, sy in (("right", -1.0), ("left", 1.0)):
        add(f"p_{side}_hip_x", "pelvis", "revolute", axis=(1, 0, 0),
            pos=(0, sy * 0.1, -0.12), lo=-0.44, hi=0.44, **PHANTOM)
        add(f"p_{side}_hip_z", f"p_{side}_hip_x", "revolute",
            axis=(0, 0, 1), lo=-1.05, hi=0.61, **PHANTOM)
        add(f"{side}_thigh", f"p_{side}_hip_z", "revolute",
            axis=(0, 1, 0), mass=4.5, com=(0, 0, -0.17),
            inertia=(0.05, 0.05, 0.01), lo=-1.92, hi=0.35,
            geom=dict(kind="capsule", size=(0.07, 0.12),
                      offset=(0, 0, -0.17), axis=(0, 0, 1)))
        add(f"{side}_shin", f"{side}_thigh", "revolute",
            axis=(0, 1, 0), pos=(0, 0, -0.34), mass=2.6,
            com=(0, 0, -0.15), inertia=(0.02, 0.02, 0.004),
            lo=-0.05, hi=2.77,
            geom=dict(kind="capsule", size=(0.05, 0.11),
                      offset=(0, 0, -0.15), axis=(0, 0, 1)))
        add(f"p_{side}_ankle_y", f"{side}_shin", "revolute",
            axis=(0, 1, 0), pos=(0, 0, -0.3), lo=-0.87, hi=0.87,
            **PHANTOM)
        add(f"{side}_foot", f"p_{side}_ankle_y", "revolute",
            axis=(1, 0, 0), mass=1.0, com=(0.045, 0, -0.0225),
            inertia=(0.002, 0.004, 0.004), lo=-0.44, hi=0.44,
            geom=dict(kind="box", size=(0.0885, 0.045, 0.0275),
                      offset=(0.045, 0, -0.0225)))
        add(f"p_{side}_shoulder1", "torso", "revolute",
            axis=(0.5 * -1, sy * 0.5, 0.7), pos=(0, sy * 0.17, 0.06),
            lo=-1.48, hi=1.05, **PHANTOM)
        add(f"{side}_upper_arm", f"p_{side}_shoulder1", "revolute",
            axis=(0.5, sy * 0.5, -0.7), mass=1.6,
            com=(0, sy * 0.08, -0.08), inertia=(0.01, 0.01, 0.004),
            lo=-1.48, hi=1.05,
            geom=dict(kind="capsule", size=(0.04, 0.08),
                      offset=(0, sy * 0.08, -0.08),
                      axis=(0, sy * 0.7, -0.7)))
        add(f"{side}_lower_arm", f"{side}_upper_arm", "revolute",
            axis=(0.7, sy * 0.7, 0.0), pos=(0, sy * 0.17, -0.17),
            mass=1.2, com=(0.01, sy * 0.01, 0.01),
            inertia=(0.005, 0.005, 0.002), lo=-1.57, hi=0.87,
            geom=dict(kind="capsule", size=(0.031, 0.06),
                      offset=(0.05, sy * 0.05, 0.05),
                      axis=(0.7, sy * 0.7, 0.7)))
        add(f"{side}_hand", f"{side}_lower_arm", "fixed",
            pos=(0.12, sy * 0.12, 0.12), mass=0.6,
            inertia=(5e-4,) * 3,
            geom=dict(kind="sphere", size=(0.04,)))
    return ArticulatedModel(links, geoms, fixed_base=False)


# Actuated dof names in tree order with their gear lookup keys.
TREE_DOFS = (
    [("abdomen_z", "abdomen_z"), ("abdomen_y", "abdomen_y"),
     ("abdomen_x", "abdomen_x")]
    + [(f"right_{j}", j) for j in
       ("hip_x", "hip_z", "hip_y", "knee", "ankle_y", "ankle_x")]
    + [(f"right_{j}", j) for j in ("shoulder1", "shoulder2", "elbow")]
    + [(f"left_{j}", j) for j in
       ("hip_x", "hip_z", "hip_y", "knee", "ankle_y", "ankle_x")]
    + [(f"left_{j}", j) for j in ("shoulder1", "shoulder2", "elbow")]
)


class HumanoidState(NamedTuple):
    q: torch.Tensor   # (N, nq)
    v: torch.Tensor   # (N, nv)


class Humanoid(Task):
    name = "Humanoid"
    act_dim = 21
    obs_dim = 55
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
        self.actions_cost = float(env_cfg.get("actionsCost", 0.01))
        self.energy_cost = float(env_cfg.get("energyCost", 0.05))
        self.dof_vel_scale = float(env_cfg.get("dofVelocityScale", 0.1))
        self.joints_at_limit_cost = float(
            env_cfg.get("jointsAtLimitCost", 0.25))
        self.death_cost = float(env_cfg.get("deathCost", -1.0))
        self.termination_height = float(
            env_cfg.get("terminationHeight", 0.8))
        self.model = m = build_humanoid_model()
        # Every 1-dof joint is one of the 21 actuated revolute dofs, in
        # tree order (per-dof tables survive the phantom collapse).
        self._act_v_idx = np.asarray(m.j1_v)
        self._act_q_idx = np.asarray(m.j1_q)
        assert len(self._act_v_idx) == 21
        self._gears_np = np.array([DOF_GEARS[key] for _, key in TREE_DOFS],
                                  np.float32)
        dof_names = [name for name, _ in TREE_DOFS]
        real_mass = np.array([m.mass0[m.link_index[b]] for b in REAL_BODIES])
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"humanoid": TaskNames(
                body_names=REAL_BODIES, shape_names=REAL_BODIES,
                dof_names=dof_names, tendon_names=[])},
            defaults_map={"humanoid": {
                "rigid_body_properties": {"mass": real_mass},
                # Scaling stiffness needs positive defaults (1.0).
                "dof_properties": {"stiffness": np.ones(21)},
            }},
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        self._mass_dims = self.params_spec.indices_of(
            "rigid_body_properties", "mass")
        self._stiff_dims = self.params_spec.indices_of(
            "dof_properties", "stiffness")
        self._real_links_np = np.array([m.link_index[b]
                                        for b in REAL_BODIES])
        self.setup_noise(cfg["task"]["randomization_params"])
        # Whole-actor geometry scale DR (apply_randomizations.py:174-189).
        self._scale_dims = self.params_spec.indices_of("scale", "")
        self._base = DynParams.defaults(m, device=self.device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)
        self._act_v = idx(self._act_v_idx)
        self._act_q = idx(self._act_q_idx)
        self._real_links = idx(self._real_links_np)
        self._mass_cols = idx(self._mass_dims)
        self._stiff_cols = idx(self._stiff_dims)
        self._gears = torch.as_tensor(self._gears_np, device=self.device)
        # The reset pose, built once on the task's device.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=self.device)
        self._q0[2] = START_Z

    # ------------------------------------------------------------------ #
    def _dyn_params(self, params) -> DynParams:
        """Builds every env's DynParams from its flat DR sample: (N, P)
        params -> fields with a leading N axis."""
        n = params.shape[0]
        base = self._base
        mass = base.mass.expand(n, -1)
        if self._mass_dims:
            mass = mass.clone()
            mass[:, self._real_links] = (base.mass[self._real_links]
                                         * params[:, self._mass_cols])
        inertia = base.inertia * (mass / base.mass)[:, :, None]
        stiffness = base.stiffness.expand(n, -1)
        if self._stiff_dims:
            # Scaling operation: default (1.0) x sampled multiplier.
            stiffness = stiffness.clone()
            stiffness[:, self._act_v] = 1.0 * params[:, self._stiff_cols]
        fields = dict(mass=mass, inertia=inertia, stiffness=stiffness)
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(n, **fields)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        jitter = env_draw(torch.rand, (n, 21), gen, device=dev) * 0.1 - 0.05
        q = self._q0.expand(n, -1).clone()
        q[:, self._act_q] += jitter
        v = env_draw(torch.rand, (n, m.nv), gen, device=dev) * 0.1 - 0.05
        return HumanoidState(q=q, v=v)

    def physics_step(self, state, actions, params, gen):
        # The engine is natively batched: the whole env batch steps as one
        # set of tensor contractions.
        m = self.model
        dp = self._dyn_params(params)
        h = self.dt / self.substeps
        tau = actions.new_zeros(actions.shape[0], m.nv)
        tau[:, self._act_v] = (torch.clamp(actions, -1, 1) * self._gears
                               * self.power_scale)
        q, v = state.q, state.v
        for _ in range(self.substeps):
            kin = forward_kinematics(m, q, v, dp)
            f_ext = ground_contact_forces(m, kin, dp, dt=h)
            qdd, _ = forward_dynamics(m, q, v, tau, dp, f_ext, dt=h, kin=kin)
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        return HumanoidState(q=q, v=v)

    def observe(self, state, params):
        q, v = state.q, state.v
        R = quat_to_rot(q[:, 3:7])
        vx_world = (R[:, 0] * v[:, 3:6]).sum(-1)
        return torch.cat([
            q[:, 2:3], q[:, 3:7], v[:, 3:6], v[:, 0:3],
            R[:, 2, 2][:, None], torch.tanh(vx_world / 3.0)[:, None],
            q[:, self._act_q], v[:, self._act_v] * self.dof_vel_scale,
        ], dim=-1)

    def reward(self, state, actions, params):
        q, v = state.q, state.v
        R = quat_to_rot(q[:, 3:7])
        vx_world = (R[:, 0] * v[:, 3:6]).sum(-1)
        up_proj = R[:, 2, 2]
        a = torch.clamp(actions, -1, 1)
        dof_vel = v[:, self._act_v]
        rew = (vx_world + 0.5
               + self.heading_weight * torch.tanh(vx_world)
               + torch.where(up_proj > 0.93, self.up_weight, 0.0)
               - self.actions_cost * (a ** 2).sum(-1)
               - self.energy_cost * torch.abs(
                   a * dof_vel * self.dof_vel_scale).sum(-1))
        dead = q[:, 2] < self.termination_height
        return torch.where(dead, self.death_cost, rew)

    def early_termination(self, state, params):
        return state.q[:, 2] < self.termination_height

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Side-view stick figure from one observation row: pelvis at the
        observed torso height, torso leaned by the base quaternion's pitch,
        legs posed by hip_y/knee (obs dof order = TREE_DOFS), arms drawn
        schematically from shoulder2/elbow."""
        return self.render_obs_frames(np.asarray(obs_row)[None], height,
                                      width)[0]

    def render_obs_frames(self, obs_traj, height=200, width=200):
        """``render_obs_frame`` of each row of a (T, obs_dim) episode, as a
        (T, H, W, 3) uint8 batch. Each stage is drawn on every frame
        before the next, in the one-frame order, so later colours cover
        earlier ones as they do there. Pixel offsets truncate toward zero
        (``astype(int)``, as ``int``)."""
        obs = np.asarray(obs_traj, np.float64)
        frames = np.arange(obs.shape[0])
        z = obs[:, 0]
        w, x, y, zq = obs[:, 1:5].T
        dof = obs[:, 13:34]                      # 21, TREE_DOFS order
        # Torso z-axis projected onto the world x-z plane.
        lean = np.arctan2(2 * (x * zq + w * y),
                          1 - 2 * (x * x + y * y))
        scale = height / 2.2                      # 2.2 m field of view
        cx = width // 2
        gy = height - int(0.06 * height)
        # The ground, alike in every frame: drawn once.
        ground = np.full((1, height, width, 3), 255, np.uint8)
        ground[:, gy:gy + 2] = (120, 120, 120)
        imgs = np.repeat(ground, len(frames), axis=0)
        py = gy - (np.clip(z, 0.1, 2.0) * scale * 0.7).astype(int)

        def sin_px(length, angle):
            return (length * np.sin(angle)).astype(int)

        def cos_px(length, angle):
            return (length * np.cos(angle)).astype(int)

        torso_len = 0.45 * scale
        tx = cx + sin_px(torso_len, lean)
        ty = py - cos_px(torso_len, lean)
        draw_lines(imgs, frames, cx, py, tx, ty, (150, 111, 214), 2)
        r = max(3, int(0.09 * scale))
        fill_discs(imgs, frames, tx + sin_px(1.5 * r, lean),
                   ty - cos_px(1.5 * r, lean), r, (150, 111, 214))
        # Legs: right dofs at [3:9], left at [12:18]; hip_y is the 3rd
        # entry of each 6-dof leg block, knee the 4th. Thigh and shin
        # share a colour: one call.
        for off, color in ((3, (40, 40, 40)), (12, (120, 120, 120))):
            hip = lean + dof[:, off + 2]
            kx = cx + sin_px(0.34 * scale, hip)
            ky = py + cos_px(0.34 * scale, hip)
            knee = hip + dof[:, off + 3]
            fx = kx + sin_px(0.33 * scale, knee)
            fy = ky + cos_px(0.33 * scale, knee)
            draw_lines(imgs, np.tile(frames, 2),
                       np.concatenate([np.full_like(kx, cx), kx]),
                       np.concatenate([py, ky]), np.concatenate([kx, fx]),
                       np.concatenate([ky, fy]), color, 1)
        # Arms: shoulder2/elbow of each 3-dof arm block ([9:12], [18:21]).
        for off, color in ((9, (40, 40, 40)), (18, (120, 120, 120))):
            sh = lean + np.pi + 0.6 * dof[:, off + 1]
            ex = tx + sin_px(0.25 * scale, sh)
            ey = ty - cos_px(0.25 * scale, sh)
            el = sh + 0.6 * dof[:, off + 2]
            wx2 = ex + sin_px(0.23 * scale, el)
            wy2 = ey - cos_px(0.23 * scale, el)
            draw_lines(imgs, np.tile(frames, 2), np.concatenate([tx, ex]),
                       np.concatenate([ty, ey]), np.concatenate([ex, wx2]),
                       np.concatenate([ey, wy2]), color, 1)
        return imgs
