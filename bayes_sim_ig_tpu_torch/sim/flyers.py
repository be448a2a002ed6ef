"""Free-flyer tasks: Ingenuity (Mars helicopter) and Quadcopter.

Port of ``bayes_sim_ig_tpu/sim/flyers.py``: free-base mechanisms with
rotor links and thrust forces applied as external spatial forces (no
ground contact: the flyers operate mid-air and crash conditions end the
episode).

DR layouts:
  * Ingenuity (cfg/ingenuity.yaml): 5 body-mass multipliers (chassis + 2
    physics rotors + 2 visual rotors) and 4 additive dof stiffness dims
    (the two coaxial rotor pairs, named rotor_one_roll0/rotor_two_roll0
    ...). It flies in Mars gravity (-3.721); obs = [target-relative pos
    (3), quat (4), linvel (3), angvel (3)] (13 dims).
  * Quadcopter (cfg/quadcopter.yaml): 9 body-mass multipliers (chassis +
    4 rotor arms + 4 rotors). Obs adds the 4 arm tilt positions and
    velocities (21 dims); actions = 8 dof PD targets + 4 rotor thrusts.

The thrust of every env is computed in one batched pass and handed to the
engine env-last, (nb, 6, N). Each env step runs two physics substeps,
each with a fresh factor of the mass matrix (nv 10 and 14: the dense SPD
solve).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dr import TaskNames, build_params_spec
from ..parallel.mesh import env_draw
from ..physics import (
    ArticulatedModel, LinkSpec, DynParams, forward_dynamics,
    integrate_and_clamp, carried_mass_factor,
)
from ..physics.spatial import quat_to_rot
from .render2d import draw_line
from ..utils.device import resolve_device
from .task import Task


class FlyerState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor


class _FlyerBase(Task):
    """Shared free-flyer machinery: state container, PD/thrust stepping."""

    dt = 1.0 / 100.0
    substeps = 2
    gravity = -9.81
    target = (0.0, 0.0, 1.0)
    kp = kd = None

    def _setup(self, cfg, device, links, actor, dof_names):
        """The model, DR spec and device tables shared by both flyers."""
        self.device = resolve_device(device)
        self.model = m = ArticulatedModel(links, fixed_base=False)
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={actor: TaskNames(
                body_names=m.body_names, shape_names=m.body_names,
                dof_names=dof_names, tendon_names=[])},
            defaults_map={actor: {
                "rigid_body_properties": {"mass": m.mass0.copy()},
                "dof_properties": {"stiffness": np.zeros(len(dof_names))},
            }},
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        self._mass_dims = self.params_spec.indices_of(
            "rigid_body_properties", "mass")
        self._stiff_dims = self.params_spec.indices_of(
            "dof_properties", "stiffness")
        self._dof_v_idx = [m.v_off[i] for i in range(m.nb)
                           if m.joint_types[i] == "revolute"]
        self._dof_links = [i for i in range(m.nb)
                           if m.joint_types[i] == "revolute"]
        self.setup_noise(cfg["task"]["randomization_params"])
        # Whole-actor geometry scale DR.
        self._scale_dims = self.params_spec.indices_of("scale", "")
        self._base = DynParams.defaults(m, gravity=(0.0, 0.0, self.gravity),
                                        device=self.device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)
        self._dof_v = idx(self._dof_v_idx)
        self._mass_cols = idx(self._mass_dims)
        self._stiff_cols = idx(self._stiff_dims)
        self._target = torch.tensor(self.target, device=self.device)
        # The reset pose, built once on the task's device.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=self.device)
        self._q0[2] = 1.0

    def _make_dyn_params(self, params) -> DynParams:
        """Every env's DynParams from its flat DR sample: (N, P) params ->
        fields with a leading N axis."""
        base = self._base
        n = params.shape[0]
        mass = base.mass * params[:, self._mass_cols]
        fields = dict(mass=mass,
                      inertia=base.inertia * (mass / base.mass)[:, :, None])
        if self._stiff_dims:
            # Additive on top of the base values.
            stiffness = base.stiffness.expand(n, -1).clone()
            stiffness[:, self._dof_v] += params[:, self._stiff_cols]
            fields["stiffness"] = stiffness
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(n, **fields)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        pos_jitter = env_draw(torch.rand, (n, 3), gen, device=dev) * 0.4 - 0.2
        q = self._q0.expand(n, -1).clone()
        q[:, 0:3] += pos_jitter
        v = env_draw(torch.rand, (n, m.nv), gen, device=dev) * 0.2 - 0.1
        return FlyerState(q=q, v=v)

    def _thrust(self, q, actions):
        """(N, 6) world wrench [torque@chassis origin; force] on the
        chassis. Task-specific."""
        raise NotImplementedError

    def _joint_targets(self, actions):
        """(N, n_dofs) PD position targets, or None."""
        return None

    def _thrust_forces(self, q, actions):
        """The engine's external forces, env-last (nb, 6, N): the thrust
        wrench on the chassis (link 0), nothing on the other links."""
        f_ext = q.new_zeros(self.model.nb, 6, q.shape[0])
        f_ext[0] = self._thrust(q, actions).T
        return f_ext

    def physics_step(self, state, actions, params, gen):
        m = self.model
        dp = self._make_dyn_params(params)
        h = self.dt / self.substeps
        n = actions.shape[0]
        targets = self._joint_targets(actions)
        # Joint PD drives solved implicitly in forward_dynamics (PhysX
        # drive semantics): stable however light the DR corners make the
        # rotor-arm links.
        drive = {}
        if targets is not None:
            kp = actions.new_zeros(n, m.nv).index_fill_(1, self._dof_v,
                                                        self.kp)
            kd = actions.new_zeros(n, m.nv).index_fill_(1, self._dof_v,
                                                        self.kd)
            tgt = actions.new_zeros(n, m.nv)
            tgt[:, self._dof_v] = targets
            drive = dict(drive_kp=kp, drive_kd=kd, drive_target=tgt)
        zero_tau = actions.new_zeros(n, m.nv)
        # A fresh factor on each substep (carried_mass_factor's default;
        # BSIM_FROZEN_MASS=1 forces the frozen-mass scheme).
        q, v, factor = state.q, state.v, None
        for _ in range(self.substeps):
            f_ext = self._thrust_forces(q, actions)
            qdd, _, factor = forward_dynamics(
                m, q, v, zero_tau, dp, f_ext, dt=h,
                factor=carried_mass_factor(factor), return_factor=True,
                **drive)
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        return FlyerState(q=q, v=v)

    def _kinematics_obs(self, state):
        q, v = state.q, state.v
        return self._target - q[:, 0:3], q[:, 3:7], v[:, 3:6], v[:, 0:3]

    def reward(self, state, actions, params):
        rel, quat, v_lin, v_ang = self._kinematics_obs(state)
        dist = torch.linalg.norm(rel, dim=-1)
        pos_reward = 1.0 / (1.0 + dist ** 2)
        up = quat_to_rot(quat)[:, 2, 2]
        up_reward = 1.0 / (1.0 + (1.0 - up) ** 2)
        spin_reward = 1.0 / (1.0 + (v_ang ** 2).sum(-1))
        rew = pos_reward + pos_reward * (up_reward + spin_reward)
        return torch.where(self._crashed(state), -2.0, rew)

    def _crashed(self, state):
        dist = torch.linalg.norm(self._target - state.q[:, 0:3], dim=-1)
        return (dist > 4.0) | (state.q[:, 2] < 0.1)

    def early_termination(self, state, params):
        return self._crashed(state)

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Side-view (x-z) schematic from one observation row: hover-target
        crosshair at the frame center, the craft at its target-relative
        position with a rotor bar tilted by the base quaternion's pitch,
        and a velocity arrow."""
        obs = np.asarray(obs_row, np.float64)
        rel = obs[0:3]                      # target - position
        w, x, y, z = obs[3:7]
        pitch = np.arctan2(2 * (x * z + w * y),
                           1 - 2 * (x * x + y * y))
        v = obs[7:10]
        img = np.full((height, width, 3), 255, np.uint8)
        scale = width / 8.0                 # 8 m field of view
        cx, cy = width // 2, height // 2

        def line(x0, y0, x1, y1, color, thick=1):
            draw_line(img, x0, y0, x1, y1, color, thick)

        line(cx - 5, cy, cx + 5, cy, (90, 170, 90), 1)   # target cross
        line(cx, cy - 5, cx, cy + 5, (90, 170, 90), 1)
        bx = cx - int(rel[0] * scale)       # body = target - rel
        by = cy + int(rel[2] * scale)
        yy, xx = np.ogrid[:height, :width]
        r = max(3, int(0.02 * width))
        img[(xx - bx) ** 2 + (yy - by) ** 2 <= r * r] = (150, 111, 214)
        arm = 0.06 * width
        c, s = np.cos(pitch), np.sin(pitch)
        line(bx - int(arm * c), by - int(arm * s),
             bx + int(arm * c), by + int(arm * s), (40, 40, 40), 1)
        line(bx, by, bx + int(v[0] * scale * 0.5),
             by - int(v[2] * scale * 0.5), (204, 77, 77), 1)
        return img


# --------------------------------------------------------------------- #
class Ingenuity(_FlyerBase):
    name = "Ingenuity"
    obs_dim = 13
    act_dim = 6
    gravity = -3.721  # Mars
    max_thrust = 5.0
    ROTOR_Z = (0.2, 0.3)

    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(
            env_cfg.get("maxEpisodeLength",
                        env_cfg.get("episodeLength", 2000)))
        links = [LinkSpec("chassis", parent=-1, joint_type="free",
                          mass=1.0, inertia=(0.01, 0.01, 0.01))]
        # Two coaxial physics rotors + two visual rotors, each a z revolute.
        for nm, z in [("rotor_physics_0", 0.2), ("rotor_physics_1", 0.3),
                      ("rotor_visual_0", 0.2), ("rotor_visual_1", 0.3)]:
            links.append(LinkSpec(
                nm, parent=0, joint_type="revolute",
                joint_axis=(0, 0, 1), joint_pos=(0, 0, z),
                mass=0.1, inertia=(0.001, 0.001, 0.002), damping=0.02))
        self._setup(cfg, device, links, "ingenuity",
                    ["rotor_one_roll0", "rotor_one_roll1",
                     "rotor_two_roll0", "rotor_two_roll1"])

    def _thrust(self, q, actions):
        R = quat_to_rot(q[:, 3:7])             # chassis body->world (N,3,3)
        a = torch.clamp(actions, -1.0, 1.0)
        wrench = q.new_zeros(q.shape[0], 6)
        for j, rotor_z in enumerate(self.ROTOR_Z):
            f_body = torch.stack([a[:, 3 * j] * 0.3 * self.max_thrust,
                                  a[:, 3 * j + 1] * 0.3 * self.max_thrust,
                                  (a[:, 3 * j + 2] + 1.0) * 0.5
                                  * self.max_thrust], -1)
            f_world = (R * f_body[:, None, :]).sum(-1)
            # Applied at the rotor, rotor_z above the chassis origin.
            arm_world = R[:, :, 2] * rotor_z
            wrench = wrench + torch.cat(
                [torch.linalg.cross(arm_world, f_world), f_world], -1)
        return wrench

    def observe(self, state, params):
        return torch.cat(self._kinematics_obs(state), dim=-1)


# --------------------------------------------------------------------- #
class Quadcopter(_FlyerBase):
    name = "Quadcopter"
    obs_dim = 21
    act_dim = 12
    max_thrust = 8.0
    kp = 10.0
    kd = 0.5

    ARM_DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float64)

    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(
            env_cfg.get("maxEpisodeLength",
                        env_cfg.get("episodeLength", 500)))
        links = [LinkSpec("chassis", parent=-1, joint_type="free",
                          mass=1.0, inertia=(0.01, 0.01, 0.02))]
        for i, (dx, dy) in enumerate(self.ARM_DIRS):
            arm_idx = len(links)
            # Arm tilt joint: axis perpendicular to the arm, horizontal.
            links.append(LinkSpec(
                f"rotor_arm{i}", parent=0, joint_type="revolute",
                joint_axis=(-dy, dx, 0.0),
                joint_pos=(0.15 * dx, 0.15 * dy, 0.0),
                mass=0.1, com=(0.05 * dx, 0.05 * dy, 0.0),
                inertia=(0.001, 0.001, 0.001), damping=0.1,
                limit_lower=-0.52, limit_upper=0.52))
            links.append(LinkSpec(
                f"rotor{i}", parent=arm_idx, joint_type="revolute",
                joint_axis=(0, 0, 1),
                joint_pos=(0.1 * dx, 0.1 * dy, 0.02),
                mass=0.05, inertia=(2e-4, 2e-4, 4e-4), damping=0.02))
        names = [l.name for l in links if l.joint_type == "revolute"]
        self._setup(cfg, device, links, "quadcopter", names)
        m = self.model
        # All 8 revolute dofs are PD position-servoed, interleaved [tilt0,
        # spin0, tilt1, spin1, ...]: 8 dof targets + 4 thrusts. Servoing
        # each arm's z-axis spin angle stands in for a second tilt (the
        # thrust model reads only the first).
        self._arm_links = [i for i in range(m.nb)
                           if m.body_names[i].startswith("rotor_arm")]
        self._rotor_links = [i for i in range(m.nb)
                             if m.body_names[i].startswith("rotor")
                             and not m.body_names[i].startswith(
                                 "rotor_arm")]
        dev = self.device
        self._arm_q = torch.as_tensor([m.q_off[i] for i in self._arm_links],
                                      device=dev)
        self._arm_v = torch.as_tensor([m.v_off[i] for i in self._arm_links],
                                      device=dev)
        d = torch.as_tensor(self.ARM_DIRS, dtype=torch.float32, device=dev)
        # Each rotor's thrust axis is the body z tilted about its arm axis
        # (-dy, dx, 0): (dx sin t, dy sin t, cos t). Applied at the rotor.
        self._arm_xy = d                                         # (4, 2)
        self._rotor_pos = torch.cat(
            [0.25 * d, torch.full((4, 1), 0.02, device=dev)], -1)  # (4, 3)

    def _joint_targets(self, actions):
        # First 8 actions: PD position targets for all 8 dofs in the
        # interleaved [tilt, spin] x 4 layout.
        return torch.clamp(actions[:, :8], -1.0, 1.0) * 0.52

    def _thrust(self, q, actions):
        a = torch.clamp(actions[:, 8:], -1.0, 1.0)              # (N, 4)
        thrust = (a + 1.0) * 0.5 * self.max_thrust
        R = quat_to_rot(q[:, 3:7])                              # (N, 3, 3)
        tilt = q[:, self._arm_q]                                # (N, 4)
        s = torch.sin(tilt)
        axis = torch.stack([self._arm_xy[:, 0] * s, self._arm_xy[:, 1] * s,
                            torch.cos(tilt)], -1)               # (N, 4, 3)
        f_body = axis * thrust[..., None]
        f_world = (R[:, None] * f_body[:, :, None, :]).sum(-1)  # (N, 4, 3)
        arm_world = (R[:, None] * self._rotor_pos[None, :, None, :]).sum(-1)
        torque = torch.linalg.cross(arm_world, f_world)
        return torch.cat([torque.sum(1), f_world.sum(1)], -1)

    def observe(self, state, params):
        # 21 dims: the 4 arm tilt positions + velocities (rotor spin angles
        # are unbounded, so they are not observed).
        return torch.cat([*self._kinematics_obs(state),
                          state.q[:, self._arm_q], state.v[:, self._arm_v]],
                         dim=-1)

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Top-down (x-y) schematic: the X-frame's four arms rotated by the
        base yaw and foreshortened by their observed tilt angles
        (obs[13:17]), target crosshair from the relative-position obs,
        planar velocity arrow."""
        obs = np.asarray(obs_row, np.float64)
        rel = obs[0:3]
        w, x, y, z = obs[3:7]
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        v = obs[7:10]
        tilts = obs[13:17]
        img = np.full((height, width, 3), 255, np.uint8)
        scale = width / 8.0
        cx, cy = width // 2, height // 2

        def line(x0, y0, x1, y1, color, thick=1):
            draw_line(img, x0, y0, x1, y1, color, thick)

        tx = cx + int(rel[0] * scale)        # target, body at center
        ty = cy - int(rel[1] * scale)
        line(tx - 5, ty, tx + 5, ty, (90, 170, 90), 1)
        line(tx, ty - 5, tx, ty + 5, (90, 170, 90), 1)
        yy, xx = np.ogrid[:height, :width]
        r = max(3, int(0.02 * width))
        img[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = (150, 111, 214)
        arm = 0.08 * width
        for i, d in enumerate(self.ARM_DIRS):
            ang = yaw + np.arctan2(d[1], d[0])
            ln = arm * max(np.cos(tilts[i]), 0.2)
            ex = cx + int(ln * np.cos(ang))
            ey = cy - int(ln * np.sin(ang))
            line(cx, cy, ex, ey, (40, 40, 40), 1)
            img[(xx - ex) ** 2 + (yy - ey) ** 2 <= 9] = (80, 80, 80)
        line(cx, cy, cx + int(v[0] * scale * 0.5),
             cy - int(v[1] * scale * 0.5), (204, 77, 77), 1)
        return img
