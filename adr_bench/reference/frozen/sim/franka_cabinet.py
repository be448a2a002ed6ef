# Frozen copy of bayes_sim_ig_tpu_torch/sim/franka_cabinet.py (commit 674a7cc); see frozen/__init__.py for what changed.
# Its departures from the port are those of the other tasks here: env_draw from
# utils/device.py (one device, no mesh) and no frames (render_obs_frame
# dropped); a substep integrates with integrate and then clamp_limits, the
# plain pair that the port's integrate_and_clamp launches as one kernel on the
# card; forward_kinematics is the plain chain on every device, where the port
# launches its kernel on the card; the plain SPD factor and substitute of ops/
# run under forward_dynamics' dense route on every device. frozen/__init__.py
# still names only ShadowHand and Humanoid among the tasks: FrankaCabinet is
# the fourth.
"""FrankaCabinet: a 9-dof Panda arm opening a cabinet drawer.

Port of ``bayes_sim_ig_tpu/sim/franka_cabinet.py``: a fixed-base 7-dof arm
+ 2 prismatic fingers (simplified Panda-like kinematics), and a fixed
cabinet with one prismatic drawer: two fixed roots, nq = nv = 10. The
drawer's handle is a sphere; the two finger pads are body-attached contact
planes, so closing the fingers on the handle and pulling drags the drawer
open through friction forces.

DR layout (cfg/franka_cabinet.yaml): actor 'franka' with 10 body-mass
multipliers (link0..7 + 2 fingers) and 9 dof-stiffness scaling dims, the
per-env PD drive gains of the 7 arm + 2 finger joints (a position drive's
stiffness is its gain). 19 dims.

Obs (23): dof_pos scaled to [-1, 1] (9), dof_vel*scale (9), drawer_pos
(1), drawer_vel (1), hand-to-handle vector (3), with the sampled per-env
geometry scale. Actions (9): position-target deltas * actionScale * dt.
Reward: the config's distReward, openReward, fingerDistReward and
actionPenalty terms.

Each env step runs two physics substeps, each with a fresh factor of the
10-dof mass matrix (its ancestor pairs fill 0.818 of the lower triangle:
the dense SPD solve).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dr import TaskNames, build_params_spec
from ..utils.device import env_draw
from ..physics import (
    ArticulatedModel, LinkSpec, DynParams,
    forward_kinematics, forward_dynamics, integrate, clamp_limits,
    sphere_plane_pair_forces,
)
from ..utils.device import resolve_device
from .task import Task

FRANKA_BODIES = [f"panda_link{i}" for i in range(8)] + \
    ["panda_leftfinger", "panda_rightfinger"]
FRANKA_DOFS = [f"panda_joint{i}" for i in range(1, 8)] + \
    ["panda_finger_joint1", "panda_finger_joint2"]
# Default PD gains: arm joints 400, fingers 800; stiffness dims SCALE these.
ARM_KP, FINGER_KP = 400.0, 800.0
ARM_KD, FINGER_KD = 40.0, 40.0
DEFAULT_DOF = np.array([0.0, -0.5, 0.0, -2.0, 0.0, 2.0, 0.78, 0.035,
                        0.035], np.float32)
DRAWER_HANDLE_LOCAL = (0.0, 0.0, 0.05)  # on the drawer link
HAND_TIP_LOCAL = (0.0, 0.0, 0.16)       # on panda_link7
HANDLE_R = 0.02


def build_model() -> ArticulatedModel:
    # Simplified Panda: alternating z/y axes, link lengths ~ the real arm.
    links = [LinkSpec("panda_link0", parent=-1, joint_type="fixed",
                      mass=3.0, inertia=(0.01,) * 3)]
    arm_spec = [
        # (axis, joint_pos (from parent), mass)
        ((0, 0, 1), (0.0, 0.0, 0.333), 3.0),   # joint1
        ((0, 1, 0), (0.0, 0.0, 0.0), 3.0),     # joint2
        ((0, 0, 1), (0.0, 0.0, 0.316), 2.5),   # joint3
        ((0, -1, 0), (0.0825, 0.0, 0.0), 2.5),  # joint4
        ((0, 0, 1), (-0.0825, 0.0, 0.384), 2.0),  # joint5
        ((0, -1, 0), (0.0, 0.0, 0.0), 1.5),    # joint6
        ((0, 0, -1), (0.088, 0.0, 0.107), 0.8),  # joint7 (hand)
    ]
    limits = [(-2.9, 2.9), (-1.76, 1.76), (-2.9, 2.9), (-3.07, -0.07),
              (-2.9, 2.9), (-0.02, 3.75), (-2.9, 2.9)]
    for i, ((ax, pos, mass), (lo, hi)) in enumerate(zip(arm_spec, limits)):
        links.append(LinkSpec(
            f"panda_link{i + 1}", parent=i, joint_type="revolute",
            joint_axis=ax, joint_pos=pos, mass=mass,
            com=(0, 0, 0.1), inertia=(0.02, 0.02, 0.01),
            damping=5.0, limit_lower=lo, limit_upper=hi, effort=87.0))
    hand = 7  # panda_link7
    for nm, sy in (("panda_leftfinger", 1.0), ("panda_rightfinger", -1.0)):
        links.append(LinkSpec(
            nm, parent=hand, joint_type="prismatic",
            joint_axis=(0, sy, 0), joint_pos=(0.0, 0.0, 0.107),
            mass=0.1, com=(0, 0, 0.02), inertia=(1e-4,) * 3,
            damping=5.0, limit_lower=0.0, limit_upper=0.04,
            effort=70.0))
    # Cabinet: fixed frame + prismatic drawer sliding in -x toward the arm.
    cab = len(links)
    links.append(LinkSpec("cabinet", parent=-1, joint_type="fixed",
                          joint_pos=(0.85, 0.0, 0.4), mass=20.0,
                          inertia=(0.5,) * 3))
    links.append(LinkSpec(
        "drawer_top", parent=cab, joint_type="prismatic",
        joint_axis=(-1, 0, 0), joint_pos=(0.0, 0.0, 0.1),
        mass=2.0, com=(0.0, 0.0, 0.0), inertia=(0.02, 0.02, 0.02),
        damping=20.0, limit_lower=0.0, limit_upper=0.4))
    return ArticulatedModel(links, geoms=[], fixed_base=True)


class FrankaState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor
    targets: torch.Tensor  # (N, 9) PD position targets


class FrankaCabinet(Task):
    name = "FrankaCabinet"
    obs_dim = 23
    act_dim = 9
    dt = 1.0 / 60.0
    substeps = 2

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("episodeLength", 500))
        self.action_scale = float(env_cfg.get("actionScale", 7.5))
        self.dof_vel_scale = float(env_cfg.get("dofVelocityScale", 0.1))
        self.dist_reward_scale = float(env_cfg.get("distRewardScale", 1.5))
        self.open_reward_scale = float(env_cfg.get("openRewardScale", 4.0))
        self.finger_dist_reward_scale = float(
            env_cfg.get("fingerDistRewardScale", 10.0))
        self.action_penalty_scale = float(
            env_cfg.get("actionPenaltyScale", 0.01))
        self.model = m = build_model()
        self._dof_links = [m.link_index[f"panda_link{i}"]
                           for i in range(1, 8)] + \
            [m.link_index["panda_leftfinger"],
             m.link_index["panda_rightfinger"]]
        self._dof_v = np.array([m.v_off[i] for i in self._dof_links])
        self._dof_q = np.array([m.q_off[i] for i in self._dof_links])
        self._drawer = m.link_index["drawer_top"]
        self._drawer_q = m.q_off[self._drawer]
        self._drawer_v = m.v_off[self._drawer]
        self._hand = m.link_index["panda_link7"]
        self._lf = m.link_index["panda_leftfinger"]
        self._rf = m.link_index["panda_rightfinger"]
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"franka": TaskNames(
                body_names=FRANKA_BODIES, shape_names=FRANKA_BODIES,
                dof_names=FRANKA_DOFS, tendon_names=[])},
            defaults_map={"franka": {
                "rigid_body_properties": {"mass": np.array(
                    [m.mass0[m.link_index[b]] for b in FRANKA_BODIES])},
                "dof_properties": {"stiffness": np.ones(9)},
            }},
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        self._mass_dims = self.params_spec.indices_of(
            "rigid_body_properties", "mass")
        self._stiff_dims = self.params_spec.indices_of(
            "dof_properties", "stiffness")
        self._franka_links = np.array(
            [m.link_index[b] for b in FRANKA_BODIES])
        self.setup_noise(cfg["task"]["randomization_params"])
        # Whole-actor geometry scale DR.
        self._scale_dims = self.params_spec.indices_of("scale", "")
        dev = self.device
        self._base = DynParams.defaults(m, device=dev)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self._dof_v_t = idx(self._dof_v)
        self._dof_q_t = idx(self._dof_q)
        self._franka_links_t = idx(self._franka_links)
        self._mass_cols = idx(self._mass_dims)
        self._stiff_cols = idx(self._stiff_dims)
        self._limits_lo = f32([m.limit_lower[v] for v in self._dof_v])
        self._limits_hi = f32([m.limit_upper[v] for v in self._dof_v])
        self._kp0 = f32([ARM_KP] * 7 + [FINGER_KP] * 2)
        self._kd0 = f32([ARM_KD] * 7 + [FINGER_KD] * 2)
        self._default_dof = f32(DEFAULT_DOF)
        # The reset pose, built once on the task's device.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=dev)
        self._q0[self._dof_q_t] = self._default_dof
        self._handle_local = f32(DRAWER_HANDLE_LOCAL)
        self._tip_local = f32(HAND_TIP_LOCAL)

    def _dyn_params(self, params) -> DynParams:
        """Every env's DynParams from its flat DR sample: (N, P) params ->
        fields with a leading N axis."""
        base = self._base
        n = params.shape[0]
        fields = {}
        if self._mass_dims:
            mass = base.mass.expand(n, -1).clone()
            mass[:, self._franka_links_t] *= params[:, self._mass_cols]
            fields.update(mass=mass, inertia=base.inertia
                          * (mass / base.mass)[:, :, None])
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(n, **fields)

    def _pd_gains(self, params):
        """Per-env (N, 9) drive gains: the stiffness dims scale kp."""
        kp = self._kp0.expand(params.shape[0], -1)
        if self._stiff_dims:
            kp = kp * params[:, self._stiff_cols]
        return kp, self._kd0.expand(params.shape[0], -1)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        q = self._q0.expand(n, -1).clone()
        q[:, self._dof_q_t] += (env_draw(torch.rand, (n, 9), gen, device=dev)
                                * 0.1 - 0.05)
        v = torch.zeros((n, m.nv), device=dev)
        return FrankaState(q=q, v=v,
                           targets=self._default_dof.expand(n, -1).clone())

    @staticmethod
    def _point(kin, link, local):
        """World position (3, N) of a point fixed on ``link``."""
        return kin.p_w[link] + (kin.R_w[link] * local[None, :, None]).sum(1)

    def physics_step(self, state, actions, params, gen):
        m = self.model
        dp = self._dyn_params(params)
        kp, kd = self._pd_gains(params)
        h = self.dt / self.substeps
        targets = torch.clamp(
            state.targets + torch.clamp(actions, -1, 1) * self.action_scale
            * self.dt, self._limits_lo, self._limits_hi)
        n = actions.shape[0]
        # PD drives solved implicitly in forward_dynamics (PhysX drive
        # semantics): explicit tau-PD is unstable on the low-inertia
        # wrist/finger joints (h kd / I >> 2).
        kp_dof = actions.new_zeros(n, m.nv)
        kp_dof[:, self._dof_v_t] = kp
        kd_dof = actions.new_zeros(n, m.nv)
        kd_dof[:, self._dof_v_t] = kd
        tgt_dof = actions.new_zeros(n, m.nv)
        tgt_dof[:, self._dof_v_t] = targets
        zero_tau = actions.new_zeros(n, m.nv)
        q, v = state.q, state.v
        for _ in range(self.substeps):
            kin = forward_kinematics(m, q, v, dp)
            # Finger pads gripping the drawer handle: the handle sphere vs
            # the inward-facing finger planes.
            f_ext = None
            for link, sy in ((self._lf, -1.0), (self._rf, 1.0)):
                f = sphere_plane_pair_forces(
                    m, kin, dp, sphere_link=self._drawer,
                    sphere_offset=DRAWER_HANDLE_LOCAL,
                    radius=HANDLE_R, plane_link=link,
                    plane_point=(0.0, sy * 0.008, 0.045),
                    plane_normal=(0.0, sy, 0.0), mu=1.5, dt=h,
                    plane_halfsize=0.025)
                f_ext = f if f_ext is None else f_ext + f
            qdd, _ = forward_dynamics(
                m, q, v, zero_tau, dp, f_ext, dt=h, kin=kin, drive_kp=kp_dof,
                drive_kd=kd_dof, drive_target=tgt_dof, drive_effort=87.0)
            q, v = integrate(m, q, v, qdd, h)
            q, v = clamp_limits(m, q, v)
        return FrankaState(q=q, v=v, targets=targets)

    def _hand_to_handle(self, state, params):
        """(N, 3) hand-tip-to-handle vector. FK reads only the geometry
        scale: the sampled per-env one when configured, so the obs and
        reward see the geometry the dynamics ran with."""
        dp = self._base
        if self._scale_dims:
            dp = dp._replace(scale=params[:, self._scale_dims[0]])
        kin = forward_kinematics(self.model, state.q, state.v, dp)
        hand = self._point(kin, self._hand, self._tip_local)
        handle = self._point(kin, self._drawer, self._handle_local)
        return (handle - hand).T

    def observe(self, state, params):
        pos = state.q[:, self._dof_q_t]
        pos_scaled = (2.0 * (pos - self._limits_lo)
                      / (self._limits_hi - self._limits_lo) - 1.0)
        vel = state.v[:, self._dof_v_t] * self.dof_vel_scale
        dq, dv = self._drawer_q, self._drawer_v
        return torch.cat([pos_scaled, vel, state.q[:, dq:dq + 1],
                          state.v[:, dv:dv + 1],
                          self._hand_to_handle(state, params)], dim=-1)

    def reward(self, state, actions, params):
        d = torch.linalg.norm(self._hand_to_handle(state, params), dim=-1)
        dist_reward = 1.0 / (1.0 + d ** 2)
        drawer_open = state.q[:, self._drawer_q]
        finger_width = (state.q[:, int(self._dof_q[7])]
                        + state.q[:, int(self._dof_q[8])])
        around = torch.where(d < 0.06, 0.04 - finger_width,
                             torch.zeros_like(d))
        a = torch.clamp(actions, -1, 1)
        return (self.dist_reward_scale * dist_reward
                + self.finger_dist_reward_scale * around
                + self.open_reward_scale * drawer_open
                - self.action_penalty_scale * (a ** 2).sum(-1))
