"""ANYmal quadruped locomotion with velocity-command tracking.

Port of ``bayes_sim_ig_tpu/sim/anymal.py``: box base + four 3-dof legs
(HAA abduction-x, HFE flexion-y, KFE knee-y) with foot spheres (nq 19,
nv 18, nb 13), position-PD actuation (kp 85, kd 2, actionScale 0.5) solved
implicitly in ``forward_dynamics`` with an 80 N m effort clamp, default
joint angles from cfg/anymal.yaml's ``defaultJointAngles``, and episode
length ``episodeLength_s * 60``.

DR layout: 13 per-body mass multipliers (base + LF/LH/RF/RH x
hip/thigh/shank), and the whole-actor geometry scale when configured.

Obs (48): base linvel*2.0, base angvel*0.25, projected gravity, commands
(vx, vy, yaw-rate)*scales, dof pos - default, dof vel*0.05, previous
actions. Commands are resampled per episode. Reward: exp-tracking of the
commanded linear/yaw velocity minus an action penalty; termination on
base contact (height/orientation proxy).

Each env step runs two physics substeps, each with a fresh factor of the
18-dof mass matrix (its ancestor pairs fill 0.684 of the lower triangle:
the dense SPD solve).
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

LEGS = [("LF", 1, 1), ("LH", -1, 1), ("RF", 1, -1), ("RH", -1, -1)]
BASE_Z = 0.62
THIGH_LEN = 0.25
SHANK_LEN = 0.33
DEFAULT_ANGLES = {  # cfg/anymal.yaml defaultJointAngles
    "LF": (0.03, 0.4, -0.8), "LH": (0.03, -0.4, 0.8),
    "RF": (-0.03, 0.4, -0.8), "RH": (-0.03, -0.4, 0.8),
}
# Per-episode command ranges (vx, vy, yaw-rate).
CMD_LOW = (-1.0, -0.3, -0.5)
CMD_HIGH = (1.0, 0.3, 0.5)


def build_anymal_model() -> ArticulatedModel:
    links = [LinkSpec("base", parent=-1, joint_type="free", mass=16.0,
                      inertia=(0.15, 0.6, 0.6))]
    geoms = [Geom(link=0, kind="box", size=(0.26, 0.15, 0.08))]
    for nm, fx, fy in LEGS:
        px, py = 0.28 * fx, 0.115 * fy
        hip = len(links)
        links.append(LinkSpec(
            f"{nm}_HIP", parent=0, joint_type="revolute",
            joint_axis=(1, 0, 0), joint_pos=(px, py, 0.0),
            mass=1.5, com=(0.0, 0.06 * fy, 0.0),
            inertia=(0.005, 0.005, 0.005), damping=0.5,
            limit_lower=-0.7, limit_upper=0.7, effort=40.0))
        thigh = len(links)
        links.append(LinkSpec(
            f"{nm}_THIGH", parent=hip, joint_type="revolute",
            joint_axis=(0, 1, 0), joint_pos=(0.0, 0.1 * fy, 0.0),
            mass=1.2, com=(0.0, 0.0, -THIGH_LEN / 2),
            inertia=(0.01, 0.01, 0.002), damping=0.5,
            limit_lower=-1.5, limit_upper=1.5, effort=40.0))
        shank = len(links)
        links.append(LinkSpec(
            f"{nm}_SHANK", parent=thigh, joint_type="revolute",
            joint_axis=(0, 1, 0), joint_pos=(0.0, 0.0, -THIGH_LEN),
            mass=0.5, com=(0.0, 0.0, -SHANK_LEN / 2),
            inertia=(0.006, 0.006, 0.001), damping=0.5,
            limit_lower=-2.2, limit_upper=2.2, effort=40.0))
        geoms.append(Geom(link=shank, kind="sphere", size=(0.03,),
                          offset=(0.0, 0.0, -SHANK_LEN)))
    return ArticulatedModel(links, geoms, fixed_base=False)


class AnymalState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor
    commands: torch.Tensor      # (N, 3) vx, vy, yaw-rate targets
    prev_actions: torch.Tensor  # (N, 12)


class Anymal(Task):
    name = "Anymal"
    obs_dim = 48
    act_dim = 12
    dt = 1.0 / 60.0
    substeps = 2
    kp = 85.0
    kd = 2.0
    action_scale = 0.5
    lin_vel_scale = 2.0
    ang_vel_scale = 0.25
    dof_vel_scale = 0.05

    def __init__(self, cfg, device="cuda"):
        self.device = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        eplen_s = float(env_cfg.get("episodeLength_s", 50))
        self.max_episode_length = int(eplen_s / self.dt)
        self.model = m = build_anymal_model()
        self._act_v_idx = np.array([m.v_off[i] for i in range(m.nb)
                                    if m.joint_types[i] == "revolute"])
        self._act_q_idx = np.array([m.q_off[i] for i in range(m.nb)
                                    if m.joint_types[i] == "revolute"])
        defaults = []
        for nm, *_ in LEGS:
            defaults += list(DEFAULT_ANGLES[nm])
        self._default_dof_np = np.array(defaults, np.float32)
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={"anymal": TaskNames(
                body_names=m.body_names, shape_names=m.body_names,
                dof_names=[f"{nm}_{j}" for nm, *_ in LEGS
                           for j in ("HAA", "HFE", "KFE")],
                tendon_names=[])},
            defaults_map={"anymal": {
                "rigid_body_properties": {"mass": m.mass0.copy()},
            }},
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        self._mass_dims = self.params_spec.indices_of(
            "rigid_body_properties", "mass")
        self.setup_noise(cfg["task"]["randomization_params"])
        # Whole-actor geometry scale DR.
        self._scale_dims = self.params_spec.indices_of("scale", "")
        self._base = DynParams.defaults(m, device=self.device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64),
                                   device=self.device)
        self._act_v = idx(self._act_v_idx)
        self._act_q = idx(self._act_q_idx)
        self._mass_cols = idx(self._mass_dims)
        self._default_dof = torch.as_tensor(self._default_dof_np,
                                            device=self.device)
        self._cmd_low = torch.tensor(CMD_LOW, device=self.device)
        self._cmd_high = torch.tensor(CMD_HIGH, device=self.device)
        self._cmd_scale = torch.tensor(
            [self.lin_vel_scale, self.lin_vel_scale, self.ang_vel_scale],
            device=self.device)
        # The reset pose, built once on the task's device.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=self.device)
        self._q0[2] = BASE_Z
        self._q0[self._act_q] = self._default_dof

    def _dyn_params(self, params) -> DynParams:
        """Every env's DynParams from its flat DR sample: (N, P) params ->
        fields with a leading N axis."""
        base = self._base
        mass = base.mass * params[:, self._mass_cols]
        fields = dict(mass=mass,
                      inertia=base.inertia * (mass / base.mass)[:, :, None])
        if self._scale_dims:
            fields["scale"] = params[:, self._scale_dims[0]]
        return base.rows(params.shape[0], **fields)

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        q = self._q0.expand(n, -1).clone()
        jitter = env_draw(torch.rand, (n, 12), gen, device=dev) * 0.1 - 0.05
        q[:, self._act_q] += jitter
        v = torch.zeros((n, m.nv), device=dev)
        commands = self._cmd_low + env_draw(
            torch.rand, (n, 3), gen, device=dev) * (self._cmd_high
                                                  - self._cmd_low)
        return AnymalState(q=q, v=v, commands=commands,
                           prev_actions=torch.zeros((n, 12), device=dev))

    def physics_step(self, state, actions, params, gen):
        m = self.model
        dp = self._dyn_params(params)
        h = self.dt / self.substeps
        n = actions.shape[0]
        a = torch.clamp(actions, -1, 1)
        # Leg PD drives solved implicitly in forward_dynamics (PhysX drive
        # semantics): explicit tau-PD goes unstable on the light shank
        # axes under small-mass DR corners.
        kp_dof = actions.new_zeros(n, m.nv).index_fill_(1, self._act_v,
                                                        self.kp)
        kd_dof = actions.new_zeros(n, m.nv).index_fill_(1, self._act_v,
                                                        self.kd)
        tgt_dof = actions.new_zeros(n, m.nv)
        tgt_dof[:, self._act_v] = self._default_dof + a * self.action_scale
        zero_tau = actions.new_zeros(n, m.nv)
        q, v = state.q, state.v
        for _ in range(self.substeps):
            kin = forward_kinematics(m, q, v, dp)
            f_ext = ground_contact_forces(m, kin, dp, dt=h)
            qdd, _ = forward_dynamics(
                m, q, v, zero_tau, dp, f_ext, dt=h, kin=kin, drive_kp=kp_dof,
                drive_kd=kd_dof, drive_target=tgt_dof, drive_effort=80.0)
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        return AnymalState(q=q, v=v, commands=state.commands,
                           prev_actions=a)

    def _base_frames(self, state):
        R = quat_to_rot(state.q[:, 3:7])
        return R, state.v[:, 3:6], state.v[:, 0:3]

    def observe(self, state, params):
        R, v_b, w_b = self._base_frames(state)
        grav = -R[:, 2, :]               # R^T (0, 0, -1): base-frame gravity
        dof_pos = state.q[:, self._act_q] - self._default_dof
        dof_vel = state.v[:, self._act_v]
        return torch.cat([
            v_b * self.lin_vel_scale, w_b * self.ang_vel_scale, grav,
            state.commands * self._cmd_scale, dof_pos,
            dof_vel * self.dof_vel_scale, state.prev_actions], dim=-1)

    def reward(self, state, actions, params):
        R, v_b, w_b = self._base_frames(state)
        lin_err = ((state.commands[:, :2] - v_b[:, :2]) ** 2).sum(-1)
        ang_err = (state.commands[:, 2] - w_b[:, 2]) ** 2
        rew = (torch.exp(-lin_err / 0.25) + 0.5 * torch.exp(-ang_err / 0.25)
               - 0.02 * (torch.clamp(actions, -1, 1) ** 2).sum(-1))
        return torch.where(self._base_down(state, R), -2.0, rew)

    def _base_down(self, state, R=None):
        if R is None:
            R = quat_to_rot(state.q[:, 3:7])
        return (state.q[:, 2] < 0.3) | (R[:, 2, 2] < 0.6)

    def early_termination(self, state, params):
        return self._base_down(state)

    def render_obs_frame(self, obs_row, height=200, width=200):
        """Side-view schematic from one observation row. The obs is
        egocentric, so the body is drawn at nominal height, pitched by the
        measured gravity direction, with the four legs posed by their
        thigh/shank angles and command-vs-actual velocity arrows on top."""
        obs = np.asarray(obs_row, np.float64)
        grav = obs[6:9]                       # gravity dir in base frame
        pitch = np.arctan2(grav[0], -grav[2])
        dof = obs[12:24]                      # (hip, thigh, shank) x 4
        img = np.full((height, width, 3), 255, np.uint8)
        scale = width / 2.0                   # 2 m field of view
        cx = width // 2
        gy = height - int(0.08 * height)
        img[gy:gy + 2, :] = (120, 120, 120)   # ground
        by = gy - int(BASE_Z * scale * 0.8)

        def line(x0, y0, x1, y1, color, thick=1):
            draw_line(img, x0, y0, x1, y1, color, thick)

        half = 0.28 * scale
        c, s = np.cos(pitch), np.sin(pitch)
        line(cx - int(half * c), by - int(half * s),
             cx + int(half * c), by + int(half * s),
             (150, 111, 214), 3)
        for i, (nm, fx, _) in enumerate(LEGS):
            hx = cx + int(fx * half * c)
            hy = by + int(fx * half * s)
            _, th_def, sh_def = DEFAULT_ANGLES[nm]
            th = pitch + th_def + dof[3 * i + 1]
            kx = hx + int(THIGH_LEN * scale * np.sin(th))
            ky = hy + int(THIGH_LEN * scale * np.cos(th))
            line(hx, hy, kx, ky, (80, 80, 80), 1)
            sh = th + sh_def + dof[3 * i + 2]
            fx2 = kx + int(SHANK_LEN * scale * np.sin(sh))
            fy2 = ky + int(SHANK_LEN * scale * np.cos(sh))
            line(kx, ky, fx2, fy2, (40, 40, 40), 1)
        # Command (blue) vs actual (green) forward velocity, top strip.
        cmd_vx = obs[9] / self.lin_vel_scale
        act_vx = obs[0] / self.lin_vel_scale
        y0 = int(0.08 * height)
        line(cx, y0, cx + int(np.clip(cmd_vx, -1, 1) * 0.4 * width), y0,
             (77, 77, 204), 1)
        line(cx, y0 + 6, cx + int(np.clip(act_vx, -1, 1) * 0.4 * width),
             y0 + 6, (90, 170, 90), 1)
        return img
