"""ShadowHand cube reorientation: 26 hand bodies, 24 dofs, 4 coupled
tendons, a free cube and a goal orientation.

Port of ``bayes_sim_ig_tpu/sim/shadow_hand.py``: a fixed, palm-up
Shadow-like hand (wrist WRJ1/WRJ0; FF/MF/RF with J3 abduction and J2/J1/J0
flexion; LF adding the J4 metacarpal; a 5-dof thumb) and a cube resting on
the palm. The J1/J0 pairs of the four fingers are coupled by tendon
springs whose stiffness is domain-randomized.

DR layout (cfg/shadow_hand.yaml): actor 'hand' with 4 additive
tendon-stiffness dims (T_FFJ1c..T_LFJ1c) and 26 body-mass multipliers,
then actor 'object' with one scale and one mass multiplier: 32 params.
``shadow_hand_more.yaml`` adds tendon damping, drive stiffness and
damping and shape frictions (111). The scheduled correlated obs/action
noise goes through the task noise hooks; the gravity randomization is
drawn per episode into the task state.

Contacts, each set one vectorized call a substep: the cube's 8 corners on
the palm plane (geometry only: the impulse pass owns it, with Coulomb
rows), the 14 hand spheres and 14 line-contact extras on the cube with
exact sphere-box geometry (penalty), and 13 finger-finger sphere pairs
(penalty). The velocity-level impulse pass backs all 35 primary pairs
(8 palm + 14 sphere-cube + 13 finger-finger: 51 rows with the 16 palm
friction rows) against the substep's own mass factor; it is prepared on
the first substep and reused, warm-started, on the second. The 30-dof
tree fills 0.275 of the mass matrix's triangle: the branch-sparse tree
solve, in its right-looking form (mean chain depth 3.27), so the impulse
pass takes the half-solve route (``physics/contact.py::_prepare_y``).

Obs (``observationType``): "full" or no key, the 89-dim layout: dof pos
(24), dof vel (24), cube pos rel palm (3), cube quat (4), cube lin/ang vel
(6), goal quat (4), quat difference (4), previous actions (20); +18
fingertip/palm force dims with ``forceSensorObs: true``. "full_state", the
211-dim layout: dof pos/vel/force (3x24), object 13, goal 11, fingertip
states (5x13), fingertip force/torque sensors (5x6), actions (20). Any
other value raises (the JAX package maps it to 89 dims without a word).
Actions (20): position targets of the actuated dofs (the J1s follow
through the tendons). Reward: rotation distance, action penalty, reach
bonus 250, fall distance 0.24.

The JAX package's A/B switches of this task (``BSIM_HAND_PALM_SLOP``,
``BSIM_HAND_IMPULSE``, ``BSIM_PALM_PTS``, ``BSIM_HAND_SWEEPS``) are fixed
at their defaults here: palm slop 0.002, the impulse pass on all 35
pairs, 8 palm points, 2 then 1 sweeps.
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
    external_generalized_force,
)
from ..physics.contact import (contact_pairs_impulse_apply,
                               contact_pairs_impulse_prepare,
                               impulse_generalized_force,
                               impulse_row_forces,
                               sphere_box_pairs_forces,
                               sphere_plane_pairs_forces,
                               sphere_sphere_pairs_forces)
from ..physics.dynamics import _cross, _mv
from ..physics.spatial import quat_mul, rot_to_quat
from .render2d import draw_lines
from ..utils.device import resolve_device
from .task import Task

HAND_BODIES = (
    ["robot0:hand mount", "robot0:forearm", "robot0:wrist", "robot0:palm"]
    + [f"robot0:{f}{seg}" for f in ("ff", "mf", "rf")
       for seg in ("knuckle", "proximal", "middle", "distal")]
    + ["robot0:lfmetacarpal"]
    + [f"robot0:lf{seg}" for seg in ("knuckle", "proximal", "middle",
                                     "distal")]
    + ["robot0:thbase", "robot0:thproximal", "robot0:thhub",
       "robot0:thmiddle", "robot0:thdistal"])
assert len(HAND_BODIES) == 26

TENDONS = ["T_FFJ1c", "T_MFJ1c", "T_RFJ1c", "T_LFJ1c"]
# 24 dof names in tree order (wrist, FF/MF/RF, LF incl. J4, thumb).
DOF_NAMES = (
    ["robot0:WRJ1", "robot0:WRJ0"]
    + [f"robot0:{f}J{j}" for f in ("FF", "MF", "RF") for j in (3, 2, 1, 0)]
    + [f"robot0:LFJ{j}" for j in (4, 3, 2, 1, 0)]
    + [f"robot0:THJ{j}" for j in (4, 3, 2, 1, 0)])
PALM_Z = 0.3          # palm top surface height
CUBE_HALF = 0.0325
FINGER_SEG = (0.045, 0.025, 0.022)  # proximal/middle/distal lengths
FALL_DIST = 0.24
PALM_SLOP = 0.002     # impulse rest slop of the cube-palm pairs
CUBE_SLOP = 0.006     # ... of the finger-cube pairs (finger-finger: 0)
SWEEPS = (2, 1)       # impulse sweeps on the first and later substeps
DRIVE_KP = [100.0, 100.0] + [20.0] * 18
DRIVE_KD = [4.0, 4.0] + [0.5] * 18
DRIVE_EFFORT = 3.0


def build_hand_model():
    """Returns (model, link index by name, fingertip links, DR body name ->
    link, tendon (J1, J0) link pairs, cube link): the hand fixed at the
    origin, palm up, fingers along +x; the cube free above the palm. The
    mount sits at the world origin, so the cube's free-joint q is its
    world pose."""
    links = [LinkSpec("mount", parent=-1, joint_type="fixed", mass=0.1,
                      inertia=(1e-4,) * 3)]
    idx = {"mount": 0}
    geoms = []

    def add(name, parent, jt, **kw):
        i = len(links)
        geom = kw.pop("geom", None)
        links.append(LinkSpec(name, parent=idx[parent], joint_type=jt,
                              **kw))
        idx[name] = i
        if geom is not None:
            geoms.append(Geom(link=i, **geom))
        return i

    add("forearm", "mount", "fixed", mass=1.8, inertia=(0.002,) * 3,
        joint_pos=(0, 0, PALM_Z - 0.1))
    add("wrist", "forearm", "revolute", joint_axis=(0, 1, 0),
        joint_pos=(0, 0, 0.05), mass=0.3, inertia=(1e-4,) * 3,
        damping=0.5, limit_lower=-0.49, limit_upper=0.14)   # WRJ1
    add("palm", "wrist", "revolute", joint_axis=(1, 0, 0),
        joint_pos=(0, 0, 0.05), mass=0.3, com=(0.04, 0, 0),
        inertia=(3e-4,) * 3, damping=0.5,
        limit_lower=-0.698, limit_upper=0.489)              # WRJ0
    # Regular fingers at the palm's +x edge, spread in y.
    finger_y = {"ff": 0.033, "mf": 0.011, "rf": -0.011, "lf": -0.033}
    for f in ("ff", "mf", "rf", "lf"):
        y = finger_y[f]
        parent = "palm"
        base_x = 0.09
        if f == "lf":
            add("lfmetacarpal", "palm", "revolute",
                joint_axis=(1, 0, 0), joint_pos=(0.06, y, 0.0),
                mass=0.04, inertia=(1e-5,) * 3, damping=0.1,
                limit_lower=0.0, limit_upper=0.785)          # LFJ4
            parent, base_x = "lfmetacarpal", 0.03
        add(f"{f}knuckle", parent, "revolute", joint_axis=(0, 0, 1),
            joint_pos=(base_x, y if parent == "palm" else 0.0, 0.0),
            mass=0.01, inertia=(1e-6,) * 3, damping=0.1,
            limit_lower=-0.349, limit_upper=0.349)           # J3 abduction
        add(f"{f}proximal", f"{f}knuckle", "revolute",
            joint_axis=(0, -1, 0), mass=0.03,
            com=(FINGER_SEG[0] / 2, 0, 0), inertia=(1e-5,) * 3,
            damping=0.1, limit_lower=0.0, limit_upper=1.571,  # J2
            geom=dict(kind="sphere", size=(0.011,),
                      offset=(FINGER_SEG[0] * 0.6, 0, 0)))
        add(f"{f}middle", f"{f}proximal", "revolute",
            joint_axis=(0, -1, 0), joint_pos=(FINGER_SEG[0], 0, 0),
            mass=0.02, com=(FINGER_SEG[1] / 2, 0, 0),
            inertia=(5e-6,) * 3, damping=0.1,
            limit_lower=0.0, limit_upper=1.571,              # J1
            geom=dict(kind="sphere", size=(0.010,),
                      offset=(FINGER_SEG[1] * 0.6, 0, 0)))
        add(f"{f}distal", f"{f}middle", "revolute",
            joint_axis=(0, -1, 0), joint_pos=(FINGER_SEG[1], 0, 0),
            mass=0.02, com=(FINGER_SEG[2] / 2, 0, 0),
            inertia=(5e-6,) * 3, damping=0.1,
            limit_lower=0.0, limit_upper=1.571,              # J0
            geom=dict(kind="sphere", size=(0.009,),
                      offset=(FINGER_SEG[2], 0, 0)))
    # Thumb: 5 dofs from the palm's -y side.
    add("thbase", "palm", "revolute", joint_axis=(0, 0, 1),
        joint_pos=(0.03, -0.04, 0.0), mass=0.04, inertia=(1e-5,) * 3,
        damping=0.1, limit_lower=-1.047, limit_upper=1.047)  # THJ4
    add("thproximal", "thbase", "revolute", joint_axis=(1, 0, 0),
        mass=0.04, com=(0.02, -0.02, 0), inertia=(1e-5,) * 3,
        damping=0.1, limit_lower=0.0, limit_upper=1.222)     # THJ3
    add("thhub", "thproximal", "revolute", joint_axis=(0, 1, 0),
        joint_pos=(0.03, -0.03, 0), mass=0.02, inertia=(5e-6,) * 3,
        damping=0.1, limit_lower=-0.209, limit_upper=0.209)  # THJ2
    add("thmiddle", "thhub", "revolute", joint_axis=(0, -1, 0),
        mass=0.02, com=(0.016, 0, 0), inertia=(5e-6,) * 3,
        damping=0.1, limit_lower=-0.524, limit_upper=0.524,  # THJ1
        geom=dict(kind="sphere", size=(0.011,),
                  offset=(0.02, 0, 0)))
    add("thdistal", "thmiddle", "revolute", joint_axis=(0, -1, 0),
        joint_pos=(0.032, 0, 0), mass=0.02, com=(0.014, 0, 0),
        inertia=(5e-6,) * 3, damping=0.1,
        limit_lower=0.0, limit_upper=1.571,                  # THJ0
        geom=dict(kind="sphere", size=(0.009,),
                  offset=(0.028, 0, 0)))
    cube = add("cube", "mount", "free", mass=0.08, inertia=(6e-5,) * 3)
    model = ArticulatedModel(links, geoms, fixed_base=False)
    fingertips = [idx[f"{f}distal"] for f in ("ff", "mf", "rf", "lf")]
    fingertips.append(idx["thdistal"])
    # Internal link index per DR body name (mount covers 'hand mount').
    name_map = {"robot0:hand mount": idx["mount"],
                "robot0:forearm": idx["forearm"],
                "robot0:wrist": idx["wrist"],
                "robot0:palm": idx["palm"],
                "robot0:lfmetacarpal": idx["lfmetacarpal"],
                "robot0:thbase": idx["thbase"],
                "robot0:thproximal": idx["thproximal"],
                "robot0:thhub": idx["thhub"],
                "robot0:thmiddle": idx["thmiddle"],
                "robot0:thdistal": idx["thdistal"]}
    for f in ("ff", "mf", "rf", "lf"):
        for seg in ("knuckle", "proximal", "middle", "distal"):
            name_map[f"robot0:{f}{seg}"] = idx[f"{f}{seg}"]
    # Tendon-coupled (J1, J0) dof pairs per finger.
    tendon_pairs = [(idx[f"{f}middle"], idx[f"{f}distal"])
                    for f in ("ff", "mf", "rf", "lf")]
    return model, idx, fingertips, name_map, tendon_pairs, cube


# Cube face normals (cube frame) and corners (unit half-size).
_FACES = np.asarray([(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                     (0, 0, 1), (0, 0, -1)], np.float32)
_CORNERS = [(sx, sy, sz) for sx in (-1, 1) for sy in (-1, 1)
            for sz in (-1, 1)]


def nearest_cube_faces(kin, cube_link, sph_links, sph_offsets, cube_half,
                       n_env):
    """Per-env nearest cube face for each contact sphere: cube-frame
    (normal, point) tensors (T, 3, N). The nearest face is the one with
    the largest signed distance outside its plane (for a center inside
    the cube, the least-penetrated face). Not on the task's path (the
    sphere-box contact's closest points subsume it); kept as the tested
    selection contract."""
    dev = kin.p_w.device
    n_sph = len(sph_links)
    idx = torch.as_tensor(np.asarray(sph_links, np.int64), device=dev)
    R_c, p_c = kin.R_w[cube_link], kin.p_w[cube_link]
    off = torch.as_tensor(np.asarray(sph_offsets, np.float32), device=dev)
    off = off[:, :, None].expand(n_sph, 3, n_env)
    center = kin.p_w[idx] + _mv(kin.R_w[idx], off)            # world
    d = center - p_c[None]
    c_loc = (R_c[None] * d[:, :, None, :]).sum(1)              # R_c^T d
    faces = torch.as_tensor(_FACES, device=dev)
    cube_half = torch.as_tensor(cube_half, dtype=torch.float32, device=dev)
    dists = (faces[None, :, :, None] * c_loc[:, None]).sum(2) \
        - cube_half[None, None, :]                             # (T, 6, N)
    sel = torch.nn.functional.one_hot(torch.argmax(dists, dim=1),
                                      len(_FACES)).to(torch.float32)
    nrm = (sel[:, :, :, None] * faces[None, None]).sum(2)      # (T, N, 3)
    nrm = nrm.permute(0, 2, 1)                                 # (T, 3, N)
    return nrm, nrm * cube_half[None, None, :]


class HandState(NamedTuple):
    q: torch.Tensor
    v: torch.Tensor
    goal_quat: torch.Tensor     # (N, 4)
    prev_actions: torch.Tensor  # (N, 20)
    gravity_dz: torch.Tensor    # (N,) per-episode gravity perturbation
    # (N, 18) world-frame contact forces at the 5 fingertip sensors and
    # the palm, from the step's own contact solve; zeros unless
    # forceSensorObs or the full_state obs reads them.
    tip_force: torch.Tensor
    # full_state only (zeros otherwise):
    tip_torque: torch.Tensor    # (N, 15) contact torques about each tip
    tip_state: torch.Tensor     # (N, 65) 5 x [pos, quat, linvel, angvel]
    dof_force: torch.Tensor     # (N, 24) drive + tendon + contact force


def _random_quat(gen, n, device):
    """(n, 4) uniform random unit quaternions (w, x, y, z)."""
    u = env_draw(torch.rand, (n, 3), gen, device=device)
    x = torch.sqrt(1 - u[:, 0]) * torch.sin(2 * np.pi * u[:, 1])
    y = torch.sqrt(1 - u[:, 0]) * torch.cos(2 * np.pi * u[:, 1])
    z = torch.sqrt(u[:, 0]) * torch.sin(2 * np.pi * u[:, 2])
    w = torch.sqrt(u[:, 0]) * torch.cos(2 * np.pi * u[:, 2])
    return torch.stack([w, x, y, z], dim=1)


class ShadowHand(Task):
    name = "ShadowHand"
    obs_dim = 89
    act_dim = 20
    dt = 1.0 / 60.0
    substeps = 2
    # Finger flexion/opposition action dims for `policy_grasp`. Action
    # layout: [WRJ1, WRJ0, FFJ3(abd), FFJ2, FFJ0c, MFJ3, MFJ2, MFJ0c,
    # RFJ3, RFJ2, RFJ0c, LFJ4, LFJ3, LFJ2, LFJ0c, THJ4, THJ3, THJ2, THJ1,
    # THJ0].
    grasp_excitation_dims = (3, 4, 6, 7, 9, 10, 13, 14, 16, 19)
    # Obs scales of the full_state blocks (dof and object velocities;
    # forces and torques).
    VEL_OBS_SCALE = 0.2
    FORCE_TORQUE_OBS_SCALE = 0.05

    def __init__(self, cfg, device="cuda"):
        self.device = dev = resolve_device(device)
        env_cfg = cfg["env"]
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg.get("episodeLength", 600))
        self.rot_eps = float(env_cfg.get("rotEps", 0.1))
        self.rot_reward_scale = float(env_cfg.get("rotRewardScale", 1.0))
        self.dist_reward_scale = float(
            env_cfg.get("distRewardScale", -10.0))
        self.action_penalty_scale = float(
            env_cfg.get("actionPenaltyScale", -0.0002))
        self.reach_goal_bonus = float(env_cfg.get("reachGoalBonus", 250))
        self.fall_dist = float(env_cfg.get("fallDistance", FALL_DIST))
        self.fall_penalty = float(env_cfg.get("fallPenalty", 0.0))
        self.obs_type = str(env_cfg.get("observationType", "full")).lower()
        if self.obs_type not in ("full", "full_state"):
            raise ValueError(
                f"ShadowHand observationType {self.obs_type!r}: the port "
                f"takes 'full' (89 dims, 107 with forceSensorObs) or "
                f"'full_state' (211)")
        self.full_state_obs = self.obs_type == "full_state"
        self.force_sensor_obs = bool(env_cfg.get("forceSensorObs", False))
        if self.full_state_obs:
            self.obs_dim = 211
        elif self.force_sensor_obs:
            self.obs_dim = ShadowHand.obs_dim + 18
        (self.model, self._idx, self._fingertips, name_map,
         self._tendon_pairs, self._cube) = build_hand_model()
        m = self.model
        self._cube_q = m.q_off[self._cube]
        self._cube_v = m.v_off[self._cube]
        self._palm = self._idx["palm"]
        # All 24 hand dofs in tree order; the four J1 (middle) dofs are
        # tendon-driven, the other 20 actuated.
        self._hand_dof_links = [i for i in range(m.nb)
                                if m.joint_types[i] == "revolute"]
        assert len(self._hand_dof_links) == 24
        coupled = {p[0] for p in self._tendon_pairs}
        self._actuated_links = [i for i in self._hand_dof_links
                                if i not in coupled]
        assert len(self._actuated_links) == 20
        self._act_lo = np.asarray([m.limit_lower[m.v_off[i]]
                                   for i in self._actuated_links],
                                  np.float32)
        self._act_hi = np.asarray([m.limit_upper[m.v_off[i]]
                                   for i in self._actuated_links],
                                  np.float32)
        # DR spec: hand tendons and masses, then object scale and mass.
        hand_mass = np.array([m.mass0[name_map[b]] for b in HAND_BODIES])
        self.params_spec = build_params_spec(
            cfg["task"]["randomization_params"],
            actor_names_map={
                "hand": TaskNames(body_names=HAND_BODIES,
                                  shape_names=HAND_BODIES,
                                  dof_names=DOF_NAMES,
                                  tendon_names=TENDONS),
                "object": TaskNames(body_names=["object"],
                                    shape_names=["object"],
                                    dof_names=[], tendon_names=[]),
            },
            defaults_map={
                "hand": {
                    "tendon_properties": {"stiffness": np.zeros(4),
                                          "damping": np.ones(4)},
                    "dof_properties": {"stiffness": np.ones(24),
                                       "damping": np.ones(24)},
                    "rigid_body_properties": {"mass": hand_mass},
                    "rigid_shape_properties": {"friction": np.ones(26)},
                },
                "object": {
                    "scale": {"": 1.0},
                    "rigid_body_properties": {"mass": np.array([0.08])},
                    "rigid_shape_properties": {"friction": np.ones(1)},
                },
            },
            plot_names_skip_patterns=cfg["task"].get(
                "plotNamesSkipPatterns"))
        keys = self.params_spec.keys

        def dims(pred):
            return [i for i, k in enumerate(keys) if pred(k)]
        self._tendon_dims = dims(lambda k: k[1] == "tendon_properties"
                                 and k[3] == "stiffness")
        # Dims only shadow_hand_more.yaml has:
        self._tendon_damp_dims = dims(lambda k: k[1] == "tendon_properties"
                                      and k[3] == "damping")
        self._dof_stiff_dims = dims(lambda k: k[0] == "hand"
                                    and k[1] == "dof_properties"
                                    and k[3] == "stiffness")
        self._dof_damp_dims = dims(lambda k: k[0] == "hand"
                                   and k[1] == "dof_properties"
                                   and k[3] == "damping")
        self._hand_fric_dims = dims(lambda k: k[0] == "hand"
                                    and k[1] == "rigid_shape_properties"
                                    and k[3] == "friction")
        self._obj_fric_dims = dims(lambda k: k[0] == "object"
                                   and k[1] == "rigid_shape_properties"
                                   and k[3] == "friction")
        self._hand_mass_dims = dims(lambda k: k[0] == "hand"
                                    and k[3] == "mass")
        # Optional like every other dim: a config without them keeps the
        # model defaults.
        scale = dims(lambda k: k[1] == "scale")
        self._scale_dim = scale[0] if scale else None
        obj_mass = dims(lambda k: k[0] == "object" and k[3] == "mass")
        self._obj_mass_dim = obj_mass[0] if obj_mass else None
        self._hand_links = [name_map[b] for b in HAND_BODIES]
        # Hand contact spheres (fingertips, proximal/middle phalanges and
        # the thumb middle) with their body's name for friction DR.
        link_to_body = {v: k for k, v in name_map.items()}
        self._hand_spheres = [(g.link, g, link_to_body[g.link])
                              for g in m.geoms if g.link != self._cube]
        # Line-contact points: each phalanx gets a second penalty point
        # near its proximal end, the two-point manifold of a capsule on a
        # face; penalty only (the impulse pass keeps the primaries).
        self._extra_pts = []                     # (link, offset, r, name)
        for f in ("ff", "mf", "rf", "lf"):
            self._extra_pts += [
                (self._idx[f + "proximal"],
                 (FINGER_SEG[0] * 0.2, 0, 0), 0.011, f"robot0:{f}proximal"),
                (self._idx[f + "middle"],
                 (FINGER_SEG[1] * 0.2, 0, 0), 0.010, f"robot0:{f}middle"),
                (self._idx[f + "distal"],
                 (FINGER_SEG[2] * 0.45, 0, 0), 0.009, f"robot0:{f}distal"),
            ]
        self._extra_pts += [
            (self._idx["thmiddle"], (0.008, 0, 0), 0.011,
             "robot0:thmiddle"),
            (self._idx["thdistal"], (0.012, 0, 0), 0.009,
             "robot0:thdistal")]
        # The penalty box-contact points: primaries first, then extras.
        self._box_pts = ([(l, tuple(g.offset), g.size[0], n)
                          for (l, g, n) in self._hand_spheres]
                         + self._extra_pts)
        # Finger-finger sphere pairs: adjacent fingers segment by segment,
        # and the thumb against the FF/MF/RF tips. Sphere order in
        # _hand_spheres: ff/mf/rf/lf x (proximal, middle, distal), then
        # thmiddle, thdistal.
        adj = [(f, f + 1) for f in range(3)]
        self._ss_pairs = [(a * 3 + seg, b * 3 + seg)
                          for (a, b) in adj for seg in range(3)]
        self._ss_pairs += [(13, 2), (13, 5), (13, 8), (12, 2)]
        self.setup_noise(cfg["task"]["randomization_params"])
        self._grav_cfg = cfg["task"]["randomization_params"].get(
            "sim_params", {}).get("gravity")
        self._static_tables()

    def _static_tables(self):
        """The contact sets' static arrays and the index tensors of the
        step, built once."""
        m, dev = self.model, self.device

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=dev)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self._sph_links = [l for (l, _g, _n) in self._hand_spheres]
        n_sph = len(self._sph_links)
        sph_off = np.asarray([g.offset for (_l, g, _n)
                              in self._hand_spheres], np.float32)
        sph_radii = np.asarray([g.size[0] for (_l, g, _n)
                                in self._hand_spheres], np.float32)
        self._box_links = [l for (l, _o, _r, _n) in self._box_pts]
        self._box_off = np.asarray([o for (_l, o, _r, _n) in self._box_pts],
                                   np.float32)
        self._box_radii = np.asarray([r for (_l, _o, r, _n)
                                      in self._box_pts], np.float32)
        ss_ai = np.asarray([a for a, _b in self._ss_pairs])
        ss_bi = np.asarray([b for _a, b in self._ss_pairs])
        self._ss_ai, self._ss_bi = idx(ss_ai), idx(ss_bi)
        self._ss_links_a = [self._sph_links[i] for i in ss_ai]
        self._ss_links_b = [self._sph_links[i] for i in ss_bi]
        self._ss_off_a, self._ss_off_b = sph_off[ss_ai], sph_off[ss_bi]
        self._ss_radii_a = sph_radii[ss_ai]
        self._ss_radii_b = sph_radii[ss_bi]
        self._n_sph = n_sph
        # One impulse pair set: corner-palm, sphere-cube, finger-finger.
        self._imp_links_a = ([self._cube] * 8 + self._sph_links
                             + self._ss_links_a)
        self._imp_links_b = ([self._palm] * 8 + [self._cube] * n_sph
                             + self._ss_links_b)
        self._imp_slop = np.asarray(
            [PALM_SLOP] * 8 + [CUBE_SLOP] * n_sph
            + [0.0] * len(self._ss_links_a), np.float32)
        self._palm_pt = f32([(0.06, 0.0, 0.012)] * 8)
        self._palm_nrm = f32([(0.0, 0.0, 1.0)] * 8)
        self._corner = f32(_CORNERS)
        self._palm_radii = np.full(8, 0.002, np.float32)
        self._palm_half = np.full(8, 0.12, np.float32)
        # Row layout of the impulse payload: each fingertip's cube rows
        # and the rows whose reaction side is the palm.
        la, lb = self._imp_links_a, self._imp_links_b
        rows_a = la + la[:8] * 2
        rows_b = lb + lb[:8] * 2
        self._tip_rows = [idx([r for r in range(len(rows_a))
                               if rows_a[r] == tl and rows_b[r] == self._cube])
                          for tl in self._fingertips]
        self._palm_rows = idx([r for r in range(len(rows_b))
                               if rows_b[r] == self._palm])
        self._dof_q = idx([m.q_off[i] for i in self._hand_dof_links])
        self._dof_v = idx([m.v_off[i] for i in self._hand_dof_links])
        self._act_v = idx([m.v_off[i] for i in self._actuated_links])
        self._act_q = idx([m.q_off[i] for i in self._actuated_links])
        self._act_lo_t, self._act_hi_t = f32(self._act_lo), f32(self._act_hi)
        self._tendon_v1 = idx([m.v_off[j1] for j1, _ in self._tendon_pairs])
        self._tendon_v0 = idx([m.v_off[j0] for _, j0 in self._tendon_pairs])
        self._tendon_q1 = idx([m.q_off[j1] for j1, _ in self._tendon_pairs])
        self._tendon_q0 = idx([m.q_off[j0] for _, j0 in self._tendon_pairs])
        self._kp, self._kd = f32(DRIVE_KP), f32(DRIVE_KD)
        act_pos = [self._hand_dof_links.index(i)
                   for i in self._actuated_links]
        self._stiff_cols = idx([self._dof_stiff_dims[j] for j in act_pos]) \
            if self._dof_stiff_dims else None
        body_pos = {b: j for j, b in enumerate(HAND_BODIES)}
        if self._hand_fric_dims:
            self._pts_fric_cols = idx([self._hand_fric_dims[body_pos[name]]
                                       for (*_x, name) in self._box_pts])
            self._palm_fric_dim = \
                self._hand_fric_dims[body_pos["robot0:palm"]]
        self._hand_links_t = idx(self._hand_links)
        # The DR dims a step reads, as index tensors.
        self._tendon_cols = idx(self._tendon_dims)
        self._tendon_damp_cols = idx(self._tendon_damp_dims)
        self._dof_damp_cols = idx(self._dof_damp_dims)
        self._hand_mass_cols = idx(self._hand_mass_dims)
        self._z_axis = f32([0.0, 0.0, 1.0])
        self._quat_conj = f32([1.0, -1.0, -1.0, -1.0])
        # The reset pose: the cube's orientation the identity quaternion.
        self._q0 = torch.as_tensor(m.neutral_q(), dtype=torch.float32,
                                   device=dev)
        self._q0[self._cube_q + 3] = 1.0
        self._base = DynParams.defaults(m, device=dev)
        self._palm_anchor = f32([0.06, 0.0, PALM_Z])
        self._fall_anchor = f32([0.06, 0.0, PALM_Z + 0.05])

    # ------------------------------------------------------------------ #
    def _obj_scale(self, params):
        """(N,) object-scale multipliers (1 without a scale dim)."""
        if self._scale_dim is None:
            return params.new_ones(params.shape[0])
        return params[:, self._scale_dim]

    def _dyn_params(self, params, gravity_dz) -> DynParams:
        """Every env's DynParams: hand and object masses multiply (the
        cube's inertia also by the object scale squared), dof damping
        scales where the config has those dims, and gravity gets the
        episode's perturbation. ``scale`` stays 1: the task applies the
        object scale to the cube geometry itself."""
        base = self._base
        n = params.shape[0]
        mass = base.mass.expand(n, -1).clone()
        if self._hand_mass_dims:
            mass[:, self._hand_links_t] *= params[:, self._hand_mass_cols]
        if self._obj_mass_dim is not None:
            mass[:, self._cube] *= params[:, self._obj_mass_dim]
        inertia = base.inertia * (mass / base.mass)[:, :, None]
        s = self._obj_scale(params)
        inertia[:, self._cube] *= (s ** 2)[:, None]
        fields = dict(mass=mass, inertia=inertia)
        if self._dof_damp_dims:
            damping = base.damping.expand(n, -1).clone()
            damping[:, self._dof_v] *= params[:, self._dof_damp_cols]
            fields["damping"] = damping
        gravity = base.gravity + gravity_dz[:, None] * self._z_axis
        return base.rows(n, gravity=gravity, **fields)

    def _contact_frictions(self, params):
        """Friction multipliers of the penalty points (N, n_box), the palm
        (N,) and the cube (N,), from the shape-friction dims
        (shadow_hand_more.yaml only; 1 otherwise)."""
        n = params.shape[0]
        ones = params.new_ones(n)
        if self._hand_fric_dims:
            pts_mu = params[:, self._pts_fric_cols]
            palm_mu = params[:, self._palm_fric_dim]
        else:
            pts_mu = params.new_ones(n, len(self._box_pts))
            palm_mu = ones
        obj_mu = (params[:, self._obj_fric_dims[0]]
                  if self._obj_fric_dims else ones)
        return pts_mu, palm_mu, obj_mu

    def init_state(self, gen, params):
        n = params.shape[0]
        m = self.model
        dev = params.device
        cq = self._cube_q
        q = self._q0.expand(n, -1).clone()
        # Cube resting on the palm (its top near PALM_Z), scaled half-size.
        s = self._obj_scale(params)
        cube_xy = env_draw(torch.rand, (n, 2), gen, device=dev) * 0.02 - 0.01
        q[:, cq + 0] = 0.06 + cube_xy[:, 0]
        q[:, cq + 1] = cube_xy[:, 1]
        q[:, cq + 2] = PALM_Z + 0.012 + CUBE_HALF * s
        # Slightly randomized hand dofs.
        q[:, self._dof_q] += env_draw(torch.rand, (n, 24), gen,
                                      device=dev) * 0.2
        goal = _random_quat(gen, n, dev)
        if self._grav_cfg is not None:
            g_var = float(self._grav_cfg["range"][1])
            gravity_dz = env_draw(torch.randn, (n,), gen, device=dev) * g_var
        else:
            gravity_dz = torch.zeros(n, device=dev)
        z = params.new_zeros
        return HandState(q=q, v=z(n, m.nv), goal_quat=goal,
                         prev_actions=z(n, 20), gravity_dz=gravity_dz,
                         tip_force=z(n, 18), tip_torque=z(n, 15),
                         tip_state=z(n, 65), dof_force=z(n, 24))

    def physics_step(self, state, actions, params, gen):
        m = self.model
        n_env = actions.shape[0]
        dp = self._dyn_params(params, state.gravity_dz)
        h = self.dt / self.substeps
        a = torch.clamp(actions, -1.0, 1.0)
        targets = self._act_lo_t + (a + 1.0) * 0.5 * (self._act_hi_t
                                                      - self._act_lo_t)
        s = self._obj_scale(params)                             # (N,)
        if self._tendon_dims:  # additive stiffness DR dims
            tendon_k = 50.0 + params[:, self._tendon_cols]
        else:
            tendon_k = params.new_full((n_env, 4), 50.0)
        tendon_d = (params[:, self._tendon_damp_cols]
                    if self._tendon_damp_dims else torch.ones_like(tendon_k))
        # Servo gains: stiff wrist drives hold the hand against gravity,
        # finger servos are position drives, all solved implicitly.
        kp, kd = self._kp, self._kd
        if self._stiff_cols is not None:
            kp = kp * params[:, self._stiff_cols]
        tip_mu, palm_mu, obj_mu = self._contact_frictions(params)

        # Object scale is applied here (pre-scaled corner offsets, box
        # half-extents, init height and cube inertia) and dp.scale stays
        # 1, so the contact functions' own scale multiply is the identity.
        cube_half = CUBE_HALF * s                               # (N,)
        corner_off = self._corner[:, :, None] * cube_half       # (8, 3, N)
        half3 = cube_half[None].expand(3, n_env)
        mu_palm = (palm_mu * obj_mu)[None].expand(8, n_env)
        mu_box = tip_mu.T * obj_mu[None]                        # (n_box, N)
        ss_mu = tip_mu.T[self._ss_ai] * tip_mu.T[self._ss_bi]   # (13, N)

        kp_dof = actions.new_zeros(n_env, m.nv)
        kp_dof[:, self._act_v] = kp.expand(n_env, 20)
        kd_dof = actions.new_zeros(n_env, m.nv)
        kd_dof[:, self._act_v] = kd.expand(n_env, 20)
        tgt_dof = actions.new_zeros(n_env, m.nv)
        tgt_dof[:, self._act_v] = targets

        q, v = state.q, state.v
        prep = warm = stash = None
        for sub in range(self.substeps):
            # Tendon coupling: spring-damper pulling q_J1 toward q_J0.
            delta = q[:, self._tendon_q1] - q[:, self._tendon_q0]
            ddot = v[:, self._tendon_v1] - v[:, self._tendon_v0]
            f_t = tendon_k * 0.01 * delta + tendon_d * 0.002 * ddot
            tau = actions.new_zeros(n_env, m.nv)
            tau[:, self._tendon_v1] = -f_t
            tau[:, self._tendon_v0] = f_t
            kin = forward_kinematics(m, q, v, dp)
            # Cube-palm: geometry only, the velocity-level pass owns it.
            _, geo_palm = sphere_plane_pairs_forces(
                m, kin, dp, [self._cube] * 8, corner_off, self._palm_radii,
                [self._palm] * 8, self._palm_pt, self._palm_nrm, mu_palm,
                dt=h, plane_halfsizes=self._palm_half,
                return_geometry=True, forces=False)
            f_box, geo_box = sphere_box_pairs_forces(
                m, kin, dp, self._box_links, self._box_off, self._box_radii,
                self._cube, half3, mu_box, dt=h, return_geometry=True)
            f_ss, geo_ss = sphere_sphere_pairs_forces(
                m, kin, dp, self._ss_links_a, self._ss_off_a,
                self._ss_radii_a, self._ss_links_b, self._ss_off_b,
                self._ss_radii_b, mu=ss_mu, dt=h, return_geometry=True)
            f_ext = f_box + f_ss
            # The sensors read the last substep's solve (pre-integration
            # kinematics, h stale against the post-step state).
            stash = (f_box, kin, f_ext, tau)
            # The impulse set keeps the primary box rows only.
            geo = tuple(torch.cat([p, b[:self._n_sph], c], 0)
                        for p, b, c in zip(geo_palm, geo_box, geo_ss))
            qdd, _, factor = forward_dynamics(
                m, q, v, tau, dp, f_ext, dt=h, kin=kin, return_factor=True,
                drive_kp=kp_dof, drive_kd=kd_dof, drive_target=tgt_dof,
                drive_effort=DRIVE_EFFORT)
            # Velocity-level contacts before the position update: Coulomb
            # rows on the 8 cube-palm pairs, prepared on the first substep
            # (against its factor) and reused, warm-started, after.
            if prep is None:
                prep = contact_pairs_impulse_prepare(
                    m, kin, factor, self._imp_links_a, self._imp_links_b,
                    geo[0], geo[2], mu=mu_palm, fric_pairs=np.arange(8))
            v_pred = v + h * qdd
            v_res, warm = contact_pairs_impulse_apply(
                prep, v_pred, geo[1], dt=h, slop=self._imp_slop,
                iters=SWEEPS[min(sub, len(SWEEPS) - 1)], warm=warm,
                return_warm=True)
            qdd = qdd + (v_res - v_pred) / h
            q, v = integrate_and_clamp(m, q, v, qdd, h)
        z = actions.new_zeros
        tip_force, tip_torque = z(n_env, 18), z(n_env, 15)
        tip_state, dof_force = z(n_env, 65), z(n_env, 24)
        if self.force_sensor_obs or self.full_state_obs:
            tip_force, tip_torque = self._sensor_forces(
                stash, warm, prep, h, torques=self.full_state_obs)
        if self.full_state_obs:
            _f_box, kin_s, f_ext_s, tau_s = stash
            tip_state = self._tip_states(kin_s)
            dof_force = self._dof_forces(q, v, targets, kp, kd, tau_s, kin_s,
                                         f_ext_s, prep, warm, h)
        return HandState(q=q, v=v, goal_quat=state.goal_quat,
                         prev_actions=a, gravity_dz=state.gravity_dz,
                         tip_force=tip_force, tip_torque=tip_torque,
                         tip_state=tip_state, dof_force=dof_force)

    def _sensor_forces(self, stash, warm, payload, h, torques=False):
        """World-frame contact forces at the 5 fingertip sensors and the
        palm, (N, 18), from the last substep's solve: each tip's penalty
        wrench plus its impulse cube rows; the palm's impulse rows with the
        reaction sign (force on the palm from the cube). With ``torques``
        also (N, 15): the contact torque about each fingertip link origin
        (zeros otherwise)."""
        f_box, kin, _f_ext, _tau = stash
        n = f_box.shape[-1]
        rf = impulse_row_forces(payload, warm[0], h)           # (R, 3, N)
        cpt = payload["cpt"]
        rows, trq = [], []
        for tl, ridx in zip(self._fingertips, self._tip_rows):
            f = f_box[tl, 3:] + rf[ridx].sum(0)                # on the tip
            rows.append(f)
            if torques:
                arm = cpt[ridx] - kin.p_w[tl][None]
                trq.append(f_box[tl, :3] + _cross(arm, rf[ridx]).sum(0))
        rows.append(-rf[self._palm_rows].sum(0))
        tip_torque = (torch.cat(trq, 0).T if torques
                      else f_box.new_zeros(n, 15))
        return torch.cat(rows, 0).T, tip_torque

    def _tip_states(self, kin):
        """(N, 65): per fingertip [world pos, quat, world linvel, world
        angvel] (kin.v is body-coordinate [w; vl] at the link origin)."""
        cols = []
        for tl in self._fingertips:
            R = kin.R_w[tl]                                    # (3, 3, N)
            cols += [kin.p_w[tl], rot_to_quat(R), _mv(R, kin.v[tl, 3:]),
                     _mv(R, kin.v[tl, :3])]
        return torch.cat(cols, 0).T

    def _dof_forces(self, q, v, targets, kp, kd, tau, kin, f_ext, payload,
                    warm, h):
        """(N, 24) generalized force on the hand dofs: the implicit drive's
        torque at the post-step state (clipped at the drive effort), the
        tendon torques, and J^T of the last substep's penalty and impulse
        contact forces."""
        drive = torch.clamp(kp * (targets - q[:, self._act_q])
                            - kd * v[:, self._act_v],
                            -DRIVE_EFFORT, DRIVE_EFFORT)       # (N, 20)
        total = tau.clone()
        total[:, self._act_v] += drive
        contact = (external_generalized_force(self.model, kin, f_ext)
                   + impulse_generalized_force(payload, warm[0], h))
        return (total + contact.T)[:, self._dof_v]

    def _cube_pose(self, state):
        cq = self._cube_q
        return state.q[:, cq:cq + 3], state.q[:, cq + 3:cq + 7]

    def _quat_diff(self, qa, qb):
        return quat_mul(qa, qb * self._quat_conj)

    def observe(self, state, params):
        cv = self._cube_v
        pos, quat = self._cube_pose(state)
        diff = self._quat_diff(quat, state.goal_quat)
        rel = pos - self._palm_anchor
        if self.full_state_obs:
            # dof pos (24), dof vel (24), dof force (24), object pose and
            # velocity (13), goal pos, quat and quat difference (11),
            # fingertip states (65), force/torque sensors (30), actions.
            sens = torch.cat([
                torch.cat([state.tip_force[:, 3 * i:3 * i + 3],
                           state.tip_torque[:, 3 * i:3 * i + 3]], -1)
                for i in range(5)], -1)
            return torch.cat([
                state.q[:, self._dof_q],
                state.v[:, self._dof_v] * self.VEL_OBS_SCALE,
                state.dof_force * self.FORCE_TORQUE_OBS_SCALE,
                rel, quat, state.v[:, cv + 3:cv + 6],
                state.v[:, cv:cv + 3] * self.VEL_OBS_SCALE,
                torch.zeros_like(pos),  # goal position (the anchor)
                state.goal_quat, diff, state.tip_state,
                sens * self.FORCE_TORQUE_OBS_SCALE,
                state.prev_actions], -1)
        cols = [state.q[:, self._dof_q], state.v[:, self._dof_v], rel, quat,
                state.v[:, cv + 3:cv + 6], state.v[:, cv:cv + 3],
                state.goal_quat, diff, state.prev_actions]
        if self.force_sensor_obs:
            cols.append(state.tip_force)
        return torch.cat(cols, -1)

    def _rot_dist(self, state):
        _, quat = self._cube_pose(state)
        diff = self._quat_diff(quat, state.goal_quat)
        w = torch.clamp(torch.abs(diff[:, 0]), -1.0, 1.0)
        return 2.0 * torch.arccos(w)

    def _cube_fallen(self, state):
        pos, _ = self._cube_pose(state)
        return torch.linalg.norm(pos - self._fall_anchor,
                                 dim=-1) > self.fall_dist

    def reward(self, state, actions, params):
        rot_dist = self._rot_dist(state)
        pos, _ = self._cube_pose(state)
        dist = torch.linalg.norm(pos - self._fall_anchor, dim=-1)
        a = torch.clamp(actions, -1, 1)
        rew = (self.dist_reward_scale * dist
               + self.rot_reward_scale / (rot_dist + self.rot_eps)
               + self.action_penalty_scale * (a ** 2).sum(-1))
        rew = torch.where(rot_dist < 0.1, rew + self.reach_goal_bonus, rew)
        return torch.where(self._cube_fallen(state),
                           rew + self.fall_penalty - 2.0, rew)

    def early_termination(self, state, params):
        return self._cube_fallen(state) | (self._rot_dist(state) < 0.1)

    # ------------------------------------------------------------------ #
    def render_obs_frame(self, obs_row, height=200, width=200):
        """Top-down schematic from one 89-dim-layout observation row: palm
        patch, cube position and yaw (filled square), goal yaw (outline)
        and a side bar for the cube height."""
        return self.render_obs_frames(np.asarray(obs_row)[None], height,
                                      width)[0]

    def render_obs_frames(self, obs_traj, height=200, width=200):
        """``render_obs_frame`` of each row of a (T, obs_dim) episode, as a
        (T, H, W, 3) uint8 batch. Each stage is drawn on every frame
        before the next, in the one-frame order, so later colours cover
        earlier ones as they do there."""
        obs = np.asarray(obs_traj, np.float64)
        frames = np.arange(obs.shape[0])
        cx, cy = width // 2, height // 2
        scale = width / 0.5                      # 0.5 m field of view

        def squares(imgs, ids, center, half_px, yaw, color, w=1):
            c, s = np.cos(yaw), np.sin(yaw)
            corners = ((-1, -1), (1, -1), (1, 1), (-1, 1))
            xs = [center[0] + half_px * (c * sx - s * sy)
                  for sx, sy in corners]
            ys = [center[1] - half_px * (s * sx + c * sy)
                  for sx, sy in corners]
            draw_lines(imgs, np.tile(ids, 4), np.concatenate(xs),
                       np.concatenate(ys), np.concatenate(xs[1:] + xs[:1]),
                       np.concatenate(ys[1:] + ys[:1]), color, w)

        def yaw_of(quat):
            w_, x, y, z = quat.T
            return np.arctan2(2 * (w_ * z + x * y), 1 - 2 * (y * y + z * z))

        # Palm patch (the 0.12 half-size contact plane), alike in every
        # frame: drawn once.
        palm = np.full((1, height, width, 3), 255, np.uint8)
        squares(palm, np.zeros(1, int), (cx, cy), 0.12 * scale, np.zeros(1),
                (160, 160, 160), 1)
        imgs = np.repeat(palm, len(frames), axis=0)
        rel = obs[:, 48:51]
        cube_px = (cx + rel[:, 0] * scale, cy - rel[:, 1] * scale)
        squares(imgs, frames, cube_px, CUBE_HALF * scale,
                yaw_of(obs[:, 51:55]), (204, 77, 77), 2)
        squares(imgs, frames, (cx, cy), CUBE_HALF * scale,
                yaw_of(obs[:, 61:65]), (77, 77, 204), 1)
        # Cube height bar on the left (rel z in [-0.25, 0.25]).
        z_frac = np.clip((rel[:, 2] + 0.25) / 0.5, 0.0, 1.0)
        top = ((1.0 - z_frac) * (height - 1)).astype(int)
        imgs[:, :, 2:8][np.arange(height) >= top[:, None]] = (90, 170, 90)
        return imgs
