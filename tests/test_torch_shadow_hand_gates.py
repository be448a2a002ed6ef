"""The behaviour gates of the JAX package's ShadowHand
(tests/test_task_behaviors.py::TestShadowHandCube) on the port, on the
CPU: the rest height follows the object scale, a fingertip on a side face
pushes the cube away, a max-effort squeeze neither crushes through the
cube nor loses it, the force-sensor and full_state layouts respond to a
squeeze, and fingers cannot cross. Then ``make_env`` on the CPU,
``policy_grasp`` on the task, the registry and the CLI, and a tiny run of
``bayes_sim_main --task ShadowHand``. The gates' bounds are the JAX
package's."""

import numpy as np
import torch

from bayes_sim_ig_tpu_torch.physics import DynParams, forward_kinematics
from bayes_sim_ig_tpu_torch.physics.contact import sphere_plane_pairs_forces
from bayes_sim_ig_tpu_torch.physics.dynamics import _mv
from bayes_sim_ig_tpu_torch.physics.spatial import quat_to_rot
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.shadow_hand import (
    CUBE_HALF, ShadowHand, nearest_cube_faces,
)
from bayes_sim_ig_tpu_torch.utils.collect import get_collect_policy

from . import torch_task_checks as tc

torch.set_num_threads(1)

STEM = "shadow_hand"
# Full curl: flexions and thumb opposition at full drive.
FLEX = [3, 4, 6, 7, 9, 10, 13, 14, 16, 19]


def _env(n=2, mean=None, cfg=None):
    return tc.delta_env("ShadowHand", STEM,
                        np.ones(32) if mean is None else mean, num_envs=n,
                        cfg=cfg)


def _neutral_actions(task, n):
    """Actions holding every dof at q = 0 (wrist and abductions)."""
    lo, hi = task._act_lo, task._act_hi
    return torch.from_numpy(np.tile((2.0 * (0.0 - lo) / (hi - lo) - 1.0)
                                    .astype(np.float32), (n, 1)))


def _max_penetration(task, st, pts):
    """Deepest penetration of the given (link, offset, radius) contact
    points into the cube, over points whose center lies within the cube
    grown by their radius."""
    links = torch.as_tensor([p[0] for p in pts])
    offs = torch.as_tensor(np.stack([np.asarray(p[1], np.float32)
                                     for p in pts]))
    radii = torch.as_tensor([p[2] for p in pts], dtype=torch.float32)
    n = st.q.shape[0]
    dp = DynParams.defaults(task.model).rows(n)
    kin = forward_kinematics(task.model, st.q, st.v, dp)
    c = kin.p_w[links] + _mv(kin.R_w[links], offs[:, :, None].expand(
        -1, 3, n))                                         # (S, 3, N)
    cq = task._cube_q
    Rc = quat_to_rot(st.q[:, cq + 3:cq + 7])               # (N, 3, 3)
    local = torch.einsum("nji,sjn->sin", Rc, c - kin.p_w[task._cube][None])
    d_face = local.abs().amax(1) - CUBE_HALF
    pen = radii[:, None] - d_face
    inside = (local.abs() < CUBE_HALF + radii[:, None, None]).all(1)
    return float(torch.where(inside, pen, torch.zeros_like(pen)).max())


def test_cube_scale_sets_rest_height_and_stays_finite():
    heights = []
    for scale in (0.6, 1.8):
        mean = np.ones(32)
        mean[-2] = scale  # object scale dim
        env = _env(mean=mean)
        obs = env.reset()
        h0 = float(obs[:, 50].mean())  # cube pos rel palm, z
        for _ in range(30):
            obs, _, _, _ = env.step(torch.zeros(2, 20))
        assert torch.isfinite(obs).all()
        heights.append(h0)
    assert heights[1] > heights[0] + 0.02, heights


def test_side_face_contact_pushes_cube_away():
    """A fingertip overlapping the cube's +x face pushes the cube along
    -x (and the finger along +x); with the cube 3.5 cm further along -x
    (the tip in the face's normal column, an air gap) every force is
    zero."""
    env = _env(n=1)
    env.reset()
    task = env.task
    m = task.model
    st = env.state.task_state
    dp = DynParams.defaults(m).rows(1)
    kin = forward_kinematics(m, st.q, st.v, dp)
    tip_link, tip_geom, _ = next((l, g, n) for (l, g, n)
                                 in task._hand_spheres if "ffdistal" in n)
    tip = (kin.p_w[tip_link][:, 0] + kin.R_w[tip_link][..., 0]
           @ torch.tensor(tip_geom.offset, dtype=torch.float32)).numpy()
    r = tip_geom.size[0]
    cq = task._cube_q
    q_probe = st.q.clone()
    q_probe[:, cq:cq + 3] = 0.0
    joint_off = forward_kinematics(m, q_probe, st.v, dp).p_w[
        task._cube][:, 0].numpy()
    sph_off = np.asarray([tip_geom.offset], np.float32)

    def face_forces(cube_center):
        q = st.q.clone()
        q[:, cq:cq + 3] = torch.from_numpy(
            (cube_center - joint_off).astype(np.float32))
        q[:, cq + 3:cq + 7] = torch.tensor([1.0, 0, 0, 0])
        k = forward_kinematics(m, q, torch.zeros_like(st.v), dp)
        nrm, pt = nearest_cube_faces(k, task._cube, [tip_link], sph_off,
                                     torch.full((1,), CUBE_HALF), 1)
        return sphere_plane_pairs_forces(
            m, k, dp, [tip_link], sph_off, np.asarray([r], np.float32),
            [task._cube], pt, nrm, 1.0, dt=task.dt / 2,
            plane_halfsizes=np.full(1, CUBE_HALF, np.float32)).numpy()

    overlap = tip - np.array([CUBE_HALF + r - 0.005, 0, 0])
    f_hit = face_forces(overlap)
    assert f_hit[task._cube, 3, 0] < -1e-3, f_hit[task._cube]
    assert f_hit[tip_link, 3, 0] > 1e-3, f_hit[tip_link]
    f_gap = face_forces(overlap - np.array([0.035, 0, 0]))
    assert np.abs(f_gap).max() == 0.0, np.abs(f_gap).max()


def _env_at_jax_reset(n=2):
    """A delta env started from the JAX package's own reset of the same
    delta env (tests/test_task_behaviors.py::_delta_env, its key stream):
    the gate's scenario as the reference runs it."""
    from bayes_sim_ig_tpu_torch.sim.shadow_hand import HandState
    from .test_task_behaviors import _delta_env as jax_delta_env
    jenv = jax_delta_env("ShadowHand", np.ones(32), num_envs=n)
    jenv.reset()
    env = _env(n=n)
    env.reset()
    env.state = env.state._replace(task_state=HandState(*[
        torch.from_numpy(np.array(x)) for x in jenv.state.task_state]))
    return env


def test_squeeze_cannot_crush_through_cube():
    """A max-effort full-curl squeeze may penetrate by the 6 mm rest slop
    plus an impact allowance (16 mm in all), never tunnel through. From
    the reference's initial state (the margin depends on it: from the
    port's own draws of seeds 0-5 the worst is 10.3-20.8 mm, in both
    packages alike)."""
    env = _env_at_jax_reset()
    task = env.task
    pts = [(l, g.offset, g.size[0]) for (l, g, _n) in task._hand_spheres]
    act = torch.ones(2, 20)
    act[:, 2] = 0.0
    act[:, 5] = 0.0
    worst = 0.0
    for _ in range(50):
        env.step(act)
        worst = max(worst, _max_penetration(task, env.state.task_state, pts))
    assert torch.isfinite(env.state.task_state.q).all()
    assert worst < 0.016, worst


def test_sustained_squeeze_holds_cube():
    """A 200-step max-effort curl holds the cube: it never leaves the fall
    radius, and after 100 steps no contact point (line-contact extras
    included) sits more than 10 mm deep."""
    env = _env()
    env.reset()
    task = env.task
    act = _neutral_actions(task, 2)
    act[:, FLEX] = 1.0
    worst_settled = 0.0
    for t in range(200):
        env.step(act)
        st = env.state.task_state
        assert not task._cube_fallen(st).any(), t
        if t >= 100:
            worst_settled = max(worst_settled,
                                _max_penetration(task, st, task._box_pts))
    assert torch.isfinite(env.state.task_state.q).all()
    assert worst_settled < 0.010, worst_settled


def _squeezed(cfg_edits, n=4, steps=60, act_fn=None):
    cfg = tc.load_cfg(STEM, n)
    cfg["env"].update(cfg_edits)
    env = _env(n=n, cfg=cfg)
    obs = env.reset()
    act = _neutral_actions(env.task, n)
    act_fn(act)
    for _ in range(steps):
        env.step(act)
    return env, obs


def _full_curl(act):
    act[:, FLEX] = 1.0


def test_force_sensor_obs_block():
    """forceSensorObs: 107-dim obs; after a full curl the palm sensor
    carries at least the cube's weight in every env, the obs ends with
    the sensors; a half curl gives a light fingertip reading; the default
    config keeps 89 dims and a zero sensor block."""
    env, obs = _squeezed({"forceSensorObs": True}, act_fn=_full_curl)
    task = env.task
    assert task.obs_dim == 107 and obs.shape == (4, 107)
    tf = env.state.task_state.tip_force
    assert torch.isfinite(tf).all()
    sensor_f = torch.linalg.norm(tf.reshape(4, 6, 3), dim=2)
    assert (sensor_f[:, 5] > 0.5).all(), sensor_f[:, 5]
    obs = task.observe(env.state.task_state, env.state.params)
    assert torch.equal(obs[:, 89:], tf)

    def half_curl(act):
        act[:, [3, 6, 9, 13]] = 0.4
        act[:, [4, 7, 10, 14]] = 0.2
        act[:, [16, 19]] = 0.4
    env, _ = _squeezed({"forceSensorObs": True}, act_fn=half_curl)
    tf2 = env.state.task_state.tip_force
    assert torch.isfinite(tf2).all()
    tips = torch.linalg.norm(tf2.reshape(4, 6, 3), dim=2)[:, :5]
    assert tips.max() > 0.01, tips
    env0 = _env()
    assert env0.task.obs_dim == 89
    env0.reset()
    env0.step(torch.zeros(2, 20))
    assert not env0.state.task_state.tip_force.any()


def test_full_state_obs_layout():
    """full_state: 211 dims; after a full curl the dof-force block is
    alive, the fingertip block holds positions near the palm and unit
    quaternions, the sensor block is the state's forces and torques
    scaled, the actions block the previous actions."""
    env, obs = _squeezed({"observationType": "full_state"},
                         act_fn=_full_curl)
    task = env.task
    assert task.obs_dim == 211 and obs.shape == (4, 211)
    ts = env.state.task_state
    obs = task.observe(ts, env.state.params).numpy()
    assert np.isfinite(obs).all()
    assert np.abs(obs[:, 48:72]).max() > 0.01
    tips = obs[:, 96:161].reshape(4, 5, 13)
    assert (np.linalg.norm(tips[:, :, :3] - np.array([0.06, 0.0, 0.32]),
                           axis=-1) < 0.5).all()
    np.testing.assert_allclose(np.linalg.norm(tips[:, :, 3:7], axis=-1),
                               1.0, atol=1e-4)
    sens = obs[:, 161:191].reshape(4, 5, 6)
    tf = ts.tip_force.numpy().reshape(4, 6, 3)
    np.testing.assert_allclose(sens[:, :, :3],
                               tf[:, :5] * task.FORCE_TORQUE_OBS_SCALE,
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(obs[:, 191:211], ts.prev_actions.numpy())
    assert np.abs(tf).max() > 0.1


def test_fingers_cannot_cross_through_each_other():
    """FF abducted toward MF and MF toward FF stop at contact: same-segment
    sphere centers stay apart, and FF keeps the higher y."""
    env = _env()
    env.reset()
    task = env.task
    act = torch.zeros(2, 20)
    act[:, 2] = -1.0
    act[:, 5] = 1.0
    for _ in range(60):
        env.step(act)
    st = env.state.task_state
    assert torch.isfinite(st.q).all()
    kin = forward_kinematics(task.model, st.q, st.v,
                             DynParams.defaults(task.model).rows(2))

    def center(name):
        link, geom, _ = next((l, g, n) for (l, g, n) in task._hand_spheres
                             if name in n)
        R = kin.R_w[link].permute(2, 0, 1)
        p = kin.p_w[link].T
        off = torch.tensor(geom.offset, dtype=torch.float32)
        return (p + R @ off).numpy(), geom.size[0]

    for seg in ("proximal", "middle", "distal"):
        c_ff, r_ff = center(f"ff{seg}")
        c_mf, r_mf = center(f"mf{seg}")
        gap = np.linalg.norm(c_ff - c_mf, axis=-1)
        assert (gap > 0.55 * (r_ff + r_mf)).all(), (seg, gap)
    c_ff, _ = center("ffdistal")
    c_mf, _ = center("mfdistal")
    assert (c_ff[:, 1] > c_mf[:, 1]).all(), (c_ff[:, 1], c_mf[:, 1])


def test_make_env_builds_shadow_hand_on_the_cpu():
    env = make_env("ShadowHand", tc.load_cfg(STEM, 3), device="cpu")
    assert isinstance(env.task, ShadowHand)
    assert env.task.device.type == "cpu"
    assert env.task.params_spec.dim == 32 and env.num_envs == 3


def test_policy_grasp_drives_the_task_excitation_dims():
    task = make_env("ShadowHand", tc.load_cfg(STEM, 4), device="cpu").task
    policy = get_collect_policy("policy_grasp", task)
    act = policy(torch.zeros(4, 20), torch.Generator().manual_seed(0))
    dims = list(task.grasp_excitation_dims)
    others = [i for i in range(20) if i not in dims]
    assert (act[:, dims] >= 0.7).all()
    assert (act[:, others].abs() <= 0.3).all()


def test_shadow_hand_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "ShadowHand" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "ShadowHand",
                                          "--rl_device", "cpu"])
    assert cfg_env["env"]["numEnvs"] == 1024
    assert cfg_train["policy"]["pi_hid_sizes"] == [512, 256, 128]
    assert cfg_train["learn"]["nsteps"] == 8


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """One tiny ADR iteration (4 envs, episodes of 20 steps) through the
    impulse pass's plain tree half-solves."""
    out = tc.tiny_adr_run("ShadowHand", STEM, tmp_path, monkeypatch,
                          {"episodeLength": 20}, num_envs=4)
    assert out["env"].state.task_state.q.shape == (4, 31)
    assert out["env"].task.params_spec.dim == 32
