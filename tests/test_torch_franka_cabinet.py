"""The port's FrankaCabinet task against the JAX package on the CPU: the
config copies, the 19-dim DR spec, the two-fixed-root model with revolute,
prismatic and fixed joints, 5 physics steps with the per-env implicit PD
drives (kp scaled by the stiffness dims, effort 87) and the finger-pad
pair contacts, obs, reward and termination from one numpy state; obs and
reward with whole-actor scale DR (the sampled per-env scale); then the
behaviour gates (a held target is reached, the arm tracks toward the
handle, a low drive gain tracks slower), the DR corner, the render and a
tiny run of ``bayes_sim_main --task FrankaCabinet``.

Tolerances: state, obs and rewards within atol 1e-4 over the 5 steps
(float32 on both sides, sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.sim.franka_cabinet import (
    FrankaCabinet as JaxFrankaCabinet,
)
from bayes_sim_ig_tpu_torch.sim import available_tasks
from bayes_sim_ig_tpu_torch.sim.franka_cabinet import (
    FrankaCabinet, FrankaState,
)

from . import torch_task_checks as tc

torch.set_num_threads(1)

STEM = "franka_cabinet"
N = 6
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def tasks():
    cfg = tc.load_cfg(STEM, N)
    return JaxFrankaCabinet(cfg), FrankaCabinet(cfg, device="cpu")


def test_config_copies_match_the_jax_package():
    tc.config_copies_match(STEM)


def test_spec_and_model_match_jax(tasks):
    jt, tt = tasks
    tc.spec_matches(tt, jt, 19)
    m = tt.model
    assert (m.nq, m.nv, m.nb) == (10, 10, 12)
    assert m.joint_types.count("fixed") == 2 and m.free_list == []
    assert m.joint_types.count("prismatic") == 3
    assert m.dof_anc_chains == jt.model.dof_anc_chains
    assert set(tt._mass_dims) | set(tt._stiff_dims) == set(range(19))


def test_pd_gains_scale_per_env(tasks):
    jt, tt = tasks
    params = tc.params_in_box(tt, N, 3)
    kp, kd = tt._pd_gains(torch.from_numpy(params))
    np.testing.assert_allclose(
        kp.numpy(), np.array([400.0] * 7 + [800.0] * 2) * params[:, 10:],
        rtol=1e-6)
    assert (kd == 40.0).all() and kd.shape == (N, 9)


def test_physics_obs_and_reward_match_jax_over_5_steps(tasks):
    jt, tt = tasks
    params = tc.params_in_box(tt, N, 0)
    st = tt.init_state(torch.Generator().manual_seed(0),
                       torch.from_numpy(params))
    v = np.random.RandomState(1).uniform(-0.3, 0.3, (N, 10)).astype(
        np.float32)
    tc.steps_match_jax(jt, tt, (st.q.numpy(), v, st.targets.numpy()),
                       params, seed=2, amp=1.0)


def test_obs_and_reward_use_the_per_env_scale():
    """With whole-actor scale DR the hand-to-handle vector (obs[20:23]) and
    the reward read each env's sampled scale, as the JAX package's do."""
    cfg = tc.load_cfg(STEM, N)
    cfg["task"]["randomization_params"]["actor_params"]["franka"][
        "scale"] = {"range": [0.5, 1.5], "operation": "scaling",
                    "distribution": "uniform"}
    jt, tt = JaxFrankaCabinet(cfg), FrankaCabinet(cfg, device="cpu")
    params = tc.params_in_box(tt, N, 4)
    st = tt.init_state(torch.Generator().manual_seed(4),
                       torch.from_numpy(params))
    tp, jp = torch.from_numpy(params), jnp.asarray(params)
    js = type(jt.init_state(jax.random.PRNGKey(0), jp))(
        *[jnp.asarray(x.numpy()) for x in st])
    act = np.random.RandomState(5).uniform(-1, 1, (N, 9)).astype(np.float32)
    obs = tt.observe(st, tp)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jt.observe(js, jp)),
                               **TOL)
    np.testing.assert_allclose(
        tt.reward(st, torch.from_numpy(act), tp).numpy(),
        np.asarray(jt.reward(js, jnp.asarray(act), jp)), **TOL)
    one = params.copy()
    one[:, tt._scale_dims[0]] = 1.0
    assert not torch.allclose(obs[:, 20:23],
                              tt.observe(st, torch.from_numpy(one))[:, 20:23])


def test_commanded_pose_is_reached():
    """A held joint-space target is reached within the gravity-sag bound
    (~0.11 rad on the loaded shoulder, much tighter elsewhere)."""
    env = tc.delta_env("FrankaCabinet", STEM, np.ones(19), num_envs=2)
    env.reset()
    tgt = torch.tensor([0.5, -1.2, 0.5, -1.0, 0.5, 2.6, 1.78, 0.02,
                        0.02]).expand(2, -1).clone()
    st = env.state
    env.state = st._replace(task_state=st.task_state._replace(targets=tgt))
    for _ in range(150):
        env.step(torch.zeros(2, 9))
    err = (env.state.task_state.q[:, env.task._dof_q_t] - tgt).abs()
    assert float(err[:, 1].max()) < 0.2, err
    assert float(torch.cat([err[:, :1], err[:, 2:]], 1).max()) < 0.05, err


def test_pd_arm_tracks_targets():
    mean = np.ones(19)
    mean[:10] = 0.8
    env = tc.delta_env("FrankaCabinet", STEM, mean, num_envs=2)
    obs = env.reset()
    d0 = float(torch.linalg.norm(obs[:, 20:23], dim=1).mean())
    act = torch.zeros(2, 9)
    act[:, 1] = 0.6
    act[:, 3] = 0.6
    for _ in range(60):
        obs, _, _, _ = env.step(act)
    d1 = float(torch.linalg.norm(obs[:, 20:23], dim=1).mean())
    assert d1 < d0, (d0, d1)  # the hand moved toward the handle


def test_low_drive_gain_tracks_slower():
    errs = []
    for gain in (1.8, 0.1):
        mean = np.ones(19)
        mean[:10] = 0.8
        mean[10:] = gain
        env = tc.delta_env("FrankaCabinet", STEM, mean, num_envs=2)
        env.reset()
        act = torch.zeros(2, 9)
        act[:, 0] = 1.0  # swing joint 1
        for _ in range(30):
            obs, _, _, _ = env.step(act)
        errs.append(abs(float(obs[:, 0].mean())))
    assert errs[1] < errs[0], errs


def test_state_keeps_clipped_targets(tasks):
    _, tt = tasks
    params = torch.from_numpy(tc.params_in_box(tt, N, 6))
    st = tt.init_state(torch.Generator().manual_seed(6), params)
    out = tt.physics_step(st, torch.ones(N, 9), params, None)
    assert isinstance(out, FrankaState)
    want = torch.minimum(st.targets + 7.5 / 60.0, tt._limits_hi)
    np.testing.assert_allclose(out.targets.numpy(), want.numpy(), rtol=1e-6)


def test_corner_params_stay_finite():
    tc.corner_stays_finite("FrankaCabinet", STEM, "lows", 60)


def test_render_obs_frame(tasks):
    tc.render_matches_jax("FrankaCabinet", STEM, tasks[0])


def test_franka_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "FrankaCabinet" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "FrankaCabinet",
                                          "--rl_device", "cpu"])
    assert cfg_env["env"]["numEnvs"] == 2048
    assert cfg_env["bayessim"]["trainTrajLen"] == 30


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """One tiny ADR iteration (8 envs, episodes of 20 steps)."""
    out = tc.tiny_adr_run("FrankaCabinet", STEM, tmp_path, monkeypatch,
                          {"episodeLength": 20})
    assert out["env"].state.task_state.targets.shape == (8, 9)
