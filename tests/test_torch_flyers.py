"""The port's Ingenuity and Quadcopter tasks against the JAX package on the
CPU: the config copies, the 9-dim DR specs, 5 physics steps with the
batched thrust (Ingenuity in Mars gravity with its additive rotor
stiffness DR; Quadcopter with 8 implicit PD arm targets and 4 thrusts),
obs, reward and termination from one numpy state; the thrust wrench
against the JAX package's per-env one; then the behaviour gates (a
heavier Ingenuity climbs less under full thrust, whole-actor scale DR on
Quadcopter), the DR corner, the render and a tiny run of
``bayes_sim_main`` per task.

Tolerances: state, obs and rewards within atol 1e-4 over the 5 steps
(float32 on both sides, sums in another order); the thrust wrench within
rtol 1e-5 / atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.sim.flyers import (
    Ingenuity as JaxIngenuity, Quadcopter as JaxQuadcopter,
)
from bayes_sim_ig_tpu_torch.sim import available_tasks
from bayes_sim_ig_tpu_torch.sim.flyers import Ingenuity, Quadcopter

from . import torch_task_checks as tc

torch.set_num_threads(1)

N = 6
TASKS = {"Ingenuity": ("ingenuity", JaxIngenuity, Ingenuity, 9, 10),
         "Quadcopter": ("quadcopter", JaxQuadcopter, Quadcopter, 9, 14)}


@pytest.fixture(scope="module")
def tasks():
    out = {}
    for name, (stem, jcls, tcls, _, _) in TASKS.items():
        cfg = tc.load_cfg(stem, N)
        out[name] = (jcls(cfg), tcls(cfg, device="cpu"))
    return out


@pytest.mark.parametrize("name", list(TASKS))
def test_config_copies_match_the_jax_package(name):
    tc.config_copies_match(TASKS[name][0])


@pytest.mark.parametrize("name", list(TASKS))
def test_spec_and_model_match_jax(tasks, name):
    jt, tt = tasks[name]
    stem, _, _, dim, nv = TASKS[name]
    tc.spec_matches(tt, jt, dim)
    assert len(tc.load_cfg(stem)["env"]["realParams"]["means"][0]) == dim
    assert tt.model.nv == jt.model.nv == nv
    assert tt.model.dof_anc_chains == jt.model.dof_anc_chains
    assert tt.max_episode_length == jt.max_episode_length
    bound = set(tt._mass_dims) | set(tt._stiff_dims)
    assert bound == set(range(dim))


@pytest.mark.parametrize("name", list(TASKS))
def test_physics_obs_and_reward_match_jax_over_5_steps(tasks, name):
    jt, tt = tasks[name]
    params = tc.params_in_box(tt, N, 0)
    st = tt.init_state(torch.Generator().manual_seed(0),
                       torch.from_numpy(params))
    tc.steps_match_jax(jt, tt, tuple(x.numpy() for x in st), params,
                       seed=1, amp=1.0)


@pytest.mark.parametrize("name", list(TASKS))
def test_thrust_matches_the_jax_per_env_thrust(tasks, name):
    """The batched thrust, env-last (nb, 6, N), against the JAX package's
    per-env thrust under vmap, moved env-last: only the chassis row is
    loaded."""
    jt, tt = tasks[name]
    rs = np.random.RandomState(5)
    st = tt.init_state(torch.Generator().manual_seed(5),
                       torch.from_numpy(tc.params_in_box(tt, N, 5)))
    q = st.q.numpy().copy()
    quat = rs.randn(N, 4)
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rs.uniform(-0.5, 0.5, (N, q.shape[1] - 7))
    act = rs.uniform(-1, 1, (N, tt.act_dim)).astype(np.float32)
    got = tt._thrust_forces(torch.from_numpy(q), torch.from_numpy(act))
    want = jnp.moveaxis(jax.vmap(jt._thrust_forces, (0, 0, None))(
        jnp.asarray(q), jnp.asarray(act), None), 0, -1)
    assert tuple(got.shape) == (tt.model.nb, 6, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(got[0].abs().min(0).values.max()) > 0.0
    assert (got[1:] == 0).all()


def test_ingenuity_flies_in_mars_gravity_with_additive_rotor_stiffness(
        tasks):
    _, tt = tasks["Ingenuity"]
    params = torch.from_numpy(tc.params_in_box(tt, N, 6))
    dp = tt._make_dyn_params(params)
    assert torch.equal(dp.gravity[0], torch.tensor([0.0, 0.0, -3.721]))
    base = tt._base.stiffness[tt._dof_v]
    np.testing.assert_allclose(
        dp.stiffness[:, tt._dof_v].numpy(),
        (base + params[:, tt._stiff_cols]).numpy(), rtol=1e-6)


def test_ingenuity_heavier_chassis_climbs_less():
    """Full upward thrust for 0.5 s: a 3x-heavier craft gains less
    altitude, so the mass dim is identifiable from trajectories."""
    gains = []
    for chassis_mult in (1.0, 3.0):
        mean = np.ones(9)
        mean[0] = chassis_mult
        mean[5:] = 0.1
        env = tc.delta_env("Ingenuity", "ingenuity", mean)
        obs = env.reset()
        z0 = 1.0 - float(obs[:, 2].mean())  # target z = 1 - rel_z
        act = torch.zeros(4, 6)
        act[:, 2] = 1.0
        act[:, 5] = 1.0
        for _ in range(50):
            obs, _, _, _ = env.step(act)
        gains.append(1.0 - float(obs[:, 2].mean()) - z0)
    assert gains[1] < gains[0] - 0.05, gains


def test_quadcopter_arm_targets_are_tracked():
    """The 8 implicit PD drives hold the arms near their commanded tilt
    (0.52 x the action) against the thrust."""
    env = tc.delta_env("Quadcopter", "quadcopter", np.ones(9), num_envs=2)
    env.reset()
    act = torch.zeros(2, 12)
    act[:, 0:8:2] = 0.5
    for _ in range(40):
        obs, _, _, _ = env.step(act)
    tilt = obs[:, 13:17]
    assert (tilt - 0.26).abs().max() < 0.05, tilt


@pytest.mark.parametrize("name", list(TASKS))
def test_whole_actor_scale_dr(name):
    tc.scale_dr_stays_finite(name, TASKS[name][0])


@pytest.mark.parametrize("name", list(TASKS))
def test_corner_params_stay_finite(name):
    tc.corner_stays_finite(name, TASKS[name][0], "lows", 60)


@pytest.mark.parametrize("name", list(TASKS))
def test_render_obs_frame(tasks, name):
    tc.render_matches_jax(name, TASKS[name][0], tasks[name][0])


def test_flyers_are_registered_and_the_cli_takes_them():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    for name, envs in (("Ingenuity", 4096), ("Quadcopter", 8192)):
        assert name in available_tasks()
        args, cfg_env, cfg_train = init_args(["--task", name,
                                              "--rl_device", "cpu"])
        assert cfg_env["env"]["numEnvs"] == envs
        assert cfg_train["policy"]["pi_hid_sizes"] == [256, 128, 64]


@pytest.mark.parametrize("name", list(TASKS))
def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch, name):
    """One tiny ADR iteration (8 envs, episodes of 20 steps)."""
    out = tc.tiny_adr_run(name, TASKS[name][0], tmp_path, monkeypatch,
                          {"maxEpisodeLength": 20})
    assert out["env"].task.max_episode_length == 20
