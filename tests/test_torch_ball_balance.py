"""The port's BallBalance task against the JAX package on the CPU: the
config copies, the 7-dim DR spec (a multiplying ball-mass dim, additive
leg dof-friction dims), the two-root model on the branch-sparse tree
solve (its factors compare too: both packages take the right-looking
tree path here), 5 physics steps with the ground contacts and the
ball-tray pair contact, obs, reward and termination from one numpy state;
then the behaviour gates (leg torque tilts the tray and rolls the ball,
high leg friction damps the response), the DR corner, the NaN-pivot
quarantine on the tree solve, realParams as the JAX loader reads them,
the render and a tiny run of ``bayes_sim_main --task BallBalance``.

Tolerances: state, obs and rewards within atol 1e-4 over the 5 steps
(float32 on both sides; the ball lands on the tray in the first steps,
and the contact amplifies rounding to a few 1e-5 in the velocities)."""

import numpy as np
import pytest
import torch

from bayes_sim_ig_tpu.sim.ball_balance import BallBalance as JaxBallBalance
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.physics.dynamics import _uses_tree_solve
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.ball_balance import BallBalance

from . import torch_task_checks as tc

torch.set_num_threads(1)

STEM = "ball_balance"
N = 6


@pytest.fixture(scope="module")
def tasks():
    cfg = tc.load_cfg(STEM, N)
    return JaxBallBalance(cfg), BallBalance(cfg, device="cpu")


def test_config_copies_match_the_jax_package():
    tc.config_copies_match(STEM)


def test_spec_matches_jax_and_realparams(tasks):
    jt, tt = tasks
    tc.spec_matches(tt, jt, 7)
    assert tt._ball_mass_dims == jt._ball_mass_dims == [0]
    assert tt._fric_dims == jt._fric_dims == list(range(1, 7))


def test_two_root_forest_takes_the_tree_solve(tasks):
    """Tray (free, 6 legs dofs below it) and ball (free): 18 dofs in two
    trees, 87 of 171 lower-triangle pairs (0.509 <= 0.66)."""
    _, tt = tasks
    m = tt.model
    assert m.nv == 18 and m.free_list == [(0, 0, 0), (7, 13, 12)]
    chains = m.dof_anc_chains
    assert [k for k, c in enumerate(chains) if not c] == [0, 12]
    assert sum(1 + len(c) for c in chains) == 87
    assert _uses_tree_solve(m)


def test_dyn_params_multiply_ball_mass_and_add_friction(tasks):
    _, tt = tasks
    params = torch.from_numpy(tc.params_in_box(tt, N, 7))
    dp = tt._dyn_params(params)
    ball = tt._ball_idx
    np.testing.assert_allclose(dp.mass[:, ball].numpy(),
                               (0.5 * params[:, 0]).numpy(), rtol=1e-6)
    assert torch.equal(dp.mass[:, :ball], tt._base.mass[:ball].expand(N, -1))
    np.testing.assert_allclose(dp.friction[:, tt._leg_v].numpy(),
                               params[:, 1:].numpy(), rtol=1e-6)


def test_physics_obs_and_reward_match_jax_over_5_steps(tasks):
    jt, tt = tasks
    params = tc.params_in_box(tt, N, 0)
    st = tt.init_state(torch.Generator().manual_seed(0),
                       torch.from_numpy(params))
    v = st.v.numpy().copy()
    v[:, :12] = np.random.RandomState(1).uniform(-0.2, 0.2, (N, 12))
    ts = tc.steps_match_jax(jt, tt, (st.q.numpy(), v), params, seed=2)
    # The ball rests on the tray, which stands on its feet.
    bq = tt.model.q_off[tt._ball_idx]
    assert ((ts.q[:, bq + 2] - ts.q[:, 2]) > 0.05).all()


def test_leg_torque_tilts_tray_and_ball_rolls():
    env = tc.delta_env("BallBalance", STEM, np.ones(7))
    obs = env.reset()
    start = obs[:, :2].clone()
    act = torch.tensor([[1.0, -1.0, 0.0]] * 4)
    for _ in range(40):
        obs, _, _, _ = env.step(act)
    moved = float(torch.linalg.norm(obs[:, :2] - start, dim=1).mean())
    assert moved > 0.02, moved


def test_high_leg_friction_damps_response():
    moves = []
    for fric in (0.1, 100.0):
        mean = np.ones(7)
        mean[1:] = fric
        env = tc.delta_env("BallBalance", STEM, mean)
        obs = env.reset()
        q0 = obs[:, 12:18].clone()  # leg dof positions
        act = torch.tensor([[1.0, -1.0, 1.0]] * 4)
        for _ in range(30):
            obs, _, _, _ = env.step(act)
        moves.append(float((obs[:, 12:18] - q0).abs().mean()))
    assert moves[1] < moves[0], moves


def test_corner_params_stay_finite():
    tc.corner_stays_finite("BallBalance", STEM, "lows", 60)
    tc.corner_stays_finite("BallBalance", STEM, "highs", 60)


def test_nan_pivot_env_is_quarantined_and_reset():
    """A negative ball mass makes env 1's tree pivot of the ball's dofs
    NaN, so only its state goes non-finite; env_step ends its episode with
    zeroed obs and reward and resets it next."""
    env = make_env("BallBalance", tc.load_cfg(STEM, 3), seed=2,
                   device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    params = env.state.params.clone()
    params[1, 0] = -1.0
    env.state = env.state._replace(params=params)
    obs, rew, done, _ = env.step(torch.zeros(3, 3))
    assert int(done[1]) == 1 and float(rew[1]) == 0.0
    assert (obs[1] == 0).all()
    assert not torch.isfinite(env.state.task_state.v[1]).all()
    for i in (0, 2):
        assert torch.isfinite(env.state.task_state.q[i]).all()
    env.step(torch.zeros(3, 3))
    assert int(env.state.progress[1]) == 0
    assert all(torch.isfinite(x).all() for x in env.state.task_state)


def test_real_params_match_the_jax_loader():
    from bayes_sim_ig_tpu.utils.args import load_real_params as jax_load
    from bayes_sim_ig_tpu_torch.utils.args import load_real_params
    cfg = tc.load_cfg(STEM)
    got = load_real_params(cfg, 7)
    want = jax_load(cfg, 7)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        for x, y in zip(a, b):
            assert x.shape[0] == 7
            np.testing.assert_array_equal(x, y)


def test_render_obs_frame(tasks):
    tc.render_matches_jax("BallBalance", STEM, tasks[0])


def test_ball_balance_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "BallBalance" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "BallBalance",
                                          "--rl_device", "cpu"])
    assert cfg_env["env"]["numEnvs"] == 128
    assert cfg_train["policy"]["pi_hid_sizes"] == [128, 64, 32]


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """One tiny ADR iteration (8 envs, episodes of 20 steps) through the
    tree solve's plain version."""
    out = tc.tiny_adr_run("BallBalance", STEM, tmp_path, monkeypatch,
                          {"episodeLength": 20})
    assert out["env"].state.task_state.q.shape == (8, 20)
