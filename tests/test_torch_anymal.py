"""The port's Anymal task against the JAX package on the CPU: the config
copies, the 13-dim DR spec, 5 physics steps with the implicit PD drives
(kp 85, kd 2, effort 80) and the feet in ground contact, obs, reward and
termination from one numpy state; then the env layer (per-episode
commands, a fresh mass-matrix factor on each substep, whole-actor scale
DR, the DR corner, the NaN-pivot quarantine on the dense solve), the
render and a tiny run of ``bayes_sim_main --task Anymal``.

Tolerances: state, obs and rewards within atol 1e-4 over the 5 steps
(float32 on both sides, sums in another order; the port's plain Cholesky
against XLA's on the JAX side, which agree on solutions, not factors)."""

import numpy as np
import pytest
import torch

from bayes_sim_ig_tpu.sim.anymal import Anymal as JaxAnymal
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.anymal import Anymal

from . import torch_task_checks as tc

torch.set_num_threads(1)

STEM = "anymal"
N = 6


@pytest.fixture(scope="module")
def tasks():
    cfg = tc.load_cfg(STEM, N)
    return JaxAnymal(cfg), Anymal(cfg, device="cpu")


def test_config_copies_match_the_jax_package():
    tc.config_copies_match(STEM)


def test_spec_matches_jax_and_realparams(tasks):
    jt, tt = tasks
    tc.spec_matches(tt, jt, 13)
    assert len(tc.load_cfg(STEM)["env"]["realParams"]["means"][0]) == 13
    assert tt.max_episode_length == jt.max_episode_length == 3000


def test_physics_obs_and_reward_match_jax_over_5_steps(tasks):
    """The base at 0.56 m puts the feet ~5 mm into the ground: contacts
    and the drives act from the first step."""
    jt, tt = tasks
    params = tc.params_in_box(tt, N, 0)
    st = tt.init_state(torch.Generator().manual_seed(0),
                       torch.from_numpy(params))
    q = st.q.numpy().copy()
    q[:, 2] = 0.56
    rs = np.random.RandomState(1)
    v = rs.uniform(-0.1, 0.1, (N, tt.model.nv)).astype(np.float32)
    prev = rs.uniform(-1, 1, (N, 12)).astype(np.float32)
    ts = tc.steps_match_jax(jt, tt, (q, v, st.commands.numpy(), prev),
                            params, seed=2)
    assert (ts.q[:, 2] > 0.45).all()


def test_init_state_bounds():
    task = Anymal(tc.load_cfg(STEM, 64), device="cpu")
    st = task.init_state(torch.Generator().manual_seed(0), torch.ones(64, 13))
    assert st.q.shape == (64, 19) and st.v.shape == (64, 18)
    assert (st.q[:, 2] == 0.62).all() and (st.v == 0).all()
    jit = st.q[:, task._act_q] - task._default_dof
    assert (jit.abs() <= 0.05).all() and jit.abs().max() > 0.04
    lo, hi = torch.tensor([-1.0, -0.3, -0.5]), torch.tensor([1.0, 0.3, 0.5])
    assert ((st.commands >= lo) & (st.commands <= hi)).all()
    assert (st.prev_actions == 0).all()


def test_commands_are_resampled_per_episode():
    """A reset env draws new commands; the others keep theirs."""
    env = make_env("Anymal", tc.load_cfg(STEM, 3), seed=4, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    cmd0 = env.state.task_state.commands.clone()
    env.state = env.state._replace(
        reset_buf=torch.tensor([0, 1, 0], dtype=torch.int32))
    env.step(torch.zeros(3, 12))
    cmd1 = env.state.task_state.commands
    assert torch.equal(cmd1[[0, 2]], cmd0[[0, 2]])
    assert not torch.equal(cmd1[1], cmd0[1])


def test_flat_sample_consumed_fully(tasks):
    _, tt = tasks
    assert set(tt._mass_dims) == set(range(tt.params_spec.dim))


def test_fresh_factor_on_every_substep(tasks, monkeypatch):
    """Anymal refactors on each of its 2 substeps: forcing the frozen
    scheme changes the step, so the factor really was fresh."""
    from bayes_sim_ig_tpu_torch.sim import anymal
    _, tt = tasks
    params = torch.from_numpy(tc.params_in_box(tt, N, 3))
    st = tt.init_state(torch.Generator().manual_seed(3), params)
    st = st._replace(v=torch.full_like(st.v, 0.3))
    act = torch.full((N, 12), 0.5)
    tc.fresh_factor_on_every_substep(anymal, tt, st, act, params,
                                     monkeypatch)


def test_whole_actor_scale_dr():
    tc.scale_dr_stays_finite("Anymal", STEM)


def test_corner_params_stay_finite():
    """The corner of all lows (0.01x masses) for 60 steps of random
    actions: finite through the implicit drives, the velocity clamps and
    the non-finite quarantine."""
    tc.corner_stays_finite("Anymal", STEM, "lows", 60)


def test_nan_pivot_env_is_quarantined_and_reset():
    """Negative body masses make env 1's mass matrix negative definite:
    its Cholesky pivot is NaN, so only its state goes non-finite; env_step
    ends its episode with zeroed obs and reward and resets it next."""
    env = make_env("Anymal", tc.load_cfg(STEM, 3), seed=2, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    params = env.state.params.clone()
    params[1] = -1.0
    env.state = env.state._replace(params=params)
    obs, rew, done, _ = env.step(torch.zeros(3, 12))
    assert int(done[1]) == 1 and float(rew[1]) == 0.0
    assert (obs[1] == 0).all()
    assert not torch.isfinite(env.state.task_state.v[1]).all()
    for i in (0, 2):
        assert torch.isfinite(env.state.task_state.q[i]).all()
    env.step(torch.zeros(3, 12))
    assert int(env.state.progress[1]) == 0
    assert all(torch.isfinite(x).all() for x in env.state.task_state)


def test_render_obs_frame(tasks):
    tc.render_matches_jax("Anymal", STEM, tasks[0])


def test_anymal_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "Anymal" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "Anymal", "--rl_device",
                                          "cpu"])
    assert cfg_env["env"]["numEnvs"] == 4000
    assert cfg_train["policy"]["pi_hid_sizes"] == [256, 128, 64]
    assert cfg_train["learn"]["nsteps"] == 24


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """One tiny ADR iteration (8 envs, episodes of 30 steps)."""
    out = tc.tiny_adr_run("Anymal", STEM, tmp_path, monkeypatch,
                          {"episodeLength_s": 0.5})
    assert out["env"].task.max_episode_length == 30
    assert out["env"].state.task_state.q.shape == (8, 19)
