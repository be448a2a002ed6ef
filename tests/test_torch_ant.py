"""The port's Ant task and the slice as a whole on the CPU: physics_step,
observe and reward against the JAX package over 5 steps from the same
state, params and actions; the DR spec and its full consumption; corner
params that stay finite for 80 steps; the NaN-pivot quarantine through
env_step; and a tiny run of ``bayes_sim_main --task Ant``.

Ant's ground contacts amplify float32 rounding differences between XLA and
eager torch, as the spinning Cartpole pole does: the comparison steps a
few times at small actions (|a| <= 0.3) with q and v held to atol 1e-4,
obs to atol 1e-4 and rewards to atol 1e-4."""

import os
import pickle

import numpy as np
import torch
import yaml

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.sim.ant import Ant as JaxAnt, AntState as JaxState
from bayes_sim_ig_tpu_torch.distributions import MoG, Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.ant import Ant, AntState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg", "ant.yaml")
TOL = dict(rtol=0, atol=1e-4)


def _cfg(num_envs):
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = num_envs
    return cfg


def test_config_copies_match_the_jax_package():
    for rel in ("ant.yaml", os.path.join("train", "ppo_ant.yaml")):
        with open(os.path.join(REPO, "bayes_sim_ig_tpu", "cfg", rel)) as a, \
                open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                                  rel)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), rel


def test_spec_matches_jax_and_realparams():
    cfg = _cfg(4)
    spec = Ant(cfg, device="cpu").params_spec
    jspec = JaxAnt(cfg).params_spec
    assert spec.names == jspec.names
    np.testing.assert_array_equal(spec.lows, jspec.lows)
    np.testing.assert_array_equal(spec.highs, jspec.highs)
    assert spec.dim == 17 == len(cfg["env"]["realParams"]["means"][0])


def test_physics_obs_and_reward_match_jax_over_5_steps():
    n = 6
    cfg = _cfg(n)
    jt, tt = JaxAnt(cfg), Ant(cfg, device="cpu")
    rs = np.random.RandomState(0)
    spec = tt.params_spec
    params = rs.uniform(spec.lows, spec.highs, (n, spec.dim)).astype(
        np.float32)
    m = tt.model
    q = np.tile(m.neutral_q(), (n, 1))
    q[:, 2] = 0.42  # feet in ground contact from the first step
    q[:, 7:] += rs.uniform(-0.08, 0.08, (n, 8))
    q = q.astype(np.float32)
    v = rs.uniform(-0.05, 0.05, (n, m.nv)).astype(np.float32)
    js = JaxState(jnp.asarray(q), jnp.asarray(v))
    ts = AntState(torch.from_numpy(q), torch.from_numpy(v))
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    key = jax.random.PRNGKey(0)
    for t in range(5):
        act = rs.uniform(-0.3, 0.3, (n, 8)).astype(np.float32)
        ja, ta = jnp.asarray(act), torch.from_numpy(act)
        js = jt.physics_step(js, ja, jp, key)
        ts = tt.physics_step(ts, ta, tp, None)
        for got, want in ((ts.q, js.q), (ts.v, js.v),
                          (tt.observe(ts, tp), jt.observe(js, jp)),
                          (tt.reward(ts, ta, tp), jt.reward(js, ja, jp))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"step {t}", **TOL)
        np.testing.assert_array_equal(
            tt.early_termination(ts, tp).numpy(),
            np.asarray(jt.early_termination(js, jp)))


def test_init_state_bounds():
    task = Ant(_cfg(64), device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = task.init_state(gen, torch.zeros(64, 17))
    q0 = torch.as_tensor(task.model.neutral_q(), dtype=torch.float32)
    assert st.q.shape == (64, 15) and st.v.shape == (64, 14)
    assert (st.q[:, 2] == 0.55).all() and torch.equal(st.q[:, 3:7],
                                                      q0[3:7].expand(64, 4))
    assert (st.q[:, 7:].abs() <= 0.08).all()
    assert (st.v.abs() <= 0.05).all()


def test_flat_sample_consumed_fully():
    t = Ant(_cfg(4), device="cpu")
    bound = set(t._mass_dims) | set(t._stiff_dims) | set(t._damp_dims)
    assert bound == set(range(t.params_spec.dim))


def test_corner_params_stay_finite():
    """The worst DR corner (all lows: 0.01x masses) for 80 steps of random
    actions with 2 envs: finite via the velocity clamps and, as a last
    resort, the non-finite quarantine of env_step."""
    env = make_env("Ant", _cfg(2), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[np.asarray(spec.lows, np.float64)],
            Ss=[np.eye(spec.dim) * 1e-12]), spec.lows, spec.highs,
        device="cpu"))
    env.reset()
    rs = np.random.RandomState(1)
    for t in range(80):
        act = torch.from_numpy(rs.uniform(-1, 1, (2, 8)).astype(np.float32))
        obs, rew, done, _ = env.step(act)
        assert torch.isfinite(obs).all() and torch.isfinite(rew).all(), t


def test_nan_pivot_env_is_quarantined_and_reset():
    """Negative body masses make env 1's mass matrix negative definite:
    its first Cholesky pivot is NaN, so only its state goes non-finite;
    env_step ends its episode with zeroed obs and reward, and resets it
    next."""
    env = make_env("Ant", _cfg(3), seed=2, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    params = env.state.params.clone()
    params[1, :9] = -1.0  # the 9 mass multipliers
    env.state = env.state._replace(params=params)
    obs, rew, done, _ = env.step(torch.zeros(3, 8))
    assert int(done[1]) == 1 and float(rew[1]) == 0.0
    assert (obs[1] == 0).all()
    assert not torch.isfinite(env.state.task_state.q[1]).all()
    for i in (0, 2):
        assert torch.isfinite(env.state.task_state.q[i]).all()
    obs2, _, _, _ = env.step(torch.zeros(3, 8))
    assert int(env.state.progress[1]) == 0
    assert torch.isfinite(obs2).all()
    assert all(torch.isfinite(x).all() for x in env.state.task_state)


def test_render_obs_frame():
    env = make_env("Ant", _cfg(2), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    obs = env.reset()
    frame = env.task.render_obs_frame(obs[0].numpy())
    assert frame.shape == (200, 200, 3) and frame.dtype == np.uint8
    assert (frame < 255).any()


def test_ant_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "Ant" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "Ant", "--rl_device",
                                          "cpu"])
    assert cfg_env["env"]["numEnvs"] == 1024
    assert cfg_train["policy"]["pi_hid_sizes"] == [256, 128, 64]


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """bayes_sim_main.main on a tiny Ant config (8 envs, 16 training
    trajectories, 2 evaluation episodes of 20 steps, 1 PPO iteration):
    one ADR iteration through the physics, MDNN and PPO; a finite 17-dim
    posterior on disk."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    from bayes_sim_ig_tpu_torch.ops.launch import launch_counts
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    cfg = _cfg(8)
    cfg["env"]["episodeLength"] = 20
    cfg["bayessim"].update(trainTrajs=16, realIters=1, realEvals=2)
    cfg_path = tmp_path / "ant.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    before = launch_counts()
    out = bayes_sim_main.main([
        "--task", "Ant", "--cfg_env", str(cfg_path), "--logdir",
        str(tmp_path / "logs"), "--max_iterations", "1", "--rl_device",
        "cpu"])
    assert launch_counts() == before  # CPU tensors: the plain version
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert len(out["iter_secs"]) == 1
    with open(os.path.join(out["logdir"], "checkpoints",
                           "posterior_0.pkl"), "rb") as f:
        post = pickle.load(f)
    assert post["means"].shape[1] == 17
    for k in ("weights", "means", "covs"):
        assert np.isfinite(post[k]).all(), k
    st = out["env"].state.task_state
    assert st.q.shape == (8, 15) and torch.isfinite(st.q).all()
