"""The README quick start on the port: the Pendulum task against the JAX
package on the CPU (trajectories step for step from the same state,
params and actions, with obs and rewards; the oracle of
tests/test_sim.py::TestPendulumPhysics), the MDNN golden-fixture gate of
tests/test_engine.py in its median-over-seeds form, PPO learning
Pendulum (tests/test_ppo.py's setup), and ``bayes_sim_main --task
Pendulum`` end to end at a tiny size.

Tolerances: the same float32 formula on both sides, with sin and the
float modulo of two libraries, which differ by an ulp from the first
step; the driven pendulum amplifies that (max deviation 3.1e-6 by step
30, 2.7e-5 by step 50, 3.6e-4 by step 100 at random actions in [-1, 1]),
so trajectories are held to rtol 1e-5 / atol 1e-5 over 30 steps."""

import os
import pickle

import numpy as np
import torch
import yaml

import jax.numpy as jnp

from bayes_sim_ig_tpu.sim.pendulum import (
    Pendulum as JaxPendulum, PendulumState as JaxState,
)
from bayes_sim_ig_tpu_torch.distributions import MoG, Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.rl import process_ppo
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.pendulum import Pendulum, PendulumState

from .test_engine import TRUE_PARAMS, load_pendulum_data
from .test_sim import pendulum_cfg, pendulum_oracle_step
from .test_torch_engine import _run_bsim

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg", "pendulum.yaml")
TOL = dict(rtol=1e-5, atol=1e-5)


def test_config_copies_match_the_jax_package():
    for rel in ("pendulum.yaml", os.path.join("train", "ppo_pendulum.yaml")):
        with open(os.path.join(REPO, "bayes_sim_ig_tpu", "cfg", rel)) as a, \
                open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                                  rel)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), rel


def test_spec_matches_jax():
    cfg = pendulum_cfg()
    spec = Pendulum(cfg, device="cpu").params_spec
    jspec = JaxPendulum(cfg).params_spec
    assert spec.names == jspec.names
    np.testing.assert_array_equal(spec.lows, jspec.lows)
    np.testing.assert_array_equal(spec.highs, jspec.highs)
    t = Pendulum(cfg, device="cpu")
    assert (t._mass_dim, t._length_dim) == (JaxPendulum(cfg)._mass_dim,
                                            JaxPendulum(cfg)._length_dim)


def test_trajectories_match_jax_step_for_step():
    """TestPendulumPhysics's setup (16 envs, params U[0.1, 2]), run for 30
    steps: state, obs and the pre-step reward at every step, and the
    first step against the numpy oracle."""
    cfg = pendulum_cfg()
    jt, tt = JaxPendulum(cfg), Pendulum(cfg, device="cpu")
    rs = np.random.RandomState(0)
    n = tt.num_envs
    params = np.stack([rs.uniform(0.1, 2.0, n), rs.uniform(0.1, 2.0, n)],
                      axis=1).astype(np.float32)
    th0 = rs.uniform(-np.pi, np.pi, n).astype(np.float32)
    thdot0 = rs.uniform(-1, 1, n).astype(np.float32)
    js = JaxState(th=jnp.asarray(th0), thdot=jnp.asarray(thdot0))
    ts = PendulumState(th=torch.from_numpy(th0),
                       thdot=torch.from_numpy(thdot0))
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    for t in range(30):
        act = rs.uniform(-1, 1, (n, 1)).astype(np.float32)
        ja, ta = jnp.asarray(act), torch.from_numpy(act)
        np.testing.assert_allclose(tt.reward(ts, ta, tp).numpy(),
                                   np.asarray(jt.reward(js, ja, jp)), **TOL,
                                   err_msg=f"reward {t}")
        js = jt.physics_step(js, ja, jp, None)
        ts = tt.physics_step(ts, ta, tp, None)
        if t == 0:
            th1, thdot1 = pendulum_oracle_step(
                th0, thdot0, act[:, 0] * 2.0, params[:, tt._mass_dim],
                params[:, tt._length_dim])
            np.testing.assert_allclose(ts.th.numpy(), th1, rtol=2e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(ts.thdot.numpy(), thdot1, rtol=2e-4,
                                       atol=1e-5)
        for got, want in ((ts.th, js.th), (ts.thdot, js.thdot),
                          (tt.observe(ts, tp), jt.observe(js, jp))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                       err_msg=f"step {t}")


def test_init_state_and_env_semantics():
    """Reset draws th ~ U[-pi, pi], thdot ~ U[-1, 1]; the reward is the
    pre-step state's; done on the last step of an episode."""
    env = make_env("Pendulum", pendulum_cfg(num_envs=256, episode_len=11),
                   device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    obs = env.reset()
    st = env.state.task_state
    assert (st.th.abs() <= np.pi).all() and st.th.abs().max() > 2.5
    assert (st.thdot.abs() <= 1.0).all()
    torch.testing.assert_close(obs, env.task.observe(st, env.state.params))
    act = torch.zeros(256, 1)
    want = env.task.reward(st, act, env.state.params)
    _, rew, _, _ = env.step(act)
    torch.testing.assert_close(rew, want)
    dones = [int(env.step(act)[2].sum()) for _ in range(9)]
    assert dones[:-1] == [0] * 8 and dones[-1] == 256


def test_get_img_and_render_match_jax():
    env = make_env("Pendulum", pendulum_cfg(), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    obs = env.reset()
    jt = JaxPendulum(pendulum_cfg())
    np.testing.assert_array_equal(env.task.render_obs_frame(obs[3].numpy()),
                                  jt.render_obs_frame(obs[3].numpy()))
    img = env.task.get_img(env.state, env_id=3)
    assert img.shape == (200, 200, 3) and (img < 255).any()


def test_mdnn_golden_gate_median_over_seeds():
    """test_engine.py's MDNN+summary_start gate in its median-over-seeds
    form (test_posterior_gate_distributional): median NLL of the truth
    over seeds 0, 1, 2 below 2.2 (the uniform prior sits at 1.38, a broken
    model far above 5), and the truth preferred to a far point."""
    _, real_states, real_actions = load_pendulum_data(
        "pendulum_true_data_ones_policy_rnd.npz")
    nlls, margins = [], []
    for seed in (0, 1, 2):
        bsim = _run_bsim("MDNN", "summary_start", seed)
        assert type(bsim.model).__name__ == "MDNN"
        posterior = bsim.predict(real_states, real_actions)
        nll = float(-posterior.eval(TRUE_PARAMS.reshape(1, -1), log=True)[0])
        far = float(-posterior.eval(np.array([[0.2, 1.8]]), log=True)[0])
        nlls.append(nll)
        margins.append(nll - far)
    assert np.median(nlls) < 2.2, nlls
    assert np.median(margins) < 0.0, margins


def _ppo_gain(seed, tmp_path):
    env = make_env("Pendulum", pendulum_cfg(64, 100), seed=seed, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[np.ones(2)], Ss=[np.eye(2) * 1e-10]),
        spec.lows, spec.highs, device="cpu"))
    cfg_train = {"seed": seed, "learn": {
        "nsteps": 64, "noptepochs": 5, "nminibatches": 4,
        "optim_stepsize": 1e-3, "desired_kl": 0.008, "gamma": 0.95,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [64, 64], "vf_hid_sizes": [64, 64]}}
    ppo = process_ppo(env, cfg_train, logdir=str(tmp_path / str(seed)))

    def eval_reward():
        obs = env.reset()
        tot = 0.0
        for _ in range(60):
            act, _ = ppo.act(obs, deterministic=True)
            obs, rew, _, _ = env.step(act)
            tot += float(rew.mean())
        return tot / 60

    before = eval_reward()
    ppo.run(num_learning_iterations=60, log_interval=1000)
    assert ppo.current_learning_iteration == 60
    return eval_reward() - before


def test_ppo_learns_pendulum(tmp_path):
    """tests/test_ppo.py's setup: 64 envs at params pinned to (1, 1),
    100-step episodes, 60 PPO iterations of 64 steps; the deterministic
    policy's mean step reward over 60 steps rises by more than 1, judged
    on the median over seeds 0-4. torch's draws differ from JAX's, and
    this gain is a noisy read of learning: over seeds 0-8 the port's
    spans -0.83..2.91 (median 1.71), the JAX package's 2.14..3.70 over
    seeds 0-6, while the stochastic policy's training reward over
    iterations 50-60 agrees (median over seeds 0-5: port -3.87, JAX
    -4.68)."""
    gains = [_ppo_gain(seed, tmp_path) for seed in range(5)]
    assert np.median(gains) > 1.0, f"PPO did not learn: gains {gains}"


def test_quick_start_cli_runs_on_cpu(tmp_path, monkeypatch):
    """The README quick start (``--task Pendulum``: MDNN, summary_start,
    policy_random) through bayes_sim_main.main at a tiny size: 16 envs, 64
    training trajectories, 2 ADR iterations of 1 PPO iteration each;
    finite 2-dim posteriors on disk."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "Pendulum" in available_tasks()
    _, cfg_env, cfg_train = init_args(["--task", "Pendulum",
                                       "--rl_device", "cpu"])
    assert cfg_env["env"]["numEnvs"] == 100
    assert cfg_env["bayessim"]["modelClass"] == "MDNN"
    assert cfg_env["bayessim"]["summarizerFxn"] == "summary_start"
    assert cfg_train["learn"]["nsteps"] == 64
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update(numEnvs=16, episodeLength=20)
    cfg["bayessim"].update(trainTrajs=64, realIters=2, realEvals=4)
    cfg_path = tmp_path / "pendulum.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    out = bayes_sim_main.main([
        "--task", "Pendulum", "--cfg_env", str(cfg_path), "--logdir",
        str(tmp_path / "logs"), "--max_iterations", "1", "--rl_device",
        "cpu"])
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert len(out["iter_secs"]) == 2
    for it in (0, 1):
        with open(os.path.join(out["logdir"], "checkpoints",
                               f"posterior_{it}.pkl"), "rb") as f:
            post = pickle.load(f)
        assert post["means"].shape[1] == 2
        for k in ("weights", "means", "covs"):
            assert np.isfinite(post[k]).all(), (it, k)
