"""The port's Cartpole, env step and device samplers against the JAX
package: Cartpole physics_step / observe / reward / early_termination over
50 steps from the same state, params and actions (atol 1e-4); the
non-finite quarantine of env_step; and sample_distr by moments and
bounds (JAX keys and torch generators never give the same stream)."""

import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.distributions import (
    MoG as JaxMoG, to_device_distr as jax_to_device_distr,
)
from bayes_sim_ig_tpu.sim import env_step as jax_env_step
from bayes_sim_ig_tpu.sim.cartpole import (
    Cartpole as JaxCartpole, CartpoleState as JaxState,
)
from bayes_sim_ig_tpu_torch.distributions import (
    MoG, Uniform, sample_distr, to_device_distr,
)
from bayes_sim_ig_tpu_torch.sim import VecEnv, make_env
from bayes_sim_ig_tpu_torch.sim.cartpole import Cartpole, CartpoleState

torch.set_num_threads(1)

CFG = os.path.join(os.path.dirname(__file__), "..",
                   "bayes_sim_ig_tpu_torch", "cfg", "cartpole.yaml")
N = 16


def _cfg(num_envs=N):
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = num_envs
    return cfg


def _moderate_params(rs, n):
    """Params inside the prior box but away from its stiff corners (pole
    mass 0.01 with damping 100 makes the explicit substeps diverge, and
    two diverging runs cannot be compared value for value)."""
    p = np.empty((n, 13), np.float32)
    p[:, 0:3] = rs.uniform(0.5, 2.0, (n, 3))       # masses
    p[:, 3:9] = rs.uniform(0.1, 1.0, (n, 6))       # friction, restitution
    p[:, 9:11] = rs.uniform(0.0, 1.0, (n, 2))      # stiffness
    p[:, 11:13] = rs.uniform(0.0, 2.0, (n, 2))     # damping
    return p


def test_cartpole_spec_matches_jax():
    assert (Cartpole(_cfg(), device="cpu").params_spec.names
            == JaxCartpole(_cfg()).params_spec.names)


def test_cartpole_50_steps_match_jax():
    rs = np.random.RandomState(0)
    jt, tt = JaxCartpole(_cfg()), Cartpole(_cfg(), device="cpu")
    params = _moderate_params(rs, N)
    s0 = rs.uniform(-0.1, 0.1, (4, N)).astype(np.float32)
    # Forces up to 80 N keep most poles from spinning over within the 50
    # steps: a spinning pole amplifies float32 rounding differences
    # between the two frameworks past the 1e-4 bar.
    acts = rs.uniform(-0.2, 0.2, (50, N, 1)).astype(np.float32)
    js = JaxState(*[jnp.asarray(v) for v in s0])
    ts = CartpoleState(*[torch.from_numpy(v.copy()) for v in s0])
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    key = jax.random.PRNGKey(0)
    step = jax.jit(jt.physics_step)
    for t in range(50):
        js = step(js, jnp.asarray(acts[t]), jp, key)
        ts = tt.physics_step(ts, torch.from_numpy(acts[t]), tp, None)
        np.testing.assert_allclose(tt.observe(ts, tp).numpy(),
                                   np.asarray(jt.observe(js, jp)),
                                   rtol=0, atol=1e-4, err_msg=f"step {t}")
        np.testing.assert_allclose(
            tt.reward(ts, torch.from_numpy(acts[t]), tp).numpy(),
            np.asarray(jt.reward(js, jnp.asarray(acts[t]), jp)),
            rtol=0, atol=1e-4)
        np.testing.assert_array_equal(
            tt.early_termination(ts, tp).numpy(),
            np.asarray(jt.early_termination(js, jp)))


def test_env_step_quarantines_a_nan_env_like_jax():
    cfg = _cfg(4)
    spec_lows = Cartpole(cfg, device="cpu").params_spec.lows
    spec_highs = Cartpole(cfg, device="cpu").params_spec.highs
    prior_t = to_device_distr(Uniform(spec_lows, spec_highs), device="cpu")
    from bayes_sim_ig_tpu.distributions import Uniform as JaxUniform
    prior_j = jax_to_device_distr(JaxUniform(spec_lows, spec_highs))

    env = make_env("Cartpole", cfg, device="cpu")
    env.set_distr(prior_t)
    env.reset()
    st = env.state
    x = st.task_state.x.clone()
    x[1] = float("nan")
    env.state = st._replace(task_state=st.task_state._replace(x=x))
    obs, rew, done, _ = env.step(torch.zeros(4, 1))

    jtask = JaxCartpole(cfg)
    from bayes_sim_ig_tpu.sim.task import env_full_reset as jax_reset
    jst, _ = jax_reset(jtask, prior_j, jax.random.PRNGKey(0))
    jst = jst._replace(task_state=jst.task_state._replace(
        x=jst.task_state.x.at[1].set(jnp.nan)))
    _, jobs, jrew, jdone = jax_env_step(jtask, prior_j, jst,
                                        jnp.zeros((4, 1)))
    for got, want in ((obs[1].numpy(), np.asarray(jobs[1])),
                      (rew[1].numpy(), np.asarray(jrew[1])),
                      (done[1].numpy(), np.asarray(jdone[1]))):
        np.testing.assert_array_equal(got, want)
    assert int(done[1]) == 1 and float(rew[1]) == 0.0
    assert (obs[1] == 0).all()
    assert torch.isfinite(obs).all() and torch.isfinite(rew).all()
    # The quarantined env re-randomizes and restarts on the next step.
    obs2, _, _, _ = env.step(torch.zeros(4, 1))
    assert int(env.state.progress[1]) == 0
    assert torch.isfinite(obs2).all()
    assert all(torch.isfinite(v).all() for v in env.state.task_state)


def test_env_step_resets_at_the_episode_length():
    cfg = _cfg(3)
    env = make_env("Cartpole", cfg, seed=1, device="cpu")
    spec = env.task.params_spec
    mean = np.ones(spec.dim)
    mean[9:] = 0.5
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[mean], Ss=[np.eye(spec.dim) * 1e-8]),
        spec.lows, spec.highs, device="cpu"))
    env.max_episode_length = 4
    env.reset()
    dones = [int(env.step(torch.zeros(3, 1))[2][0]) for _ in range(4)]
    assert dones == [0, 0, 1, 0]
    assert isinstance(env, VecEnv)


@pytest.mark.parametrize("kind", ["uniform", "mog"])
def test_sample_distr_moments_and_bounds(kind):
    n = 100_000
    lows = np.array([0.0, -1.0, 0.5])
    highs = np.array([1.0, 1.0, 3.0])
    if kind == "uniform":
        host = Uniform(lows, highs)
        mean = (lows + highs) / 2
        cov = np.diag((highs - lows) ** 2 / 12)
    else:
        c = np.array([[0.01, 0.004, 0.0], [0.004, 0.02, -0.003],
                      [0.0, -0.003, 0.015]])
        ms = [np.array([0.3, -0.2, 1.2]), np.array([0.6, 0.4, 2.0])]
        host = MoG(a=[0.3, 0.7], ms=ms, Ss=[c, c * 0.5])
        mean, cov = host.calc_mean_and_cov()
    distr = to_device_distr(host, lows, highs, device="cpu")
    gen = torch.Generator().manual_seed(0)
    x = sample_distr(distr, gen, n).double().numpy()
    assert x.shape == (n, 3)
    assert (x >= lows.astype(np.float32)).all()
    assert (x <= highs.astype(np.float32)).all()
    # Means and covariances within 4 standard errors (the mixture's mass
    # lies >= 5 sd inside the box, so the clip moves neither).
    se_mean = np.sqrt(np.diag(cov) / n)
    assert (np.abs(x.mean(0) - mean) < 4 * se_mean).all()
    d = x - mean
    prods = d[:, :, None] * d[:, None, :]
    se_cov = prods.std(0) / np.sqrt(n)
    assert (np.abs(prods.mean(0) - cov) < 4 * se_cov + 1e-12).all()


def test_device_mog_cholesky_layout_matches_jax():
    c = np.array([[0.04, 0.01], [0.01, 0.09]])
    host_t = MoG(a=[1.0], ms=[np.zeros(2)], Ss=[c])
    host_j = JaxMoG(a=[1.0], ms=[np.zeros(2)], Ss=[c])
    t = to_device_distr(host_t, [-1, -1], [1, 1], device="cpu")
    j = jax_to_device_distr(host_j, [-1, -1], [1, 1])
    np.testing.assert_allclose(t.chols.numpy(), np.asarray(j.chols))
    np.testing.assert_allclose(t.weights.numpy(),
                               np.exp(np.asarray(j.log_weights)), rtol=1e-6)


def test_make_env_refuses_tasks_not_yet_ported():
    """A task neither package has is refused (ShadowHand, the last task
    of the JAX package, is ported)."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_env("Dactyl", _cfg(), device="cpu")


def test_make_env_defaults_to_the_card(monkeypatch):
    """make_env and every task constructor default to the card; without
    one (torch.cuda.is_available() False, as on this CPU-only torch or
    forced so on a card's machine) the default raises instead of running
    on the CPU, and device="cpu" is what a caller asks the CPU with."""
    import inspect
    from bayes_sim_ig_tpu_torch import sim
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_env("Cartpole", _cfg())
    assert inspect.signature(make_env).parameters["device"].default == "cuda"
    for name in sim.available_tasks():
        cls = sim._TASK_REGISTRY[name]
        assert inspect.signature(cls).parameters["device"].default == \
            "cuda", name
        with pytest.raises(RuntimeError, match="is_available"):
            cls(_cfg())
    assert make_env("Cartpole", _cfg(), device="cpu").device.type == "cpu"


def test_postprocess_round_matches_jax():
    """Episode extraction and repeat-last padding, value for value."""
    from bayes_sim_ig_tpu.utils.collect import _postprocess_round as jpp
    from bayes_sim_ig_tpu_torch.utils.collect import _postprocess_round
    rs = np.random.RandomState(3)
    steps, n = 7, 5
    obs0 = rs.randn(n, 4).astype(np.float32)
    obs = rs.randn(steps, n, 4).astype(np.float32)
    act = rs.randn(steps, n, 1).astype(np.float32)
    rew = rs.randn(steps, n).astype(np.float32)
    done = np.zeros((steps, n), np.int32)
    done[[2, 6, 0, 4, 6], np.arange(n)] = 1  # first episode ends differ
    done[5, 0] = 1                           # a later episode is ignored
    labels = rs.randn(n, 13).astype(np.float32)
    want = jpp(*(jnp.asarray(v) for v in (obs0, obs, act, rew, done,
                                          labels)))
    got = _postprocess_round(*(torch.from_numpy(v) for v in
                               (obs0, obs, act, rew, done, labels)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_collect_policies():
    from bayes_sim_ig_tpu_torch.utils.collect import get_collect_policy
    act = torch.full((1000, 2), -0.7)
    gen = torch.Generator().manual_seed(0)
    rnd = get_collect_policy("policy_random")(act, gen)
    assert float(rnd.min()) >= 0.0 and float(rnd.max()) < 1.0  # U[0, 1]
    assert torch.equal(get_collect_policy("policy_ones")(act, gen),
                       torch.ones_like(act))
    assert get_collect_policy(None)(act, gen) is act
    mixed = get_collect_policy("policy_rl_randomized")(act, gen)
    assert mixed.shape == act.shape
    with pytest.warns(UserWarning, match="grasp_excitation_dims"):
        grasp = get_collect_policy("policy_grasp",
                                   task=Cartpole(_cfg(), device="cpu"))
    assert torch.equal(grasp(act, gen), torch.ones_like(act))
    with pytest.raises(KeyError):
        get_collect_policy("policy_nope")


def test_base_task_get_img_is_none_like_jax():
    """Task.get_img, the optional single-env frame: None unless a task
    draws one (the JAX package's sim/task.py:102)."""
    env = make_env("Cartpole", _cfg(4), seed=0, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    assert env.task.get_img(env.state) is None
    assert env.task.get_img(env.state, env_id=3, height=8, width=8) is None
    jtask = JaxCartpole(_cfg(4))
    assert jtask.get_img(None) is None
