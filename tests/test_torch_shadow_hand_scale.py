"""ShadowHand's two larger configs, which the card runs at the JAX
package's own scale (shadow_hand_more.yaml: 10,000 envs and 111 DR params;
shadow_hand_grasp.yaml: 2,048 envs, ``policy_grasp`` and the 107-dim
force-sensor obs), against the JAX package on the CPU at 4 envs:

  * ``VecEnv.step`` of each config against JAX's ``VecEnv.step`` from one
    state (the port's reset, carried across as numpy) with the same
    actions (|a| <= 0.3: the contacts amplify rounding): obs, reward,
    done and every state field within 1e-4 after each of 5 steps (the JAX
    steps eager, ``jax.disable_jit``). The configs' scheduled observation
    and action noise is left out of this comparison: each package draws
    its white noise from its own stream (JAX threefry, a torch
    generator), and those draws, ~5e-6 on the actions by step 5, grow to
    2.4e-4 in the state through the contacts (2.6e-5 without them);
  * that noise (``dr/noise.py::apply_noise``, each config's observation
    and action noise) against JAX's with the white noise's draws
    injected, at frame counts across the schedule: within 1e-6;
  * ``policy_grasp`` against JAX's with the jitter's uniform draws
    injected: equal within 1e-7;
  * a tiny ADR loop (``bayes_sim_main.main``: 16 envs, episodes of 20,
    trajectories of 10 steps) on each config: finite
    posteriors of the config's dimension, its obs width, and on the grasp
    config ``policy_grasp`` in the collection;
  * the programs these configs add to a round (the reset, the collection
    step under each config's collection policy, the extraction,
    ``VecEnv.reset``/``step`` and the rollout step) make no host sync and
    no host copy (``torch_task_checks.NoHostTraffic``).

The JAX envs are shared per module: a first eager JAX ShadowHand step
compiles many ops."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.distributions import Uniform as JaxUniform
from bayes_sim_ig_tpu.dr.noise import apply_noise as jax_apply_noise
from bayes_sim_ig_tpu.distributions import to_device_distr as jax_distr
from bayes_sim_ig_tpu.sim import make_env as jax_make_env
from bayes_sim_ig_tpu.sim.task import EnvState as JaxEnvState
from bayes_sim_ig_tpu.utils.collect import (
    get_collect_policy as jax_get_collect_policy,
)
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.dr import noise
from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.utils import collect
from bayes_sim_ig_tpu_torch.utils.collect import (
    _collect_round, collect_round, collect_step_graph, get_collect_policy,
)

from . import torch_task_checks as tc
from .torch_task_checks import NoHostTraffic

torch.set_num_threads(1)

N = 4
# stem: (DR dims, obs width, collection policy)
CONFIGS = {"shadow_hand_more": (111, 89, "policy_rl_randomized"),
           "shadow_hand_grasp": (32, 107, "policy_grasp")}


def _cfg(stem, episode_length=1000, noise=True):
    cfg = tc.load_cfg(stem, N)
    cfg["env"]["episodeLength"] = episode_length
    if not noise:
        for kind in ("observations", "actions"):
            del cfg["task"]["randomization_params"][kind]
    return cfg


@pytest.fixture(scope="module")
def jax_envs():
    """{stem: the JAX package's VecEnv of the config at 4 envs}."""
    return {stem: jax_make_env("ShadowHand", _cfg(stem, noise=False), seed=0)
            for stem in CONFIGS}


def _actions(task, steps, seed=0, amp=1.0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.uniform(-amp, amp, (task.num_envs,
                                                    task.act_dim))
                             .astype(np.float32)) for _ in range(steps)]


@pytest.mark.parametrize("stem", list(CONFIGS))
def test_vec_env_step_matches_jax_over_5_steps(stem, jax_envs):
    dim, obs_dim, _ = CONFIGS[stem]
    env = make_env("ShadowHand", _cfg(stem, noise=False), seed=0,
                   device="cpu")
    jenv = jax_envs[stem]
    assert env.task.obs_noise is None and env.task.act_noise is None
    spec = env.task.params_spec
    assert spec.dim == dim and env.task.obs_dim == obs_dim
    assert jenv.task.params_spec.dim == dim and jenv.task.obs_dim == obs_dim
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    jenv.set_distr(jax_distr(JaxUniform(spec.lows, spec.highs)))
    env.reset()
    st = env.state
    jtask_state = type(jenv.task.init_state(
        jax.random.PRNGKey(0), jnp.asarray(st.params.numpy())))
    jenv.state = JaxEnvState(
        task_state=jtask_state(*[jnp.asarray(x.numpy())
                                 for x in st.task_state]),
        **{k: jnp.asarray(v.numpy()) for k, v in st._asdict().items()
           if k != "task_state"},
        key=jax.random.PRNGKey(0))
    for t, a in enumerate(_actions(env.task, 5, seed=1, amp=0.3)):
        obs, rew, done, _ = env.step(a)
        with jax.disable_jit():
            jobs, jrew, jdone, _ = jenv.step(jnp.asarray(a.numpy()))
        assert obs.shape == (N, obs_dim)
        pairs = [(obs, jobs), (rew, jrew)] + list(zip(
            env.state.task_state, jenv.state.task_state))
        for i, (g, w) in enumerate(pairs):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4, err_msg=f"step {t} {i}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


@pytest.mark.parametrize("kind", ["obs", "act"])
@pytest.mark.parametrize("stem", list(CONFIGS))
def test_noise_matches_jax_with_the_draws_injected(stem, kind, monkeypatch):
    """The config's scheduled noise (``<kind>_noise``: additive gaussian,
    white and correlated) on the same tensor and correlated draw, the
    port's white draw replaced by the normal draws JAX makes from its key,
    at frame counts before, inside and past the linear schedule."""
    cfg = _cfg(stem)
    tt = make_env("ShadowHand", cfg, device="cpu").task
    jt = jax_make_env("ShadowHand", cfg).task
    tcfg, jcfg = getattr(tt, f"{kind}_noise"), getattr(jt, f"{kind}_noise")
    assert tcfg is not None and tcfg.schedule == "linear"
    width = tt.obs_dim if kind == "obs" else tt.act_dim
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (N, width)).astype(np.float32)
    corr = rs.randn(N, width).astype(np.float32)
    for t, frame in enumerate((0, 7, 20000, 40000, 90000)):
        key = jax.random.PRNGKey(t)
        want = np.asarray(jax_apply_noise(jcfg, key, jnp.asarray(x),
                                          jnp.asarray(corr), frame))
        white = np.array(jax.random.normal(key, x.shape, jnp.float32))
        monkeypatch.setattr(noise, "env_draw",
                            lambda *a, **k: torch.from_numpy(white))
        got = noise.apply_noise(tcfg, torch.Generator(), torch.from_numpy(x),
                                torch.from_numpy(corr),
                                torch.tensor(frame, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=f"frame {frame}")
        assert frame == 0 or not np.array_equal(want, x)


@pytest.mark.parametrize("seed", [0, 1])
def test_policy_grasp_matches_jax_with_the_draws_injected(seed, jax_envs,
                                                          monkeypatch):
    """Both packages' ``get_collect_policy("policy_grasp", task)`` on the
    same RL actions, the port's jitter draw replaced by the uniform draws
    JAX makes from its key (JAX: u * 0.6 - 0.3 from ``minval``/``maxval``;
    the port: ``rand`` * 0.6 - 0.3)."""
    jtask = jax_envs["shadow_hand_grasp"].task
    env = make_env("ShadowHand", _cfg("shadow_hand_grasp"), device="cpu")
    rs = np.random.RandomState(seed)
    act = rs.uniform(-1.5, 1.5, (N, env.task.act_dim)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax_get_collect_policy("policy_grasp", jtask)(
        jnp.asarray(act), key))
    u = np.array(jax.random.uniform(key, act.shape, jnp.float32))
    draws = []

    def injected(fn, shape, gen, dtype, device):
        draws.append(tuple(shape))
        return torch.from_numpy(u).to(dtype)
    monkeypatch.setattr(collect, "env_draw", injected)
    got = get_collect_policy("policy_grasp", env.task)(
        torch.from_numpy(act), torch.Generator())
    assert draws == [act.shape]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    dims = list(env.task.grasp_excitation_dims)
    assert (got.numpy()[:, dims] >= 0.7 - 1e-6).all()


@pytest.mark.parametrize("stem", list(CONFIGS))
def test_adr_loop_runs_on_cpu(stem, tmp_path, monkeypatch):
    dim, obs_dim, cpol = CONFIGS[stem]
    calls = []
    grasp = collect.policy_grasp

    def counted(*args):
        calls.append(1)
        return grasp(*args)
    monkeypatch.setattr(collect, "policy_grasp", counted)
    out = tc.tiny_adr_run("ShadowHand", stem, tmp_path, monkeypatch,
                          {"episodeLength": 20}, num_envs=16,
                          bayessim_edits={"trainTrajLen": 10})
    assert out["env"].task.params_spec.dim == dim
    assert out["env"].task.obs_dim == obs_dim
    assert out["posterior"].xs[0].m.shape == (dim,)
    assert (len(calls) > 0) == (cpol == "policy_grasp")


@pytest.mark.parametrize("stem", list(CONFIGS))
def test_the_programs_make_no_host_sync_and_no_host_copy(stem, tmp_path):
    """After a first round that builds each program: the round's reset, a
    collection step under the config's collection policy, the extraction,
    ``VecEnv.reset``, ``VecEnv.step`` and a rollout, with the prior: no
    op of NoHostTraffic's list, no boolean-mask index."""
    cfg = _cfg(stem, episode_length=6)
    env = make_env("ShadowHand", cfg, seed=3, device="cpu")
    ppo = process_ppo(env, {"seed": 0, "learn": {
        "nsteps": 2, "noptepochs": 1, "nminibatches": 2,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [16], "vf_hid_sizes": [16]}},
        logdir=str(tmp_path))
    task, gen = env.task, ppo.gen
    spec = task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), device="cpu")
    env.set_distr(distr)
    cpol = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    _collect_round(env, ppo.policy_apply, cpol, 7, ppo.net, distr, gen)
    reset = env.reset_program(gen, distr)
    rnd = collect_round(env, 6, reset.state.params)
    state, obs = reset(distr)
    step = collect_step_graph(env, ppo.policy_apply, cpol, 7, ppo.net,
                              distr, gen, state, obs)
    obs = env.reset()
    acts = _actions(task, 2)
    env.step(acts[0])
    ppo.rollout(distr, env.state, obs)
    mode = NoHostTraffic()
    with mode:
        reset(distr)
        step.load(state, obs, distr)
        step.step()
        rnd.extract()
        env.reset()
        env.step(acts[1])
        ppo.rollout(distr, env.state, obs)
    assert not mode.hits, f"{stem}: {sorted(set(mode.hits))}"
