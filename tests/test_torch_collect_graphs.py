"""The port's last compiled programs on static buffers, which the card runs
as CUDA graphs and the CPU runs eagerly: the collection round's reset
(``sim/task.py::EnvReset``) and episode extraction
(``utils/collect.py::CollectRound``), ``VecEnv.reset`` and ``VecEnv.step``
(``EnvReset``, ``EnvStep``), ``PPO.act`` (``rl/ppo.py::_Act``) and the
PPO iteration's tail (the rollout's last value, the permutations drawn by
the update's first program). Every case runs 4 envs, episodes cut to 6
steps:

  (a) none of them makes a host sync or a host copy
      (``torch_task_checks.NoHostTraffic``), for all ten tasks;
  (b) a round whose env 0 terminates early at every step equals the
      list-and-``torch.stack`` round of the plain ``env_full_reset``,
      ``env_step`` and ``_postprocess_round`` bit for bit, its labels the
      params drawn at the round's reset, not those of env 0's later
      episodes;
  (c) ``VecEnv.reset`` and 10 ``VecEnv.step`` calls equal
      ``env_full_reset`` and ``env_step`` bit for bit, the frame counter
      carried across a second reset; an obs and an ``env.state`` a caller
      holds do not change at the next step;
  (d) ``VecEnv.step`` against the JAX package's from one state and the
      same actions: within 1e-4 over 5 steps (Cartpole, Ant);
  (e) the deterministic ``PPO.act`` against the JAX package's
      ``_mean_fn`` on the converted params: rtol 1e-5;
  (f) ``PPO.train_iteration`` (its permutations drawn by the update's
      first program) equals the rollout, the eager draws and the update
      with those permutations bit for bit;
  (g) on a card, the programs' replays against their eager bodies
      (``cuda`` marker; skipped without one).
And ``RFF`` and ``to_device_distr`` default to the card: without one they
raise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.rl.ppo import process_ppo as jax_process_ppo
from bayes_sim_ig_tpu.sim import make_env as jax_make_env
from bayes_sim_ig_tpu.distributions import Uniform as JaxUniform
from bayes_sim_ig_tpu.distributions import to_device_distr as jax_distr
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.models.rff import RFF
from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.sim.task import env_full_reset, env_step
from bayes_sim_ig_tpu_torch.utils.collect import (
    _collect_round, collect_round, get_collect_policy,
)
from bayes_sim_ig_tpu_torch.utils.convert import actor_critic_params_to_jax
from bayes_sim_ig_tpu_torch.utils.step_graph import clone_tree

from .test_torch_step_graph import (N, TASKS, _assert_states_equal, _cfg,
                                    _BY_NAME, _leaves, _mog,
                                    _old_collect_round, _setup, _uniform)
from .test_torch_train_graphs import _card_or_skip, _with_bodies
from .torch_task_checks import NoHostTraffic

torch.set_num_threads(1)

STEPS = 10


def _actions(task, steps, seed=0, amp=1.0):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.uniform(-amp, amp, (task.num_envs,
                                                    task.act_dim))
                             .astype(np.float32)) for _ in range(steps)]


# ------------------------------------------------------------------ #
# (a) no host sync and no host data in the programs
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name", [t[0] for t in TASKS])
def test_the_programs_make_no_host_sync_and_no_host_copy(task_name,
                                                         tmp_path):
    """After a first call that builds each program (and the per-model
    tables): the reset of a collection round and of VecEnv (the frame
    counter from a device tensor), the extraction, VecEnv.step and both
    PPO.act programs, with a mixture distribution: no op of
    NoHostTraffic's list, no boolean-mask index."""
    env, ppo, cfg = _setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    distr = _mog(task)
    env.set_distr(distr)
    cpol = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    _collect_round(env, ppo.policy_apply, cpol, 7, ppo.net, distr, gen)
    reset = env.reset_program(gen, distr)
    rnd = collect_round(env, 6, reset.state.params)
    obs = env.reset()
    acts = _actions(task, 2)
    env.step(acts[0])
    ppo.act(obs)
    ppo.act(obs, deterministic=True)
    mode = NoHostTraffic()
    with mode:
        reset(distr)
        rnd.extract()
        env.reset()
        env.step(acts[1])
        ppo.act(obs)
        ppo.act(obs, deterministic=True)
    assert not mode.hits, f"{task_name}: {sorted(set(mode.hits))}"


# ------------------------------------------------------------------ #
# (b) a round against the plain loop, with an env reset inside it
# ------------------------------------------------------------------ #
def _terminate_env0(monkeypatch, task):
    """Env 0 terminates early at every step: it re-randomizes its params
    at every step of a round."""
    early = task.early_termination
    first = torch.arange(N) == 0
    monkeypatch.setattr(task, "early_termination",
                        lambda state, params: early(state, params) | first)


@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "ShadowHand"])
def test_round_labels_are_the_params_of_its_reset(task_name, tmp_path,
                                                   monkeypatch):
    """A round through the programs' bodies whose env 0 resets at every
    step equals the list-and-stack round from the same generator, bit for
    bit (labels, states, actions, rewards, generator after); env 0's
    label is the params of the round's reset, which its later episodes
    no longer carry."""
    env, ppo, cfg = _setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    _terminate_env0(monkeypatch, task)
    distr = _uniform(task)
    cpol = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    mel = 7
    start = gen.get_state()
    got = _collect_round(env, ppo.policy_apply, cpol, mel, ppo.net, distr,
                         gen)
    got_gen = gen.get_state()
    step_params = [g for k, g in env.step_graphs.items()
                   if k[0] == "collect"][0].state.params
    gen.set_state(start)
    reset_params = env_full_reset(task, distr, gen)[0].params
    gen.set_state(start)
    want = _old_collect_round(task, ppo.policy_apply, cpol, mel, ppo.net,
                              distr, gen)
    for name, a, b in zip(("labels", "states", "actions", "rewards"), got,
                          want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
    assert torch.equal(got_gen, gen.get_state())
    assert torch.equal(got[0], reset_params)
    assert not torch.equal(got[0][0], step_params[0])


# ------------------------------------------------------------------ #
# (c) VecEnv.reset and VecEnv.step against the plain functions
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name", ["Cartpole", "Ant"])
def test_vec_env_equals_the_plain_reset_and_steps(task_name, tmp_path):
    """VecEnv.reset, 10 VecEnv.step calls (an episode of 6 steps: resets
    inside) and a second reset through the programs equal env_full_reset
    and env_step from the same generator, bit for bit: every obs, reward
    and done, the state after each, the frame counter (carried across the
    second reset) and the generator. An obs and an env.state held across
    the next step keep their values."""
    env, _, _ = _setup(task_name, tmp_path)
    task = env.task
    distr = _mog(task)
    env.set_distr(distr)
    acts = _actions(task, STEPS)
    start = env.gen.get_state()
    obs = env.reset()
    got = [(obs, None, None, clone_tree(env.state))]
    for a in acts:
        held_obs, held_state = obs, env.state
        keep = (held_obs.clone(), clone_tree(held_state))
        obs, rew, done, _ = env.step(a)
        assert torch.equal(held_obs, keep[0])
        _assert_states_equal(held_state, keep[1], "held state")
        got.append((obs, rew, done, env.state))
    got.append((env.reset(), None, None, env.state))
    got_gen = env.gen.get_state()

    env.gen.set_state(start)
    state, obs = env_full_reset(task, distr, env.gen)
    want = [(obs, None, None, state)]
    for a in acts:
        state, obs, rew, done = env_step(task, distr, state, a, env.gen,
                                         env.max_episode_length)
        want.append((obs, rew, done, state))
    state, obs = env_full_reset(task, distr, env.gen, state.frame_count)
    want.append((obs, None, None, state))
    assert int(got[-1][3].frame_count) == STEPS
    assert sum(int(w[2].sum()) for w in want[1:-1]) > 0, "no reset crossed"
    for t, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g[:3], w[:3]):
            if b is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0,
                                           msg=f"call {t}")
        _assert_states_equal(g[3], w[3], f"call {t}")
    assert torch.equal(got_gen, env.gen.get_state())


# ------------------------------------------------------------------ #
# (d) VecEnv.step against the JAX package's
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name,amp", [("Cartpole", 1.0), ("Ant", 0.3)])
def test_vec_env_step_matches_jax(task_name, amp):
    """5 VecEnv.step calls of both packages from the port's reset state
    (carried across as numpy, field by field) with the same actions
    (|a| <= 0.3 on Ant, whose contacts amplify rounding): obs, reward,
    done and every state field within 1e-4 after each step. The JAX steps
    run eagerly (``jax.disable_jit``): a jitted Ant step compiles for tens
    of seconds."""
    from bayes_sim_ig_tpu.sim.task import EnvState as JaxEnvState
    _, stem, _ = _BY_NAME[task_name]
    cfg = _cfg(stem, {"episodeLength": 1000})
    env = make_env(task_name, cfg, seed=0, device="cpu")
    jenv = jax_make_env(task_name, cfg, seed=0)
    spec = env.task.params_spec
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
    for t, a in enumerate(_actions(env.task, 5, seed=1, amp=amp)):
        obs, rew, done, _ = env.step(a)
        with jax.disable_jit():
            jobs, jrew, jdone, _ = jenv.step(jnp.asarray(a.numpy()))
        pairs = [(obs, jobs), (rew, jrew)] + list(zip(
            env.state.task_state, jenv.state.task_state))
        for i, (g, w) in enumerate(pairs):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-4, err_msg=f"step {t} {i}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


# ------------------------------------------------------------------ #
# (e) PPO.act against the JAX package's _mean_fn
# ------------------------------------------------------------------ #
def test_deterministic_act_matches_the_jax_mean_fn(tmp_path):
    """The deterministic PPO.act program against the JAX trainer's jitted
    ``_mean_fn`` on the port's policy converted to the JAX layout, on the
    observations of a reset: rtol 1e-5."""
    env, ppo, cfg = _setup("Cartpole", tmp_path)
    env.set_distr(_uniform(env.task))
    obs = env.reset()
    jenv = jax_make_env("Cartpole", cfg, seed=0)
    jppo = jax_process_ppo(jenv, {"seed": 0, "learn": {"nsteps": STEPS},
                                  "policy": {"pi_hid_sizes": [16],
                                             "vf_hid_sizes": [16]}},
                           logdir=str(tmp_path / "jax"))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    actor_critic_params_to_jax(ppo.net))
    got, logp = ppo.act(obs, deterministic=True)
    assert logp is None
    want = np.asarray(jppo._mean_fn(params, jnp.asarray(obs.numpy())))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------ #
# (f) the PPO iteration's tail
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name,asymmetric", [("Cartpole", False),
                                                  ("Pendulum", True)])
def test_train_iteration_equals_the_eager_tail(task_name, asymmetric,
                                               tmp_path):
    """Two iterations of train_iteration (the rollout's last value by its
    program, the permutations drawn by the update's prepare) against two
    trainers' worth of the eager tail, each from the same seeds: the
    public rollout, noptepochs torch.randperm calls, update_from_traj with
    those permutations. The permutations, the metrics, the policy, the
    Adam state, the lr, the env state and both generators bit for bit."""
    runs = []
    for eager in (False, True):
        env, ppo, _ = _setup(task_name, tmp_path, asymmetric)
        distr = _mog(env.task)
        env.set_distr(distr)
        obs = env.reset()
        state = env.state
        out = []
        for _ in range(2):
            if eager:
                state, obs, traj, last_val = ppo.rollout(distr, state, obs)
                perms = torch.stack([
                    torch.randperm(ppo.nsteps * N, generator=ppo.gen)
                    for _ in range(ppo.noptepochs)])
                metrics = ppo.update_from_traj(traj, last_val, perms)
            else:
                state, obs, metrics = ppo.train_iteration(distr, state, obs)
                traj = ppo.rollout_graph(distr, state, obs).traj
                perms = ppo.update_program(traj, None, draw=True)._rows
            out.append([perms.reshape(-1).clone()]
                       + [v.clone() for v in metrics.values()])
        out += [[p.detach().clone() for p in ppo.params],
                [ppo.adam.count.clone(), ppo.lr.clone()],
                [v.clone() for _, v in _leaves(state)] + [obs.clone()],
                [ppo.gen.get_state(), env.gen.get_state()]]
        runs.append(out)
    for a, b in zip(*runs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------------------------------ #
# The defaults of RFF and to_device_distr
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("entry", ["RFF", "to_device_distr"])
def test_default_device_is_the_card(entry):
    """Without a card, RFF and to_device_distr raise at their default
    device (the card) and build on the CPU when asked."""
    if torch.cuda.is_available():
        pytest.skip("checks the default without a CUDA card")
    make = {"RFF": lambda **kw: RFF(8, 3, 1.0, **kw),
            "to_device_distr": lambda **kw: to_device_distr(
                Uniform(np.zeros(2), np.ones(2)), **kw)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    out = make(device="cpu")
    tensors = [out.coeff] if entry == "RFF" else list(out)
    assert all(t.device.type == "cpu" for t in tensors)


# ------------------------------------------------------------------ #
# (g) on a card: the programs' replays against their eager bodies
# ------------------------------------------------------------------ #
def _card_setup(task_name, tmp_path):
    from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
    _card_or_skip()
    _, stem, cut = _BY_NAME[task_name]
    cfg = _cfg(stem, cut)
    cfg["env"]["numEnvs"] = 64
    env = make_env(task_name, cfg, seed=3, device="cuda")
    ppo = process_ppo(env, {"seed": 0, "learn": {"nsteps": STEPS},
                            "policy": {"pi_hid_sizes": [16],
                                       "vf_hid_sizes": [16]}},
                      logdir=str(tmp_path))
    return env, ppo, cfg


def _twice(run):
    """run() through the replays (after a call that captures), then
    through the bodies."""
    run()
    return run(), _with_bodies(run)


@pytest.mark.cuda
@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "ShadowHand"])
def test_round_replays_equal_their_bodies_on_the_card(task_name, tmp_path):
    """A collection round (reset, steps, extraction) replayed and through
    the bodies from the same generator state: labels, states, actions,
    rewards and the generator bit for bit."""
    env, ppo, cfg = _card_setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    spec = task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                            spec.highs, device="cuda")
    cpol = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    start = gen.get_state()

    def run():
        gen.set_state(start)
        out = _collect_round(env, ppo.policy_apply, cpol, 7, ppo.net, distr,
                             gen)
        return list(out) + [gen.get_state()]
    got, want = _twice(run)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "ShadowHand"])
def test_vec_env_replays_equal_their_bodies_on_the_card(task_name,
                                                        tmp_path):
    """VecEnv.reset and 10 VecEnv.step calls replayed and through the
    bodies from the same generator and state: every obs, reward, done,
    state leaf and the generator bit for bit."""
    env, _, _ = _card_setup(task_name, tmp_path)
    env.set_distr(to_device_distr(
        Uniform(env.task.params_spec.lows, env.task.params_spec.highs),
        device="cuda"))
    acts = [a.cuda() for a in _actions(env.task, STEPS)]
    env.reset()
    start = (env.gen.get_state(), env.state)

    def run():
        env.gen.set_state(start[0])
        env.state = start[1]
        out = [env.reset()]
        for a in acts:
            out += list(env.step(a)[:3])
        return out + [v for _, v in _leaves(env.state)] + [
            env.gen.get_state()]
    got, want = _twice(run)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
