"""The port's step loops as static-buffer steps (utils/step_graph.py): the
collection round and the PPO rollout, which the card runs as CUDA graphs
of one step and the CPU runs eagerly.

  (a) the noise schedules read a () int32 frame counter on the device and
      equal the JAX package's float32 schedule exactly;
  (b) one step of each of the ten tasks (policy, collection policy and
      env_step) makes no host sync and builds no tensor from host data:
      a dispatch mode fails on ``aten._local_scalar_dense`` (``.item()``,
      ``float(t)``, ``bool(t)``), ``aten.nonzero``, a boolean-mask index,
      and ``aten.lift_fresh`` -- what ``torch.tensor``,
      ``torch.as_tensor``, ``torch.from_numpy``, ``Tensor.new_tensor``, a
      list index and a Python scalar stored through an index show on
      torch 2.13 (each a host-to-device copy on a card);
  (c) the static-buffer body run eagerly equals the plain ``env_step``
      loop (the port's loops before the graphs) bit for bit: every step's
      outputs, every state leaf, the frame counter and the generators;
      the collection round and the PPO rollout, asymmetric included,
      against the list-and-``torch.stack`` loops;
  (d) on a card, the graph replays equal the eager body bit for bit
      (``cuda`` marker; skipped without one).
"""

import os

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from bayes_sim_ig_tpu.dr import noise as jnoise
from bayes_sim_ig_tpu_torch.distributions import MoG, Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.dr import noise
from bayes_sim_ig_tpu_torch.rl import networks
from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.sim.task import env_full_reset, env_step
from bayes_sim_ig_tpu_torch.utils import step_graph
from bayes_sim_ig_tpu_torch.utils.collect import (
    _collect_round, _postprocess_round, collect_step_graph,
    get_collect_policy,
)

from .torch_task_checks import NoHostTraffic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every task at 4 envs, its episodes cut to 6 steps so that 10 steps cross
# a reset (re-randomized params, fresh state, redrawn noise).
TASKS = [("Cartpole", "cartpole", {}), ("Pendulum", "pendulum", {}),
         ("Ant", "ant", {}), ("Humanoid", "humanoid", {}),
         ("Anymal", "anymal", {"episodeLength_s": 0.1}),
         ("Quadcopter", "quadcopter", {"maxEpisodeLength": 6}),
         ("Ingenuity", "ingenuity", {"maxEpisodeLength": 6}),
         ("BallBalance", "ball_balance", {}),
         ("FrankaCabinet", "franka_cabinet", {}),
         ("ShadowHand", "shadow_hand", {})]
_BY_NAME = {t[0]: t for t in TASKS}
N = 4
STEPS = 10


def _cfg(stem, cut, asymmetric=False):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           f"{stem}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = N
    cfg["env"].update(cut or {"episodeLength": 6})
    if asymmetric:
        cfg["env"]["asymmetric_observations"] = True
    return cfg


def _setup(task_name, tmp_path, asymmetric=False):
    """(env, ppo, cfg) on the CPU at 4 envs with a 16-wide policy."""
    _, stem, cut = _BY_NAME[task_name]
    cfg = _cfg(stem, cut, asymmetric)
    env = make_env(task_name, cfg, seed=3, device="cpu")
    cfg_train = {"seed": 0, "learn": {
        "nsteps": STEPS, "noptepochs": 1, "nminibatches": 2,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [16], "vf_hid_sizes": [16]}}
    ppo = process_ppo(env, cfg_train, logdir=str(tmp_path))
    return env, ppo, cfg


def _uniform(task):
    spec = task.params_spec
    return to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                           spec.highs, device="cpu")


def _mog(task, k=3, seed=0):
    """A k-component mixture inside the param box: the posterior's kind,
    drawn through torch.multinomial."""
    spec = task.params_spec
    lo, hi = np.asarray(spec.lows), np.asarray(spec.highs)
    rs = np.random.RandomState(seed)
    ms = [lo + (hi - lo) * rs.uniform(0.3, 0.7, lo.shape) for _ in range(k)]
    Ss = [np.diag(((hi - lo) * 0.05) ** 2 + 1e-12) for _ in range(k)]
    w = rs.uniform(0.5, 1.0, k)
    return to_device_distr(MoG(a=w / w.sum(), ms=ms, Ss=Ss), lo, hi,
                           device="cpu")


def _leaves(state):
    """(name, tensor) of every EnvState field, task-state leaves named."""
    out = [(f"task_state.{k}", v) for k, v in state.task_state._asdict()
           .items()]
    return out + [(k, v) for k, v in state._asdict().items()
                  if k != "task_state"]


def _assert_states_equal(got, want, what):
    for (name, g), (_, w) in zip(_leaves(got), _leaves(want)):
        assert g.dtype == w.dtype, f"{what} {name}"
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{what} {name}")


# ------------------------------------------------------------------ #
# (a) the noise schedules on a device frame counter
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("schedule", ["linear", "constant", None])
@pytest.mark.parametrize("schedule_steps", [0, 50])
def test_schedule_scaling_matches_jax_exactly(schedule, schedule_steps):
    """schedule_scaling at a () int32 counter against the JAX package's
    float32 schedule (dr/noise.py:50-62), frame for frame over 0 to
    2 x schedule_steps (0 to 20 without steps), bit for bit."""
    cfg = {"distribution": "gaussian", "operation": "additive",
           "range": [0.0, 0.1], "schedule_steps": schedule_steps}
    if schedule is not None:
        cfg["schedule"] = schedule
    tc, jc = noise.make_noise_config(cfg), jnoise.make_noise_config(cfg)
    last = 2 * schedule_steps if schedule_steps else 20
    for frame in range(last + 1):
        got = noise.schedule_scaling(
            tc, torch.tensor(frame, dtype=torch.int32))
        want = np.asarray(jnoise.schedule_scaling(
            jc, jnp.asarray(frame, jnp.int32)), np.float32)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy().tobytes() == want.tobytes(), (frame, got, want)


def test_frame_counter_is_a_device_int32_that_survives_resets(tmp_path):
    """EnvState.frame_count is a () int32 tensor on the env's device,
    advanced by every step and carried across VecEnv.reset."""
    env, _, _ = _setup("Cartpole", tmp_path)
    env.set_distr(_uniform(env.task))
    env.reset()
    fc = env.state.frame_count
    assert fc.dtype == torch.int32 and fc.shape == () and int(fc) == 0
    for _ in range(3):
        env.step(torch.zeros(N, env.task.act_dim))
    env.reset()
    assert int(env.state.frame_count) == 3


# ------------------------------------------------------------------ #
# (b) no host sync and no host data in a step
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name", [t[0] for t in TASKS])
def test_a_step_makes_no_host_sync_and_no_host_copy(task_name, tmp_path):
    """The collection step (PPO policy, the config's collection policy,
    env_step with a reset and a mixture posterior) and the rollout step,
    after one step that builds the per-model tables (a graph's first step
    runs eagerly for that): no op of _SYNCING, no boolean-mask index."""
    env, ppo, cfg = _setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    distr = _mog(task)
    collect_policy = get_collect_policy(cfg["bayessim"]["collectPolicy"],
                                        task)
    state, obs = env_full_reset(task, distr, gen)
    graphs = [collect_step_graph(env, ppo.policy_apply, collect_policy, 6,
                                 ppo.net, distr, gen, state, obs, STEPS),
              ppo.rollout_graph(distr, state, obs)]
    for g in graphs:
        g.load(state, obs, distr)
        g.body()
        mode = NoHostTraffic()
        with mode:
            for _ in range(STEPS - 1):
                g.body()
        assert not mode.hits, f"{task_name}: {sorted(set(mode.hits))}"
        assert int(g.traj["done"].sum()) > 0, "no reset crossed"


# ------------------------------------------------------------------ #
# (c) the static-buffer body against the plain loops, bit for bit
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "Humanoid",
                                       "ShadowHand"])
def test_step_body_equals_the_env_step_loop(task_name, tmp_path):
    """10 collection steps through the static buffers equal 10 plain
    env_step calls from the same state and generator: obs, reward and
    done of every step, every state leaf and the frame counter after, and
    the generator's state. Cartpole closed form, Ant the dense solve,
    Humanoid the tree solve, ShadowHand the contacts and half-solves."""
    env, ppo, cfg = _setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    distr = _uniform(task)
    collect_policy = get_collect_policy(cfg["bayessim"]["collectPolicy"],
                                        task)
    mel = 7  # resets at progress 6: two within 10 steps
    state0, obs0 = env_full_reset(task, distr, gen)
    start = gen.get_state()

    g = collect_step_graph(env, ppo.policy_apply, collect_policy, mel,
                           ppo.net, distr, gen, state0, obs0, STEPS)
    g.load(state0, obs0, distr)
    for _ in range(STEPS):
        g.step()
    got_gen = gen.get_state()

    gen.set_state(start)
    state, obs = state0, obs0
    for t in range(STEPS):
        act = collect_policy(ppo.policy_apply(ppo.net, obs, gen), gen)
        state, obs, rew, done = env_step(task, distr, state, act, gen, mel)
        for k, v in (("obs", obs), ("act", act), ("rew", rew),
                     ("done", done)):
            torch.testing.assert_close(g.traj[k][t], v, rtol=0, atol=0,
                                       msg=f"{task_name} step {t} {k}")
    assert int(g.traj["done"].sum()) > 0, "no reset crossed"
    _assert_states_equal(g.state, state, task_name)
    assert int(g.state.frame_count) == STEPS
    torch.testing.assert_close(g.obs, obs, rtol=0, atol=0)
    assert torch.equal(got_gen, gen.get_state())


def _old_collect_round(task, policy_apply, collect_policy,
                       max_episode_length, policy_params, distr, gen):
    """The collection round before the graphs: lists of steps, stacked."""
    env_state, obs0 = env_full_reset(task, distr, gen)
    labels = env_state.params
    obs = obs0
    seqs = {"obs": [], "act": [], "rew": [], "done": []}
    for _ in range(max_episode_length - 1):
        act = collect_policy(policy_apply(policy_params, obs, gen), gen)
        env_state, obs, rew, done = env_step(task, distr, env_state, act,
                                             gen, max_episode_length)
        for k, v in (("obs", obs), ("act", act), ("rew", rew),
                     ("done", done)):
            seqs[k].append(v)
    return _postprocess_round(obs0, *[torch.stack(seqs[k]) for k in
                                      ("obs", "act", "rew", "done")],
                              labels)


@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "ShadowHand"])
def test_collect_round_equals_the_stacked_loop(task_name, tmp_path):
    """Two collection rounds (the second replays the first's cached step)
    equal the list-and-torch.stack round: labels, states, actions and
    rewards, and the generator after."""
    env, ppo, cfg = _setup(task_name, tmp_path)
    task, gen = env.task, ppo.gen
    distr = _uniform(task)
    collect_policy = get_collect_policy(cfg["bayessim"]["collectPolicy"],
                                        task)
    mel = 9
    start = gen.get_state()
    got = [_collect_round(env, ppo.policy_apply, collect_policy, mel,
                          ppo.net, distr, gen) for _ in range(2)]
    got_gen = gen.get_state()
    # One step graph, one reset and one round's buffers, cached.
    assert sorted(k[0] for k in env.step_graphs) == ["collect", "reset",
                                                     "round"]
    gen.set_state(start)
    want = [_old_collect_round(task, ppo.policy_apply, collect_policy, mel,
                               ppo.net, distr, gen) for _ in range(2)]
    for r in range(2):
        for name, a, b in zip(("labels", "states", "actions", "rewards"),
                              got[r], want[r]):
            torch.testing.assert_close(a, b, rtol=0, atol=0,
                                       msg=f"round {r} {name}")
    assert torch.equal(got_gen, gen.get_state())


def _old_rollout(ppo, distr, env_state, obs):
    """PPO.rollout before the graphs: lists of steps, stacked."""
    keys = ["obs", "act", "logp", "val", "rew", "done"]
    if ppo.asymmetric:
        keys.append("cin")
    steps = {k: [] for k in keys}
    for _ in range(ppo.nsteps):
        act, logp = networks.sample_action(ppo.net, obs, ppo.gen)
        cin = ppo._critic_input(env_state, obs)
        val = networks.value(ppo.net, cin)
        env_state, obs2, rew, done = env_step(
            ppo.task, distr, env_state, act, ppo.vec_env.gen)
        for k, v in zip(keys, (obs, act, logp, val, rew, done.float(),
                               cin)):
            steps[k].append(v)
        obs = obs2
    traj = {k: torch.stack(v) for k, v in steps.items()}
    last_val = networks.value(ppo.net, ppo._critic_input(env_state, obs))
    return env_state, obs, traj, last_val


@pytest.mark.parametrize("task_name,asymmetric", [
    ("Cartpole", False), ("Pendulum", True), ("ShadowHand", True)])
def test_rollout_equals_the_stacked_loop(task_name, asymmetric, tmp_path):
    """Two PPO rollouts (the second replays the first's cached step) under
    a mixture posterior equal the list-and-torch.stack rollout: the
    trajectory (with the critic's privileged inputs when asymmetric), the
    env state and observations after, the last value, and both
    generators (PPO's for the actions, the env's for its draws)."""
    env, ppo, _ = _setup(task_name, tmp_path, asymmetric)
    assert ppo.asymmetric == asymmetric
    distr = _mog(env.task)
    env.set_distr(distr)
    obs0 = env.reset()
    state0 = env.state
    gens = (ppo.gen, env.gen)
    start = [g.get_state() for g in gens]

    def two(rollout):
        out, state, obs = [], state0, obs0
        for _ in range(2):
            state, obs, traj, last_val = rollout(ppo, distr, state, obs)
            out.append((state, obs, traj, last_val))
        return out

    got = two(type(ppo).rollout)
    got_gens = [g.get_state() for g in gens]
    for g, s in zip(gens, start):
        g.set_state(s)
    want = two(_old_rollout)
    for r, ((gs, go, gt, gl), (ws, wo, wt, wl)) in enumerate(zip(got,
                                                               want)):
        assert sorted(gt) == sorted(wt)
        for k in wt:
            torch.testing.assert_close(gt[k], wt[k], rtol=0, atol=0,
                                       msg=f"rollout {r} {k}")
        _assert_states_equal(gs, ws, f"rollout {r}")
        torch.testing.assert_close(go, wo, rtol=0, atol=0)
        torch.testing.assert_close(gl, wl, rtol=0, atol=0)
    assert float(want[0][2]["done"].sum()) > 0, "no reset crossed"
    for g, s in zip(gens, got_gens):
        assert torch.equal(g.get_state(), s)


def test_reinit_keeps_the_policy_tensors_and_the_generator(tmp_path):
    """PPO.reinit writes a fresh init into the tensors a captured step
    reads, and reseeds the same generator: equal to a new trainer's."""
    env, ppo, _ = _setup("Cartpole", tmp_path)
    tensors = [p for p in ppo.net.parameters()]
    gen = ppo.gen
    ppo.reinit(seed=5)
    assert all(a is b for a, b in zip(ppo.net.parameters(), tensors))
    assert ppo.gen is gen
    _, fresh, _ = _setup("Cartpole", tmp_path)
    fresh.reinit(seed=5)
    for a, b in zip(ppo.net.parameters(), fresh.net.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(ppo.gen.get_state(), fresh.gen.get_state())


def test_step_graph_refuses_a_step_past_its_buffers(tmp_path):
    env, ppo, cfg = _setup("Cartpole", tmp_path)
    distr = _uniform(env.task)
    state, obs = env_full_reset(env.task, distr, ppo.gen)
    g = collect_step_graph(env, ppo.policy_apply, get_collect_policy(
        "policy_random"), 3, ppo.net, distr, ppo.gen, state, obs)
    g.load(state, obs, distr)
    g.step()
    g.step()
    with pytest.raises(IndexError):
        g.step()


# ------------------------------------------------------------------ #
# (d) on a card: graph replays against the eager body
# ------------------------------------------------------------------ #
@pytest.mark.cuda
@pytest.mark.parametrize("task_name", ["Cartpole", "Ant", "Humanoid",
                                       "ShadowHand"])
def test_graph_replays_equal_the_eager_body_on_the_card(task_name, tmp_path):
    """At 64 envs: 10 replays of the captured collection step equal 10
    eager bodies from the same state and generator, bit for bit (obs,
    act, rew, done, every state leaf, the generator), and the replays'
    kernel launches equal the body's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    from bayes_sim_ig_tpu_torch.ops.launch import launch_counts
    _, stem, cut = _BY_NAME[task_name]
    cfg = _cfg(stem, cut)
    cfg["env"]["numEnvs"] = 64
    env = make_env(task_name, cfg, seed=3, device="cuda")
    ppo = process_ppo(env, {"seed": 0, "learn": {"nsteps": STEPS},
                            "policy": {"pi_hid_sizes": [16],
                                       "vf_hid_sizes": [16]}},
                      logdir=str(tmp_path))
    task, gen = env.task, ppo.gen
    distr = to_device_distr(
        Uniform(task.params_spec.lows, task.params_spec.highs),
        task.params_spec.lows, task.params_spec.highs, device="cuda")
    collect_policy = get_collect_policy(cfg["bayessim"]["collectPolicy"],
                                        task)
    state0, obs0 = env_full_reset(task, distr, gen)
    g = collect_step_graph(env, ppo.policy_apply, collect_policy, 7,
                           ppo.net, distr, gen, state0, obs0, STEPS)
    start = gen.get_state()
    g.load(state0, obs0, distr)
    g.step()  # the first step runs eagerly and captures the rest

    def run(step):
        gen.set_state(start)
        g.load(state0, obs0, distr)
        before = launch_counts()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        after = launch_counts()
        return ({k: v.clone() for k, v in g.traj.items()},
                [v.clone() for _, v in _leaves(g.state)], gen.get_state(),
                {k: after[k] - before[k] for k in after})

    graph = run(g.step)
    eager = run(g.body)
    assert g.replays == STEPS
    for k in graph[0]:
        torch.testing.assert_close(graph[0][k], eager[0][k], rtol=0, atol=0,
                                   equal_nan=True, msg=k)
    for (name, _), a, b in zip(_leaves(g.state), graph[1], eager[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=name)
    assert torch.equal(graph[2], eager[2])
    assert graph[3] == eager[3]
    assert step_graph.STATS["collect"]["captures"] >= 1


@pytest.mark.parametrize("nv,rows,width", [(30, 51, 17), (12, 7, 12),
                                          (5, 1, 5)])
def test_scatter_sum_equals_index_add(nv, rows, width):
    """The impulse pass's scatter of (row, closure dof) entries into dofs,
    the same sum at every run on a card: every position in exactly one
    dof's list, and the sums within 1e-6 of index_add_'s (float64)."""
    from bayes_sim_ig_tpu_torch.physics.contact import (
        _scatter_sum, _scatter_table,
    )
    rs = np.random.RandomState(nv)
    flat = np.stack([rs.choice(nv, width, replace=False)
                     for _ in range(rows)]).reshape(-1)
    table = _scatter_table(flat, nv)
    listed = np.sort(table[table < flat.size])
    np.testing.assert_array_equal(listed, np.arange(flat.size))
    for d in range(nv):
        assert (flat[table[d][table[d] < flat.size]] == d).all()
    vals = torch.from_numpy(rs.randn(flat.size, 9).astype(np.float32))
    got = _scatter_sum(vals, torch.from_numpy(table))
    want = torch.zeros(nv, 9, dtype=torch.float64).index_add_(
        0, torch.from_numpy(flat), vals.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
