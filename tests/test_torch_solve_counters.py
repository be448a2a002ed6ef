"""The physics' solve counters and the env-step counter of the port
(``physics/dynamics.py::STATS``, ``sim/task.py::STATS``):

  (a) one Anymal step (its 18-dof mass matrix fills 0.684 of the lower
      triangle: the dense route) calls two SPD factors and two
      substitutes, one per substep, and one Humanoid step (the tree
      route) two tree factors and two substitutes; one Ant step (dense,
      the frozen-mass scheme: the first substep's factor serves the
      second) one factor and two substitutes;
  (b) ``launch_counts`` stays the kernels' launches, and ``replay_counts``
      adds the counts registered with ``count_at_replay``;
  (c) on a card (``cuda`` marker), a step graph's replays add what its
      capture counted, as they add the kernels' launches;
  (d) on a card, an env step integrates in two launches of the
      integration kernel, one a substep, eager and replayed alike: in
      (c) for Anymal, here for the other cells' tasks, Humanoid and
      ShadowHand.

This file imports no JAX, so that its card case runs where JAX is
absent."""

import os

import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.ops import launch
from bayes_sim_ig_tpu_torch.ops.launch import (count_at_replay, launch_counts,
                                               launch_increments,
                                               replay_counts)
from bayes_sim_ig_tpu_torch.physics import dynamics
from bayes_sim_ig_tpu_torch.sim import env_step, make_env, task as task_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3


def _env(name, stem, device="cpu", n=N):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           stem + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = n
    env = make_env(name, cfg, seed=1, device=device)
    spec = env.task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                            spec.highs, device=device)
    env.set_distr(distr)
    env.reset()
    return env, distr


def _step_counts(env, distr):
    """The counters' increments over one ``env_step``."""
    before = replay_counts()
    env_step(env.task, distr, env.state,
             torch.zeros(env.num_envs, env.task.act_dim,
                         device=env.device),
             torch.Generator(device=env.device).manual_seed(0))
    after = replay_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("name, stem, route", [
    ("Anymal", "anymal", "dense"), ("Humanoid", "humanoid", "tree"),
    ("Ant", "ant", "dense")])
def test_one_step_counts_its_solves_by_route(name, stem, route):
    env, distr = _env(name, stem)
    assert dynamics._uses_tree_solve(env.task.model) == (route == "tree")
    factors = 1 if name == "Ant" else 2  # Ant carries its factor
    assert _step_counts(env, distr) == {
        f"physics.{route}_factor": factors,
        f"physics.{route}_substitute": 2, "sim.env_steps": 1}


def test_launch_counts_are_the_kernels_and_replay_counts_add_the_work():
    kernels = launch_counts()
    work = {f"physics.{k}" for k in dynamics.STATS} | {
        f"sim.{k}" for k in task_mod.STATS}
    assert set(replay_counts()) == set(kernels) | work
    assert not set(kernels) & work
    assert set(dynamics.STATS) == {"dense_factor", "dense_substitute",
                                   "tree_factor", "tree_substitute"}


def test_a_registered_dict_is_added_at_replay(monkeypatch):
    """A dict registered with ``count_at_replay`` is read by
    ``replay_counts`` under its prefix, and not by ``launch_counts``; its
    rise over a capture is one of ``launch_increments``."""
    monkeypatch.setattr(launch, "_AT_REPLAY", dict(launch._AT_REPLAY))
    mine = {"a": 0, "b": 3}
    count_at_replay("mine", mine)
    before = replay_counts()
    assert before["mine.a"] == 0 and before["mine.b"] == 3
    assert "mine.a" not in launch_counts()
    mine["a"] += 2
    (inc,) = launch_increments(before, replay_counts())
    assert inc == (mine, "a", 2)


def test_a_carried_factor_counts_only_its_substitute():
    """``forward_dynamics`` fed a factor (the frozen-mass scheme) skips the
    factorization: one substitute, no factor; ``mass_factor_solve`` is one
    substitute of any number of right-hand sides."""
    env, _ = _env("Anymal", "anymal")
    task = env.task
    st = env.state.task_state
    m = task.model
    dp = task._dyn_params(env.state.params)
    tau = torch.zeros(N, m.nv)
    _, _, factor = dynamics.forward_dynamics(m, st.q, st.v, tau, dp,
                                             dt=0.01, return_factor=True)
    before = dict(dynamics.STATS)
    dynamics.forward_dynamics(m, st.q, st.v, tau, dp, dt=0.01,
                              factor=factor)
    dynamics.mass_factor_solve(m, factor, torch.ones(5, m.nv, N))
    assert {k: dynamics.STATS[k] - before[k] for k in before} == {
        "dense_factor": 0, "dense_substitute": 2, "tree_factor": 0,
        "tree_substitute": 0}


@pytest.mark.cuda
def test_step_graph_replays_add_the_counts():
    """``VecEnv.step`` at 64 Anymal envs on the card: the first call runs
    the step eagerly and captures it, each later call replays it; over
    five calls the solves, the env steps, the SPD kernels' and the
    integration and kinematics kernels' launches all count five steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    env, _ = _env("Anymal", "anymal", device="cuda", n=64)
    act = torch.zeros(64, env.task.act_dim, device="cuda")
    before = replay_counts()
    for _ in range(5):
        env.step(act)
    torch.cuda.synchronize()
    after = replay_counts()
    got = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert got == {"physics.dense_factor": 10,
                   "physics.dense_substitute": 10, "sim.env_steps": 5,
                   "spd_factor_lanes": 10, "spd_substitute_lanes": 10,
                   "integrate_clamp": 10, "forward_kinematics": 10}
    env.free_step_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("name, stem", [
    ("Humanoid", "humanoid"), ("ShadowHand", "shadow_hand")])
def test_a_step_integrates_in_two_launches(name, stem):
    """At 64 envs on the card: the first ``VecEnv.step`` runs eagerly and
    captures, the next four replay; each of the five counts two launches of
    the integration kernel (``launch_counts``, which replays add to), one
    a substep."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    env, _ = _env(name, stem, device="cuda", n=64)
    act = torch.zeros(64, env.task.act_dim, device="cuda")
    for _ in range(5):
        before = replay_counts()
        env.step(act)
        torch.cuda.synchronize()
        after = replay_counts()
        assert after["integrate_clamp"] - before["integrate_clamp"] == 2
        assert after["sim.env_steps"] - before["sim.env_steps"] == 1
    env.free_step_graphs()
