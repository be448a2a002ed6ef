"""Checks shared by the CPU tests of the port's tasks (tests/test_torch_
{anymal,flyers,ball_balance,franka_cabinet}.py): the config copies, the
DR spec against the JAX package's, physics steps with obs, reward and
termination against JAX's from one numpy state, delta-distribution envs
for the behaviour gates, the render, a tiny run of ``bayes_sim_main``,
and, from ``torch_host_traffic``, the dispatch mode that finds host
traffic in a captured body (tests/test_torch_{step_graph,train_graphs}.py)."""

import os
import pickle

import numpy as np
import torch
import yaml

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu_torch.distributions import (
    MoG, Uniform, to_device_distr,
)
from bayes_sim_ig_tpu_torch.ops import spd_kernel, tree_solve
from bayes_sim_ig_tpu_torch.sim import make_env

from .torch_host_traffic import NoHostTraffic  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_cfg(stem, num_envs=None):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           f"{stem}.yaml")) as f:
        cfg = yaml.safe_load(f)
    if num_envs is not None:
        cfg["env"]["numEnvs"] = num_envs
    return cfg


def config_copies_match(stem, with_train=True):
    """The port's copy of cfg/<stem>.yaml (and of its PPO config) loads
    equal to the JAX package's."""
    rels = [f"{stem}.yaml"]
    if with_train:
        rels.append(os.path.join("train", f"ppo_{stem}.yaml"))
    for rel in rels:
        with open(os.path.join(REPO, "bayes_sim_ig_tpu", "cfg", rel)) as a, \
                open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                                  rel)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), rel


def spec_matches(tt, jt, dim):
    spec, jspec = tt.params_spec, jt.params_spec
    assert spec.names == jspec.names
    np.testing.assert_array_equal(spec.lows, jspec.lows)
    np.testing.assert_array_equal(spec.highs, jspec.highs)
    assert spec.dim == dim


def params_in_box(task, n, seed):
    spec = task.params_spec
    rs = np.random.RandomState(seed)
    return rs.uniform(spec.lows, spec.highs, (n, spec.dim)).astype(
        np.float32)


def steps_match_jax(jt, tt, state, params, seed, steps=5, amp=0.5,
                    tol=1e-4):
    """``steps`` physics steps of both packages from one numpy state tuple
    and (N, P) params with the same random actions in [-amp, amp]: every
    state field, obs and reward within atol ``tol`` after each step, the
    termination masks equal. Returns the port's last state."""
    jcls = type(jt.init_state(jax.random.PRNGKey(0), jnp.asarray(params)))
    tcls = type(tt.init_state(torch.Generator().manual_seed(0),
                              torch.from_numpy(params)))
    js = jcls(*[jnp.asarray(x) for x in state])
    ts = tcls(*[torch.from_numpy(np.array(x)) for x in state])
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    rs = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)
    n = params.shape[0]
    for t in range(steps):
        act = rs.uniform(-amp, amp, (n, tt.act_dim)).astype(np.float32)
        ja, ta = jnp.asarray(act), torch.from_numpy(act)
        js = jt.physics_step(js, ja, jp, key)
        ts = tt.physics_step(ts, ta, tp, None)
        pairs = list(zip(ts, js)) + [
            (tt.observe(ts, tp), jt.observe(js, jp)),
            (tt.reward(ts, ta, tp), jt.reward(js, ja, jp))]
        for i, (got, want) in enumerate(pairs):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=tol,
                                       err_msg=f"step {t}, field {i}")
        np.testing.assert_array_equal(
            tt.early_termination(ts, tp).numpy(),
            np.asarray(jt.early_termination(js, jp)))
    return ts


def delta_env(task_name, stem, mean, num_envs=4, cfg=None, seed=0):
    """A CPU env whose DR distribution is a delta at ``mean``."""
    cfg = load_cfg(stem, num_envs) if cfg is None else cfg
    env = make_env(task_name, cfg, seed=seed, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[np.asarray(mean, np.float64)],
            Ss=[np.eye(spec.dim) * 1e-12]), spec.lows, spec.highs,
        device="cpu"))
    return env


def corner_stays_finite(task_name, stem, corner, steps, seed=1):
    """``steps`` steps of random actions at a corner of the DR box
    ("lows" or "highs") stay finite in obs and reward."""
    spec = make_env(task_name, load_cfg(stem, 2), device="cpu").task \
        .params_spec
    env = delta_env(task_name, stem, getattr(spec, corner), num_envs=2)
    env.reset()
    rs = np.random.RandomState(seed)
    for t in range(steps):
        act = torch.from_numpy(rs.uniform(
            -1, 1, (2, env.task.act_dim)).astype(np.float32))
        obs, rew, done, _ = env.step(act)
        assert torch.isfinite(obs).all() and torch.isfinite(rew).all(), t


def scale_dr_stays_finite(task_name, stem, steps=20):
    """A whole-actor 'scale' subtree added to the config binds one spec
    dim named <actor>_scale_mult; both corners of a 0.5-1.5 range step
    finitely and hold their scale."""
    cfg = load_cfg(stem, 2)
    actors = cfg["task"]["randomization_params"]["actor_params"]
    actor = next(iter(actors))
    actors[actor]["scale"] = {"range": [0.5, 1.5], "operation": "scaling",
                              "distribution": "uniform"}
    probe = make_env(task_name, cfg, device="cpu").task
    spec = probe.params_spec
    assert probe._scale_dims, "scale dim not bound"
    dim = probe._scale_dims[0]
    assert spec.names[dim] == f"{actor}_scale_mult"
    for corner in (spec.lows, spec.highs):
        env = delta_env(task_name, stem, corner, num_envs=2, cfg=cfg)
        env.reset()
        rs = np.random.RandomState(2)
        for t in range(steps):
            act = torch.from_numpy(rs.uniform(
                -1, 1, (2, env.task.act_dim)).astype(np.float32))
            obs, rew, done, _ = env.step(act)
            assert torch.isfinite(obs).all(), (task_name, t)
        assert float((env.state.params[:, dim] - corner[dim]).abs().max()) \
            < 1e-5


def render_matches_jax(task_name, stem, jax_task):
    env = make_env(task_name, load_cfg(stem, 2), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    obs = env.reset()
    frame = env.task.render_obs_frame(obs[0].numpy())
    assert frame.ndim == 3 and frame.shape[2] == 3
    assert frame.dtype == np.uint8 and (frame < 255).any()
    np.testing.assert_array_equal(
        frame, jax_task.render_obs_frame(obs[0].numpy()))


def tiny_adr_run(task_name, stem, tmp_path, monkeypatch, env_edits,
                 num_envs=8, bayessim_edits=None):
    """bayes_sim_main.main on a tiny config (``num_envs`` envs, 16 training
    trajectories, 2 evaluation episodes, 1 PPO iteration, then
    ``bayessim_edits``): one ADR iteration through the physics, MDNN and
    PPO on the CPU; a finite posterior of the spec's dims on disk, no
    kernel launched. Returns the run's output."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    cfg = load_cfg(stem, num_envs)
    cfg["env"].update(env_edits)
    cfg["bayessim"].update(trainTrajs=16, realIters=1, realEvals=2)
    cfg["bayessim"].update(bayessim_edits or {})
    cfg_path = tmp_path / f"{stem}.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    before = (dict(tree_solve.LAUNCHES), dict(spd_kernel.LAUNCHES))
    out = bayes_sim_main.main([
        "--task", task_name, "--cfg_env", str(cfg_path), "--logdir",
        str(tmp_path / "logs"), "--max_iterations", "1", "--rl_device",
        "cpu"])
    assert (tree_solve.LAUNCHES, spd_kernel.LAUNCHES) == before
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert len(out["iter_secs"]) == 1
    with open(os.path.join(out["logdir"], "checkpoints",
                           "posterior_0.pkl"), "rb") as f:
        post = pickle.load(f)
    assert post["means"].shape[1] == out["env"].task.params_spec.dim
    for k in ("weights", "means", "covs"):
        assert np.isfinite(post[k]).all(), k
    for leaf in out["env"].state.task_state:
        assert torch.isfinite(leaf).all()
    return out
