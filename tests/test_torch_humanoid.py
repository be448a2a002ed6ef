"""The port's Humanoid task on the branch-sparse tree solve, against the
JAX package on the CPU: the model build, the DR spec and DynParams, the
CRBA pair values, forward dynamics and ``mass_factor_solve`` on the tree
path (JAX's CPU pick is the tree with the left-looking factor, as the
port's plain path), 5 physics steps in ground contact with obs, reward
and termination, then the env layer (corner params, the NaN-pivot
quarantine) and a tiny run of ``bayes_sim_main --task Humanoid``.

Tolerances. Humanoid's mass matrix with DR draws has condition numbers
of ~7e3 (ultra-light hands beside an 8 kg torso), so float32 solves on
either side are good to ~1e-5 of the largest acceleration only: against a
float64 solve of the same system the JAX package's qdd is off by 4.4e-3
at max |qdd| 525, the port's by 1.9e-3. Accelerations and solves are
therefore held to 1e-4 of their largest magnitude; CRBA values (O(1-10))
to atol 1e-4; over 5 steps, obs and rewards to atol 1e-4 and the raw
state (whose joint velocities inherit the solve's conditioning) to atol
1e-3."""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import bayes_sim_ig_tpu.physics as jphys
import bayes_sim_ig_tpu.physics.dynamics as jdyn
from bayes_sim_ig_tpu.sim.humanoid import (
    Humanoid as JaxHumanoid, HumanoidState as JaxState,
)
import bayes_sim_ig_tpu_torch.physics as tphys
import bayes_sim_ig_tpu_torch.physics.dynamics as tdyn
from bayes_sim_ig_tpu_torch.distributions import MoG, Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.ops import tree_solve
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts
from bayes_sim_ig_tpu_torch.sim import available_tasks, make_env
from bayes_sim_ig_tpu_torch.sim.humanoid import Humanoid, HumanoidState
from bayes_sim_ig_tpu_torch.utils import collect, trace
from bayes_sim_ig_tpu_torch.utils.convert import dynparams_from_jax

from . import torch_task_checks as tc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg", "humanoid.yaml")
N = 8
H = 1.0 / 120.0  # the task's substep
OBS_TOL = dict(rtol=0, atol=1e-4)
STATE_TOL = dict(rtol=0, atol=1e-3)


def _cfg(num_envs=N):
    with open(CFG) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = num_envs
    return cfg


def _tasks():
    cfg = _cfg()
    return JaxHumanoid(cfg), Humanoid(cfg, device="cpu")


def _scaled_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _state(task, seed):
    """Params drawn over the DR box, and a state with the feet 1 cm into
    the ground (at START_Z = 1.34 the lowest contact point is 0.205 m
    above it), small joint jitter and velocities."""
    rs = np.random.RandomState(seed)
    spec = task.params_spec
    params = rs.uniform(spec.lows, spec.highs, (N, spec.dim)).astype(
        np.float32)
    m = task.model
    q = np.tile(m.neutral_q(), (N, 1))
    q[:, 2] = 1.125
    q[:, task._act_q_idx] += rs.uniform(-0.05, 0.05, (N, 21))
    v = rs.uniform(-0.05, 0.05, (N, m.nv))
    return params, q.astype(np.float32), v.astype(np.float32), rs


def test_config_copies_match_the_jax_package():
    for rel in ("humanoid.yaml", os.path.join("train", "ppo_humanoid.yaml")):
        with open(os.path.join(REPO, "bayes_sim_ig_tpu", "cfg", rel)) as a, \
                open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                                  rel)) as b:
            assert yaml.safe_load(a) == yaml.safe_load(b), rel


def test_model_build_matches_jax():
    jt, tt = _tasks()
    jm, tm = jt.model, tt.model
    assert (tm.nb, tm.nq, tm.nv) == (jm.nb, jm.nq, jm.nv) == (16, 28, 27)
    assert tm.collapsed and tm.j1_chain_maxpos == jm.j1_chain_maxpos == 2
    assert tm.dof_anc_chains == jm.dof_anc_chains
    assert tm.parent == jm.parent and tm.free_list == jm.free_list
    assert tm.body_names == jm.body_names
    assert tm.link_index == jm.link_index
    for name in ("j1_v", "j1_q", "j1_links", "j1_prev", "j1_chain_pos",
                 "j1_last", "dof_link", "dof_parent", "depth", "parent_pad"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    for name in ("mass0", "com0", "inertia0", "joint_pos", "joint_rot_T",
                 "j1_E", "j1_t", "j1_axis", "j1_lo", "j1_hi", "j1_maxv",
                 "anc_dof", "crba_mask", "dof_vd_mask", "stiffness0",
                 "damping0"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name),
                                      err_msg=name)
    assert [(g.link, g.kind, g.size, g.offset, g.axis) for g in tm.geoms] \
        == [(g.link, g.kind, g.size, g.offset, g.axis) for g in jm.geoms]
    # 243 of 378 pairs: the tree solve, with the left-looking plain form.
    assert tdyn._uses_tree_solve(tm)
    assert tree_solve.tree_tables(tm.dof_anc_chains).mean_depth \
        >= tdyn.TREE_LL_MIN_MEAN_DEPTH


def test_spec_gears_and_dyn_params_match_jax():
    jt, tt = _tasks()
    spec = tt.params_spec
    assert spec.names == jt.params_spec.names
    np.testing.assert_array_equal(spec.lows, jt.params_spec.lows)
    np.testing.assert_array_equal(spec.highs, jt.params_spec.highs)
    assert spec.dim == 37 == len(_cfg()["env"]["realParams"]["means"][0])
    assert set(tt._mass_dims) | set(tt._stiff_dims) == set(range(37))
    np.testing.assert_array_equal(tt._gears_np, jt._gears)
    assert tt.act_noise is not None and tt.obs_noise is None
    params, _, _, _ = _state(tt, 0)
    want = dynparams_from_jax(jax.vmap(jt._dyn_params)(jnp.asarray(params)))
    got = tt._dyn_params(torch.from_numpy(params))
    for name, g, w in zip(got._fields, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   err_msg=name)


def _both_kin(jt, tt, params, q, v):
    jdp = jax.vmap(jt._dyn_params)(jnp.asarray(params))
    tdp = tt._dyn_params(torch.from_numpy(params))
    kj = jphys.forward_kinematics(jt.model, jnp.asarray(q), jnp.asarray(v),
                                  jdp)
    kt = tphys.forward_kinematics(tt.model, torch.from_numpy(q),
                                  torch.from_numpy(v), tdp)
    return jdp, tdp, kj, kt


def test_crba_pair_values_match_jax():
    """The port's vectorized pair build against JAX's per-pair sums
    (dynamics.py:933-937), diag_extra included."""
    jt, tt = _tasks()
    params, q, v, _ = _state(tt, 1)
    jdp, tdp, kj, kt = _both_kin(jt, tt, params, q, v)
    jm, tm = jt.model, tt.model
    F = jdyn._mass_factors_i10(jm, kj, jdyn._i10_direct(kj, jdp))
    extra = np.asarray(jdp.armature).T + 1e-6 + H * np.asarray(jdp.damping).T
    want = []
    for (k, i) in tree_solve.ancestor_pairs(jm.dof_anc_chains):
        val = sum(F[k, c] * kj.S_o[i, c] for c in range(6))
        want.append(np.asarray(val) + (extra[k] if k == i else 0.0))
    st = tdyn._structure(tm, "cpu")
    Ft = tdyn._mass_factors_i10(tm, kt, tdyn._i10_direct(kt, tdp))
    extra_t = tdp.armature.T + 1e-6 + H * tdp.damping.T
    got = tdyn._tree_pair_values(st, Ft, kt.S_o, extra_t)
    assert tuple(got.shape) == (243, N)
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-4)


def test_forward_dynamics_and_mass_factor_solve_match_jax():
    jt, tt = _tasks()
    params, q, v, rs = _state(tt, 2)
    jdp, tdp, kj, kt = _both_kin(jt, tt, params, q, v)
    tau = rs.uniform(-5.0, 5.0, (N, tt.model.nv)).astype(np.float32)
    fj = jphys.ground_contact_forces(jt.model, kj, jdp, dt=H)
    ft = tphys.ground_contact_forces(tt.model, kt, tdp, dt=H)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-2)
    # The same contact forces into both solves.
    f_in = np.array(fj)
    qj, _, facj = jdyn.forward_dynamics(
        jt.model, jnp.asarray(q), jnp.asarray(v), jnp.asarray(tau), jdp,
        jnp.asarray(f_in), dt=H, kin=kj, return_factor=True)
    qt, _, fact = tdyn.forward_dynamics(
        tt.model, torch.from_numpy(q), torch.from_numpy(v),
        torch.from_numpy(tau), tdp, torch.from_numpy(f_in), dt=H, kin=kt,
        return_factor=True)
    assert facj[0] == fact[0] == "tree"
    _scaled_close(qt.numpy(), qj)
    # The factor payload against JAX's (both left-looking on the CPU).
    Hj, Dj = facj[1]
    Ht, Dt = fact[1]
    pairs = tree_solve.ancestor_pairs(tt.model.dof_anc_chains)
    np.testing.assert_allclose(Dt.numpy(), np.stack(Dj), rtol=1e-4)
    np.testing.assert_allclose(
        Ht.numpy(), np.stack([np.asarray(Hj[p]) for p in pairs]),
        rtol=1e-4, atol=1e-5)
    rhs = rs.randn(3, tt.model.nv, N).astype(np.float32)
    got = tdyn.mass_factor_solve(tt.model, fact, torch.from_numpy(rhs))
    assert tuple(got.shape) == (3, tt.model.nv, N)
    _scaled_close(got.numpy(), jdyn.mass_factor_solve(jt.model, facj,
                                                      jnp.asarray(rhs)))
    # The K-rhs solve of the forward_dynamics rhs reproduces qdd.
    one = tdyn.mass_factor_solve(tt.model, fact,
                                 torch.from_numpy(rhs[:1]))[0]
    assert torch.equal(one, tdyn.mass_factor_solve(
        tt.model, fact, torch.from_numpy(rhs))[0])


def test_physics_obs_and_reward_match_jax_over_5_steps():
    jt, tt = _tasks()
    params, q, v, rs = _state(tt, 3)
    js = JaxState(jnp.asarray(q), jnp.asarray(v))
    ts = HumanoidState(torch.from_numpy(q), torch.from_numpy(v))
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    key = jax.random.PRNGKey(0)
    for t in range(5):
        act = rs.uniform(-0.3, 0.3, (N, 21)).astype(np.float32)
        ja, ta = jnp.asarray(act), torch.from_numpy(act)
        js = jt.physics_step(js, ja, jp, key)
        ts = tt.physics_step(ts, ta, tp, None)
        for got, want in ((ts.q, js.q), (ts.v, js.v)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"step {t}", **STATE_TOL)
        for got, want in ((tt.observe(ts, tp), jt.observe(js, jp)),
                          (tt.reward(ts, ta, tp), jt.reward(js, ja, jp))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f"step {t}", **OBS_TOL)
        np.testing.assert_array_equal(
            tt.early_termination(ts, tp).numpy(),
            np.asarray(jt.early_termination(js, jp)))
    # In ground contact, still standing.
    assert (ts.q[:, 2] > 1.0).all() and (ts.q[:, 2] < 1.125).all()


def test_fresh_factor_on_every_substep(monkeypatch):
    """Humanoid refactors on each of its 2 substeps: forcing the frozen
    scheme changes the step, so the factor really was fresh."""
    from bayes_sim_ig_tpu_torch.sim import humanoid
    tt = Humanoid(_cfg(), device="cpu")
    params, q, v, rs = _state(tt, 4)
    st = HumanoidState(torch.from_numpy(q), torch.from_numpy(v))
    tp = torch.from_numpy(params)
    act = torch.from_numpy(rs.uniform(-0.3, 0.3, (N, 21)).astype(np.float32))
    tc.fresh_factor_on_every_substep(humanoid, tt, st, act, tp, monkeypatch)


def test_init_state_bounds():
    task = Humanoid(_cfg(64), device="cpu")
    gen = torch.Generator().manual_seed(0)
    st = task.init_state(gen, torch.ones(64, 37))
    q0 = torch.as_tensor(task.model.neutral_q(), dtype=torch.float32)
    assert st.q.shape == (64, 28) and st.v.shape == (64, 27)
    assert (st.q[:, 2] == 1.34).all()
    assert torch.equal(st.q[:, 3:7], q0[3:7].expand(64, 4))
    jit = st.q[:, task._act_q]
    assert (jit.abs() <= 0.05).all() and jit.abs().max() > 0.04
    assert (st.v.abs() <= 0.05).all()


def test_corner_params_stay_finite():
    """The DR corner of all lows (0.1x masses, 0.01x stiffness) for 40
    steps of random actions: finite through the velocity clamps and the
    non-finite quarantine."""
    env = make_env("Humanoid", _cfg(2), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(
        MoG(a=[1.0], ms=[np.asarray(spec.lows, np.float64)],
            Ss=[np.eye(spec.dim) * 1e-12]), spec.lows, spec.highs,
        device="cpu"))
    env.reset()
    rs = np.random.RandomState(1)
    for t in range(40):
        act = torch.from_numpy(rs.uniform(-1, 1, (2, 21)).astype(np.float32))
        obs, rew, done, _ = env.step(act)
        assert torch.isfinite(obs).all() and torch.isfinite(rew).all(), t


def test_nan_pivot_env_is_quarantined_and_reset():
    """Negative body masses make env 1's mass matrix negative definite:
    its tree pivots are NaN, so only its state goes non-finite; env_step
    ends its episode with zeroed obs and reward, and resets it next."""
    env = make_env("Humanoid", _cfg(3), seed=2, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    env.reset()
    params = env.state.params.clone()
    params[1, :16] = -1.0  # the 16 mass multipliers
    env.state = env.state._replace(params=params)
    obs, rew, done, _ = env.step(torch.zeros(3, 21))
    assert int(done[1]) == 1 and float(rew[1]) == 0.0
    assert (obs[1] == 0).all()
    assert not torch.isfinite(env.state.task_state.v[1]).all()
    for i in (0, 2):
        assert torch.isfinite(env.state.task_state.q[i]).all()
    obs2, _, _, _ = env.step(torch.zeros(3, 21))
    assert int(env.state.progress[1]) == 0
    assert torch.isfinite(obs2).all()
    assert all(torch.isfinite(x).all() for x in env.state.task_state)


def test_render_obs_frame():
    env = make_env("Humanoid", _cfg(2), device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cpu"))
    obs = env.reset()
    frame = env.task.render_obs_frame(obs[0].numpy())
    want = JaxHumanoid(_cfg(2)).render_obs_frame(obs[0].numpy())
    assert frame.shape == (200, 200, 3) and frame.dtype == np.uint8
    np.testing.assert_array_equal(frame, want)


def _episode_rows(tt, envs=40, steps=24, seed=0):
    """(envs * (steps + 1), 55) float32 observation rows of the port's CPU
    env (each env's reset, then ``steps`` steps at random actions), with
    the renderer's edge cases written over the first rows: the torso
    height below 0.1 and above 2.0, lean at and near 0, +-pi/2 and +-pi,
    an all-zero and an unnormalised quaternion, legs and arms stretched
    off each edge of the image (hip_y and knee at obs 18-19 and 27-28,
    shoulder2 and elbow at 23-24 and 32-33), the head at its highest."""
    params = torch.from_numpy(tc.params_in_box(tt, envs, seed))
    st = tt.init_state(torch.Generator().manual_seed(seed), params)
    rows = [tt.observe(st, params)]
    rs = np.random.RandomState(seed + 1)
    for _ in range(steps):
        act = rs.uniform(-1, 1, (envs, tt.act_dim)).astype(np.float32)
        st = tt.physics_step(st, torch.from_numpy(act), params, None)
        rows.append(tt.observe(st, params))
    obs = torch.cat(rows).numpy()
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    # shoulder2 values that point an arm up, left or right at lean 0.
    up, left, right = -np.pi / 0.6, 0.5 * np.pi / 0.6, -0.5 * np.pi / 0.6
    upright = [1, 0, 0, 0]
    edges = [
        {0: 0.05}, {0: -1.0}, {0: 2.5}, {0: 0.1}, {0: 2.0},
        {1: upright}, {1: [1, 0, 1e-7, 0]}, {1: [c, 0, s, 0]},
        {1: [c, 0, -s, 0]}, {1: [0, 0, 1, 0]}, {1: [0, 0, -1, 0]},
        {1: [1e-4, 0, 1, 0]}, {1: [1e-4, 0, -1, 0]}, {1: [0, 0, 0, 0]},
        {1: [2.0, 0.3, 1.5, -0.7]},
        # 15-22: the right (dark) limbs, then the left, stretched up at
        # the highest pelvis (the head at its highest too), left, right,
        # and down at the lowest pelvis; the other side's limbs hang.
        {0: 2.5, 1: upright, 18: [np.pi, 0], 23: [up, 0], 27: [0, 0],
         32: [0, 0]},
        {0: 2.5, 1: upright, 27: [np.pi, 0], 32: [up, 0], 18: [0, 0],
         23: [0, 0]},
        {1: upright, 18: [-np.pi / 2, 0], 23: [left, 0], 27: [0, 0],
         32: [0, 0]},
        {1: upright, 27: [-np.pi / 2, 0], 32: [left, 0], 18: [0, 0],
         23: [0, 0]},
        {1: upright, 18: [np.pi / 2, 0], 23: [right, 0], 27: [0, 0],
         32: [0, 0]},
        {1: upright, 27: [np.pi / 2, 0], 32: [right, 0], 18: [0, 0],
         23: [0, 0]},
        {0: 0.0, 1: upright, 18: [0, 0], 27: [np.pi, 0]},
        {0: 0.0, 1: upright, 27: [0, 0], 18: [np.pi, 0]},
    ]
    for row, cols in enumerate(edges):
        for col, vals in cols.items():
            vals = np.atleast_1d(vals)
            obs[row, col:col + len(vals)] = vals
    return obs


@pytest.mark.parametrize("size", [(200, 200), (40, 16)])
def test_render_obs_frames_equal_the_jax_frames_row_by_row(size):
    """A 1,000-row episode drawn as one batch is, frame for frame and bit
    for bit, the JAX package's ``render_obs_frame`` of each row; at the
    small size the head disc crosses the top edge and the limbs every
    edge."""
    jt, tt = _tasks()
    obs = _episode_rows(tt)
    assert obs.shape == (1000, 55) and np.isfinite(obs).all()
    got = tt.render_obs_frames(obs, *size)
    assert got.shape == (1000, *size, 3) and got.dtype == np.uint8
    want = np.stack([jt.render_obs_frame(row, *size) for row in obs])
    assert np.array_equal(got, want)
    assert np.array_equal(tt.render_obs_frame(obs[7], *size), want[7])
    # The dark right hand off the top, the right foot off the bottom;
    # at the small size also the head disc over the top and the right
    # limbs off the left and right edges.
    dark = [40, 40, 40]
    assert dark in got[15, 0].tolist() and dark in got[21, -1].tolist()
    if size == (40, 16):
        assert [150, 111, 214] in got[15, 0].tolist()
        assert dark in got[17, :, 0].tolist()
        assert dark in got[19, :, -1].tolist()


def test_humanoid_is_registered_and_the_cli_takes_it():
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    assert "Humanoid" in available_tasks()
    args, cfg_env, cfg_train = init_args(["--task", "Humanoid",
                                          "--rl_device", "cpu"])
    assert cfg_env["env"]["numEnvs"] == 4096
    assert cfg_train["policy"]["pi_hid_sizes"] == [400, 200, 100]
    assert cfg_train["learn"]["nsteps"] == 32


def test_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    """bayes_sim_main.main on a tiny Humanoid config (8 envs, 16 training
    trajectories, 2 evaluation episodes of 20 steps, 1 PPO iteration):
    one ADR iteration through the tree-solve physics, MDNN and PPO; a
    finite 37-dim posterior on disk, no kernel launched, every evaluation
    frame drawn as one batch."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    cfg = _cfg(8)
    cfg["env"]["episodeLength"] = 20
    cfg["bayessim"].update(trainTrajs=16, realIters=1, realEvals=2)
    cfg_path = tmp_path / "humanoid.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    before = launch_counts()
    frames_before = dict(collect.STATS)
    trace.reset()
    trace.enable()
    try:
        out = bayes_sim_main.main([
            "--task", "Humanoid", "--cfg_env", str(cfg_path), "--logdir",
            str(tmp_path / "logs"), "--max_iterations", "1", "--rl_device",
            "cpu"])
        spans = [r for r in trace.records() if r["name"] == "collect.frames"]
    finally:
        trace.disable()
        trace.reset()
    assert launch_counts() == before
    # Every evaluation frame is drawn by the batch renderer.
    drawn = collect.STATS["frames"] - frames_before["frames"]
    assert drawn > 0 and drawn == (collect.STATS["frames_batched"]
                                   - frames_before["frames_batched"])
    assert spans and all(r["attrs"]["batched"] for r in spans)
    assert sum(r["attrs"]["frames"] for r in spans) == drawn
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert len(out["iter_secs"]) == 1
    with open(os.path.join(out["logdir"], "checkpoints",
                           "posterior_0.pkl"), "rb") as f:
        post = pickle.load(f)
    assert post["means"].shape[1] == 37
    for k in ("weights", "means", "covs"):
        assert np.isfinite(post[k]).all(), k
    st = out["env"].state.task_state
    assert st.q.shape == (8, 28) and torch.isfinite(st.q).all()
