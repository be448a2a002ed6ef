"""The kinematics kernel (``csrc/forward_kinematics.cu`` through
``physics/dynamics.py::forward_kinematics``): one launch a substep on the
card for the torch chain ``kinematics_chain``.

  (a) its tables cover every link, 1-dof joint and dof once, for every
      articulated task's model, a model with no free body (FrankaCabinet),
      one with no 1-dof joint and one with joint chains (Humanoid); and the
      kernel's schedule, replayed in numpy from those tables, is the chain
      to float32 rounding;
  (b) on the CPU, for a batch and for a single env, ``forward_kinematics``
      is the torch chain, bit for bit, and launches nothing;
  (c) on a card (``cuda`` marker; skipped without one): every field of the
      kernel's result against the torch chain on the card, bit for bit, at
      the cells' widths (4,000, 4,096 and 10,000 envs), and a single env
      against its row of the batch, at random states with the geometry
      scale DR'd;
  (d) on a card: a captured ``VecEnv.step`` of Anymal, Humanoid and
      ShadowHand launches the kernel twice a replay and its eager body
      makes no host sync and no host copy.

This file imports no JAX, so that its card cases run where JAX is absent.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts, replay_counts
from bayes_sim_ig_tpu_torch.physics import (
    ArticulatedModel, DynParams, LinkSpec, forward_kinematics,
)
from bayes_sim_ig_tpu_torch.physics import dynamics
from bayes_sim_ig_tpu_torch.sim import make_env

from .integrate_states import kinematics_states
from .torch_host_traffic import NoHostTraffic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every articulated task, by config stem.
TASKS = {"Ant": "ant", "Anymal": "anymal", "Humanoid": "humanoid",
         "ShadowHand": "shadow_hand", "BallBalance": "ball_balance",
         "Quadcopter": "quadcopter", "Ingenuity": "ingenuity",
         "FrankaCabinet": "franka_cabinet"}
MODELS = list(TASKS) + ["FreeBody"]


def _cfg(stem, n):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           stem + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = n
    return cfg


def _model(name):
    """A task's model, or "FreeBody": one free body, no 1-dof joint."""
    if name == "FreeBody":
        return ArticulatedModel([LinkSpec("body", parent=-1,
                                          joint_type="free", mass=2.0,
                                          inertia=(0.02, 0.03, 0.04))])
    return make_env(name, _cfg(TASKS[name], 1), seed=0,
                    device="cpu").task.model


def _inputs(model, n, seed=0, device="cpu"):
    q, v, scale = kinematics_states(model, n, seed, device)
    params = DynParams.defaults(model, device=device).rows(n, scale=scale)
    return q, v, params


def _tables(model):
    """The kernel's tables, split into their rows."""
    st = dynamics._structure(model, "cpu")
    it, ft = st["fk_itab"].numpy(), st["fk_ftab"].numpy()
    nb, nj, nv = model.nb, model.j1_links.size, model.nv
    cut = np.cumsum([4 * nb, 5 * nj, nv])
    links, joints, dofs, frees = np.split(it, cut)
    return (links.reshape(nb, 4), joints.reshape(nj, 5), dofs,
            frees.reshape(-1, 2), ft[:12 * nb].reshape(nb, 12),
            ft[12 * nb:].reshape(nj, 37))


# ------------------------------------------------------------------ #
# (a), (b) on the CPU
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", MODELS)
def test_the_tables_cover_every_link_joint_and_dof(name):
    model = _model(name)
    st = dynamics._structure(model, "cpu")
    assert st["fk_itab"].dtype == torch.int32
    links, joints, dofs, frees, lf, jf = _tables(model)
    nb, nj, nv = model.nb, model.j1_links.size, model.nv
    # Links: parents, the chains that end at each, free joints, ancestors.
    np.testing.assert_array_equal(links[:, 0], model.parent_pad)
    ends = links[:, 1][links[:, 1] >= 0]
    np.testing.assert_array_equal(np.sort(ends),
                                  np.flatnonzero(model.j1_last))
    np.testing.assert_array_equal(model.j1_links[links[:, 1][links[:, 1]
                                                             >= 0]],
                                  np.flatnonzero(links[:, 1] >= 0))
    assert sorted(links[:, 2][links[:, 2] >= 0]) == list(
        range(len(model.free_list)))
    bits = (links[:, 3].astype(np.uint32)[:, None]
            >> np.arange(nv, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(bits, model.anc_dof != 0)
    # Joints and free joints: every q and v column once.
    np.testing.assert_array_equal(joints[:, :2],
                                  np.stack([model.j1_q, model.j1_v], 1))
    np.testing.assert_array_equal(joints[:, 2], model.j1_chain_pos)
    chained = model.j1_chain_pos > 0
    np.testing.assert_array_equal(joints[chained, 3],
                                  model.j1_prev[chained])
    np.testing.assert_array_equal(
        joints[:, 4], np.append(model.parent_pad, nb)[model.j1_links])
    q_cols = list(joints[:, 0]) + [c for (_, qi) in frees
                                   for c in range(qi, qi + 7)]
    assert sorted(q_cols) == list(range(model.nq))
    free_dofs = np.flatnonzero(dofs >= 0)
    assert sorted(list(joints[:, 1]) + list(free_dofs)) == list(range(nv))
    for f, (i, qi, vi) in enumerate(model.free_list):
        assert links[i, 2] == f and tuple(frees[f]) == (i, qi)
        np.testing.assert_array_equal(dofs[vi:vi + 6], 6 * f + np.arange(6))
    # Floats: the chain's own tables.
    np.testing.assert_array_equal(lf[:, :9].reshape(nb, 3, 3),
                                  st["fixed_rot_T"].numpy())
    np.testing.assert_array_equal(lf[:, 9:], st["fixed_pos"].numpy())
    for k, (key, w) in zip((0, 9, 18, 27, 30, 33, 36),
                           (("j1_E", 9), ("j1_K", 9), ("j1_aaT", 9),
                            ("j1_t", 3), ("j1_ax_par", 3), ("j1_axis", 3),
                            ("j1_rev", 1))):
        np.testing.assert_array_equal(jf[:, k:k + w],
                                      st[key].numpy().reshape(nj, w))
    if name == "Humanoid":
        assert model.j1_chain_maxpos == 2 and chained.any()


def _sum3(a, b, c):
    return (a + b) + c


def _mm(A, B):
    return np.stack([np.stack([_sum3(A[i, 0] * B[0, l], A[i, 1] * B[1, l],
                                     A[i, 2] * B[2, l]) for l in range(3)])
                     for i in range(3)])


def _mv(A, x):
    return np.stack([_sum3(A[i, 0] * x[0], A[i, 1] * x[1], A[i, 2] * x[2])
                     for i in range(3)])


def _mvT(A, x):
    return np.stack([_sum3(A[0, j] * x[0], A[1, j] * x[1], A[2, j] * x[2])
                     for j in range(3)])


def _cross(a, b):
    return np.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _quat_to_rot(w, x, y, z):
    one = np.float32(1)
    return np.stack([
        np.stack([one - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)]),
        np.stack([2 * (x * y + w * z), one - 2 * (x * x + z * z),
                  2 * (y * z - w * x)]),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  one - 2 * (x * x + y * y)])])


def _replay(model, q, v, scale):
    """The kernel's schedule, a lane at a time, in float32 numpy over the
    env axis: the link, joint and dof tables read as the kernel reads
    them. Returns the Kinematics fields, env-last."""
    links, joints, dofs, frees, lf, jf = _tables(model)
    nb, nj, nv = model.nb, model.j1_links.size, model.nv
    q, v, scale = q.T.numpy(), v.T.numpy(), scale.numpy()
    n = scale.shape[0]
    eye = np.eye(3, dtype=np.float32)
    # Each 1-dof joint's (G, u), then the chain rounds.
    G = np.zeros((max(nj, 1), 3, 3, n), np.float32)
    u = np.zeros((max(nj, 1), 3, n), np.float32)
    for j in range(nj):
        rev, q1 = jf[j, 36], q[joints[j, 0]]
        ang = q1 * rev
        sn, cs = np.sin(ang), np.cos(ang)
        Rj = (cs * eye[..., None] + sn * jf[j, 9:18].reshape(3, 3, 1)
              + (1 - cs) * jf[j, 18:27].reshape(3, 3, 1))
        G[j] = _mm(np.broadcast_to(jf[j, :9].reshape(3, 3, 1), Rj.shape),
                   Rj)
        pris = q1 * (1 - rev)
        u[j] = jf[j, 27:30, None] * scale + jf[j, 30:33, None] * pris
    for rnd in range(1, model.j1_chain_maxpos + 1):
        Gp, up = G[joints[:, 3]], u[joints[:, 3]]
        for j in np.flatnonzero(joints[:, 2] == rnd):
            G[j], u[j] = _mm(Gp[j], G[j]), up[j] + _mv(Gp[j], u[j])
    # Each link's local transform, then the pointer-jumping rounds.
    R = np.broadcast_to(eye[None, ..., None], (nb + 1, 3, 3, n)).copy()
    p = np.zeros((nb + 1, 3, n), np.float32)
    for b in range(nb):
        R[b] = lf[b, :9].reshape(3, 3, 1)
        p[b] = lf[b, 9:, None] * scale
        if nj:
            R[b] = R[b] + (G[links[b, 1]] if links[b, 1] >= 0 else 0)
            p[b] = p[b] + (u[links[b, 1]] if links[b, 1] >= 0 else 0)
        if len(frees):
            f = links[b, 2]
            qi = frees[f, 1] if f >= 0 else 0
            R[b] = R[b] + (_quat_to_rot(*q[qi + 3:qi + 7]) if f >= 0 else 0)
            p[b] = p[b] + (q[qi:qi + 3] if f >= 0 else 0)
    ptr = np.append(links[:, 0], nb)
    for _ in range(len(dynamics._structure(model, "cpu")["jump_gathers"])):
        AR, Ap = R[ptr], p[ptr]
        R = np.stack([_mm(AR[b], R[b]) for b in range(nb + 1)])
        p = np.stack([Ap[b] + _mv(AR[b], p[b]) for b in range(nb + 1)])
        ptr = ptr[ptr]
    o = p[0]
    rel = p[:nb] - o
    # Dof subspaces, their products with v, link velocities.
    S = np.zeros((nv, 6, n), np.float32)
    for j in range(nj):
        rev, par = jf[j, 36], joints[j, 4]
        aw = _mv(R[par], _mv(G[j], jf[j, 33:36, None]))
        mom = _cross(p[par] + _mv(R[par], u[j]) - o, aw)
        S[joints[j, 1]] = np.concatenate([aw * rev,
                                          mom * rev + aw * (1 - rev)])
    for m in np.flatnonzero(dofs >= 0):
        f, k = divmod(dofs[m], 6)
        i = frees[f, 0]
        col = R[i][:, k % 3]
        S[m] = (np.concatenate([col, _cross(rel[i], col)]) if k < 3 else
                np.concatenate([np.zeros_like(col), col]))
    Sv = S * v[:, None]
    V = np.zeros((nb, 6, n), np.float32)
    for b in range(nb):
        for m in range(nv):
            if (int(links[b, 3]) >> m) & 1:
                V[b] = V[b] + Sv[m]
    vb = np.stack([np.concatenate([
        _mvT(R[b], V[b, :3]), _mvT(R[b], V[b, 3:] + _cross(V[b, :3],
                                                          rel[b]))])
        for b in range(nb)])
    return R[:nb], p[:nb], vb, S, Sv, V, o


@pytest.mark.parametrize("name", MODELS)
def test_the_kernels_schedule_is_the_chain_to_rounding(name):
    """The kernel's lanes, replayed on the CPU from its tables at 64 envs,
    against the chain: each field within float32 rounding of its largest
    entry (the CPU's own sums and sines round otherwise than the card's, so
    the bits are held on the card, in (c))."""
    model = _model(name)
    q, v, params = _inputs(model, 64, seed=2)
    want = dynamics.kinematics_chain(model, q, v, params)
    got = _replay(model, q, v, params.scale)
    for field, g, w in zip(dynamics.Kinematics._fields, got, want):
        assert g.shape == tuple(w.shape), field
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=tol,
                                   err_msg=field)


@pytest.mark.parametrize("name", ["Humanoid", "ShadowHand", "FrankaCabinet",
                                  "FreeBody"])
def test_cpu_and_single_env_calls_are_the_torch_chain(name):
    model = _model(name)
    q, v, params = _inputs(model, 9)
    one = DynParams.defaults(model)._replace(scale=params.scale[3])
    before = launch_counts()
    for got, want in ((forward_kinematics(model, q, v, params),
                       dynamics.kinematics_chain(model, q, v, params)),
                      (forward_kinematics(model, q[3], v[3], one),
                       dynamics.kinematics_chain(model, q[3], v[3], one))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert launch_counts() == before


# ------------------------------------------------------------------ #
# (c), (d) on a card
# ------------------------------------------------------------------ #
def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4000, 4096, 10000])
@pytest.mark.parametrize("name", MODELS)
def test_the_kernel_is_the_torch_chain_on_the_card(name, n):
    """At the cells' widths every field bit for bit (``torch.equal``): the
    kernel rounds every operation as PyTorch's kernels of the chain do on
    the card, so that the port's step stays the benchmark reference's. A
    single env is a batch of one: one launch, the batch's row. It is not
    held to the chain run on that env alone, which sums a lone env's rows
    (and cuBLAS a few envs' folds) in another order than a batch's: up to
    64 ulps apart on an H100."""
    _card_or_skip()
    model = _model(name)
    q, v, params = _inputs(model, n, seed=n, device="cuda")
    before = launch_counts()["forward_kinematics"]
    got = forward_kinematics(model, q, v, params)
    want = dynamics.kinematics_chain(model, q, v, params)
    assert launch_counts()["forward_kinematics"] == before + 1
    for field, g, w in zip(dynamics.Kinematics._fields, got, want):
        assert g.shape == w.shape, field
        assert torch.equal(g, w), field
    one = DynParams.defaults(model, device="cuda")._replace(
        scale=params.scale[7])
    single = forward_kinematics(model, q[7], v[7], one)
    assert launch_counts()["forward_kinematics"] == before + 2
    for field, g, w in zip(dynamics.Kinematics._fields, single, want):
        assert torch.equal(g, w[..., 7]), field


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Anymal", "Humanoid", "ShadowHand"])
def test_a_captured_vec_env_step_launches_the_kernel_twice(name):
    """At 64 envs: the first ``VecEnv.step`` runs eagerly and captures, the
    next four replay, each adding two kernel launches (one a substep); the
    replays equal the eager body from the same state and generator bit for
    bit, and the eager body makes no host sync and no host copy."""
    _card_or_skip()
    from bayes_sim_ig_tpu_torch.utils.step_graph import Graphed
    env = make_env(name, _cfg(TASKS[name], 64), seed=3, device="cuda")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cuda"))
    rs = np.random.RandomState(0)
    acts = [torch.as_tensor(rs.uniform(-1, 1, (64, env.task.act_dim)),
                            dtype=torch.float32, device="cuda")
            for _ in range(5)]
    env.reset()
    start = (env.gen.get_state(), env.state)

    def run(mode=None, launches=None):
        env.gen.set_state(start[0])
        env.state = start[1]
        out = []
        for a in acts:
            before = replay_counts()["forward_kinematics"]
            with mode or contextlib.nullcontext():
                out += list(env.step(a)[:3])
            if launches is not None:
                launches.append(replay_counts()["forward_kinematics"]
                                - before)
        leaves = list(env.state.task_state) + list(env.state[1:])
        return out + leaves + [env.gen.get_state()]

    run()  # captures
    launches = []
    replayed = run(launches=launches)
    assert launches == [2] * 5
    mode = NoHostTraffic()
    call = Graphed.__call__
    Graphed.__call__ = lambda self: self.body()
    try:
        eager = run(mode)
    finally:
        Graphed.__call__ = call
    assert mode.hits == []
    for a, b in zip(replayed, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    env.free_step_graphs()
