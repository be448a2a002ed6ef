"""The integration kernel (``csrc/integrate.cu`` through
``physics/dynamics.py::integrate_and_clamp``): one launch a substep on the
card for ``integrate`` followed by ``clamp_limits``.

  (a) its tables cover every q and v column once, for every articulated
      task's model, a model with no free body (FrankaCabinet) and one with
      no 1-dof joint;
  (b) on the CPU, for a batch and for a single env, ``integrate_and_clamp``
      is the torch chain, bit for bit, and launches nothing;
  (c) on a card (``cuda`` marker; skipped without one): the kernel against
      the torch chain on the card at states that drive every clamp (a
      single env is a batch of one: one launch, the batch's row), and a
      captured ``VecEnv.step`` against its eager body, which makes no host
      sync and no host copy.

This file imports no JAX, so that its card cases run where JAX is absent.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.ops import integrate_kernel
from bayes_sim_ig_tpu_torch.physics import (
    ArticulatedModel, LinkSpec, clamp_limits, integrate, integrate_and_clamp,
)
from bayes_sim_ig_tpu_torch.physics import dynamics
from bayes_sim_ig_tpu_torch.sim import make_env

from .integrate_states import clamp_driving_states as _states
from .torch_host_traffic import NoHostTraffic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DT = 1 / 120
# Every articulated task, by config stem.
TASKS = {"Ant": "ant", "Anymal": "anymal", "Humanoid": "humanoid",
         "ShadowHand": "shadow_hand", "BallBalance": "ball_balance",
         "Quadcopter": "quadcopter", "Ingenuity": "ingenuity",
         "FrankaCabinet": "franka_cabinet"}


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


def _chain(model, q, v, qdd):
    return clamp_limits(model, *integrate(model, q, v, qdd, DT))


# ------------------------------------------------------------------ #
# (a), (b) on the CPU
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", list(TASKS) + ["FreeBody"])
def test_the_tables_cover_every_column_once(name):
    model = _model(name)
    st = dynamics._structure(model, "cpu")
    table, limits = st["integ_table"], st["integ_limits"]
    n_free, n_j1 = len(model.free_list), model.j1_q.size
    assert table.dtype == torch.int32
    assert tuple(table.shape) == (n_free + n_j1, 2)
    q_cols, v_cols = [], []
    for i, (qo, vo) in enumerate(table.tolist()):
        q_cols += range(qo, qo + 7) if i < n_free else [qo]
        v_cols += range(vo, vo + 6) if i < n_free else [vo]
    assert sorted(q_cols) == list(range(model.nq))
    assert sorted(v_cols) == list(range(model.nv))
    want = np.stack([model.j1_maxv, model.j1_lo, model.j1_hi], 1)
    np.testing.assert_array_equal(limits.numpy(), want.reshape(-1, 3))


@pytest.mark.parametrize("name", ["ShadowHand", "FrankaCabinet",
                                  "FreeBody"])
def test_cpu_and_single_env_calls_are_the_torch_chain(name):
    model = _model(name)
    q, v, qdd = _states(model, 9)
    before = dict(integrate_kernel.LAUNCHES)
    for got, want in ((integrate_and_clamp(model, q, v, qdd, DT),
                       _chain(model, q, v, qdd)),
                      (integrate_and_clamp(model, q[3], v[3], qdd[3], DT),
                       _chain(model, q[3], v[3], qdd[3]))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert integrate_kernel.LAUNCHES == before


# ------------------------------------------------------------------ #
# (c) on a card
# ------------------------------------------------------------------ #
def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ShadowHand", "Humanoid", "Anymal", "Ant",
                                  "BallBalance", "FrankaCabinet",
                                  "FreeBody"])
def test_the_kernel_is_the_torch_chain_on_the_card(name):
    """At 1,001 envs (a last block of one env), bit for bit: the kernel
    rounds every operation as PyTorch's kernels of the chain do on the
    card (the multiply-add its cross product fuses, the order its sums
    take), so that the port's step stays the benchmark reference's; a last
    bit off flips a reward term or a contact of an env now and then. A
    single env is one launch and gives its row of the batch bit for bit;
    it is not held to the chain run on that env alone, which sums a lone
    env's rows in another order than a batch's (up to 3.5 ulps apart on
    an H100)."""
    _card_or_skip()
    model = _model(name)
    q, v, qdd = _states(model, 1001, seed=1, device="cuda")
    before = integrate_kernel.LAUNCHES["integrate_clamp"]
    got = integrate_and_clamp(model, q, v, qdd, DT)
    want = _chain(model, q, v, qdd)
    assert integrate_kernel.LAUNCHES["integrate_clamp"] == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # A single env is a batch of one: one launch, the batch's row.
    one = integrate_and_clamp(model, q[7], v[7], qdd[7], DT)
    assert integrate_kernel.LAUNCHES["integrate_clamp"] == before + 2
    for g, w in zip(one, want):
        assert g.shape == w.shape[1:]
        torch.testing.assert_close(g, w[7], rtol=0, atol=0)
    # Every clamp was driven: joints at their limits with the inward
    # velocity zeroed, velocities at max_velocity, bodies at the caps.
    if model.j1_q.size:
        qj, vj = want[0][:, model.j1_q].cpu(), want[1][:, model.j1_v].cpu()
        lo, hi = torch.as_tensor(model.j1_lo), torch.as_tensor(model.j1_hi)
        assert ((qj == lo) & (vj == 0)).any() and ((qj == hi) & (vj == 0)) \
            .any()
        assert (vj.abs() == torch.as_tensor(model.j1_maxv)).any()
    for (_, _, vi) in model.free_list:
        for k, cap in ((0, dynamics.MAX_ANG_VEL), (3, dynamics.MAX_LIN_VEL)):
            nrm = want[1][:, vi + k:vi + k + 3].norm(dim=1)
            assert (nrm > 0.999 * cap).any() and (nrm < 0.99 * cap).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Anymal", "Humanoid", "ShadowHand"])
def test_a_captured_vec_env_step_is_its_eager_body(name):
    """At 64 envs, 5 ``VecEnv.step`` calls as replays (after one that
    captures) and through the eager body from the same state and
    generator: obs, rewards, dones, every state leaf and the generator bit
    for bit; the eager body makes no host sync and no host copy."""
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

    def run(mode=None):
        env.gen.set_state(start[0])
        env.state = start[1]
        out = []
        for a in acts:
            with mode or contextlib.nullcontext():
                out += list(env.step(a)[:3])
        leaves = list(env.state.task_state) + list(env.state[1:])
        return out + leaves + [env.gen.get_state()]

    run()  # captures
    replayed = run()
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
