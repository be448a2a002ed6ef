"""The benchmark's plain reference of Anymal
(``adr_bench/reference/frozen/sim/anymal.py``: a frozen copy of the
port's task over the frozen physics, whose dense mass-matrix solves are
the plain PyTorch SPD factor and substitute on every device) against the
port and against the JAX package on the CPU, at 8 envs:

  * the whole ``env_step`` (episode resets, DR redraws, the implicit PD
    drives, contacts, obs, reward, termination) of both from seeded
    random states, actions and DR draws, over 5 steps with one env
    resetting;
  * the frozen task's physics, obs, reward and termination against the
    JAX package's Anymal over 5 steps from one numpy state.

Tolerances are those of ``tests/test_torch_anymal.py``: atol 1e-4 on every
state field, obs and reward (float32 on both sides, sums in another
order; against JAX the plain Cholesky meets XLA's, which agree on
solutions, not factors). The port's CPU path and the frozen copy run the
same plain solves, so they agree far inside it; the tolerance leaves the
port room to reorder a sum without the reference moving. The done flags
and the termination masks are equal."""

import os
import sys

import numpy as np
import pytest
import torch

from bayes_sim_ig_tpu.sim.anymal import Anymal as JaxAnymal
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.sim import env_step, make_env

from . import torch_task_checks as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "adr_bench") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "adr_bench"))

from reference.frozen.distributions import device as fdevice  # noqa: E402
from reference.frozen.physics.dynamics import _uses_tree_solve  # noqa: E402
from reference.frozen.sim import (EnvState, env_step as frozen_step,  # noqa: E402
                                  make_task)

torch.set_num_threads(1)

STEM = "anymal"
N = 8
TOL = 1e-4


@pytest.fixture(scope="module")
def frozen():
    return make_task("Anymal", tc.load_cfg(STEM, N), "cpu")


def _frozen_state(task, state):
    """The port's EnvState as the frozen task's own state type."""
    ts = task.init_state(torch.Generator().manual_seed(0),
                         torch.ones(N, task.params_spec.dim))
    return EnvState(task_state=type(ts)(*state.task_state),
                    **{k: getattr(state, k) for k in state._fields
                       if k != "task_state"})


def test_frozen_task_is_the_dense_route(frozen):
    """The reference's Anymal is the deployment's: 18 dofs whose ancestor
    pairs fill more than 0.66 of the lower triangle, 13 DR parameters,
    3,000-step episodes, 48 obs and 12 actions."""
    m = frozen.model
    assert (m.nv, m.nb) == (18, 13) and not _uses_tree_solve(m)
    assert frozen.params_spec.dim == 13
    assert frozen.max_episode_length == 3000
    assert (frozen.obs_dim, frozen.act_dim) == (48, 12)


@pytest.mark.parametrize("seed", [0, 1])
def test_frozen_env_step_matches_the_port(frozen, seed):
    env = make_env("Anymal", tc.load_cfg(STEM, N), seed=seed, device="cpu")
    spec = env.task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                            spec.highs, device="cpu")
    env.set_distr(distr)
    env.reset()
    rs = np.random.RandomState(seed)
    ts = env.state.task_state
    v = torch.from_numpy(rs.uniform(-0.3, 0.3, ts.v.shape)
                         .astype(np.float32))
    state = env.state._replace(
        task_state=ts._replace(v=v),
        params=torch.from_numpy(tc.params_in_box(env.task, N, seed)),
        reset_buf=torch.from_numpy(
            (np.arange(N) == 3).astype(np.int32)))
    fdistr = fdevice.DeviceUniform(*distr)
    gen_port = torch.Generator().manual_seed(100 + seed)
    gen_ref = torch.Generator().manual_seed(100 + seed)
    ref = _frozen_state(frozen, state)
    for t in range(5):
        act = torch.from_numpy(rs.uniform(-1, 1, (N, 12))
                               .astype(np.float32))
        state, obs, rew, done = env_step(env.task, distr, state, act,
                                         gen_port)
        ref, r_obs, r_rew, r_done = frozen_step(frozen, fdistr, ref, act,
                                                gen_ref)
        for name, got, want in (
                [(f"task_state.{k}", a, b) for k, a, b in zip(
                    state.task_state._fields, state.task_state,
                    ref.task_state)]
                + [(k, getattr(state, k), getattr(ref, k))
                   for k in ("params", "progress", "obs_corr",
                             "act_corr")]
                + [("obs", obs, r_obs), ("rew", rew, r_rew)]):
            torch.testing.assert_close(got, want, rtol=0, atol=TOL,
                                       msg=f"step {t}, {name}")
        assert torch.equal(done, r_done), t
    assert torch.isfinite(state.task_state.q).all()


def test_frozen_physics_matches_jax(frozen):
    """As ``test_torch_anymal.py``'s JAX comparison, with the frozen task
    in the port's place: the base at 0.56 m puts the feet ~5 mm into the
    ground, so contacts and the drives act from the first step."""
    cfg = tc.load_cfg(STEM, N)
    jt = JaxAnymal(cfg)
    params = tc.params_in_box(frozen, N, 4)
    st = frozen.init_state(torch.Generator().manual_seed(4),
                           torch.from_numpy(params))
    q = st.q.numpy().copy()
    q[:, 2] = 0.56
    rs = np.random.RandomState(5)
    v = rs.uniform(-0.1, 0.1, (N, frozen.model.nv)).astype(np.float32)
    prev = rs.uniform(-1, 1, (N, 12)).astype(np.float32)
    ts = tc.steps_match_jax(jt, frozen, (q, v, st.commands.numpy(), prev),
                            params, seed=6, tol=TOL)
    assert (ts.q[:, 2] > 0.45).all()
