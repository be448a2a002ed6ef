"""The benchmark's plain reference of FrankaCabinet
(``adr_bench/reference/frozen/sim/franka_cabinet.py``: a frozen copy of
the port's task over the frozen physics, whose dense mass-matrix solves
are the plain PyTorch SPD factor and substitute on every device) against
the port and against the JAX package on the CPU, at 8 envs:

  * the whole ``env_step`` (episode resets, DR redraws of the 10 body
    masses and 9 drive stiffnesses, the per-env implicit PD drives, the
    finger-pad pair contacts, obs, reward, termination) of both from the
    grip pose, with the handle between the pads, and seeded random
    actions and DR draws, over 5 steps with one env resetting;
  * the frozen task's physics, obs, reward and termination against the
    JAX package's FrankaCabinet over 5 steps from the grip pose.

Tolerances are those of ``tests/test_torch_franka_cabinet.py``: atol 1e-4
on every state field, obs and reward (float32 on both sides, sums in
another order; against JAX the plain Cholesky meets XLA's, which agree on
solutions, not factors). The port's CPU path and the frozen copy run the
same plain solves, so they agree far inside it; the tolerance leaves the
port room to reorder a sum without the reference moving. The done flags
and the termination masks are equal."""

import os
import sys

import numpy as np
import pytest
import torch

from bayes_sim_ig_tpu.sim.franka_cabinet import (
    FrankaCabinet as JaxFrankaCabinet,
)
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.sim import env_step, make_env

from . import torch_task_checks as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "adr_bench") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "adr_bench"))

from reference.frozen.distributions import device as fdevice  # noqa: E402
from reference.frozen.physics import (  # noqa: E402
    forward_kinematics, sphere_plane_pair_forces)
from reference.frozen.physics.dynamics import _uses_tree_solve  # noqa: E402
from reference.frozen.sim import (EnvState, env_step as frozen_step,  # noqa: E402
                                  make_task)

torch.set_num_threads(1)

STEM = "franka_cabinet"
N = 8
TOL = 1e-4


@pytest.fixture(scope="module")
def frozen():
    return make_task("FrankaCabinet", tc.load_cfg(STEM, N), "cpu")


def _frozen_state(task, state):
    """The port's EnvState as the frozen task's own state type."""
    ts = task.init_state(torch.Generator().manual_seed(0),
                         torch.ones(N, task.params_spec.dim))
    return EnvState(task_state=type(ts)(*state.task_state),
                    **{k: getattr(state, k) for k in state._fields
                       if k != "task_state"})


def test_frozen_task_is_the_deployments(frozen):
    """The reference's FrankaCabinet is the deployment's: 10 dofs (7
    revolute arm joints, two prismatic fingers, the prismatic drawer)
    under two fixed roots, on the dense route; 19 DR parameters, 500-step
    episodes, 23 obs and 9 actions."""
    m = frozen.model
    assert (m.nv, m.nq, m.nb) == (10, 10, 12) and not _uses_tree_solve(m)
    assert m.joint_types.count("fixed") == 2 and m.free_list == []
    assert m.joint_types.count("prismatic") == 3
    assert frozen.params_spec.dim == 19
    assert frozen.max_episode_length == 500
    assert (frozen.obs_dim, frozen.act_dim) == (23, 9)


# An arm pose that holds the drawer's handle between the finger pads, each
# pad 2 mm into the handle sphere (found by gradient descent on the frozen
# chain): the 7 arm joints, the two fingers, the drawer.
GRIP_Q = (0.0, -0.0855, 0.0, -2.4974, 0.0, 1.6489, 0.78, 0.026, 0.026,
          0.2347)


def _grip(rs):
    """(q, v) of N envs at the grip pose, each arm joint jittered by up to
    2 mrad, the velocities under 0.01."""
    q = np.tile(np.asarray(GRIP_Q, np.float32), (N, 1))
    q[:, :7] += rs.uniform(-0.002, 0.002, (N, 7)).astype(np.float32)
    v = rs.uniform(-0.01, 0.01, (N, len(GRIP_Q))).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(v)


def _pad_forces(task, q, params):
    """Each env's summed pad-contact force magnitude at ``q``."""
    m = task.model
    kin = forward_kinematics(m, q, torch.zeros_like(q),
                             task._dyn_params(params))
    total = 0.0
    for link, sy in ((task._lf, -1.0), (task._rf, 1.0)):
        f = sphere_plane_pair_forces(
            m, kin, task._dyn_params(params), sphere_link=task._drawer,
            sphere_offset=(0.0, 0.0, 0.05), radius=0.02, plane_link=link,
            plane_point=(0.0, sy * 0.008, 0.045),
            plane_normal=(0.0, sy, 0.0), mu=1.5, dt=task.dt / 2,
            plane_halfsize=0.025)
        total = total + f.abs().sum((0, 1))
    return total


@pytest.mark.parametrize("seed", [0, 1])
def test_frozen_env_step_matches_the_port(frozen, seed):
    env = make_env("FrankaCabinet", tc.load_cfg(STEM, N), seed=seed,
                   device="cpu")
    spec = env.task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                            spec.highs, device="cpu")
    env.set_distr(distr)
    env.reset()
    rs = np.random.RandomState(seed)
    q, v = _grip(rs)
    params = torch.from_numpy(tc.params_in_box(env.task, N, seed))
    assert (_pad_forces(frozen, q, params) > 0).all()
    state = env.state._replace(
        task_state=env.state.task_state._replace(q=q, v=v,
                                                 targets=q[:, :9].clone()),
        params=params,
        reset_buf=torch.from_numpy(
            (np.arange(N) == 3).astype(np.int32)))
    fdistr = fdevice.DeviceUniform(*distr)
    gen_port = torch.Generator().manual_seed(100 + seed)
    gen_ref = torch.Generator().manual_seed(100 + seed)
    ref = _frozen_state(frozen, state)
    p0 = state.params.clone()
    for t in range(5):
        act = torch.from_numpy(rs.uniform(-1, 1, (N, 9))
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
    # Env 3 reset on the first step and drew new masses and gains.
    assert not torch.equal(state.params[3], p0[3])
    torch.testing.assert_close(state.params[:3], p0[:3], rtol=0, atol=0)
    assert torch.isfinite(state.task_state.q).all()


def test_frozen_physics_matches_jax(frozen):
    """As ``test_torch_franka_cabinet.py``'s JAX comparison, with the
    frozen task in the port's place, from the grip pose (jittered by up
    to 2 mrad an arm joint) with small actions: the per-env PD drives,
    the prismatic joints and the pad contacts, which act in every env
    at the first step (a few let go of the handle by the fifth)."""
    cfg = tc.load_cfg(STEM, N)
    jt = JaxFrankaCabinet(cfg)
    params = tc.params_in_box(frozen, N, 4)
    q, v = _grip(np.random.RandomState(5))
    assert (_pad_forces(frozen, q, torch.from_numpy(params)) > 0).all()
    q, v = q.numpy(), v.numpy()
    ts = tc.steps_match_jax(jt, frozen, (q, v, q[:, :9].copy()),
                            params, seed=6, amp=0.1, tol=TOL)
    assert torch.isfinite(ts.q).all()
