"""The port's summarizers against the JAX package's on the same numpy
inputs: start/waypts exactly, corr/corrdiff to 1e-6 abs (the bar
PARITY.md:17-18 set against the original)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayes_sim_ig_tpu import summarizers as jsum
from bayes_sim_ig_tpu_torch import summarizers as tsum

torch.set_num_threads(1)

# (n_traj, T states, T' actions, state_dim, act_dim): padding, chopping,
# the waypoint chop of the corr family, and the >50-dim 5-step branch.
SHAPES = [(6, 21, 20, 4, 1), (5, 7, 6, 3, 2), (4, 12, 12, 60, 3)]


def _inputs(shape, seed=0):
    n, ts, ta, s, a = shape
    rs = np.random.RandomState(seed)
    return (rs.randn(n, ts, s).astype(np.float32) * 5.0,
            rs.uniform(0.0, 1.0, (n, ta, a)).astype(np.float32))


@pytest.mark.parametrize("name", ["summary_start", "summary_waypts"])
@pytest.mark.parametrize("shape", SHAPES)
def test_start_and_waypts_exact(name, shape):
    states, actions = _inputs(shape)
    want = np.asarray(jsum.get_summarizer(name)(jnp.asarray(states),
                                                jnp.asarray(actions)))
    got = tsum.get_summarizer(name)(torch.from_numpy(states),
                                    torch.from_numpy(actions)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["summary_corr", "summary_corrdiff"])
@pytest.mark.parametrize("shape", SHAPES)
def test_corr_family_within_1e6(name, shape):
    states, actions = _inputs(shape, seed=1)
    states = states / 5.0  # the fixture scale of PARITY.md's bar
    want = np.asarray(jsum.get_summarizer(name)(jnp.asarray(states),
                                                jnp.asarray(actions)))
    got = tsum.get_summarizer(name)(torch.from_numpy(states),
                                    torch.from_numpy(actions)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_corrdiff_width_on_the_cartpole_slice():
    # 21 steps of 4 obs + 1 action: 10 waypoints, 3 diffs each, so
    # 30 x 10 cross terms + mean + std = 302 (the MDRFF input width).
    states, actions = _inputs((2, 21, 21, 4, 1))
    got = tsum.summary_corrdiff(torch.from_numpy(states),
                                torch.from_numpy(actions))
    assert got.shape == (2, 302)


def test_pad_states_actions_matches():
    states, actions = _inputs((3, 5, 3, 2, 1))
    js, ja = jsum.pad_states_actions(jnp.asarray(states),
                                     jnp.asarray(actions), 8)
    ts, ta = tsum.pad_states_actions(torch.from_numpy(states),
                                     torch.from_numpy(actions), 8)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))

