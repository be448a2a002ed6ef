"""The port's path signatures (``summarizers/signature.py``) and
``summary_signatory`` against the JAX package's on the same numpy inputs,
against the sequential Chen-relation oracle at float64, and the shipped
``cartpole_more.yaml`` through the ADR loop on the CPU.

Float32 bar: rtol 1e-5, and an atol of 1e-6 times the largest entry of
each signature level. Each level is a float32 sum over the path's steps,
and both packages sum in their own order: against a float64 computation
each package is off by 2-4e-7 of the level's largest entry (JAX by up to
7.3e-6 at a depth-3 level of scale 27), so a fixed atol of 1e-6 would be
below either package's own rounding. Gradients: rtol 1e-4."""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu import summarizers as jsum
from bayes_sim_ig_tpu.summarizers import signature as jsig
from bayes_sim_ig_tpu_torch import summarizers as tsum
from bayes_sim_ig_tpu_torch.summarizers import signature as tsig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, T, d, depth): a small path, cartpole_more's time-augmented path
# (20 steps of 1 + 4 + 1 channels), and a wide depth-2 path (d = 30,
# where signature_depth picks 2).
CASES = [((5, 7, 3), 1), ((5, 7, 3), 2), ((5, 7, 3), 3),
         ((4, 20, 6), 1), ((4, 20, 6), 2), ((4, 20, 6), 3),
         ((3, 9, 30), 2)]


def _paths(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _assert_levels_close(got, want, d, depth):
    off = 0
    for k in range(1, depth + 1):
        lvl = slice(off, off + d ** k)
        off += d ** k
        np.testing.assert_allclose(
            got[:, lvl], want[:, lvl], rtol=1e-5,
            atol=1e-6 * np.abs(want[:, lvl]).max(), err_msg=f"level {k}")
    assert off == got.shape[1]


@pytest.mark.parametrize("shape,depth", CASES)
def test_path_signature_matches_jax(shape, depth):
    paths = _paths(shape)
    want = np.asarray(jsig.path_signature(jnp.asarray(paths), depth))
    got = tsig.path_signature(torch.from_numpy(paths), depth).numpy()
    d = shape[-1]
    assert got.shape == want.shape == (shape[0],
                                       sum(d ** k for k in
                                           range(1, depth + 1)))
    _assert_levels_close(got, want, d, depth)


def test_chunked_equals_unchunked_exactly():
    # 37 paths in chunks of 8: four full chunks and a zero-padded tail.
    paths = torch.from_numpy(_paths((37, 9, 4), seed=3))
    full = tsig.path_signature(paths, 3)
    chunked = tsig.path_signature(paths, 3, chunk_size=8)
    np.testing.assert_array_equal(chunked.numpy(), full.numpy())


@pytest.mark.parametrize("ndim", [4, 22, 23, 110, 111])
def test_signature_depth_matches_jax(ndim):
    assert tsig.signature_depth(ndim) == jsig.signature_depth(ndim)
    assert tsig.MAX_SIGNATURE_OUTPUT_DIM == jsig.MAX_SIGNATURE_OUTPUT_DIM
    assert tsig.SIGNATURE_CHUNK == jsig.SIGNATURE_CHUNK


def _states_actions(seed=4):
    rs = np.random.RandomState(seed)
    # Actions one step short: pad_states_actions repeats the last one.
    return (rs.randn(3, 12, 4).astype(np.float32),
            rs.uniform(-1.0, 1.0, (3, 11, 1)).astype(np.float32))


def test_summary_signatory_matches_jax():
    states, actions = _states_actions()
    want = np.asarray(jsum.summary_signatory(jnp.asarray(states),
                                             jnp.asarray(actions)))
    got = tsum.get_summarizer("summary_signatory")(
        torch.from_numpy(states), torch.from_numpy(actions)).numpy()
    assert got.shape == want.shape == (3, 6 + 36 + 216)
    _assert_levels_close(got, want, 6, 3)
    # Level 1 of the time channel is the number of increments.
    np.testing.assert_allclose(got[:, 0], 11.0, rtol=1e-6)
    assert tsum.path_signature is tsig.path_signature
    assert tsum.signature_depth is tsig.signature_depth


def test_summary_signatory_gradient_matches_jax():
    states, actions = _states_actions(seed=5)
    a = jnp.asarray(actions)
    want = np.asarray(jax.grad(
        lambda s: jsum.summary_signatory(s, a).sum())(jnp.asarray(states)))
    s = torch.from_numpy(states).requires_grad_(True)
    tsum.summary_signatory(s, torch.from_numpy(actions)).sum().backward()
    got = s.grad.numpy()
    assert np.abs(got).sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _chen_product(A, B, depth):
    out = [A[0] + B[0]]
    if depth >= 2:
        out.append(A[1] + B[1] + np.einsum("i,j->ij", A[0], B[0]))
    if depth >= 3:
        out.append(A[2] + B[2] + np.einsum("i,jk->ijk", A[0], B[1])
                   + np.einsum("ij,k->ijk", A[1], B[0]))
    return out


def _signature_oracle(path, depth):
    """Sequential Chen-relation signature of one path (the JAX package's
    test oracle)."""
    sig = None
    for t in range(path.shape[0] - 1):
        dx = path[t + 1] - path[t]
        exp_dx = [dx, np.einsum("i,j->ij", dx, dx) / 2.0,
                  np.einsum("i,j,k->ijk", dx, dx, dx) / 6.0][:depth]
        sig = exp_dx if sig is None else _chen_product(sig, exp_dx, depth)
    return np.concatenate([lvl.ravel() for lvl in sig])


def test_matches_sequential_chen_oracle_at_float64():
    path = np.random.RandomState(8).randn(1, 11, 5)
    got = tsig.path_signature(torch.from_numpy(path), 3).numpy()[0]
    np.testing.assert_allclose(got, _signature_oracle(path[0], 3),
                               rtol=1e-12, atol=1e-12)


def test_config_copy_matches_the_jax_package():
    rel = "cartpole_more.yaml"
    with open(os.path.join(REPO, "bayes_sim_ig_tpu", "cfg", rel)) as a, \
            open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                              rel)) as b:
        assert yaml.safe_load(a) == yaml.safe_load(b)


def test_cartpole_more_adr_loop_runs_on_cpu(tmp_path, monkeypatch):
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           "cartpole_more.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 16
    cfg["bayessim"].update(trainTrajs=64, realIters=1, realEvals=2)
    cfg_path = tmp_path / "cartpole_more.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    out = bayes_sim_main.main([
        "--task", "Cartpole", "--cfg_env", str(cfg_path), "--logdir",
        str(tmp_path / "logs"), "--max_iterations", "1", "--rl_device",
        "cpu"])
    assert "summary_signatory" in out["logdir"]
    # 1 time + 4 obs + 1 action channels at depth 3.
    assert out["bsim"].model.input_dim == 6 + 36 + 216
    with open(os.path.join(out["logdir"], "checkpoints",
                           "posterior_0.pkl"), "rb") as f:
        post = pickle.load(f)
    assert post["means"].shape[1] == 13
    for k in ("weights", "means", "covs"):
        assert np.isfinite(post[k]).all(), k
