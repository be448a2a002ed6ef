"""The port's MDNN / MDRFF against the JAX package's, with the JAX params
carried across (utils/convert.py) and the JAX noise passed in:
forward and loss to rtol 1e-5, grads to rtol 1e-4, 20 Adam steps with
injected minibatch ids and noise against optax to rtol 1e-4 / atol 1e-5,
and predict_MoGs to rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bayes_sim_ig_tpu.models import MDNN as JaxMDNN, MDRFF as JaxMDRFF
from bayes_sim_ig_tpu_torch.models import MDNN, MDRFF, mdn_train_step
from bayes_sim_ig_tpu_torch.models.mdnn import mdn_loss
from bayes_sim_ig_tpu_torch.utils.convert import (mdnn_params_from_jax,
                                                  mdnn_params_to_jax)

torch.set_num_threads(1)

LOWS = np.array([0.1, 0.0, -1.0], np.float32)
HIGHS = np.array([2.0, 1.0, 1.0], np.float32)


def _pair(kind, full_covariance=False, input_dim=12, lr=1e-3):
    """A JAX model and its port with the same weights (and coeff)."""
    kw = dict(input_dim=input_dim, output_dim=3, output_lows=LOWS,
              output_highs=HIGHS, n_gaussians=4,
              full_covariance=full_covariance, activation="tanh", lr=lr,
              seed=3)
    if kind == "MDNN":
        jm = JaxMDNN(hidden_layers=(16, 8), **kw)
        tm = MDNN(hidden_layers=(16, 8), device="cpu", **kw)
    else:
        jm = JaxMDRFF(n_feat=40, sigma=2.0, **kw)
        tm = MDRFF(n_feat=40, sigma=2.0, device="cpu", **kw)
        tm.rff.coeff.copy_(torch.from_numpy(np.asarray(jm.rff.coeff)))
    tm.net.load_state_dict(mdnn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    return jm, tm


def _data(n, input_dim=12, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, input_dim).astype(np.float32)
    y = rs.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return x, y


def _noise(key, n):
    return np.array(jax.random.uniform(key, (n, 3, 4), jnp.float32))


def _params_close(tm, jax_params, rtol, atol):
    got = mdnn_params_to_jax(tm.net)
    want = jax.tree_util.tree_map(np.asarray, jax_params)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind,full_cov", [("MDNN", False), ("MDNN", True),
                                           ("MDRFF", False)])
def test_forward_loss_and_grads_match_jax(kind, full_cov):
    jm, tm = _pair(kind, full_cov)
    x, y = _data(24)
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(_noise(key, 24))

    j_out = jm._forward(jm.params, jnp.asarray(x), key)
    t_out = tm(torch.from_numpy(x), noise)
    for j, t in zip(j_out, t_out):
        if j is None:
            assert t is None
            continue
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=1e-5, atol=1e-6)

    j_loss, j_grads = jax.value_and_grad(jm._loss)(
        jm.params, jnp.asarray(x), jnp.asarray(y), key)
    t_loss = mdn_loss(*t_out, torch.from_numpy(y))
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               rtol=1e-5)
    t_loss.backward()
    for name, param in tm.net.named_parameters():
        head, _, leaf = name.rpartition(".")
        tree = (j_grads["trunk"][int(head.split(".")[1])]
                if head.startswith("trunk") else j_grads[head])
        want = np.asarray(tree["w"]).T if leaf == "weight" \
            else np.asarray(tree["b"])
        np.testing.assert_allclose(param.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_20_adam_steps_of_mdrff_match_optax():
    jm, tm = _pair("MDRFF", lr=1e-3)
    x, y = _data(64)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 64, (20, 16))
    keys = jax.random.split(jax.random.PRNGKey(11), 20)

    grad_fn = jax.jit(jax.value_and_grad(jm._loss))
    opt = optax.adam(1e-3)
    params = jm.params
    state = opt.init(params)
    for i in range(20):
        _, grads = grad_fn(
            params, jnp.asarray(x[ids[i]]), jnp.asarray(y[ids[i]]), keys[i])
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)

    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(20):
        mdn_train_step(tm, xt, yt, torch.from_numpy(ids[i]),
                       torch.from_numpy(_noise(keys[i], 16)))
    _params_close(tm, params, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,full_cov", [("MDNN", True), ("MDRFF", False)])
def test_predict_mogs_matches_jax(kind, full_cov):
    jm, tm = _pair(kind, full_cov)
    x, _ = _data(3, seed=4)
    # predict_MoGs splits its key once and draws the jitter from the
    # second half: draw the same jitter for the port.
    _, noise_key = jax.random.split(jm._key)
    want = jm.predict_MoGs(x)
    got = tm.predict_MoGs(x, noise=torch.from_numpy(_noise(noise_key, 3)))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.a, w.a, rtol=1e-5)
        for gg, wg in zip(g.xs, w.xs):
            np.testing.assert_allclose(gg.m, wg.m, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(gg.C, wg.C, rtol=1e-5, atol=1e-7)


def test_run_training_cadence_and_fresh_adam():
    _, tm = _pair("MDRFF")
    x, y = _data(50)
    y = LOWS + y * (HIGHS - LOWS)
    log = tm.run_training(x, y, n_updates=12, batch_size=8)
    # 5 evaluations plus the final one, train and test in parallel series.
    assert len(log["train_loss"]) == len(log["test_loss"]) == 6
    assert np.isfinite(log["train_loss"]).all()
    before = [p.detach().clone() for p in tm.net.parameters()]
    tm.run_training(x, y, n_updates=1, batch_size=8)
    # One update of a fresh Adam moves every weight by about lr.
    step = max(float((p.detach() - b).abs().max())
               for p, b in zip(tm.net.parameters(), before))
    assert step == pytest.approx(tm.lr, rel=0.05)


def test_convert_roundtrip_and_init_bounds():
    jm, tm = _pair("MDNN", full_covariance=True)
    back = mdnn_params_to_jax(tm.net)
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_array_equal(g, np.asarray(w))
    fresh = MDNN(input_dim=12, output_dim=3, output_lows=LOWS,
                 output_highs=HIGHS, n_gaussians=4, full_covariance=False,
                 hidden_layers=(16,), activation="tanh", lr=1e-3, seed=0,
                 device="cpu")
    for layer in [fresh.net.trunk[0], fresh.net.pi]:
        bound = 1.0 / np.sqrt(layer.in_features)
        assert float(layer.weight.detach().abs().max()) <= bound
        assert float(layer.bias.detach().abs().max()) <= bound


@pytest.mark.parametrize("kind", ["MDNN", "MDRFF"])
def test_models_default_to_the_card(kind, monkeypatch):
    """MDNN and MDRFF default to the card; without one
    (torch.cuda.is_available() False) the default raises instead of
    running on the CPU, and device="cpu" is what a caller asks the CPU
    with."""
    import inspect
    cls = {"MDNN": MDNN, "MDRFF": MDRFF}[kind]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(input_dim=12, output_dim=3, output_lows=LOWS,
              output_highs=HIGHS, n_gaussians=4, full_covariance=False,
              activation="tanh", lr=1e-3, seed=0)
    if kind == "MDNN":
        kw["hidden_layers"] = (16,)
    else:
        kw["n_feat"] = 40
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        cls(**kw)
    model = cls(device="cpu", **kw)
    mog = model.predict_MoGs(np.zeros((1, 12), np.float32))[0]
    assert mog.ndim == 3 and np.isfinite(mog.calc_mean_and_cov()[0]).all()
    assert all(p.device.type == "cpu" for p in model.net.parameters())
