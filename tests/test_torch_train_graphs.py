"""The port's training programs on static buffers (rl/ppo.py ``_Update``,
models/mdnn.py ``_Fit``), which the card runs as CUDA graphs and the CPU
runs eagerly:

  (a) the restructured PPO update against the JAX package's
      update_from_traj with the same permutations, asymmetric (the
      symmetric case is tests/test_torch_ppo.py::
      test_one_ppo_update_matches_the_jax_chain), rtol 1e-4 / atol 1e-6;
      and bit for bit against the eager minibatch loop it replaced;
  (b) the Adam state and the lr stay in the trainer's tensors through two
      updates, ``reinit`` and ``load``, equal to what fresh tensors give;
      ``MDNN.reinit`` writes a fresh model's next init into the net's
      tensors;
  (c) the MDN update with the port's in-place Adam against optax over 20
      steps with the draws injected, rtol 1e-4 / atol 1e-5 (MDNN diagonal,
      MDNN full covariance, MDRFF); and ``run_training``'s static-buffer
      step bit for bit against the plain loop of ``mdn_train_step``;
  (d) the update's programs and the MDN update body make no host sync and
      no host copy (``NoHostTraffic``);
  (e) on a card, graph replays of the update and of the fit equal their
      eager bodies bit for bit (``cuda`` marker; skipped without one).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bayes_sim_ig_tpu.rl import networks as jnet
from bayes_sim_ig_tpu_torch.models import MDNN, MDRFF, init_mdnn_params
from bayes_sim_ig_tpu_torch.models.mdnn import mdn_train_step
from bayes_sim_ig_tpu_torch.rl.ppo import AdamState, apply_update
from bayes_sim_ig_tpu_torch.utils.convert import (
    actor_critic_params_from_jax, actor_critic_params_to_jax,
)

from .test_torch_models import HIGHS, LOWS, _data, _noise, _pair, \
    _params_close
from .test_torch_ppo import (ACT, EPOCHS, MINIBATCHES, NENV, OBS, T, _Env,
                             _jax_update, _ppo, _traj)
from .torch_task_checks import NoHostTraffic

torch.set_num_threads(1)

STATE = 5  # the privileged state's width of the asymmetric critic


class _AsymTask:
    obs_dim, act_dim, num_envs = OBS, ACT, NENV
    asymmetric_observations, state_dim = True, STATE


class _AsymEnv:
    task, device = _AsymTask(), torch.device("cpu")


def _jax_params(asymmetric):
    return jnet.init_actor_critic(jax.random.PRNGKey(0), OBS, ACT, [16, 16],
                                  [16, 16], 1.0,
                                  state_dim=STATE if asymmetric else 0)


def _inputs(asymmetric, seed=0):
    """(traj, last_val, perms) as numpy, the critic's inputs included when
    asymmetric; the actions near the policy of ``_jax_params``."""
    traj = _traj(_jax_params(asymmetric), seed)
    rs = np.random.RandomState(seed + 1)
    if asymmetric:
        traj["cin"] = rs.randn(T, NENV, STATE).astype(np.float32)
    last_val = rs.randn(NENV).astype(np.float32)
    perms = np.stack([rs.permutation(T * NENV) for _ in range(EPOCHS)])
    return traj, last_val, perms


def _torch(traj, last_val, perms):
    return ({k: torch.from_numpy(v) for k, v in traj.items()},
            torch.from_numpy(last_val), torch.from_numpy(perms))


def _state(ppo):
    """Copies of the params, the Adam state and the lr."""
    return ([p.detach().clone() for p in ppo.params],
            [ppo.adam.count.clone()] + [m.clone() for m in ppo.adam.mu]
            + [v.clone() for v in ppo.adam.nu], ppo.lr.clone())


def _assert_equal(a, b):
    for x, y in zip(a[0] + a[1] + [a[2]], b[0] + b[1] + [b[2]]):
        assert torch.equal(x, y)


# ------------------------------------------------------------------ #
# (a) the PPO update against JAX and against the loop it replaced
# ------------------------------------------------------------------ #
def test_asymmetric_ppo_update_matches_the_jax_chain():
    ppo = _ppo(_AsymEnv())
    assert ppo.asymmetric
    params = _jax_params(asymmetric=True)
    ppo.net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    traj, last_val, perms = _inputs(asymmetric=True)
    want_params, want_state, want_lr = _jax_update(params, traj, last_val,
                                                   perms, 3e-3)
    metrics = ppo.update_from_traj(*_torch(traj, last_val, perms))
    got = actor_critic_params_to_jax(ppo.net)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    assert float(ppo.adam.count) == int(want_state[1].count)
    assert float(metrics["lr"]) == pytest.approx(want_lr, rel=1e-6)


def _old_update(ppo, traj, last_val, perms):
    """The eager update before the static buffers: GAE, flat data, one
    minibatch at a time from slices of the permutations, the adaptive lr;
    returns the (epochs, minibatches, 4) metrics."""
    from bayes_sim_ig_tpu_torch.rl.ppo import gae_advantages
    advs = gae_advantages(traj["val"], traj["rew"], traj["done"], last_val,
                          ppo.gamma, ppo.lam)
    rets = advs + traj["val"]
    n = traj["val"].shape[0] * traj["val"].shape[1]

    def flat(x):
        return x.reshape((n,) + x.shape[2:])
    adv = flat(advs)
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    data = {"obs": flat(traj["obs"]), "act": flat(traj["act"]),
            "logp": flat(traj["logp"]), "val": flat(traj["val"]),
            "adv": adv, "ret": flat(rets)}
    if "cin" in traj:
        data["cin"] = flat(traj["cin"])
    mb = n // ppo.nminibatches
    metrics = []
    for perm in perms:
        for i in range(ppo.nminibatches):
            ids = perm[i * mb:(i + 1) * mb]
            out = ppo.loss_fn({k: v[ids] for k, v in data.items()})
            grads = torch.autograd.grad(out[0], ppo.params)
            apply_update(ppo.params, grads, out[0].detach(), ppo.adam,
                         ppo.lr, ppo.max_grad_norm)
            metrics.append(torch.stack([o.detach() for o in out]))
    metrics = torch.stack(metrics).reshape(len(perms), ppo.nminibatches, 4)
    kl_last = metrics[-1, :, 3].mean()
    kl = float(ppo.desired_kl)
    lr = ppo.lr
    lr = torch.where(kl_last > kl * 2.0, torch.clamp(lr / 1.5, min=1e-6),
                     lr)
    lr = torch.where(kl_last < kl / 2.0, torch.clamp(lr * 1.5, max=1e-2),
                     lr)
    ppo.lr.copy_(lr)
    return metrics


@pytest.mark.parametrize("asymmetric", [False, True])
def test_update_programs_equal_the_eager_minibatch_loop(asymmetric):
    """Two iterations of prepare, noptepochs x nminibatches minibatch
    steps at a device counter and finish equal the loop of slices they
    replaced, bit for bit: params, Adam state, lr and every metric."""
    env = _AsymEnv() if asymmetric else _Env()
    got, want = _ppo(env), _ppo(env)
    for it in range(2):
        traj, last_val, perms = _torch(*_inputs(asymmetric, it))
        out = got.update_from_traj(traj, last_val, perms)
        metrics = _old_update(want, traj, last_val, perms)
        _assert_equal(_state(got), _state(want))
        update = got.update_program(traj, last_val)
        assert torch.equal(update.metrics, metrics)
        m = metrics.reshape(-1, 4).mean(dim=0)
        for i, k in enumerate(("loss", "pg_loss", "vf_loss", "approx_kl")):
            assert torch.equal(out[k], m[i])
        assert torch.equal(out["lr"], want.lr)
        assert torch.equal(out["mean_reward"], traj["rew"].mean())
    assert len(got._updates) == 1


def test_update_refuses_a_minibatch_past_its_rows():
    ppo = _ppo()
    traj, last_val, perms = _torch(*_inputs(False))
    ppo.update_from_traj(traj, last_val, perms)
    with pytest.raises(IndexError):
        ppo.update_program(traj, last_val).step()


# ------------------------------------------------------------------ #
# (b) the optimizer state and the weights stay in their tensors
# ------------------------------------------------------------------ #
def _ptrs(ppo):
    return [t.data_ptr() for t in ppo.params + [ppo.adam.count]
            + ppo.adam.mu + ppo.adam.nu + [ppo.lr]]


def test_update_reinit_and_load_keep_the_adam_and_lr_tensors(tmp_path):
    """Two updates, reinit and load write into the tensors of the first
    init, and give the state a trainer whose Adam state and lr are fresh
    tensors before every call gives."""
    ppo, fresh = _ppo(), _ppo()
    ptrs = _ptrs(ppo)
    for it in range(2):
        inputs = _torch(*_inputs(False, it))
        ppo.update_from_traj(*inputs)
        # Fresh tensors holding the same values (the update's programs
        # read the trainer's attributes on the CPU).
        fresh.adam = AdamState(count=fresh.adam.count.clone(),
                               mu=[m.clone() for m in fresh.adam.mu],
                               nu=[v.clone() for v in fresh.adam.nu])
        fresh.lr = fresh.lr.clone()
        fresh.update_from_traj(*inputs)
        _assert_equal(_state(ppo), _state(fresh))
    assert _ptrs(ppo) == ptrs
    assert float(ppo.adam.count) == 2 * EPOCHS * MINIBATCHES

    path = str(tmp_path / "p.ckpt")
    ppo.save(path)
    ppo.reinit(seed=5)
    assert _ptrs(ppo) == ptrs
    new = _ppo()
    new.reinit(seed=5)
    _assert_equal(_state(ppo), _state(new))
    assert float(ppo.adam.count) == 0.0 and float(ppo.lr) == \
        pytest.approx(3e-3, rel=1e-7)

    other = _ppo()
    other.update_from_traj(*_torch(*_inputs(False, 3)))
    other_ptrs = _ptrs(other)
    other.load(path)
    assert _ptrs(other) == other_ptrs
    assert float(other.adam.count) == 0.0
    assert all(not m.any() for m in other.adam.mu + other.adam.nu)
    assert float(other.lr) == float(fresh.lr)
    for a, b in zip(other.params, fresh.params):
        assert torch.equal(a, b)


_MDN_KW = dict(input_dim=12, output_dim=3, output_lows=LOWS,
               output_highs=HIGHS, n_gaussians=4, full_covariance=True,
               hidden_layers=(16, 8), activation="tanh", lr=1e-3, seed=3,
               device="cpu")


def test_mdnn_reinit_keeps_the_net_tensors_and_draws_a_fresh_init():
    model = MDNN(**_MDN_KW)
    tensors = list(model.net.parameters())
    ptrs = [p.data_ptr() for p in tensors]
    model.reinit()
    assert all(a is b for a, b in zip(model.net.parameters(), tensors))
    assert [p.data_ptr() for p in model.net.parameters()] == ptrs
    # The second init a generator of the model's seed draws.
    gen = torch.Generator().manual_seed(3)
    args = (12, 3, 4, (16, 8), True, "tanh")
    init_mdnn_params(gen, *args)
    want = init_mdnn_params(gen, *args)
    for a, b in zip(model.net.parameters(), want.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ #
# (c) the MDN update against optax, and the fit against the plain loop
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("kind,full_cov", [("MDNN", False), ("MDNN", True),
                                           ("MDRFF", False)])
def test_20_mdn_updates_match_optax(kind, full_cov):
    jm, tm = _pair(kind, full_cov, lr=1e-3)
    x, y = _data(64)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, 64, (20, 16))
    keys = jax.random.split(jax.random.PRNGKey(11), 20)
    grad_fn = jax.jit(jax.value_and_grad(jm._loss))
    opt = optax.adam(1e-3)
    params = jm.params
    state = opt.init(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(20):
        want, grads = grad_fn(params, jnp.asarray(x[ids[i]]),
                              jnp.asarray(y[ids[i]]), keys[i])
        upd, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        got = mdn_train_step(tm, xt, yt, torch.from_numpy(ids[i]),
                             torch.from_numpy(_noise(keys[i], 16)))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4,
                                   atol=1e-5)
    _params_close(tm, params, rtol=1e-4, atol=1e-5)
    assert float(tm.adam_count) == 20.0


def _plain_fit(model, x, y, n_updates, batch_size, test_frac=0.2):
    """run_training's loop before the static buffers: ids, then jitter,
    from the model's generator, one mdn_train_step each, a test loss
    before each fifth and after the last."""
    x = torch.as_tensor(x)
    y = model.normalize_samples(torch.as_tensor(y))
    n_train = max(int(x.shape[0] * (1.0 - test_frac)), 1)
    model._reset_adam()
    n_evals = min(5, n_updates)
    bounds = [i * n_updates // n_evals for i in range(n_evals + 1)]
    train, test = [], []

    def test_loss():
        with torch.no_grad():
            return model._loss(x[n_train:], y[n_train:],
                               model._noise(x.shape[0] - n_train))
    for s in range(n_evals):
        test.append(test_loss())
        for _ in range(bounds[s], bounds[s + 1]):
            ids = torch.randint(0, n_train, (batch_size,),
                                generator=model._gen)
            train.append(mdn_train_step(model, x[:n_train], y[:n_train],
                                        ids, model._noise(batch_size)))
    test.append(test_loss())
    return torch.stack(train), torch.stack(test)


@pytest.mark.parametrize("kind,full_cov", [("MDNN", True), ("MDRFF", False)])
def test_fit_program_equals_the_plain_loop(kind, full_cov):
    """Two run_training calls through the fit's static buffers and device
    counter equal the plain loop bit for bit: every train loss, the six
    test losses, the weights, the Adam state and the generator."""
    _, got = _pair(kind, full_cov)
    _, want = _pair(kind, full_cov)
    x, y = _data(50)
    y = LOWS + y * (HIGHS - LOWS)
    for _ in range(2):
        log = got.run_training(x, y, n_updates=12, batch_size=8)
        train, test = _plain_fit(want, x, y, 12, 8)
        fit = got.fit_program(40, x.shape[1], 8, 12)
        assert torch.equal(fit.losses, train)
        assert log["test_loss"] == [float(t) for t in test]
        for a, b in zip(got.net.parameters(), want.net.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(got.adam_mu + got.adam_nu + [got.adam_count],
                        want.adam_mu + want.adam_nu + [want.adam_count]):
            assert torch.equal(a, b)
        assert torch.equal(got._gen.get_state(), want._gen.get_state())
    assert len(got._fits) == 1
    with pytest.raises(IndexError):
        fit.step()


# ------------------------------------------------------------------ #
# (d) no host sync and no host data in a captured body
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("asymmetric", [False, True])
def test_update_programs_make_no_host_sync_and_no_host_copy(asymmetric):
    ppo = _ppo(_AsymEnv() if asymmetric else _Env())
    traj, last_val, perms = _torch(*_inputs(asymmetric))
    update = ppo.update_program(traj, last_val)
    update.load(traj, last_val, perms)
    update.prepare()
    update.step()  # a graph's first call runs eagerly
    mode = NoHostTraffic()
    with mode:
        update.prepare.body()
        update.step()
        update.finish.body()
    assert not mode.hits, sorted(set(mode.hits))


@pytest.mark.parametrize("kind,full_cov", [("MDNN", False), ("MDNN", True),
                                           ("MDRFF", False)])
def test_mdn_update_body_makes_no_host_sync_and_no_host_copy(kind,
                                                             full_cov):
    """The fit's step (ids, jitter, forward, loss, gradients, in-place
    Adam, the loss at the counter) after one step: no op of _SYNCING, no
    boolean-mask index; the full-covariance scale factors included."""
    _, model = _pair(kind, full_cov)
    x, y = _data(50)
    fit = model.fit_program(40, x.shape[1], 8, 12)
    fit.load(torch.from_numpy(x[:40]), torch.from_numpy(y[:40]))
    fit.step()
    mode = NoHostTraffic()
    with mode:
        fit.step()
    assert not mode.hits, sorted(set(mode.hits))


# ------------------------------------------------------------------ #
# (e) on a card: replays against the eager bodies
# ------------------------------------------------------------------ #
def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")


def _with_bodies(fn):
    """Runs ``fn`` with every Graphed bound to its eager body."""
    from bayes_sim_ig_tpu_torch.utils.step_graph import Graphed
    call = Graphed.__call__
    Graphed.__call__ = lambda self: self.body()
    try:
        return fn()
    finally:
        Graphed.__call__ = call


@pytest.mark.cuda
@pytest.mark.parametrize("asymmetric", [False, True])
def test_update_replays_equal_the_eager_bodies_on_the_card(asymmetric):
    """Three updates as replays (the first captures) and as the eager
    bodies from the same state: params, Adam state, lr and metrics bit for
    bit."""
    _card_or_skip()

    class Env:
        task = _AsymTask() if asymmetric else _Env.task
        device = torch.device("cuda")

    def run(eager):
        ppo = _ppo(Env())
        outs = []
        for it in range(3):
            inputs = tuple(
                {k: v.cuda() for k, v in x.items()} if isinstance(x, dict)
                else x.cuda()
                for x in _torch(*_inputs(asymmetric, it)))
            step = (lambda: ppo.update_from_traj(*inputs))
            outs.append(_with_bodies(step) if eager else step())
        return _state(ppo), outs

    (g_state, g_out), (e_state, e_out) = run(False), run(True)
    _assert_equal(g_state, e_state)
    for a, b in zip(g_out, e_out):
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind,full_cov", [("MDNN", False), ("MDNN", True),
                                           ("MDRFF", False)])
def test_fit_replays_equal_the_eager_bodies_on_the_card(kind, full_cov):
    _card_or_skip()
    x, y = _data(500)
    y = LOWS + y * (HIGHS - LOWS)

    def run(eager):
        kw = dict(input_dim=12, output_dim=3, output_lows=LOWS,
                  output_highs=HIGHS, n_gaussians=4,
                  full_covariance=full_cov, activation="tanh", lr=1e-3,
                  seed=3, device="cuda")
        model = (MDNN(hidden_layers=(16, 8), **kw) if kind == "MDNN"
                 else MDRFF(n_feat=40, sigma=2.0, **kw))
        logs = []
        for _ in range(2):
            step = (lambda: model.run_training(x, y, 100, 32))
            logs.append(_with_bodies(step) if eager else step())
        return model, logs

    (g, g_logs), (e, e_logs) = run(False), run(True)
    assert g_logs == e_logs
    for a, b in zip(list(g.net.parameters()) + g.adam_mu + g.adam_nu,
                    list(e.net.parameters()) + e.adam_mu + e.adam_nu):
        assert torch.equal(a, b)
    assert torch.equal(g._gen.get_state(), e._gen.get_state())
