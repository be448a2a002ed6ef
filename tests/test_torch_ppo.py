"""The port's PPO against the JAX package: GAE to rtol 1e-6, and one PPO
update from the same params, batch and permutations against the JAX
package's loss and optimizer chain (optax.chain of clip_by_global_norm,
scale_by_adam and scale(-1), times the adaptive lr; rl/ppo.py:118-121,
217-301) to rtol 1e-4; a non-finite minibatch leaves params and Adam
state unchanged."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from bayes_sim_ig_tpu.rl import networks as jnet
from bayes_sim_ig_tpu.rl.ppo import gae_advantages as jax_gae
from bayes_sim_ig_tpu_torch.rl import networks
from bayes_sim_ig_tpu_torch.rl.ppo import (
    AdamState, adam_init, apply_update, gae_advantages,
)
from bayes_sim_ig_tpu_torch.utils.convert import (
    actor_critic_params_from_jax, actor_critic_params_to_jax,
)

torch.set_num_threads(1)

T, NENV, OBS, ACT = 6, 8, 4, 1
CLIP, VF_COEF, ENT_COEF, MAX_NORM, DESIRED_KL = 0.2, 1.0, 0.01, 1.0, 0.008
GAMMA, LAM, EPOCHS, MINIBATCHES = 0.99, 0.95, 2, 2


def test_gae_matches_jax():
    rs = np.random.RandomState(0)
    vals, rews = rs.randn(2, 7, 5).astype(np.float32)
    dones = (rs.rand(7, 5) < 0.3).astype(np.float32)
    last = rs.randn(5).astype(np.float32)
    want = np.asarray(jax_gae(jnp.asarray(vals), jnp.asarray(rews),
                              jnp.asarray(dones), jnp.asarray(last),
                              GAMMA, LAM))
    got = gae_advantages(*(torch.from_numpy(v) for v in
                           (vals, rews, dones, last)), GAMMA, LAM).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _jax_update(params, traj, last_val, perms, lr):
    """The JAX package's update_from_traj (rl/ppo.py:217-310), written
    out over its own networks, GAE and optax chain; the critic reads
    traj["cin"] where the trajectory has it (asymmetric)."""
    opt = optax.chain(optax.clip_by_global_norm(MAX_NORM),
                      optax.scale_by_adam(), optax.scale(-1.0))
    obs, act, logp_old, val, rew, done = (jnp.asarray(traj[k]) for k in (
        "obs", "act", "logp", "val", "rew", "done"))
    advs = jax_gae(val, rew, done, jnp.asarray(last_val), GAMMA, LAM)
    rets = advs + val
    n = T * NENV
    flat = lambda x: x.reshape((n,) + x.shape[2:])  # noqa: E731
    adv = flat(advs)
    adv = (adv - adv.mean()) / (adv.std() + 1e-8)
    cin = jnp.asarray(traj.get("cin", traj["obs"]))
    data = (flat(obs), flat(act), flat(logp_old), flat(val), adv, flat(rets),
            flat(cin))

    def loss_fn(p, mb):
        o, a, lo, vo, ad, rt, ci = mb
        mean = jnet.policy_mean(p, o, "elu")
        logp = jnet.gaussian_logp(a, mean, p["log_std"])
        ratio = jnp.exp(logp - lo)
        pg = jnp.maximum(-ad * ratio,
                         -ad * jnp.clip(ratio, 1 - CLIP, 1 + CLIP)).mean()
        v = jnet.value(p, ci, "elu")
        vc = vo + jnp.clip(v - vo, -CLIP, CLIP)
        vf = 0.5 * jnp.maximum((v - rt) ** 2, (vc - rt) ** 2).mean()
        ent = jnet.entropy(p["log_std"])
        kl = ((ratio - 1.0) - jnp.log(ratio)).mean()
        return pg + VF_COEF * vf - ENT_COEF * ent, kl

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    state = opt.init(params)
    kls = []
    mb = n // MINIBATCHES
    for perm in perms:
        for i in range(MINIBATCHES):
            ids = perm[i * mb:(i + 1) * mb]
            (loss, kl), grads = grad_fn(params,
                                        tuple(x[ids] for x in data))
            ok = jnp.isfinite(loss)
            for g in jax.tree_util.tree_leaves(grads):
                ok &= jnp.isfinite(g).all()
            upd, new_state = opt.update(grads, state, params)
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), new_state, state)
            new_params = optax.apply_updates(
                params, jax.tree_util.tree_map(lambda u: u * lr, upd))
            params = jax.tree_util.tree_map(
                lambda a, b: jnp.where(ok, a, b), new_params, params)
            kls.append(float(kl))
    kl_last = np.mean(kls[-MINIBATCHES:])
    if kl_last > DESIRED_KL * 2.0:
        lr = max(lr / 1.5, 1e-6)
    elif kl_last < DESIRED_KL / 2.0:
        lr = min(lr * 1.5, 1e-2)
    return params, state, lr


class _Task:
    obs_dim, act_dim, num_envs = OBS, ACT, NENV


class _Env:
    task, device = _Task(), torch.device("cpu")


def _ppo(env=None):
    from bayes_sim_ig_tpu_torch.rl.ppo import PPO
    cfg = {"learn": {"cliprange": CLIP, "ent_coef": ENT_COEF,
                     "value_loss_coef": VF_COEF, "nsteps": T,
                     "noptepochs": EPOCHS, "nminibatches": MINIBATCHES,
                     "max_grad_norm": MAX_NORM, "optim_stepsize": 3e-3,
                     "desired_kl": DESIRED_KL, "gamma": GAMMA, "lam": LAM},
           "policy": {"pi_hid_sizes": [16, 16], "vf_hid_sizes": [16, 16],
                      "activation": "elu"}}
    return PPO(env or _Env(), cfg, logdir="unused")


def _traj(params, seed=0):
    rs = np.random.RandomState(seed)
    obs = rs.randn(T, NENV, OBS).astype(np.float32)
    mean = np.asarray(jnet.policy_mean(params, jnp.asarray(obs), "elu"))
    act = (mean + rs.randn(T, NENV, ACT)).astype(np.float32)
    logp = np.asarray(jnet.gaussian_logp(
        jnp.asarray(act), jnp.asarray(mean), params["log_std"]))
    logp = (logp + rs.randn(T, NENV) * 0.05).astype(np.float32)
    return {"obs": obs, "act": act, "logp": logp,
            "val": rs.randn(T, NENV).astype(np.float32),
            "rew": rs.randn(T, NENV).astype(np.float32),
            "done": (rs.rand(T, NENV) < 0.2).astype(np.float32)}


def test_one_ppo_update_matches_the_jax_chain():
    ppo = _ppo()
    params = jnet.init_actor_critic(jax.random.PRNGKey(0), OBS, ACT,
                                    [16, 16], [16, 16], 1.0)
    ppo.net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    traj = _traj(params)
    last_val = np.random.RandomState(1).randn(NENV).astype(np.float32)
    rs = np.random.RandomState(2)
    perms = np.stack([rs.permutation(T * NENV) for _ in range(EPOCHS)])

    want_params, want_state, want_lr = _jax_update(params, traj, last_val,
                                                   perms, 3e-3)
    metrics = ppo.update_from_traj(
        {k: torch.from_numpy(v) for k, v in traj.items()},
        torch.from_numpy(last_val), torch.from_numpy(perms))
    got = actor_critic_params_to_jax(ppo.net)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
    adam = want_state[1]
    assert float(ppo.adam.count) == int(adam.count)
    # optax's moments are a tree in the JAX layout; the port's follow
    # net.parameters(): compare through a net holding the moments.
    for mine, theirs in ((ppo.adam.mu, adam.mu), (ppo.adam.nu, adam.nu)):
        holder = networks.ActorCritic(torch.Generator(), OBS, ACT, [16, 16],
                                      [16, 16])
        with torch.no_grad():
            for p, m in zip(holder.parameters(), mine):
                p.copy_(m)
        for g, w in zip(
                jax.tree_util.tree_leaves(actor_critic_params_to_jax(holder)),
                jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                       atol=1e-9)
    assert float(metrics["lr"]) == pytest.approx(want_lr, rel=1e-6)


def test_approx_kl_stays_finite_where_a_ratio_underflows():
    """A sample whose old log-prob lies 200 above its new one: exp of the
    log-ratio underflows to 0 in float32. The JAX package's jitted loss
    reads log(exp(d)) as d (XLA's simplifier), so its approx KL stays
    finite and drives the adaptive lr; the port must give the same value,
    not inf (found by experiments/ppo_stream_injection.py --forced: seed
    1, iterations 48 and 51)."""
    ppo = _ppo()
    params = jnet.init_actor_critic(jax.random.PRNGKey(0), OBS, ACT,
                                    [16, 16], [16, 16], 1.0)
    ppo.net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    rs = np.random.RandomState(3)
    obs = rs.randn(16, OBS).astype(np.float32)
    mean = np.asarray(jnet.policy_mean(params, jnp.asarray(obs), "elu"))
    act = (mean + rs.randn(16, ACT)).astype(np.float32)
    logp = np.asarray(jnet.gaussian_logp(jnp.asarray(act),
                                         jnp.asarray(mean),
                                         params["log_std"]))
    logp_old = (logp + rs.randn(16) * 0.05).astype(np.float32)
    logp_old[5] += 200.0
    val, ret, adv = rs.randn(3, 16).astype(np.float32)

    @jax.jit
    def jax_kl(p):
        # rl/ppo.py:223-241, the JAX package's loss_fn as jitted there.
        m = jnet.policy_mean(p, jnp.asarray(obs), "elu")
        ratio = jnp.exp(jnet.gaussian_logp(jnp.asarray(act), m,
                                           p["log_std"])
                        - jnp.asarray(logp_old))
        return ((ratio - 1.0) - jnp.log(ratio)).mean()

    want = float(jax_kl(params))
    batch = {k: torch.from_numpy(v) for k, v in (
        ("obs", obs), ("act", act), ("logp", logp_old), ("val", val),
        ("ret", ret), ("adv", adv))}
    with torch.no_grad():
        total, _, _, kl = ppo.loss_fn(batch)
    assert np.isfinite(want) and want > 10.0
    assert float(kl) == pytest.approx(want, rel=1e-5)
    assert torch.isfinite(total)


def test_non_finite_minibatch_keeps_params_and_adam_state():
    ppo = _ppo()
    params = list(ppo.net.parameters())
    grads = [torch.randn_like(p) for p in params]
    adam = adam_init(params)
    apply_update(params, grads, torch.tensor(1.0), adam, ppo.lr,
                 MAX_NORM)  # one good step: non-zero state, in place
    assert float(adam.count) == 1.0
    before = [p.detach().clone() for p in params]
    kept = AdamState(count=adam.count.clone(),
                     mu=[m.clone() for m in adam.mu],
                     nu=[v.clone() for v in adam.nu])
    bad = [g.clone() for g in grads]
    bad[1].view(-1)[0] = float("nan")
    apply_update(params, bad, torch.tensor(1.0), adam, ppo.lr, MAX_NORM)
    for p, b in zip(params, before):
        assert torch.equal(p.detach(), b)
    assert torch.equal(adam.count, kept.count)
    for x, y in zip(adam.mu + adam.nu, kept.mu + kept.nu):
        assert torch.equal(x, y)
    # A finite gradient with a non-finite loss is skipped too.
    apply_update(params, grads, torch.tensor(float("inf")), adam, ppo.lr,
                 MAX_NORM)
    assert torch.equal(adam.count, kept.count)

    # And through a whole update: every minibatch non-finite.
    params0 = jax.tree_util.tree_leaves(actor_critic_params_to_jax(ppo.net))
    traj = _traj(actor_critic_params_to_jax(ppo.net))
    traj["obs"][:] = np.nan
    ppo._reset_optimizer(ppo.init_lr)
    ppo.update_from_traj({k: torch.from_numpy(v) for k, v in traj.items()},
                         torch.zeros(NENV),
                         torch.stack([torch.randperm(T * NENV)
                                      for _ in range(EPOCHS)]))
    for g, w in zip(
            jax.tree_util.tree_leaves(actor_critic_params_to_jax(ppo.net)),
            params0):
        np.testing.assert_array_equal(g, w)
    assert float(ppo.adam.count) == 0.0


def test_save_load_roundtrip_through_the_jax_layout(tmp_path):
    ppo = _ppo()
    ppo.current_learning_iteration = 7
    path = str(tmp_path / "p.ckpt")
    ppo.save(path)
    other = _ppo()
    other.reinit(seed=99)
    other.load(path)
    for a, b in zip(ppo.net.parameters(), other.net.parameters()):
        assert torch.equal(a, b)
    assert other.current_learning_iteration == 7
    # The checkpoint holds numpy in the JAX package's layout.
    import pickle
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["params"]["actor"][0]["w"].shape == (OBS, 16)
