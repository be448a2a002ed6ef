"""The PPO update, the MDN fit and the posterior's mixtures, plain: eager
PyTorch loops from the weights, optimizer state, data and generator
states copied before the port's programs ran.

The PPO update follows ``PPO.update_from_traj``: the epochs'
permutations drawn from the trainer's generator, GAE, normalized
advantages, one clipped-surrogate minibatch step after another with
global-norm clipping and Adam (optax's chain, skipped on a non-finite
loss or gradient), then the adaptive lr. The MDN fit follows
``BayesSim.run_training`` and ``MDNN.run_training``: the summaries, the
non-finite rows dropped, the labels normalized, a fresh Adam, and the
model generator's draws in the port's order (the test loss's jitter
before each fifth of the updates and at the end; each update's
minibatch ids, then its jitter).

Faults (for the readings that set the limits): ``half`` takes each
minibatch's loss over its first half; ``altered`` reports the first
minibatch's loss doubled, an answer wrong where it is produced.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .frozen.models import mdnn as fmdnn
from .frozen.rl import networks
from .frozen.summarizers import get_summarizer
from .step_ref import actor_critic

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _generator(state, device):
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


# ---------------------------------------------------------------------- #
# PPO.
# ---------------------------------------------------------------------- #
def gae(vals, rews, dones, last_val, gamma, lam):
    advs = torch.empty_like(vals)
    adv = torch.zeros_like(last_val)
    nxt = last_val
    for t in range(vals.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rews[t] + gamma * nxt * nonterminal - vals[t]
        adv = delta + gamma * lam * nonterminal * adv
        advs[t] = adv
        nxt = vals[t]
    return advs


def ppo_loss(net, batch, clip, vf_coef, ent_coef):
    mean = networks.policy_mean(net, batch["obs"])
    logp = networks.gaussian_logp(batch["act"], mean, net.log_std)
    log_ratio = logp - batch["logp"]
    ratio = torch.exp(log_ratio)
    adv = batch["adv"]
    pg = torch.maximum(-adv * ratio,
                       -adv * torch.clamp(ratio, 1.0 - clip, 1.0 + clip))
    v = networks.value(net, batch.get("cin", batch["obs"]))
    v_old, ret = batch["val"], batch["ret"]
    v_clip = v_old + torch.clamp(v - v_old, -clip, clip)
    vf = 0.5 * torch.maximum((v - ret) ** 2, (v_clip - ret) ** 2).mean()
    total = pg.mean() + vf_coef * vf - ent_coef * networks.entropy(
        net.log_std)
    approx_kl = ((ratio - 1.0) - log_ratio).mean()
    return total, approx_kl


@torch.no_grad()
def clipped_adam(params, grads, loss, mu, nu, count, lr, max_norm):
    """Global-norm clipping, Adam, then -lr, in place on ``params``,
    ``mu``, ``nu`` and the () update ``count``, all skipped unless the
    loss and every gradient are finite; returns the clipped gradients,
    the ones Adam took."""
    ok = torch.isfinite(loss)
    for g in grads:
        ok = ok & torch.isfinite(g).all()
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm < max_norm
    grads = [torch.where(clip, g, g / norm * max_norm) for g in grads]
    step = count + 1.0
    bc1 = 1.0 - torch.pow(ADAM_B1, step)
    bc2 = 1.0 - torch.pow(ADAM_B2, step)
    for p, g, m, v in zip(params, grads, mu, nu):
        m2 = (1.0 - ADAM_B1) * g + ADAM_B1 * m
        v2 = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * v
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
        p.copy_(torch.where(ok, p + (-upd) * lr, p))
        m.copy_(torch.where(ok, m2, m))
        v.copy_(torch.where(ok, v2, v))
    count.copy_(torch.where(ok, step, count))
    return grads


def ppo_update(snap: dict, cfg_train: dict, net_shape: dict, device,
               fault: Optional[str] = None) -> dict:
    """One update from the copies taken before the port's: the minibatch
    losses, the first minibatch's clipped gradient, the weights after and
    the lr after."""
    device = torch.device(device)
    learn = cfg_train["learn"]
    epochs, nmb = int(learn["noptepochs"]), int(learn["nminibatches"])
    gamma, lam = float(learn["gamma"]), float(learn["lam"])
    clip = float(learn["cliprange"])
    vf_coef = float(learn.get("value_loss_coef", 1.0))
    ent_coef = float(learn.get("ent_coef", 0.0))
    net = actor_critic(net_shape, cfg_train.get("policy", {}),
                       snap["params"], device)
    params = list(net.parameters())
    mu = [m.to(device).clone() for m in snap["adam_mu"]]
    nu = [v.to(device).clone() for v in snap["adam_nu"]]
    count = snap["adam_count"].to(device).clone()
    lr = snap["lr"].to(device).clone()
    tr = {k: v.to(device) for k, v in snap["traj"].items()}
    steps, envs = tr["val"].shape
    n = steps * envs
    mb = n // nmb
    gen = _generator(snap["gen"], device)
    perms = torch.stack([torch.randperm(n, generator=gen, device=device)
                         for _ in range(epochs)])
    rows = perms[:, :nmb * mb].reshape(epochs * nmb, mb)
    with torch.no_grad():
        advs = gae(tr["val"], tr["rew"], tr["done"],
                   snap["last_val"].to(device), gamma, lam)
        adv = advs.reshape(n)
        data = {k: tr[k].reshape((n,) + tr[k].shape[2:])
                for k in tr if k not in ("rew", "done")}
        data["adv"] = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        data["ret"] = (advs + tr["val"]).reshape(n)
    losses, kls, first = [], [], None
    for t in range(epochs * nmb):
        ids = rows[t]
        if fault == "half":
            ids = ids[:mb // 2]
        total, kl = ppo_loss(net, {k: v[ids] for k, v in data.items()},
                             clip, vf_coef, ent_coef)
        grads = torch.autograd.grad(total, params)
        grads = clipped_adam(params, grads, total.detach(), mu, nu, count,
                             lr, float(learn["max_grad_norm"]))
        if first is None:
            first = [g.detach().clone() for g in grads]
        losses.append(float(total.detach()))
        kls.append(kl.detach())
        if fault == "altered" and t == 0:
            losses[0] += abs(losses[0])
    desired = learn.get("desired_kl")
    schedule = learn.get("schedule", "adaptive" if desired else "fixed")
    if schedule == "adaptive" and desired is not None:
        kl_last = torch.stack(kls[-nmb:]).mean()
        kl = float(desired)
        lr = torch.where(kl_last > kl * 2.0, torch.clamp(lr / 1.5, min=1e-6),
                         lr)
        lr = torch.where(kl_last < kl / 2.0, torch.clamp(lr * 1.5, max=1e-2),
                         lr)
    return {"losses": losses, "grad": first,
            "params_after": [p.detach().clone() for p in params],
            "lr_after": float(lr)}


# ---------------------------------------------------------------------- #
# MDN.
# ---------------------------------------------------------------------- #
def mdn_net(in_dim: int, D: int, K: int, hidden: Sequence[int], params,
            device):
    net = fmdnn.MDNNNet(in_dim, D, K, hidden, full_covariance=False,
                        activation="tanh").to(device)
    with torch.no_grad():
        for p, q in zip(net.parameters(), params):
            p.copy_(q.to(device))
    return net


def summaries(summarizer: str, states, actions, device):
    fn = get_summarizer(summarizer)
    return fn(torch.as_tensor(states, dtype=torch.float32, device=device),
              torch.as_tensor(actions, dtype=torch.float32, device=device))


def mdn_fit(snap: dict, model: dict, device,
            fault: Optional[str] = None) -> dict:
    """One fit from the copies taken before the port's. ``model`` gives
    ``summarizer``, ``components``, ``hidden``, ``lr``, ``lows`` and
    ``highs``. A "main" fit summarizes the chunk's states and actions
    itself; a "refit" takes the inputs and labels it was given."""
    device = torch.device(device)
    if snap["kind"] == "main":
        x = summaries(model["summarizer"], snap["states"], snap["actions"],
                      device)
        y = snap["labels"].to(device, torch.float32)
        ok = torch.isfinite(x).all(dim=1) & torch.isfinite(y).all(dim=1)
        x, y = x[ok], y[ok]
        hidden = model["hidden"]
    else:
        x = snap["x"].to(device, torch.float32)
        y = snap["y"].to(device, torch.float32)
        hidden = (128, 128)
    lows = torch.as_tensor(model["lows"], dtype=torch.float32, device=device)
    highs = torch.as_tensor(model["highs"], dtype=torch.float32,
                            device=device)
    y = (y - lows) / (highs - lows)
    K, D = int(model["components"]), y.shape[1]
    net = mdn_net(x.shape[1], D, K, hidden, snap["params"], device)
    params = list(net.parameters())
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    count = torch.zeros((), device=device)
    lr = float(model["lr"])
    n_tot = x.shape[0]
    n_train = max(int(n_tot * (1.0 - snap["test_frac"])), 1)
    x_train, y_train = x[:n_train], y[:n_train]
    x_test, y_test = ((x[n_train:], y[n_train:]) if n_train < n_tot
                      else (x[:n_train], y[:n_train]))
    gen = _generator(snap["gen"], device)
    batch, n_up = snap["batch_size"], snap["n_updates"]

    def noise(rows):
        return torch.rand((rows, D, K), generator=gen, device=device)

    def test_loss():
        with torch.no_grad():
            return float(fmdnn.mdn_loss(*net(x_test, noise(x_test.shape[0])),
                                        y_test))
    n_evals = min(5, n_up)
    bounds = [i * n_up // n_evals for i in range(n_evals + 1)]
    losses, tests, first = [], [], None
    for s in range(n_evals):
        tests.append(test_loss())
        for _ in range(bounds[s], bounds[s + 1]):
            ids = torch.randint(0, n_train, (batch,), generator=gen,
                                device=device)
            jitter = noise(batch)
            if fault == "half":
                ids, jitter = ids[:batch // 2], jitter[:batch // 2]
            loss = fmdnn.mdn_loss(*net(x_train[ids], jitter), y_train[ids])
            grads = torch.autograd.grad(loss, params)
            if first is None:
                first = [g.detach().clone() for g in grads]
            fmdnn.adam_step(params, grads, mu, nu, count, lr)
            losses.append(float(loss.detach()))
            if fault == "altered" and len(losses) == 1:
                losses[0] += abs(losses[0])
    tests.append(test_loss())
    return {"losses": losses, "test_losses": tests, "grad": first,
            "params_after": [p.detach().clone() for p in params]}


def mixtures(call: dict, x, model: dict, device) -> List[Dict]:
    """``predict_MoGs`` at rows ``x``: the weights, means and standard
    deviations of each row's mixture, in the labels' own units."""
    device = torch.device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    lows = np.asarray(model["lows"], np.float32)
    rng = (np.asarray(model["highs"], np.float32) - lows).astype(np.float64)
    K = int(model["components"])
    D = len(lows)
    hidden = model["hidden"] if call["kind"] == "main" else (128, 128)
    net = mdn_net(x.shape[1], D, K, hidden, call["params"], device)
    gen = _generator(call["gen"], device)
    noise = torch.rand((x.shape[0], D, K), generator=gen, device=device)
    with torch.no_grad():
        w, mu, l_d, _ = net(x, noise)
    w = w.double().cpu().numpy()
    mu = mu.double().cpu().numpy()
    l_d = l_d.double().cpu().numpy()
    out = []
    for r in range(x.shape[0]):
        out.append({"a": w[r],
                    "m": mu[r].T * rng + lows,
                    "std": np.abs(l_d[r].T * rng)})
    return out


def std_of(mog: dict) -> np.ndarray:
    return np.sqrt(np.maximum(np.diagonal(mog["S"], axis1=1, axis2=2), 0.0))

