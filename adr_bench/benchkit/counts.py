"""Work counted from shapes: the least time an H100 could take for the
tree L^T D L solves, and the FLOPs of the networks.

The tree rules are a frozen copy of ``bayes_sim_ig_tpu_torch/ops/
bounds.py`` (commit 57f9c0d), so that a later change there cannot move
this yardstick. A kernel's bound is the larger of its bytes over the
card's memory rate and its FLOPs over the float32 rate outside the tensor
cores:

  * factor (E ancestor pairs with the diagonal, nv dofs, N envs): reads
    M (E floats), writes H (E) and D (nv); sum_k dk (dk + 1) / 2
    multiply-adds and divides (3 FLOPs each) and E - nv divides more;
  * substitute (K right-hand sides): reads the E - nv off-diagonal pairs
    of H, D and b, writes x; per right-hand side 2 (E - nv) multiply-adds
    and nv divides;
  * half-solves, L^-T (upsolve) or L^-1 (downsolve): read the
    off-diagonal pairs of H and b, write x; per right-hand side E - nv
    multiply-adds.

Network FLOPs count the matrix products only (2 per multiply-add), not
biases, activations or elementwise loss terms: a forward pass over
``rows`` rows of an MLP is 2 x rows x sum(fan_in x fan_out). A training
pass is the forward, the weights' gradients (as many again) and the
inputs' gradients of every layer but the first (the data needs none).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet, at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12   # TF32 on the tensor cores, dense
_F32 = 4


@dataclass(frozen=True)
class Bound:
    bytes: int
    flops: int

    @property
    def seconds(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.flops / F32_FLOPS_PER_S)


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def tree_factor(chains: Sequence[Sequence[int]], N: int) -> Bound:
    nv = len(chains)
    E = nv + sum(len(c) for c in chains)
    updates = sum(_tri(len(c)) for c in chains)
    return Bound(_F32 * N * (2 * E + nv), N * (3 * updates + (E - nv)))


def tree_substitute(chains: Sequence[Sequence[int]], N: int,
                    K: int = 1) -> Bound:
    nv = len(chains)
    off = sum(len(c) for c in chains)
    return Bound(_F32 * N * (off + nv + 2 * K * nv), N * K * (4 * off + nv))


def tree_half_solve(chains: Sequence[Sequence[int]], N: int,
                    K: int = 1) -> Bound:
    nv = len(chains)
    off = sum(len(c) for c in chains)
    return Bound(_F32 * N * (off + 2 * K * nv), N * K * 2 * off)


_SOLVES = {"factor": tree_factor, "substitute": tree_substitute,
           "upsolve": tree_half_solve, "downsolve": tree_half_solve}


def tree_step_seconds(chains, N: int, solves: Sequence[Dict]) -> float:
    """The least seconds one env step's tree solves take: the sum of each
    solve's bound. ``solves`` lists {"kind", "count", "K"} per the step's
    algorithm (the configuration file's ``tree_solves_per_step``)."""
    total = 0.0
    for s in solves:
        fn = _SOLVES[s["kind"]]
        args = (chains, N) if s["kind"] == "factor" else (
            chains, N, int(s.get("K", 1)))
        total += int(s["count"]) * fn(*args).seconds
    return total


# ---------------------------------------------------------------------- #
# Network FLOPs.
# ---------------------------------------------------------------------- #
def mlp_macs(sizes: Sequence[int]) -> int:
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def forward_flops(sizes: Sequence[int], rows: int) -> int:
    return 2 * rows * mlp_macs(sizes)


def train_flops(sizes: Sequence[int], rows: int) -> int:
    """Forward, weight gradients, and input gradients but the first
    layer's."""
    macs = mlp_macs(sizes)
    first = sizes[0] * sizes[1]
    return 2 * rows * (3 * macs - first)


@dataclass(frozen=True)
class ActorCritic:
    obs: int
    act: int
    pi: Sequence[int]
    vf: Sequence[int]
    critic_in: int  # obs, or the privileged state's width

    @property
    def actor(self):
        return [self.obs, *self.pi, self.act]

    @property
    def critic(self):
        return [self.critic_in, *self.vf, 1]


def ppo_iteration_flops(net: ActorCritic, envs: int, nsteps: int,
                        epochs: int) -> int:
    """One PPO iteration: the rollout's actor and critic forward at every
    step, the last value, and ``epochs`` training passes over the batch
    (nsteps x envs rows, cut into minibatches)."""
    rollout = nsteps * (forward_flops(net.actor, envs)
                        + forward_flops(net.critic, envs))
    last = forward_flops(net.critic, envs)
    rows = nsteps * envs
    update = epochs * (train_flops(net.actor, rows)
                       + train_flops(net.critic, rows))
    return rollout + last + update


def mdn_sizes(in_dim: int, hidden: Sequence[int], D: int, K: int):
    """The MDN's trunk and its three heads (weights, means, diagonal
    scales); the full-covariance head is not in these cells."""
    trunk = [in_dim, *hidden]
    heads = [(hidden[-1], K), (hidden[-1], D * K), (hidden[-1], D * K)]
    return trunk, heads


def mdn_forward_flops(in_dim, hidden, D, K, rows) -> int:
    trunk, heads = mdn_sizes(in_dim, hidden, D, K)
    return forward_flops(trunk, rows) + 2 * rows * sum(a * b
                                                       for a, b in heads)


def mdn_fit_flops(in_dim, hidden, D, K, batch, updates, test_rows,
                  evals=6) -> int:
    """``updates`` Adam updates on ``batch`` rows and ``evals`` test
    losses over ``test_rows`` rows."""
    trunk, heads = mdn_sizes(in_dim, hidden, D, K)
    head_macs = sum(a * b for a, b in heads)
    # Trunk trained as an MLP; the heads add their forward, their weight
    # gradients and their input gradients (into the trunk).
    per_update = (train_flops(trunk, batch)
                  + 2 * batch * 3 * head_macs)
    return (updates * per_update
            + evals * mdn_forward_flops(in_dim, hidden, D, K, test_rows))
