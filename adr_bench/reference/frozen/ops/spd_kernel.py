# Frozen copy of bayes_sim_ig_tpu_torch/ops/spd_kernel.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Batched small SPD factor and solve in the env-last ("lanes") layout.

Port of ``bayes_sim_ig_tpu/ops/spd_kernel.py``. N independent n x n SPD
systems, one per env, are held as At (n, n, N) with the env index last;
right-hand sides are (n, N) or (K, n, N). The physics factors its mass
matrix once per env step (``spd_factor_lanes``) and substitutes on every
substep and for every extra right-hand side (``spd_substitute_lanes``).

On a CUDA tensor each entry point launches the hand-written kernel of
``csrc/spd_lanes.cu``; on a CPU tensor it runs the plain PyTorch version
below (``_chol_lanes_factor``, ``_chol_lanes_substitute``,
``_chol_lanes_core``). There is no fallback: a CUDA tensor the kernel
does not take raises, and so does a failed build or launch.

The factor is a column Cholesky, as the JAX package's physics path. Its
opt-in Pallas kernel (``_pallas_lanes``) solves by Gauss elimination
instead; both give the same x for SPD input up to rounding, but only the
Cholesky gives a factor that can be reused and the NaN-pivot policy: a
pivot that is not > 0 makes that env's solution NaN, which the env
step's non-finite quarantine then resets.
"""

from __future__ import annotations

import torch

# Kernel launches made by this process, by entry point; read and reset by
# callers that must show a run went through the kernels.
LAUNCHES = {"factor": 0, "substitute": 0, "solve": 0}

MAX_N = 32  # csrc/spd_lanes.cu MAX_N
_MAX_RHS = 65535  # gridDim.y limit of the substitute launch

_FNS = None


# --------------------------------------------------------------------- #
# Plain PyTorch versions (the CPU path and the kernels' reference).
# --------------------------------------------------------------------- #
def _chol_lanes_factor(At: torch.Tensor) -> torch.Tensor:
    """Column Cholesky in lanes layout: At (n, n, N) SPD -> Lt (n, n, N)
    with Lt[k] holding column k of L (zeros above the diagonal). A pivot
    that is not > 0, NaN included, gives NaN."""
    n = At.shape[0]
    cols = []
    rows = torch.arange(n, device=At.device)[:, None]
    for j in range(n):
        raw = At[:, j]
        if j:
            built = torch.stack(cols)                      # (j, n, N)
            raw = raw - (built[:, j][:, None] * built).sum(0)
        d = torch.where(raw[j] > 0.0,
                        torch.sqrt(torch.clamp(raw[j], min=1e-30)),
                        torch.full_like(raw[j], float("nan")))
        cols.append(torch.where(rows >= j, raw / d, torch.zeros_like(raw)))
    return torch.stack(cols)


def _chol_lanes_substitute(Lt: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Forward and back substitution against a ``_chol_lanes_factor``
    result: Lt (n, n, N) and bt (n, N) or (K, n, N) -> x, shaped as bt."""
    n = Lt.shape[0]
    y = []
    for i in range(n):
        acc = bt[..., i, :]
        if i:
            acc = acc - (Lt[:i, i] * torch.stack(y, -2)).sum(-2)
        y.append(acc / Lt[i, i])
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = y[i]
        if i < n - 1:
            acc = acc - (Lt[i, i + 1:] * torch.stack(x[i + 1:], -2)).sum(-2)
        x[i] = acc / Lt[i, i]
    return torch.stack(x, -2)


def _chol_lanes_core(At: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Factor + substitute in one call (the two halves above)."""
    return _chol_lanes_substitute(_chol_lanes_factor(At), bt)


class _SolveLanes(torch.autograd.Function):
    """x = A^-1 b with the JAX package's Pallas VJP (``_pallas_bwd``):
    y = A^-1 g, through the same solve (A is symmetric), then
    dA = -y x^T per env and db = y."""

    @staticmethod
    def forward(ctx, At, bt):
        x = _chol_lanes_core(At, bt)
        ctx.save_for_backward(At, x)
        return x

    @staticmethod
    def backward(ctx, g):
        At, x = ctx.saved_tensors
        y = _chol_lanes_core(At, g)
        return -y[:, None, :] * x[None, :, :], y


# --------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------- #
def spd_solve_lanes(At: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b in lanes layout: At (n, n, N), bt (n, N) -> (n, N).
    Differentiable in At and bt."""
    return _SolveLanes.apply(At, bt)


def spd_factor_lanes(At: torch.Tensor):
    """Factorizes At (n, n, N) once for reuse against several right-hand
    sides through ``spd_substitute_lanes``; returns ("chol_lanes", Lt)."""
    return ("chol_lanes", _chol_lanes_factor(At))


def spd_substitute_lanes(factor, bt: torch.Tensor) -> torch.Tensor:
    """Solves against an ``spd_factor_lanes`` result: bt (n, N) or
    (K, n, N) -> x shaped as bt."""
    kind, Lt = factor
    if kind != "chol_lanes":
        raise ValueError(f"unknown SPD factor kind {kind!r}")
    return _chol_lanes_substitute(Lt, bt)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for batched small SPD systems in the standard layout:
    A (..., n, n), b (..., n) -> (..., n)."""
    batch = b.shape[:-1]
    n = b.shape[-1]
    At = A.reshape(-1, n, n).permute(1, 2, 0)
    bt = b.reshape(-1, n).T
    return spd_solve_lanes(At, bt).T.reshape(batch + (n,))
