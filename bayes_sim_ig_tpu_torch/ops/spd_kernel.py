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

from .launch import check_cuda, launch, on_cpu

MAX_N = 32  # csrc/spd_lanes.cu MAX_N
_MAX_RHS = 65535  # gridDim.y limit of the substitute launch


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


# --------------------------------------------------------------------- #
# The CUDA kernels.
# --------------------------------------------------------------------- #
def _check_systems(name, At):
    if At.ndim != 3 or At.shape[0] != At.shape[1]:
        raise ValueError(f"{name} needs At (n, n, N), got {tuple(At.shape)}")
    n = At.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name} takes n <= {MAX_N}, got n = {n}")


def spd_factor_lanes_cuda(At: torch.Tensor) -> torch.Tensor:
    """Launches the factor kernel: At (n, n, N) -> Lt (n, n, N)."""
    check_cuda("spd_factor_lanes_cuda", At)
    _check_systems("spd_factor_lanes_cuda", At)
    At = At.contiguous()  # the physics hands in transposed views
    n, _, N = At.shape
    Lt = torch.empty_like(At)
    launch("spd_factor_lanes", At.device, At.data_ptr(), Lt.data_ptr(), n, N)
    return Lt


def spd_substitute_lanes_cuda(Lt: torch.Tensor,
                              bt: torch.Tensor) -> torch.Tensor:
    """Launches the substitute kernel: Lt (n, n, N), bt (n, N) or
    (K, n, N) -> x shaped as bt."""
    check_cuda("spd_substitute_lanes_cuda", Lt, bt)
    _check_systems("spd_substitute_lanes_cuda", Lt)
    n, _, N = Lt.shape
    if bt.shape[-2:] != (n, N) or bt.ndim not in (2, 3):
        raise ValueError(f"spd_substitute_lanes_cuda needs bt (n, N) or "
                         f"(K, n, N) with (n, N) = {(n, N)}, got "
                         f"{tuple(bt.shape)}")
    k = bt.shape[0] if bt.ndim == 3 else 1
    if k > _MAX_RHS:
        raise ValueError(f"spd_substitute_lanes_cuda takes at most "
                         f"{_MAX_RHS} right-hand sides, got {k}")
    Lt, bt = Lt.contiguous(), bt.contiguous()
    xt = torch.empty_like(bt)
    launch("spd_substitute_lanes", Lt.device, Lt.data_ptr(), bt.data_ptr(),
           xt.data_ptr(), n, k, N)
    return xt


def spd_solve_lanes_cuda(At: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """Launches the fused factor + substitute kernel: At (n, n, N), bt
    (n, N) -> (n, N)."""
    check_cuda("spd_solve_lanes_cuda", At, bt)
    _check_systems("spd_solve_lanes_cuda", At)
    n, _, N = At.shape
    if tuple(bt.shape) != (n, N):
        raise ValueError(f"spd_solve_lanes_cuda needs bt {(n, N)}, got "
                         f"{tuple(bt.shape)}")
    At, bt = At.contiguous(), bt.contiguous()
    xt = torch.empty_like(bt)
    launch("spd_solve_lanes", At.device, At.data_ptr(), bt.data_ptr(),
           xt.data_ptr(), n, N)
    return xt


def _solve_lanes(At, bt):
    if on_cpu(At, bt):
        return _chol_lanes_core(At, bt)
    return spd_solve_lanes_cuda(At, bt)


class _SolveLanes(torch.autograd.Function):
    """x = A^-1 b with the JAX package's Pallas VJP (``_pallas_bwd``):
    y = A^-1 g, through the same solve (A is symmetric), then
    dA = -y x^T per env and db = y."""

    @staticmethod
    def forward(ctx, At, bt):
        x = _solve_lanes(At, bt)
        ctx.save_for_backward(At, x)
        return x

    @staticmethod
    def backward(ctx, g):
        At, x = ctx.saved_tensors
        y = _solve_lanes(At, g)
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
    if on_cpu(At):
        return ("chol_lanes", _chol_lanes_factor(At))
    return ("chol_lanes", spd_factor_lanes_cuda(At))


def spd_substitute_lanes(factor, bt: torch.Tensor) -> torch.Tensor:
    """Solves against an ``spd_factor_lanes`` result: bt (n, N) or
    (K, n, N) -> x shaped as bt."""
    kind, Lt = factor
    if kind != "chol_lanes":
        raise ValueError(f"unknown SPD factor kind {kind!r}")
    if on_cpu(Lt, bt):
        return _chol_lanes_substitute(Lt, bt)
    return spd_substitute_lanes_cuda(Lt, bt)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for batched small SPD systems in the standard layout:
    A (..., n, n), b (..., n) -> (..., n)."""
    batch = b.shape[:-1]
    n = b.shape[-1]
    At = A.reshape(-1, n, n).permute(1, 2, 0)
    bt = b.reshape(-1, n).T
    return spd_solve_lanes(At, bt).T.reshape(batch + (n,))
