"""Work counted from shapes for the SPD kernels: the least time an H100
could take for an env step's dense mass-matrix solves.

A frozen copy of ``bayes_sim_ig_tpu_torch/ops/bounds.py::spd_solve`` and
``spd_substitute`` (commit 548ed0a), beside ``counts.py``'s tree rules, so
that a later change there cannot move this yardstick. A kernel's bound is
the larger of its bytes over the card's memory rate and its FLOPs over
the float32 rate outside the tensor cores (``counts.Bound``), per env:

  * solve (n dofs, K right-hand sides), a factor and the substitute that
    follows it: reads the lower triangle of A, n (n + 1) / 2 floats, and
    b, writes x (K n floats each); the factor's n (n^2 - 1) / 6
    multiply-adds (2 FLOPs each), n (n - 1) / 2 divides and n square
    roots (1 each), and per right-hand side n (n - 1) multiply-adds and
    2 n divides. At K = 1 it is ``ops/bounds.py::spd_solve``;
  * substitute against a factor carried from an earlier call: reads the
    lower triangle of L, and b, writes x; the substitute's FLOPs.

The factor L is no output a step needs: a step's least work is one solve
a factor, and a substitute alone for each right-hand side beyond. It
counts that work, whatever kernels do it, so the port's factor and
substitute kernels, or one fused kernel, are read against the same
yardstick.
"""

from __future__ import annotations

from typing import Dict, Sequence

from .counts import _F32, Bound, _tri


def _factor_flops(n: int) -> int:
    return 2 * (n * (n * n - 1) // 6) + n * (n - 1) // 2 + n


def _substitute_flops(n: int, K: int) -> int:
    return K * (2 * n * (n - 1) + 2 * n)


def spd_solve(n: int, N: int, K: int = 1) -> Bound:
    return Bound(_F32 * N * (_tri(n) + 2 * K * n),
                 N * (_factor_flops(n) + _substitute_flops(n, K)))


def spd_substitute(n: int, N: int, K: int = 1) -> Bound:
    return Bound(_F32 * N * (_tri(n) + 2 * K * n),
                 N * _substitute_flops(n, K))


def spd_step_seconds(N: int, calls: Sequence[Dict]) -> float:
    """The least seconds one env step's dense solves take at N envs.
    ``calls`` lists the step's calls as {"kind": "factor" or "substitute",
    "count", "n", "K"} (the configuration file's ``spd_solves_per_step``):
    each factor and a substitute of its n are one solve, the other
    substitutes are substitutes."""
    factors: Dict[int, int] = {}
    for c in calls:
        if c["kind"] == "factor":
            n = int(c["n"])
            factors[n] = factors.get(n, 0) + int(c["count"])
    total = 0.0
    for c in calls:
        if c["kind"] != "substitute":
            continue
        n, K, count = int(c["n"]), int(c.get("K", 1)), int(c["count"])
        solves = min(count, factors.get(n, 0))
        factors[n] = factors.get(n, 0) - solves
        total += (solves * spd_solve(n, N, K).seconds
                  + (count - solves) * spd_substitute(n, N, K).seconds)
    return total
