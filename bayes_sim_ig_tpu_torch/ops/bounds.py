"""Least time an H100 could take for each kernel's work (roofline bound).

A kernel's bound is the larger of two times: the bytes its function must
move (each input it needs read once, each output written once) over the
card's memory rate, and its floating-point operations over the card's
float32 rate outside the tensor cores (these kernels do not use them).
The counts come from the shapes alone: ``chip_smoke.py`` prints each
kernel's bound beside its measured time.

Counting rules, per env unless stated:
  * SPD factor (n, N): reads the lower triangle of A, n (n + 1) / 2
    floats, and writes all of Lt, n^2 floats (the zeros above the diagonal
    are part of the output); n (n^2 - 1) / 6 multiply-adds (2 FLOPs each),
    n (n - 1) / 2 divides and n square roots (1 each).
  * SPD substitute (n, K, N): reads the lower triangle of L, and b, writes
    x (K n floats each); per right-hand side n (n - 1) multiply-adds and 2 n
    divides. The fused solve reads A's lower triangle and b, writes x, and
    does both counts.
  * Tree factor (E pairs, nv dofs, N): reads M (E floats), writes H (E)
    and D (nv); sum_k dk (dk + 1) / 2 multiply-adds and divides (one
    divide an update, as ltdl_factor) and sum_k dk divides more.
  * Tree substitute (K right-hand sides): reads the E - nv off-diagonal
    pairs of H once, D and b, writes x; per right-hand side 2 (E - nv)
    multiply-adds and nv divides.
  * Tree half-solves, L^-T (upsolve) or L^-1 (downsolve), K right-hand
    sides: read the off-diagonal pairs of H once and b, write x; per
    right-hand side E - nv multiply-adds.
  * RFF (B, d, m): reads x (B d) and coeff (d m), writes (B, 2m); 2 B d m
    FLOPs of the product plus 4 B m (a cos, a sin and two scalings,
    counted as one FLOP each, the floor of their cost).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# NVIDIA H100 SXM data sheet (at its 700 W limit): HBM3 rate, and the
# dense float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
_F32 = 4


@dataclass(frozen=True)
class Bound:
    bytes: int
    flops: int

    @property
    def ms(self) -> float:
        """max(bytes / memory rate, FLOPs / float32 rate), in ms."""
        return 1e3 * max(self.bytes / HBM_BYTES_PER_S,
                         self.flops / F32_FLOPS_PER_S)

    @property
    def by(self) -> str:
        """"bytes" or "operations": which of the two times is larger."""
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.flops / F32_FLOPS_PER_S else "operations")


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def spd_factor(n: int, N: int) -> Bound:
    flops = 2 * (n * (n * n - 1) // 6) + n * (n - 1) // 2 + n
    return Bound(_F32 * N * (_tri(n) + n * n), N * flops)


def spd_substitute(n: int, N: int, K: int = 1) -> Bound:
    flops = K * (2 * n * (n - 1) + 2 * n)
    return Bound(_F32 * N * (_tri(n) + 2 * K * n), N * flops)


def spd_solve(n: int, N: int) -> Bound:
    f, s = spd_factor(n, N), spd_substitute(n, N)
    return Bound(_F32 * N * (_tri(n) + 2 * n), f.flops + s.flops)


def tree_factor(chains: Sequence[Sequence[int]], N: int) -> Bound:
    nv = len(chains)
    E = nv + sum(len(c) for c in chains)
    updates = sum(_tri(len(c)) for c in chains)
    flops = 3 * updates + (E - nv)
    return Bound(_F32 * N * (2 * E + nv), N * flops)


def tree_substitute(chains: Sequence[Sequence[int]], N: int,
                    K: int = 1) -> Bound:
    nv = len(chains)
    off_diag = sum(len(c) for c in chains)
    return Bound(_F32 * N * (off_diag + nv + 2 * K * nv),
                 N * K * (4 * off_diag + nv))


def tree_half_solve(chains: Sequence[Sequence[int]], N: int,
                    K: int = 1) -> Bound:
    off_diag = sum(len(c) for c in chains)
    nv = len(chains)
    return Bound(_F32 * N * (off_diag + 2 * K * nv), N * K * 2 * off_diag)


def rff_features(B: int, d: int, m: int) -> Bound:
    return Bound(_F32 * (B * d + d * m + 2 * B * m), 2 * B * d * m + 4 * B * m)
