"""Generalized (scrambled) Halton quasi-random sequences.

Replaces the ``ghalton`` C++ dependency of the reference
(``bayes_sim_ig/models/rff.py:114-117``,
``utils/pdf.py:121-123,302-305``). The reference uses ``ghalton.EA_PERMS``
(evolutionary-search-optimized digit permutations); we use deterministic
digit-permutation scrambling seeded per base, which has the same role:
breaking the strong correlations of the plain Halton sequence in higher
dimensions. Sequences are deterministic across runs.

All call sites in this framework are host-side, one-shot initializations
(RFF frequency draws, quasi-random sampling of host distributions), so this
is vectorized numpy. The native C generator (``ops/native/halton.c``,
built by ``python setup.py build_ext --inplace``) is used when built, with
this as the reference implementation and fallback.
"""

from __future__ import annotations

import numpy as np

# First 100 primes — supports up to 100-dim sequences (the reference only
# uses quasi-random RFF draws when input_dim <= 100, mdrff.py:23).
_PRIMES = [
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139, 149,
    151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199, 211, 223, 227, 229,
    233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283, 293, 307, 311, 313,
    317, 331, 337, 347, 349, 353, 359, 367, 373, 379, 383, 389, 397, 401, 409,
    419, 421, 431, 433, 439, 443, 449, 457, 461, 463, 467, 479, 487, 491, 499,
    503, 509, 521, 523, 541,
]


_PERM_CACHE: dict = {}


def _permutation_for_base(base: int) -> np.ndarray:
    """Deterministic scrambling permutation of digits {0..base-1}.

    Fixes sigma(0)=0 so that the point 0 stays representable and the
    sequence remains a (0, 1)-net-like low-discrepancy sequence.
    Memoized — permutation generation otherwise dominates the native
    generator's runtime.
    """
    cached = _PERM_CACHE.get(base)
    if cached is None:
        rng = np.random.default_rng(base)
        perm = 1 + rng.permutation(base - 1)
        cached = np.concatenate([[0], perm])
        _PERM_CACHE[base] = cached
    return cached


def _radical_inverse(indices: np.ndarray, base: int,
                     perm: np.ndarray | None = None) -> np.ndarray:
    """Vectorized (scrambled) radical inverse of ``indices`` in ``base``."""
    indices = np.asarray(indices, dtype=np.int64)
    n_digits = max(1, int(np.ceil(np.log(indices.max() + 1) / np.log(base))))
    result = np.zeros(indices.shape, dtype=np.float64)
    inv_base = 1.0 / base
    scale = inv_base
    rest = indices.copy()
    for _ in range(n_digits):
        digit = rest % base
        if perm is not None:
            digit = perm[digit]
        result += digit * scale
        scale *= inv_base
        rest //= base
    return result


try:  # Optional native (C) generator, ops/native/halton.c.
    from ..ops.native import _halton_native
except ImportError:  # pragma: no cover - extension not built
    _halton_native = None


def _halton_native_sequence(n_samples, dim, skip, scramble):
    perms = np.concatenate([
        (_permutation_for_base(_PRIMES[d]) if scramble
         else np.arange(_PRIMES[d])).astype(np.int32)
        for d in range(dim)])
    raw = _halton_native.halton_fill(dim, n_samples, skip,
                                     perms.tobytes())
    return np.frombuffer(raw, np.float64).reshape(n_samples, dim).copy()


def halton_sequence(n_samples: int, dim: int, skip: int = 1,
                    scramble: bool = True) -> np.ndarray:
    """Generates ``n_samples`` points of a ``dim``-dimensional generalized
    Halton sequence in the open unit cube.

    ``skip=1`` drops the initial all-zeros point, matching the reference's
    ``sequencer.get(n + 1)[1:]`` convention (rff.py:116, pdf.py:123).
    Uses the native C generator (ops/native/halton.c) when built; the
    numpy path below is the reference implementation and fallback.
    """
    if dim > len(_PRIMES):
        raise ValueError(f"halton_sequence supports dim <= {len(_PRIMES)}, "
                         f"got {dim}")
    if _halton_native is not None:
        return _halton_native_sequence(n_samples, dim, skip, scramble)
    indices = np.arange(skip, skip + n_samples, dtype=np.int64)
    out = np.empty((n_samples, dim), dtype=np.float64)
    for d in range(dim):
        base = _PRIMES[d]
        perm = _permutation_for_base(base) if scramble else None
        out[:, d] = _radical_inverse(indices, base, perm)
    return out
