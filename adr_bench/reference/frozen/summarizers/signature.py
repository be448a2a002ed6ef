# Frozen copy of bayes_sim_ig_tpu_torch/summarizers/signature.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Truncated path signatures in PyTorch (port of
``bayes_sim_ig_tpu/summarizers/signature.py``).

The signature of a path x: [0,T] -> R^d truncated at depth m is the
concatenation of iterated integrals of levels 1..m (sizes d, d^2, ..., d^m).
For the piecewise-linear paths used here it satisfies Chen's relation
S(x) = exp(dx_1) (x) exp(dx_2) (x) ... in the truncated tensor algebra,
where dx_t are the path increments. Each level is a closed form over
exclusive prefix sums of the increments, so every level is one batched
einsum:

  L1 = sum_t dx_t
  L2 = sum_t c_{t-1} (x) dx_t + 1/2 sum_t dx_t (x) dx_t
  L3 = sum_t L2prefix_{t-1} (x) dx_t + 1/2 sum_t c_{t-1} (x) dx_t (x) dx_t
       + 1/6 sum_t dx_t (x) dx_t (x) dx_t

with c_t the exclusive prefix sum of increments and L2prefix the running
level-2 (a cumulative sum of outer products). Depths are capped at 3
(``signature_depth``). Differentiable through autograd.
"""

from __future__ import annotations

import torch

MAX_SIGNATURE_OUTPUT_DIM = 110 ** 2

# Large batches are processed in fixed-size chunks: the depth-3 path
# materializes a (chunk, T, d, d) prefix-sum intermediate.
SIGNATURE_CHUNK = 1024


def signature_depth(ndim: int) -> int:
    """Largest depth in {3, 2} with ndim^depth <= 110^2, else 1."""
    for depth in (3, 2):
        if ndim ** depth <= MAX_SIGNATURE_OUTPUT_DIM:
            return depth
    return 1


def path_signature(paths: torch.Tensor, depth: int,
                   chunk_size: int = SIGNATURE_CHUNK) -> torch.Tensor:
    """Computes truncated signatures for a batch of paths.

    Parameters
    ----------
    paths : (batch, path_len, d) tensor
    depth : truncation depth in {1, 2, 3}
    chunk_size : batches larger than this are processed in equal
        zero-padded chunks to bound the (chunk, T, d, d) peak memory.

    Returns
    -------
    (batch, d + d^2 + ... + d^depth) tensor — levels concatenated in
    signatory's layout (level 1 first, row-major within each level).
    """
    assert paths.ndim == 3, "paths should be batch x time x channels"
    assert depth in (1, 2, 3), f"depth must be 1, 2 or 3, got {depth}"
    bsz = paths.shape[0]
    if bsz > chunk_size:
        n_chunks = -(-bsz // chunk_size)
        pad = n_chunks * chunk_size - bsz
        padded = paths if pad == 0 else torch.cat(
            [paths, paths.new_zeros((pad,) + tuple(paths.shape[1:]))])
        sigs = [_signature_impl(chunk, depth)
                for chunk in padded.split(chunk_size)]
        return torch.cat(sigs)[:bsz]
    return _signature_impl(paths, depth)


def _signature_impl(paths: torch.Tensor, depth: int) -> torch.Tensor:
    dx = paths[:, 1:] - paths[:, :-1]  # (B, T, d) increments
    bsz = dx.shape[0]

    lvl1 = dx.sum(dim=1)  # (B, d)
    out = [lvl1]
    if depth >= 2:
        # Exclusive prefix sums c_{t-1} = sum_{i<t} dx_i.
        c_excl = torch.cumsum(dx, dim=1) - dx  # (B, T, d)
        lvl2 = (torch.einsum("bti,btj->bij", c_excl, dx)
                + 0.5 * torch.einsum("bti,btj->bij", dx, dx))
        out.append(lvl2.reshape(bsz, -1))
    if depth >= 3:
        # Running level-2 after each step, exclusive: L2prefix_{t-1}.
        step_l2 = (torch.einsum("bti,btj->btij", c_excl, dx)
                   + 0.5 * torch.einsum("bti,btj->btij", dx, dx))
        l2_excl = torch.cumsum(step_l2, dim=1) - step_l2  # (B, T, d, d)
        lvl3 = (torch.einsum("btij,btk->bijk", l2_excl, dx)
                + 0.5 * torch.einsum("bti,btj,btk->bijk", c_excl, dx, dx)
                + (1.0 / 6.0) * torch.einsum("bti,btj,btk->bijk",
                                             dx, dx, dx))
        out.append(lvl3.reshape(bsz, -1))
    return torch.cat(out, dim=-1)
