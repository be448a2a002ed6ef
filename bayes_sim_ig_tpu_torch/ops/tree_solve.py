"""Branch-sparse L^T D L factor and solve for articulated mass matrices,
env-last ("lanes") layout.

Port of ``bayes_sim_ig_tpu/ops/tree_solve.py``. The CRBA mass matrix of a
kinematic tree is nonzero only at the ancestor pairs of the expanded dof
tree (M[k, i] != 0 iff i is an ancestor-or-self of k), and with dofs
ordered so that parents precede children its M = L^T D L factor fills in
only at those same pairs (Featherstone, RBDA ch. 6). The solver touches
only the E ancestor pairs: Humanoid's 27 dofs have E = 243 of 378
lower-triangle entries.

Two forms of every function:
  * the JAX package's signatures (``ltdl_factor``, ``ltdl_factor_ll``,
    ``ltdl_substitute``, ``ltdl_upsolve``, ``ltdl_downsolve``,
    ``ltdl_solve``): chains plus a dict {(k, i): (.., N) row} of values at
    ``ancestor_pairs(chains)``; plain PyTorch on any device;
  * tensor form, for the physics and the kernel: pair values stacked as
    Mp (E, N) in ``ancestor_pairs`` order, the factor payload (H (E, N),
    D (nv, N)), right-hand sides (nv, N) or (K, nv, N). ``tree_factor``,
    ``tree_substitute`` and the half-solves ``tree_upsolve`` (L^-T) and
    ``tree_downsolve`` (L^-1) run the plain version on a CPU tensor and
    launch the hand-written kernels of ``csrc/tree_ltdl.cu`` (factor,
    substitute) and ``csrc/tree_half.cu`` (half-solves; both share
    ``csrc/tree_lanes.cuh``) on a CUDA tensor, with no fallback: a CUDA
    tensor the kernel does not take raises, and so does a failed build or
    launch.

NaN policy (as the JAX package's): a pivot that is not > 0 gives NaN in D,
in that env only, so an indefinite system surfaces through the env step's
non-finite quarantine. The L entries divide by the raw pivot.

H holds the factor at every pair: L[k, i] at the off-diagonal pairs and
the raw pivots on the diagonal; D holds the pivots under the NaN policy.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .launch import check_cuda, entry_fn, launch, on_cpu

# csrc/tree_ltdl.cu bounds: dofs, ancestor pairs, right-hand sides.
MAX_NV = 256
MAX_PAIRS = 1024
_MAX_RHS = 65535
# Lanes an env takes in the kernels (csrc/tree_ltdl.cu G: a half warp, two
# envs a warp), and the flags of a factor round's head: its height's last
# and first round (csrc LAST, FIRST).
GROUP = 16
_LAST_ROUND = 1 << 16
_FIRST_ROUND = 1 << 17
_BATCH = 8  # terms the factor kernel loads at once (csrc BATCH)
# csrc/tree_half.cu: envs a block (one warp wide), the most right-hand
# sides a block (TREE_HALF_KB), the fewest warps a block and the shared
# memory a block can use.
HALF_ENVS = 32
HALF_KB = 8
HALF_MIN_WARPS = 4
_SMEM_LIMIT = 232448

_TABLES: dict = {}


def ancestor_pairs(chains: Sequence[Sequence[int]]) -> List[Tuple[int, int]]:
    """All (k, i) with i an ancestor-or-self of k, k major order: (k, k)
    then (k, i) for i in ``chains[k]`` (model.dof_anc_chains: k's proper
    ancestors, leaf to root)."""
    pairs = []
    for k, ch in enumerate(chains):
        pairs.append((k, k))
        pairs.extend((k, i) for i in ch)
    return pairs


class TreeTables:
    """Static index tables of one dof tree, built once per chains list
    (``tree_tables``). Pairs of dof k occupy rows off[k] .. off[k+1]-1 of
    the stacked (E, N) layout: (k, k) first, then (k, chains[k][t]) at
    off[k] + 1 + t."""

    def __init__(self, chains: Sequence[Sequence[int]]):
        self.chains = [list(c) for c in chains]
        self.nv = nv = len(self.chains)
        self.pairs = ancestor_pairs(self.chains)
        self.E = len(self.pairs)
        self.index = {p: n for n, p in enumerate(self.pairs)}
        self.parent = [c[0] if c else -1 for c in self.chains]
        self.off = [self.index[(k, k)] for k in range(nv)] + [self.E]
        self.anc = [i for _, i in self.pairs]  # pair p = (k, anc[p])
        self.diag = self.off[:nv]
        self.mean_depth = sum(len(c) for c in self.chains) / max(nv, 1)
        # contributors[k] = [(c, t)] with k == chains[c][t] (the
        # left-looking form's descendants of k).
        self.contributors: List[List[Tuple[int, int]]] = [[] for _ in
                                                           range(nv)]
        for c in range(nv):
            for t, k in enumerate(self.chains[c]):
                self.contributors[k].append((c, t))
        # height[k]: the longest path from k down to a leaf.
        self.height = [0] * nv
        for c in range(nv - 1, -1, -1):
            for t, k in enumerate(self.chains[c]):
                self.height[k] = max(self.height[k], self.height[c] + 1 + t)
        # The layout the kernel walks: every parent precedes its child, and
        # every chain is its parent's chain behind the parent.
        self.tree_ordered = all(
            p < k and (p < 0 or ch[1:] == self.chains[p])
            for k, (p, ch) in enumerate(zip(self.parent, self.chains)))
        self._device: dict = {}

    def device_table(self, device):
        """The kernels' int32 table on ``device`` and its round counts:
        (table, Rd, Rf), built and copied once per device
        (``kernel_table``)."""
        device = torch.device(device)
        entry = self._device.get(device)
        if entry is None:
            table, *counts = kernel_table(self)
            entry = (torch.as_tensor(table, device=device), *counts)
            self._device[device] = entry
        return entry


def _rounds(items: List[int]) -> List[List[int]]:
    """``items`` in rounds of ``GROUP`` lanes, -1 for an idle lane."""
    return [items[c:c + GROUP] + [-1] * (GROUP - len(items[c:c + GROUP]))
            for c in range(0, len(items), GROUP)]


def _by(level: Sequence[int]) -> List[List[int]]:
    """Dofs grouped by ``level[k]``, lowest level first."""
    groups: Dict[int, List[int]] = {}
    for k, lv in enumerate(level):
        groups.setdefault(lv, []).append(k)
    return [groups[lv] for lv in sorted(groups)]


def contributions(tt: TreeTables):
    """Each dof i's contributions in the right-looking order: for every
    descendant c of i, in descending c, the pair row of (c, i), padded to
    a multiple of ``_BATCH`` with the row E (the factor kernel's zero
    term). Returns (begin (nv + 1), entries): dof i's run is
    entries[begin[i]:begin[i + 1]]."""
    begin, entries = [0], []
    for i in range(tt.nv):
        rows = [tt.off[c] + 1 + t for c, t in reversed(tt.contributors[i])]
        entries += rows + [tt.E] * (-len(rows) % _BATCH)
        begin.append(len(entries))
    return np.asarray(begin, np.int32), np.asarray(entries, np.int32)


def factor_rounds(tt: TreeTables):
    """The factor kernel's schedule. The right-looking elimination gives
    pair (i, chains[i][q - 1]) (q = 0: (i, i)) its final value

        h[(i, j)] = M[(i, j)] - sum_c a_c[t] h_c[t + q],

    over the descendants c of i in descending c (``contributions``), t the
    place of i in chains[c], a_c = c's pairs / c's pivot: every term is
    final once c's subtree is, so the pairs of all dofs of one height (the
    longest path down to a leaf) are independent tasks. Tasks i | q << 8
    go height by height, ``GROUP`` lanes a round. Returns head (R,): the
    flags ``_FIRST_ROUND`` and ``_LAST_ROUND`` of a height's first and
    last round, and slot (R, GROUP): the tasks, -1 for an idle lane."""
    head, slot = [], []
    for dofs in _by(tt.height):
        rounds = _rounds([i | q << 8 for i in dofs
                          for q in range(len(tt.chains[i]) + 1)])
        for n, lanes in enumerate(rounds):
            head.append((_FIRST_ROUND if n == 0 else 0)
                        | (_LAST_ROUND if n == len(rounds) - 1 else 0))
            slot.append(lanes)
    return (np.asarray(head, np.int32),
            np.asarray(slot, np.int32).reshape(-1, GROUP))


def back_rounds(tt: TreeTables) -> np.ndarray:
    """The substitute's back pass (x = L^-1 z): x_k = z_k - sum_t
    H[(k, chains[k][t])] x_chains[k][t], so dofs of one depth are
    independent. Dofs by depth from the root, ``GROUP`` lanes a round;
    (R, GROUP)."""
    return np.asarray([r for dofs in _by([len(c) for c in tt.chains])
                       for r in _rounds(dofs)],
                      np.int32).reshape(-1, GROUP)


def kernel_table(tt: TreeTables):
    """The int32 table of csrc/tree_ltdl.cu: off (nv + 1) | anc (E) |
    back rounds (Rd x GROUP) | factor heads (Rf) | factor slots (Rf x
    GROUP) | contribution begins (nv + 1) | contributions. Returns (table,
    Rd, Rf)."""
    begin, entries = contributions(tt)
    down = back_rounds(tt)
    head, slot = factor_rounds(tt)
    table = np.concatenate([np.asarray(tt.off, np.int32),
                            np.asarray(tt.anc, np.int32), down.ravel(), head,
                            slot.ravel(), begin, entries])
    return table.astype(np.int32), len(down), len(head)


def half_plan(nv: int, E: int, K: int, N: int,
              sms: int) -> Tuple[bool, int, int, int]:
    """The half-solve kernels' launch on a card of ``sms`` SMs (132 on an
    H100): csrc/tree_half.cu ``half_plan``, the same function, which reads
    the SM count from the device. The C entries keep the signatures of
    the tree kernels, so the plan cannot be passed in; this copy lets the
    CPU tests check it at every shape the wrappers take, and the card
    test holds the two equal. Returns (lanes, Kb, warps, bytes).
    ``lanes``: the one-thread-per-(env, right-hand side) kernel would walk
    with fewer warps, ceil(N / 32) K, than the card has SMs, so the
    substitute's lane-group pass (16 lanes an env, csrc/tree_lanes.cuh)
    takes the shape. Else the thread kernel: Kb right-hand sides a block,
    one (env, right-hand side) a thread of its first Kb warps; at least
    ``HALF_MIN_WARPS`` warps, the others only stage; the block's dynamic
    shared memory: the table's off and anc (padded to 16 B), x (nv rows a
    thread) and H staged for the block's 32 envs. Kb is at most
    ``HALF_KB``, at most K, and as many as 227 KB hold (2 at the edge, nv
    256 and E 1,024). Raises only for the shapes the kernels refuse."""
    if not (1 <= nv <= MAX_NV and nv <= E <= MAX_PAIRS
            and 1 <= K <= _MAX_RHS and N >= 1):
        raise ValueError(f"the half-solve kernels take 1 <= nv <= {MAX_NV}, "
                         f"nv <= E <= {MAX_PAIRS}, 1 <= K <= {_MAX_RHS} and "
                         f"N >= 1, got nv {nv}, E {E}, K {K}, N {N}")
    lanes = -(-N // HALF_ENVS) * K < sms
    fixed = 4 * (HALF_ENVS * E + -(-(nv + 1 + E) // 4) * 4)
    per_rhs = 4 * HALF_ENVS * nv
    kb = max(1, min(HALF_KB, K, (_SMEM_LIMIT - fixed) // per_rhs))
    return lanes, kb, max(kb, HALF_MIN_WARPS), fixed + kb * per_rhs


def tree_tables(chains: Sequence[Sequence[int]]) -> TreeTables:
    key = tuple(tuple(c) for c in chains)
    tt = _TABLES.get(key)
    if tt is None:
        tt = _TABLES[key] = TreeTables(chains)
    return tt


# --------------------------------------------------------------------- #
# Plain PyTorch versions over lists of pair rows (the CPU path and the
# kernels' reference).
# --------------------------------------------------------------------- #
def _nan_pivots(rows):
    return [torch.where(h > 0.0, h, torch.full_like(h, float("nan")))
            for h in rows]


def _factor_rows(tt: TreeTables, rows):
    """Right-looking sparse L^T D L (RBDA Table 6.3, expanded loops): as
    dof k is eliminated, leaf to root, every pair it affects is updated.
    rows: E pair rows in ``tt.pairs`` order -> (H rows, D rows)."""
    H = list(rows)
    ix, parent = tt.index, tt.parent
    for k in range(tt.nv - 1, -1, -1):
        i = parent[k]
        while i >= 0:
            a = H[ix[(k, i)]] / H[ix[(k, k)]]
            j = i
            while j >= 0:
                H[ix[(i, j)]] = H[ix[(i, j)]] - a * H[ix[(k, j)]]
                j = parent[j]
            H[ix[(k, i)]] = a
            i = parent[i]
    return H, _nan_pivots([H[d] for d in tt.diag])


def _factor_ll_rows(tt: TreeTables, rows):
    """Left-looking column form of ``_factor_rows``: dof k's column is
    assembled once, from the final columns of its descendants,

        col(k) = M[k, anc-or-self(k)] - sum_{c in desc(k)} a_c[t] v_c[t:]

    (t = k's position in c's chain, v_c = c's column, a_c = v_c[1:] /
    pivot_c): a few stacked ops per dof instead of O(depth^2) row ops.
    Sums in another order than the right-looking form: equal up to
    float32 rounding."""
    nv, chains, off = tt.nv, tt.chains, tt.off
    v: List[torch.Tensor] = [None] * nv  # final columns, (1 + d_k, .., N)
    a: List[torch.Tensor] = [None] * nv  # v[1:] / pivot, (d_k, .., N)
    for k in range(nv - 1, -1, -1):
        col = torch.stack(rows[off[k]:off[k + 1]])
        if tt.contributors[k]:
            w = torch.stack([a[c][t] for (c, t) in tt.contributors[k]])
            src = torch.stack([v[c][1 + t:] for (c, t) in tt.contributors[k]])
            col = col - (w[:, None] * src).sum(0)
        v[k] = col
        if chains[k]:
            a[k] = col[1:] / col[0]
    H: List[torch.Tensor] = []
    for k in range(nv):
        H.append(v[k][0])
        H.extend(a[k].unbind(0) if chains[k] else ())
    return H, _nan_pivots([v[k][0] for k in range(nv)])


def _upsolve_rows(tt: TreeTables, H, b_rows):
    """z = L^-T b, up the tree: H pair rows in ``tt.pairs`` order (the
    diagonal is not read), b_rows nv rows. Rows broadcast, so (K, N)
    right-hand-side rows take (N,) factor rows."""
    chains, off = tt.chains, tt.off
    x = list(b_rows)
    for k in range(tt.nv - 1, -1, -1):
        for t, i in enumerate(chains[k]):
            x[i] = x[i] - H[off[k] + 1 + t] * x[k]
    return x


def _downsolve_rows(tt: TreeTables, H, z_rows):
    """x = L^-1 z, down the tree (the layout of ``_upsolve_rows``)."""
    chains, off = tt.chains, tt.off
    x = list(z_rows)
    for k in range(tt.nv):
        acc = x[k]
        for t, i in enumerate(chains[k]):
            acc = acc - H[off[k] + 1 + t] * x[i]
        x[k] = acc
    return x


def _substitute_rows(tt: TreeTables, H, D, b_rows):
    """z = L^-T b (up the tree), z /= D, x = L^-1 z (down the tree). D:
    nv rows; the rest as ``_upsolve_rows``."""
    x = _upsolve_rows(tt, H, b_rows)
    return _downsolve_rows(tt, H, [x[k] / D[k] for k in range(tt.nv)])


# --------------------------------------------------------------------- #
# The JAX package's API (dicts keyed by pair, lists of rows).
# --------------------------------------------------------------------- #
def _pair_rows(tt: TreeTables, M: Dict[Tuple[int, int], torch.Tensor]):
    return [M[p] for p in tt.pairs]


def ltdl_factor(chains: Sequence[Sequence[int]],
                M: Dict[Tuple[int, int], torch.Tensor]):
    """Factorizes M = L^T D L for an SPD tree-sparse system in lanes
    layout. Returns (H, D): H a dict {(k, i): (N,)} over the ancestor
    pairs (L at the off-diagonal pairs), D a length-nv list of (N,)
    pivots (NaN where the pivot is not > 0). Reusable across right-hand
    sides (``ltdl_substitute``)."""
    tt = tree_tables(chains)
    H, D = _factor_rows(tt, _pair_rows(tt, M))
    return dict(zip(tt.pairs, H)), D


def ltdl_factor_ll(chains: Sequence[Sequence[int]],
                   M: Dict[Tuple[int, int], torch.Tensor]):
    """Left-looking form of ``ltdl_factor``: the same (H, D) contract,
    assembled one dof column at a time (fewer, larger ops on deep
    chains)."""
    tt = tree_tables(chains)
    H, D = _factor_ll_rows(tt, _pair_rows(tt, M))
    return dict(zip(tt.pairs, H)), D


def ltdl_substitute(chains: Sequence[Sequence[int]], factor,
                    b_rows: Sequence[torch.Tensor]):
    """Solves (L^T D L) x = b given an ``ltdl_factor`` result. Returns the
    list of nv rows."""
    H, D = factor
    tt = tree_tables(chains)
    return _substitute_rows(tt, [H.get(p) for p in tt.pairs], D, b_rows)


def ltdl_upsolve(chains: Sequence[Sequence[int]], H,
                 x: Dict[int, torch.Tensor], dofs: Sequence[int]):
    """Applies L^-T only (the up pass of ``ltdl_substitute``) to rows
    supported on the ancestor-closed dof set ``dofs``; x: {dof: (.., N)}.
    Fill spreads only from a dof to its ancestors, so the pass restricted
    to the closure is exact. Mutates and returns ``x``."""
    for k in sorted(dofs, reverse=True):
        for i in chains[k]:
            x[i] = x[i] - H[(k, i)] * x[k]
    return x


def ltdl_downsolve(chains: Sequence[Sequence[int]], H,
                   rows: Sequence[torch.Tensor]):
    """Applies L^-1 only (the down pass of ``ltdl_substitute``) to a full
    nv-row vector: x[k] = rows[k] - sum_i H[(k, i)] x[i], ascending."""
    x = list(rows)
    for k in range(len(chains)):
        acc = x[k]
        for i in chains[k]:
            acc = acc - H[(k, i)] * x[i]
        x[k] = acc
    return x


def ltdl_solve(chains: Sequence[Sequence[int]],
               M: Dict[Tuple[int, int], torch.Tensor],
               b_rows: Sequence[torch.Tensor]):
    """Solves M x = b for SPD tree-sparse systems in lanes layout: M a
    dict over exactly ``ancestor_pairs(chains)``, b_rows nv (N,) rows.
    Returns the list of nv solution rows."""
    return ltdl_substitute(chains, ltdl_factor(chains, M), b_rows)


# --------------------------------------------------------------------- #
# Tensor form: plain versions.
# --------------------------------------------------------------------- #
def ltdl_factor_plain(chains, Mp: torch.Tensor, left_looking: bool = False):
    """Mp (E, N) pair values in ``ancestor_pairs`` order -> (H (E, N),
    D (nv, N)), by the right-looking or the left-looking form."""
    tt = tree_tables(chains)
    fn = _factor_ll_rows if left_looking else _factor_rows
    H, D = fn(tt, list(Mp.unbind(0)))
    return torch.stack(H), torch.stack(D)


def ltdl_substitute_plain(chains, factor, b: torch.Tensor) -> torch.Tensor:
    """factor (H (E, N), D (nv, N)), b (nv, N) or (K, nv, N) -> x shaped as
    b."""
    H, D = factor
    tt = tree_tables(chains)
    x = _substitute_rows(tt, list(H.unbind(0)), list(D.unbind(0)),
                         list(b.unbind(-2)))
    return torch.stack(x, -2)


def ltdl_upsolve_plain(chains, H: torch.Tensor, b: torch.Tensor):
    """z = L^-T b: H (E, N), b (nv, N) or (K, nv, N) -> z shaped as b.
    Rows of b that are zero outside an ancestor-closed dof set stay zero
    there, so this is ``ltdl_upsolve`` on every such set at once."""
    tt = tree_tables(chains)
    return torch.stack(_upsolve_rows(tt, list(H.unbind(0)),
                                     list(b.unbind(-2))), -2)


def ltdl_downsolve_plain(chains, H: torch.Tensor, z: torch.Tensor):
    """x = L^-1 z: H (E, N), z (nv, N) or (K, nv, N) -> x shaped as z."""
    tt = tree_tables(chains)
    return torch.stack(_downsolve_rows(tt, list(H.unbind(0)),
                                       list(z.unbind(-2))), -2)


# --------------------------------------------------------------------- #
# Tensor form: the CUDA kernels.
# --------------------------------------------------------------------- #
def half_plan_cuda(nv: int, E: int, K: int,
                   N: int) -> Tuple[bool, int, int, int]:
    """The launch csrc/tree_half.cu plans for a shape on the current card
    (its ``tree_half_plan``): (lanes, Kb, warps, bytes), as
    ``half_plan``."""
    out = [ctypes.c_int() for _ in range(4)]
    entry_fn("tree_half_plan")(nv, E, K, N, *map(ctypes.byref, out))
    lanes, *rest = (v.value for v in out)
    return (bool(lanes), *rest)


def _kernel_tables(name, chains) -> TreeTables:
    tt = tree_tables(chains)
    if not 1 <= tt.nv <= MAX_NV or tt.E > MAX_PAIRS:
        raise ValueError(f"{name} takes nv <= {MAX_NV} and at most "
                         f"{MAX_PAIRS} pairs, got nv = {tt.nv}, {tt.E} pairs")
    if not tt.tree_ordered:
        raise ValueError(f"{name} needs chains[k] == [parent, *chains[parent]]"
                         f" with parent < k for every dof")
    return tt


def _table_args(tt: TreeTables, device):
    table, rd, rf = tt.device_table(device)
    return table.data_ptr(), table.numel(), tt.nv, tt.E, rd, rf


def ltdl_factor_cuda(chains, Mp: torch.Tensor):
    """Launches the factor kernel: Mp (E, N) -> (H (E, N), D (nv, N))."""
    check_cuda("ltdl_factor_cuda", Mp, no_grad=True)
    tt = _kernel_tables("ltdl_factor_cuda", chains)
    if Mp.ndim != 2 or Mp.shape[0] != tt.E:
        raise ValueError(f"ltdl_factor_cuda needs Mp ({tt.E}, N), got "
                         f"{tuple(Mp.shape)}")
    Mp = Mp.contiguous()
    N = Mp.shape[1]
    H = torch.empty_like(Mp)
    D = Mp.new_empty(tt.nv, N)
    launch("tree_ltdl_factor", Mp.device, *_table_args(tt, Mp.device),
           Mp.data_ptr(), H.data_ptr(), D.data_ptr(), N)
    return H, D


def _rhs_count(name, tt: TreeTables, H, b, D=None) -> int:
    """Checks H (E, N), D (nv, N) and b (nv, N) or (K, nv, N); returns
    K."""
    N = H.shape[-1]
    if H.shape != (tt.E, N) or (D is not None and D.shape != (tt.nv, N)):
        raise ValueError(f"{name} needs H ({tt.E}, N) and D ({tt.nv}, N), "
                         f"got {tuple(H.shape)}, "
                         f"{None if D is None else tuple(D.shape)}")
    if b.shape[-2:] != (tt.nv, N) or b.ndim not in (2, 3):
        raise ValueError(f"{name} needs b (nv, N) or (K, nv, N) with "
                         f"(nv, N) = {(tt.nv, N)}, got {tuple(b.shape)}")
    k = b.shape[0] if b.ndim == 3 else 1
    if k > _MAX_RHS:
        raise ValueError(f"{name} takes at most {_MAX_RHS} right-hand sides, "
                         f"got {k}")
    return k


def ltdl_substitute_cuda(chains, factor, b: torch.Tensor) -> torch.Tensor:
    """Launches the substitute kernel: factor (H (E, N), D (nv, N)), b
    (nv, N) or (K, nv, N) -> x shaped as b."""
    H, D = factor
    check_cuda("ltdl_substitute_cuda", H, D, b, no_grad=True)
    tt = _kernel_tables("ltdl_substitute_cuda", chains)
    k = _rhs_count("ltdl_substitute_cuda", tt, H, b, D)
    H, D, b = H.contiguous(), D.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    launch("tree_ltdl_substitute", H.device, *_table_args(tt, H.device),
           H.data_ptr(), D.data_ptr(), b.data_ptr(), x.data_ptr(), k,
           H.shape[1])
    return x


def _half_solve_cuda(half, chains, H: torch.Tensor, b: torch.Tensor):
    name = f"ltdl_{half}_cuda"
    check_cuda(name, H, b, no_grad=True)
    tt = _kernel_tables(name, chains)
    k = _rhs_count(name, tt, H, b)
    H, b = H.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    launch(f"tree_ltdl_{half}", H.device, *_table_args(tt, H.device),
           H.data_ptr(), b.data_ptr(), x.data_ptr(), k, H.shape[1])
    return x


def ltdl_upsolve_cuda(chains, H: torch.Tensor, b: torch.Tensor):
    """Launches the upsolve kernel (csrc/tree_half.cu): H (E, N), b
    (nv, N) or (K, nv, N) -> z = L^-T b shaped as b."""
    return _half_solve_cuda("upsolve", chains, H, b)


def ltdl_downsolve_cuda(chains, H: torch.Tensor, z: torch.Tensor):
    """Launches the downsolve kernel (csrc/tree_half.cu): H (E, N), z
    (nv, N) or (K, nv, N) -> x = L^-1 z shaped as z."""
    return _half_solve_cuda("downsolve", chains, H, z)


# --------------------------------------------------------------------- #
# Tensor-form entry points: plain version on the CPU, kernel on the card.
# --------------------------------------------------------------------- #
def tree_factor(chains, Mp: torch.Tensor, left_looking: bool = False):
    """Mp (E, N) -> (H (E, N), D (nv, N)). ``left_looking`` picks the form
    of the plain version (CPU tensors); the kernel has one form."""
    if on_cpu(Mp):
        return ltdl_factor_plain(chains, Mp, left_looking)
    return ltdl_factor_cuda(chains, Mp)


def tree_substitute(chains, factor, b: torch.Tensor) -> torch.Tensor:
    """Solves against a ``tree_factor`` result: b (nv, N) or (K, nv, N) ->
    x shaped as b."""
    if on_cpu(*factor, b):
        return ltdl_substitute_plain(chains, factor, b)
    return ltdl_substitute_cuda(chains, factor, b)


def tree_upsolve(chains, H: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """z = L^-T x against a ``tree_factor`` result's H: x (nv, N) or
    (K, nv, N) -> z shaped as x."""
    if on_cpu(H, x):
        return ltdl_upsolve_plain(chains, H, x)
    return ltdl_upsolve_cuda(chains, H, x)


def tree_downsolve(chains, H: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """x = L^-1 z against a ``tree_factor`` result's H: z (nv, N) or
    (K, nv, N) -> x shaped as z."""
    if on_cpu(H, z):
        return ltdl_downsolve_plain(chains, H, z)
    return ltdl_downsolve_cuda(chains, H, z)
