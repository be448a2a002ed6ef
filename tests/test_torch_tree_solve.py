"""The port's branch-sparse L^T D L (ops/tree_solve.py) against the JAX
package's, on Humanoid's dof tree, Ant's and random trees (nv 5-30) built
with numpy from a seed: every function of the JAX API, the tensor form
the physics and the kernel use, K right-hand sides, the NaN-pivot policy,
the wrappers' dispatch on CPU tensors, the kernels' host-built schedules
(each update once, no two lanes on one pair in a round, every pair's
updates in the serial order; the rounds replayed with numpy equal the
plain version bit for bit), the bound counts, and, on a CUDA card only,
the hand-written kernel (csrc/tree_ltdl.cu) against the plain version.

The systems are CRBA-like: a dense A = B B^T + n I kept at the ancestor
pairs only and made diagonally dominant, so SPD. Tolerances: float32 on
both sides with the same order of operations up to fused multiply-adds,
rtol 1e-4 / atol 1e-5 for factors and solutions; the right-looking factor
is held to the right-looking one and the left-looking to the
left-looking, whose sums run in another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayes_sim_ig_tpu.ops import tree_solve as jts
from bayes_sim_ig_tpu.sim.ant import build_ant_model
from bayes_sim_ig_tpu.sim.anymal import build_anymal_model
from bayes_sim_ig_tpu.sim.ball_balance import build_bbot_model
from bayes_sim_ig_tpu.sim.humanoid import build_humanoid_model
from bayes_sim_ig_tpu_torch.ops import bounds
from bayes_sim_ig_tpu_torch.ops import tree_solve as tts
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
N = 7


def _random_chains(nv, seed):
    """A random dof tree in topological order: each dof's parent is an
    earlier dof, or a root with probability 0.1."""
    rs = np.random.RandomState(seed)
    chains = [[]]
    for k in range(1, nv):
        p = -1 if rs.rand() < 0.1 else int(rs.randint(k))
        chains.append([] if p < 0 else [p] + chains[p])
    return chains


TREES = {
    "humanoid": build_humanoid_model().dof_anc_chains,
    "ant": build_ant_model().dof_anc_chains,
    # Two roots: the tray's tree (a free base, three 2-dof legs) and the
    # free ball.
    "ball_balance": build_bbot_model().dof_anc_chains,
    "anymal": build_anymal_model().dof_anc_chains,
    "random5": _random_chains(5, 0),
    "random12": _random_chains(12, 1),
    "random30": _random_chains(30, 2),
}
# The kernels' schedules also on a single chain 40 deep: depths past a
# warp (the lanes loop), 820 pairs.
SCHEDULE_TREES = {**TREES,
                  "chain40": [list(range(k - 1, -1, -1)) for k in range(40)]}


def _system(chains, n=N, seed=0, k=None):
    """Pair values (E, n) in ancestor_pairs order and right-hand sides
    (nv, n), or (k, nv, n) with ``k``, as float32 numpy."""
    rs = np.random.RandomState(seed)
    nv = len(chains)
    B = rs.randn(n, nv, nv)
    A = B @ B.transpose(0, 2, 1) + nv * np.eye(nv)
    keep = np.eye(nv, dtype=bool)
    for c, ch in enumerate(chains):
        keep[c, ch] = keep[ch, c] = True
    A = np.where(keep, A, 0.0)
    A[:, np.arange(nv), np.arange(nv)] += np.abs(A).sum(-1)
    pairs = jts.ancestor_pairs(chains)
    Mp = np.stack([A[:, kk, i] for kk, i in pairs]).astype(np.float32)
    shape = (nv, n) if k is None else (k, nv, n)
    return Mp, rs.randn(*shape).astype(np.float32), A


def _dicts(chains, Mp):
    pairs = jts.ancestor_pairs(chains)
    return ({p: jnp.asarray(Mp[r]) for r, p in enumerate(pairs)},
            {p: torch.from_numpy(Mp[r].copy()) for r, p in enumerate(pairs)})


def _close(got, want, tol=TOL, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol, **kw)


@pytest.mark.parametrize("tree", list(TREES))
def test_ancestor_pairs_and_tables(tree):
    chains = TREES[tree]
    assert tts.ancestor_pairs(chains) == jts.ancestor_pairs(chains)
    tt = tts.tree_tables(chains)
    assert tt.tree_ordered and tt.E == len(tt.pairs)
    for k, ch in enumerate(chains):
        assert tt.pairs[tt.off[k]] == (k, k)
        for t, i in enumerate(ch):
            assert tt.pairs[tt.off[k] + 1 + t] == (k, i)
    if tree == "humanoid":
        assert (tt.nv, tt.E, tt.mean_depth) == (27, 243, 8.0)
    for p, (k, i) in enumerate(tt.pairs):
        assert tt.anc[p] == i


def _serial_updates(tt):
    """The serial right-looking factor's updates, in its order: {target
    pair row: [(c, t, s)]}, dof c eliminated leaf to root, (t, s) its
    update of (chains[c][t], chains[c][s])."""
    order = {}
    for c in range(tt.nv - 1, -1, -1):
        ch = tt.chains[c]
        for t in range(len(ch)):
            for s in range(t, len(ch)):
                order.setdefault(tt.index[(ch[t], ch[s])], []).append(
                    (c, t, s))
    return order


@pytest.mark.parametrize("tree", list(SCHEDULE_TREES))
def test_factor_rounds_schedule(tree):
    """Every pair is one task; a task's contributions are exactly the
    serial factor's updates (c, t, s) of that pair, each once and in the
    serial order over c; no two lanes of a round write one pair; a task
    runs after the tasks of every pair it reads (its descendants'), and
    the first and last rounds of each height carry their flags."""
    tt = tts.tree_tables(SCHEDULE_TREES[tree])
    head, slot = tts.factor_rounds(tt)
    begin, entries = tts.contributions(tt)
    assert slot.shape == (len(head), tts.GROUP)
    assert (np.diff(begin) % tts._BATCH == 0).all()
    assert (entries != tt.E).sum() == tt.E - tt.nv  # the rest is padding
    serial = _serial_updates(tt)
    done, when, level = set(), {}, 0
    for r, lanes in enumerate(slot):
        first, last = (bool(int(head[r]) & f) for f in
                       (tts._FIRST_ROUND, tts._LAST_ROUND))
        assert first == (r == 0 or bool(int(head[r - 1]) & tts._LAST_ROUND))
        level += first
        tasks = [int(u) for u in lanes if u >= 0]
        targets = [tt.off[u & 255] + (u >> 8) for u in tasks]
        assert tasks and len(set(targets)) == len(targets), (tree, r)
        for u, p in zip(tasks, targets):
            i, q = u & 255, u >> 8
            assert 0 <= q <= len(tt.chains[i])
            got = []
            for row in entries[begin[i]:begin[i + 1]]:
                if row == tt.E:
                    continue  # padding: a zero term
                c = tt.pairs[row][0]
                t = row - tt.off[c] - 1
                assert tt.chains[c][t] == i
                got.append((c, t, t + q))
                # the terms read c's pairs: done at a lower height
                assert when[tt.off[c]] < level
            assert got == serial.get(p, [])
            when[p] = level
            done.add(p)
        assert last == (r + 1 == len(head)
                        or bool(int(head[r + 1]) & tts._FIRST_ROUND))
    assert sorted(done) == list(range(tt.E))


@pytest.mark.parametrize("tree", list(SCHEDULE_TREES))
def test_substitute_rounds_schedule(tree):
    """Back pass: every dof once, after all its ancestors; no dof twice in
    a round."""
    tt = tts.tree_tables(SCHEDULE_TREES[tree])
    down = tts.back_rounds(tt)
    assert down.shape[1] == tts.GROUP
    done = set()
    for lanes in down:
        ks = [int(k) for k in lanes if k >= 0]
        assert ks and len(set(ks)) == len(ks)
        for k in ks:
            assert set(tt.chains[k]) <= done
        done.update(ks)
    assert sorted(done) == list(range(tt.nv))
    assert down[down >= 0].size == tt.nv


def test_kernel_table_layout():
    tt = tts.tree_tables(TREES["humanoid"])
    table, rd, rf = tts.kernel_table(tt)
    begin, entries = tts.contributions(tt)
    head, slot = tts.factor_rounds(tt)
    down = tts.back_rounds(tt)
    assert table.dtype == np.int32 and (rd, rf) == (len(down), len(head))
    parts = np.split(table, np.cumsum([tt.nv + 1, tt.E, rd * 16, rf,
                                       rf * 16, tt.nv + 1]))
    assert parts[0].tolist() == tt.off and parts[1].tolist() == tt.anc
    for got, want in zip(parts[2:], (down.ravel(), head, slot.ravel(), begin,
                                     entries)):
        assert np.array_equal(got, want)


def _replay_factor(tt, Mp):
    """csrc/tree_ltdl.cu's factor rounds replayed on numpy float32 (E, n):
    each task subtracts its contributions in order, every lane of a round
    reading the state before the round (as lanes that run at once do);
    a height's multipliers after its last round."""
    head, slot = tts.factor_rounds(tt)
    begin, entries = tts.contributions(tt)
    h, a = Mp.copy(), np.zeros_like(Mp)
    level = []
    for hd, lanes in zip(head, slot):
        new = {}
        for u in (int(u) for u in lanes if u >= 0):
            i, q = u & 255, u >> 8
            acc = h[tt.off[i] + q]
            for row in entries[begin[i]:begin[i + 1]]:
                if row < tt.E:  # the padding row E is a zero term
                    acc = acc - a[row] * h[row + q]
            new[tt.off[i] + q] = acc
            level.append((i, q))
        for p, v in new.items():
            h[p] = v
        if int(hd) & tts._LAST_ROUND:
            for i, q in level:
                if q:
                    a[tt.off[i] + q] = h[tt.off[i] + q] / h[tt.off[i]]
            level = []
    a[tt.off[:-1]] = h[tt.off[:-1]]
    piv = h[tt.off[:-1]]
    return a, np.where(piv > 0, piv, np.float32(np.nan))


def _replay_substitute(tt, H, D, b):
    """The substitute kernel's up pass (one dof a round, one ancestor a
    lane) and back rounds (each dof pulls from its chain) replayed on
    numpy float32 as above."""
    x = b.copy()
    for k in range(tt.nv - 1, -1, -1):
        rows = range(tt.off[k] + 1, tt.off[k + 1])
        new = {tt.anc[p]: x[tt.anc[p]] - H[p] * x[k] for p in rows}
        for i, v in new.items():
            x[i] = v
    x = x / D
    for lanes in tts.back_rounds(tt):
        new = {}
        for k in (int(k) for k in lanes if k >= 0):
            acc = x[k]
            for p in range(tt.off[k] + 1, tt.off[k + 1]):
                acc = acc - H[p] * x[tt.anc[p]]
            new[k] = acc
        for k, v in new.items():
            x[k] = v
    return x


@pytest.mark.parametrize("tree", list(SCHEDULE_TREES))
def test_kernel_rounds_replay_the_plain_version(tree):
    """The kernels' schedules, replayed with the kernels' operations in
    numpy float32, give the plain right-looking factor and the plain
    substitute bit for bit (no fused multiply-add on either side: each
    pair and row receives the same terms in the same order), including
    the NaN pivots of an indefinite env."""
    chains = SCHEDULE_TREES[tree]
    tt = tts.tree_tables(chains)
    Mp, b, _ = _system(chains, seed=11)
    Mp[:, 2] = -Mp[:, 2]
    H, D = _replay_factor(tt, Mp)
    Hp, Dp = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp))
    np.testing.assert_array_equal(H, Hp.numpy())
    np.testing.assert_array_equal(D, Dp.numpy())
    x = _replay_substitute(tt, H, D, b)
    xp = tts.ltdl_substitute_plain(chains, (Hp, Dp), torch.from_numpy(b))
    np.testing.assert_array_equal(x, xp.numpy())
    assert np.isnan(x[:, 2]).all() and np.isfinite(np.delete(x, 2, 1)).all()


def test_ball_balance_forest_tables():
    """BallBalance's 18 dofs in two trees: roots 0 (the tray's free joint,
    its 6 dofs a chain, the legs below dof 5) and 12 (the ball's); 87
    pairs, mean depth 3.83; its factor rounds run height by height across
    both trees, and the back pass starts both roots in its first
    round."""
    tt = tts.tree_tables(TREES["ball_balance"])
    assert (tt.nv, tt.E) == (18, 87) and tt.tree_ordered
    assert [k for k in range(18) if tt.parent[k] < 0] == [0, 12]
    assert tt.mean_depth == pytest.approx(69 / 18)
    assert tt.height[0] == 7 and tt.height[12] == 5
    down = tts.back_rounds(tt)
    assert {0, 12} <= set(down[0].tolist())
    head, slot = tts.factor_rounds(tt)
    # Heights 0..7; the 30 pair tasks of the 4 leaves (height 0) take two
    # rounds of 16 lanes, and so do height 1's.
    assert int(sum(bool(h & tts._FIRST_ROUND) for h in head)) == 8
    assert len(head) == 10


def test_bounds_hand_counts():
    """Bytes at Humanoid's path shape (nv 27, E 243, N 4096): the factor
    reads M and writes H (243 x 4096 floats each) and D (27 x 4096); the
    substitute reads the 216 off-diagonal pairs, D and b, writes x."""
    chains = TREES["humanoid"]
    f = bounds.tree_factor(chains, 4096)
    assert f.bytes == 4 * 4096 * (243 + 243 + 27) == 8_404_992
    assert f.flops == 4096 * (3 * 1170 + 216)
    s = bounds.tree_substitute(chains, 4096)
    assert s.bytes == 4 * 4096 * (216 + 27 + 27 + 27) == 4_866_048
    assert s.flops == 4096 * (4 * 216 + 27)
    assert bounds.tree_substitute(chains, 4096, K=4).bytes == \
        4 * 4096 * (216 + 27 + 8 * 27)
    assert f.by == s.by == "bytes"
    assert f.ms == pytest.approx(8_404_992 / 3.35e12 * 1e3)
    assert s.ms == pytest.approx(0.0014525516, rel=1e-6)


@pytest.mark.parametrize("form", ["right", "left"])
@pytest.mark.parametrize("tree", list(TREES))
def test_factor_matches_jax(tree, form):
    chains = TREES[tree]
    Mp, _, _ = _system(chains, seed=3)
    jM, tM = _dicts(chains, Mp)
    jfn, tfn = ((jts.ltdl_factor, tts.ltdl_factor) if form == "right" else
                (jts.ltdl_factor_ll, tts.ltdl_factor_ll))
    jH, jD = jfn(chains, jM)
    tH, tD = tfn(chains, tM)
    assert set(tH) == set(jH)
    for p in jH:
        _close(tH[p], jH[p], err_msg=str(p))
    for k in range(len(chains)):
        _close(tD[k], jD[k], err_msg=f"D[{k}]")


@pytest.mark.parametrize("tree", list(TREES))
def test_substitute_and_solve_match_jax(tree):
    chains = TREES[tree]
    Mp, b, A = _system(chains, seed=4)
    jM, tM = _dicts(chains, Mp)
    rows_j = [jnp.asarray(r) for r in b]
    rows_t = [torch.from_numpy(r.copy()) for r in b]
    want = jts.ltdl_solve(chains, jM, rows_j)
    got = tts.ltdl_solve(chains, tM, rows_t)
    for k in range(len(chains)):
        _close(got[k], want[k], err_msg=f"x[{k}]")
    # The port's substitute on JAX's own factor (the payload carries
    # across as rows).
    jfac = jts.ltdl_factor_ll(chains, jM)
    tfac = ({p: torch.from_numpy(np.array(v)) for p, v in jfac[0].items()},
            [torch.from_numpy(np.array(d)) for d in jfac[1]])
    want = jts.ltdl_substitute(chains, jfac, rows_j)
    got = tts.ltdl_substitute(chains, tfac, rows_t)
    for k in range(len(chains)):
        _close(got[k], want[k], err_msg=f"x[{k}]")
    # And it solves the dense system.
    x = np.stack([g.numpy() for g in got]).astype(np.float64)
    resid = np.einsum("nij,jn->in", A, x) - b
    assert np.abs(resid).max() < 1e-3 * np.abs(b).max() * len(chains)


@pytest.mark.parametrize("tree", ["humanoid", "random30"])
def test_k_right_hand_sides(tree):
    """(K, N) right-hand-side rows broadcast against (N,) factor rows, as
    ``mass_factor_solve`` passes them; each equals its single solve."""
    chains = TREES[tree]
    Mp, b, _ = _system(chains, seed=5, k=3)
    jM, tM = _dicts(chains, Mp)
    jfac, tfac = jts.ltdl_factor(chains, jM), tts.ltdl_factor(chains, tM)
    got = tts.ltdl_substitute(chains, tfac,
                              [torch.from_numpy(b[:, k].copy())
                               for k in range(len(chains))])
    want = jts.ltdl_substitute(chains, jfac,
                               [jnp.asarray(b[:, k]) for k in
                                range(len(chains))])
    for k in range(len(chains)):
        assert tuple(got[k].shape) == (3, N)
        _close(got[k], want[k], err_msg=f"x[{k}]")
    Ht, Dt = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp))
    xk = tts.ltdl_substitute_plain(chains, (Ht, Dt), torch.from_numpy(b))
    for r in range(3):
        one = tts.ltdl_substitute_plain(chains, (Ht, Dt),
                                        torch.from_numpy(b[r]))
        assert torch.equal(xk[r], one)


@pytest.mark.parametrize("tree", ["humanoid", "random12"])
def test_upsolve_downsolve_match_jax(tree):
    chains = TREES[tree]
    Mp, b, _ = _system(chains, seed=6)
    jM, tM = _dicts(chains, Mp)
    jH, _ = jts.ltdl_factor(chains, jM)
    tH, _ = tts.ltdl_factor(chains, tM)
    # An ancestor-closed dof set: the last dof and its chain.
    dofs = [len(chains) - 1] + chains[-1]
    jx = jts.ltdl_upsolve(chains, jH, {d: jnp.asarray(b[d]) for d in dofs},
                          dofs)
    tx = tts.ltdl_upsolve(chains, tH,
                          {d: torch.from_numpy(b[d].copy()) for d in dofs},
                          dofs)
    for d in dofs:
        _close(tx[d], jx[d], err_msg=f"up x[{d}]")
    jd = jts.ltdl_downsolve(chains, jH, [jnp.asarray(r) for r in b])
    td = tts.ltdl_downsolve(chains, tH, [torch.from_numpy(r.copy())
                                         for r in b])
    for k in range(len(chains)):
        _close(td[k], jd[k], err_msg=f"down x[{k}]")


@pytest.mark.parametrize("form", ["right", "left"])
@pytest.mark.parametrize("tree", ["humanoid", "ant", "random30"])
def test_nan_pivot_policy_matches_jax(tree, form):
    """Env 1 negated (every pivot negative) and env 3 zeroed (pivots 0):
    NaN in D at the positions JAX gives, only in those envs; every other
    env bit for bit the clean run."""
    chains = TREES[tree]
    Mp, b, _ = _system(chains, seed=7)
    bad = Mp.copy()
    bad[:, 1] = -bad[:, 1]
    bad[:, 3] = 0.0
    jM, tM = _dicts(chains, bad)
    jfn, tfn = ((jts.ltdl_factor, tts.ltdl_factor) if form == "right" else
                (jts.ltdl_factor_ll, tts.ltdl_factor_ll))
    jD = np.stack([np.asarray(d) for d in jfn(chains, jM)[1]])
    tfac = tfn(chains, tM)
    tD = torch.stack(tfac[1]).numpy()
    np.testing.assert_array_equal(np.isnan(tD), np.isnan(jD))
    assert np.isnan(tD[:, [1, 3]]).all()
    good = [0, 2, 4, 5, 6]
    assert np.isfinite(tD[:, good]).all()
    x = torch.stack(tts.ltdl_substitute(
        chains, tfac, [torch.from_numpy(r.copy()) for r in b])).numpy()
    clean_fac = tfn(chains, _dicts(chains, Mp)[1])
    clean = torch.stack(tts.ltdl_substitute(
        chains, clean_fac, [torch.from_numpy(r.copy()) for r in b])).numpy()
    assert np.isnan(x[:, [1, 3]]).all()
    np.testing.assert_array_equal(x[:, good], clean[:, good])


@pytest.mark.parametrize("left", [False, True])
@pytest.mark.parametrize("tree", ["humanoid", "random30"])
def test_tensor_form_equals_dict_form(tree, left):
    chains = TREES[tree]
    Mp, b, _ = _system(chains, seed=8)
    _, tM = _dicts(chains, Mp)
    H, D = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp), left)
    dH, dD = (tts.ltdl_factor_ll if left else tts.ltdl_factor)(chains, tM)
    pairs = tts.ancestor_pairs(chains)
    assert torch.equal(H, torch.stack([dH[p] for p in pairs]))
    assert torch.equal(D, torch.stack(dD))
    x = tts.ltdl_substitute_plain(chains, (H, D), torch.from_numpy(b))
    dx = tts.ltdl_substitute(chains, (dH, dD),
                             [torch.from_numpy(r.copy()) for r in b])
    assert torch.equal(x, torch.stack(dx))


def test_cpu_entry_points_run_the_plain_version():
    chains = TREES["humanoid"]
    Mp, b, _ = _system(chains, seed=9)
    before = launch_counts()
    fac = tts.tree_factor(chains, torch.from_numpy(Mp), left_looking=True)
    want = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp), True)
    assert torch.equal(fac[0], want[0]) and torch.equal(fac[1], want[1])
    x = tts.tree_substitute(chains, fac, torch.from_numpy(b))
    assert torch.equal(x, tts.ltdl_substitute_plain(chains, fac,
                                                    torch.from_numpy(b)))
    assert launch_counts() == before


@pytest.mark.parametrize("fn", ["ltdl_factor_cuda", "ltdl_substitute_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    chains = TREES["random5"]
    E = len(tts.ancestor_pairs(chains))
    args = ((torch.zeros(E, 4),) if fn == "ltdl_factor_cuda" else
            ((torch.zeros(E, 4), torch.zeros(5, 4)), torch.zeros(5, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tts, fn)(chains, *args)


def test_kernel_tables_refuse_unordered_trees():
    with pytest.raises(ValueError, match="parent"):
        tts._kernel_tables("t", [[1], []])


def _card_system(tree, n, k):
    chains = (SCHEDULE_TREES[tree] if tree in SCHEDULE_TREES else
              _random_chains(30, int(tree.rsplit("_", 1)[1])))
    Mp, b, _ = _system(chains, n=n, seed=10, k=k)
    Mp[:, 0] = -Mp[:, 0]  # env 0 indefinite: every pivot negative
    return chains, torch.from_numpy(Mp).cuda(), torch.from_numpy(b).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n,k", [
    ("humanoid", 4096, 1), ("humanoid", 1, 1), ("humanoid", 17, 4),
    ("ant", 1024, 4), ("random_2", 1024, 1), ("random_3", 33, 4),
    ("ball_balance", 128, 1), ("ball_balance", 128, 4)])
def test_kernels_match_plain_on_card(tree, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, Mp, b = _card_system(tree, n, k)
    before = launch_counts()
    H, D = tts.tree_factor(chains, Mp)
    x = tts.tree_substitute(chains, (H, D), b)
    torch.cuda.synchronize()
    after = launch_counts()
    for kind in ("tree_ltdl_factor", "tree_ltdl_substitute"):
        assert after[kind] == before[kind] + 1
    Hp, Dp = tts.ltdl_factor_plain(chains, Mp)
    torch.testing.assert_close(H, Hp, equal_nan=True, **TOL)
    torch.testing.assert_close(D, Dp, equal_nan=True, **TOL)
    assert torch.equal(torch.isnan(D), torch.isnan(Dp))
    xp = tts.ltdl_substitute_plain(chains, (H, D), b)
    torch.testing.assert_close(x, xp, equal_nan=True, **TOL)
    assert torch.isnan(x[..., 0]).all()
    assert torch.isfinite(x[..., 1:]).all()


@pytest.mark.cuda
def test_kernel_refuses_inputs_that_require_grad():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, Mp, _ = _card_system("humanoid", 8, None)
    with pytest.raises(ValueError, match="gradient"):
        tts.ltdl_factor_cuda(chains, Mp.requires_grad_(True))


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n,k", [
    ("humanoid", 4097, 1), ("humanoid", 9, 3), ("ant", 1025, 1),
    ("chain40", 37, 2), ("chain40", 1027, 1), ("random30", 5, 1),
    ("ball_balance", 129, 1)])
def test_partial_blocks_on_card(tree, n, k):
    """The kernels at env counts that leave a partial block (N not a
    multiple of the 16 envs a block), and on chains longer than an env's
    16 lanes, against the plain
    version, with the NaN policy: the indefinite env 0 is NaN in D and x
    only, every other env bit for bit its clean run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, Mp, b = _card_system(tree, n, k)
    H, D = tts.ltdl_factor_cuda(chains, Mp)
    x = tts.ltdl_substitute_cuda(chains, (H, D), b)
    Hp, Dp = tts.ltdl_factor_plain(chains, Mp)
    torch.testing.assert_close(H, Hp, equal_nan=True, **TOL)
    torch.testing.assert_close(D, Dp, equal_nan=True, **TOL)
    torch.testing.assert_close(
        x, tts.ltdl_substitute_plain(chains, (Hp, Dp), b), equal_nan=True,
        **TOL)
    clean = Mp.clone()
    clean[:, 0] = -clean[:, 0]
    Hc, Dc = tts.ltdl_factor_cuda(chains, clean)
    xc = tts.ltdl_substitute_cuda(chains, (Hc, Dc), b)
    torch.cuda.synchronize()
    assert torch.isnan(D[:, 0]).all() and torch.isnan(x[..., 0]).all()
    assert torch.equal(D[:, 1:], Dc[:, 1:]) and torch.equal(H[:, 1:], Hc[:, 1:])
    assert torch.equal(x[..., 1:], xc[..., 1:])
