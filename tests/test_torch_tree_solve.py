"""The port's branch-sparse L^T D L (ops/tree_solve.py) against the JAX
package's, on Humanoid's dof tree, Ant's and random trees (nv 5-30) built
with numpy from a seed: every function of the JAX API, the tensor form
the physics and the kernel use, K right-hand sides, the NaN-pivot policy,
the wrappers' dispatch on CPU tensors, and, on a CUDA card only, the
hand-written kernel (csrc/tree_ltdl.cu) against the plain version.

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
from bayes_sim_ig_tpu.sim.humanoid import build_humanoid_model
from bayes_sim_ig_tpu_torch.ops import tree_solve as tts

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
    "random5": _random_chains(5, 0),
    "random12": _random_chains(12, 1),
    "random30": _random_chains(30, 2),
}


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
    before = dict(tts.LAUNCHES)
    fac = tts.tree_factor(chains, torch.from_numpy(Mp), left_looking=True)
    want = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp), True)
    assert torch.equal(fac[0], want[0]) and torch.equal(fac[1], want[1])
    x = tts.tree_substitute(chains, fac, torch.from_numpy(b))
    assert torch.equal(x, tts.ltdl_substitute_plain(chains, fac,
                                                    torch.from_numpy(b)))
    assert tts.LAUNCHES == before


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
    chains = (TREES[tree] if tree in TREES else
              _random_chains(30, int(tree.rsplit("_", 1)[1])))
    Mp, b, _ = _system(chains, n=n, seed=10, k=k)
    Mp[:, 0] = -Mp[:, 0]  # env 0 indefinite: every pivot negative
    return chains, torch.from_numpy(Mp).cuda(), torch.from_numpy(b).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n,k", [
    ("humanoid", 4096, 1), ("humanoid", 1, 1), ("humanoid", 17, 4),
    ("ant", 1024, 4), ("random_2", 1024, 1), ("random_3", 33, 4)])
def test_kernels_match_plain_on_card(tree, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, Mp, b = _card_system(tree, n, k)
    before = dict(tts.LAUNCHES)
    H, D = tts.tree_factor(chains, Mp)
    x = tts.tree_substitute(chains, (H, D), b)
    torch.cuda.synchronize()
    assert tts.LAUNCHES["factor"] == before["factor"] + 1
    assert tts.LAUNCHES["substitute"] == before["substitute"] + 1
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
