"""The tree solve's half-solves in tensor form (ops/tree_solve.py
``tree_upsolve``: z = L^-T b, ``tree_downsolve``: x = L^-1 z), the entry
points of the contact impulse pass: the plain versions equal the JAX
API's dict forms (``ltdl_upsolve`` on every ancestor-closed dof set,
``ltdl_downsolve``) bit for bit, and JAX's within 1e-6, at ShadowHand's
dof tree and at a random forest; composed with D^-1 they are the
substitute bit for bit; the per-thread walk of the kernels
(csrc/tree_half.cu), replayed here over the host-built table, applies
the plain versions' updates in their order and matches JAX in float64;
the host's launch plan (``half_plan``) fits every shape the wrappers
take; the wrappers' dispatch and checks; the bound's counts; and, on a
CUDA card only, the kernels against the plain versions with the NaN
policy, the card's plan against the host's, and the substitute kernel
(csrc/tree_ltdl.cu) as the two half-solves around the division."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.ops import tree_solve as jts
from bayes_sim_ig_tpu.sim.shadow_hand import build_hand_model
from bayes_sim_ig_tpu_torch.ops import bounds
from bayes_sim_ig_tpu_torch.ops import tree_solve as tts
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts

from .test_torch_tree_solve import _random_chains, _system

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
N = 6
H100_SMS = 132  # streaming multiprocessors of an H100: half_plan's route


def _forest():
    """Three random trees side by side (roots 0, 12 and 20)."""
    chains = []
    for nv, seed in ((12, 3), (8, 4), (10, 5)):
        base = len(chains)
        tree = _random_chains(nv, seed)
        chains += [[base + d for d in ch] for ch in tree]
    return chains


def _edge_chains(nv=tts.MAX_NV, pairs=tts.MAX_PAIRS, seed=0):
    """A random tree at the kernels' edge: nv dofs and at most ``pairs``
    ancestor pairs (1,024 with chains up to 9 deep at seed 0). Each dof
    hangs from a random earlier dof while the pairs allow, else starts a
    new root."""
    rs = np.random.RandomState(seed)
    chains, left = [[]], pairs - nv
    for k in range(1, nv):
        p = int(rs.randint(k))
        if len(chains[p]) < left:
            chains.append([p] + chains[p])
            left -= len(chains[-1])
        else:
            chains.append([])
    return chains


TREES = {"shadow_hand": build_hand_model()[0].dof_anc_chains,
         "forest": _forest()}
# The kernel walk's trees: those above, two random 30-dof trees and the
# wrappers' edge (nv 256, E 1,024).
WALK_TREES = {**TREES, "random_7": _random_chains(30, 7),
              "random_11": _random_chains(30, 11), "edge": _edge_chains()}
BATCH = 4  # csrc/tree_half.cu HALF_BATCH: pairs of a dof loaded at once


def _closure(chains, dof):
    return [dof] + list(chains[dof])


def _factor(chains, seed, n=N, k=None):
    Mp, b, _ = _system(chains, n=n, seed=seed, k=k)
    H, D = tts.ltdl_factor_plain(chains, torch.from_numpy(Mp))
    return H, D, torch.from_numpy(b)


def test_shadow_hand_tree_shape():
    """30 dofs (24 hand, 6 cube), 128 ancestor pairs of 465 (fill 0.275),
    mean chain depth 3.27: the tree solve's right-looking form."""
    tt = tts.tree_tables(TREES["shadow_hand"])
    assert (tt.nv, tt.E) == (30, 128)
    assert abs(tt.mean_depth - 98 / 30) < 1e-12


@pytest.mark.parametrize("tree", list(TREES))
def test_plain_forms_equal_the_dict_forms(tree):
    chains = TREES[tree]
    H, _, b = _factor(chains, 1, k=3)
    pairs = tts.ancestor_pairs(chains)
    Hd = dict(zip(pairs, H.unbind(0)))
    z = tts.ltdl_upsolve_plain(chains, H, b)
    zd = tts.ltdl_upsolve(chains, Hd, dict(enumerate(b.unbind(-2))),
                          range(len(chains)))
    assert torch.equal(z, torch.stack([zd[k] for k in range(len(chains))],
                                      -2))
    x = tts.ltdl_downsolve_plain(chains, H, b)
    xd = tts.ltdl_downsolve(chains, Hd, list(b.unbind(-2)))
    assert torch.equal(x, torch.stack(xd, -2))


@pytest.mark.parametrize("tree", list(TREES))
def test_upsolve_of_closure_rows_is_the_closure_upsolve(tree):
    """A row zero outside an ancestor-closed set stays zero there, and on
    the set it is the dict form restricted to the set, bit for bit: one
    full up-solve serves every closure of the contact rows."""
    chains = TREES[tree]
    H, _, b = _factor(chains, 2)
    Hd = dict(zip(tts.ancestor_pairs(chains), H.unbind(0)))
    for dof in range(len(chains)):
        dofs = _closure(chains, dof)
        row = torch.zeros_like(b)
        row[dofs] = b[dofs]
        z = tts.ltdl_upsolve_plain(chains, H, row)
        zd = tts.ltdl_upsolve(chains, Hd, {d: b[d].clone() for d in dofs},
                              dofs)
        outside = [d for d in range(len(chains)) if d not in dofs]
        assert (z[outside] == 0).all()
        for d in dofs:
            assert torch.equal(z[d], zd[d]), (dof, d)


@pytest.mark.parametrize("tree", list(TREES))
def test_half_solves_match_jax(tree):
    chains = TREES[tree]
    H, _, b = _factor(chains, 3)
    pairs = tts.ancestor_pairs(chains)
    jH = {p: jnp.asarray(H[r].numpy()) for r, p in enumerate(pairs)}
    nv = len(chains)
    jz = jts.ltdl_upsolve(chains, jH, {d: jnp.asarray(b[d].numpy())
                                       for d in range(nv)}, range(nv))
    np.testing.assert_allclose(
        tts.ltdl_upsolve_plain(chains, H, b).numpy(),
        np.stack([np.asarray(jz[d]) for d in range(nv)]), rtol=1e-6,
        atol=1e-6)
    jx = jts.ltdl_downsolve(chains, jH, [jnp.asarray(r.numpy()) for r in b])
    np.testing.assert_allclose(
        tts.ltdl_downsolve_plain(chains, H, b).numpy(),
        np.stack([np.asarray(r) for r in jx]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tree", list(TREES))
def test_half_solves_around_d_are_the_substitute(tree):
    chains = TREES[tree]
    H, D, b = _factor(chains, 4, k=2)
    x = tts.tree_downsolve(chains, H, tts.tree_upsolve(chains, H, b) / D)
    assert torch.equal(x, tts.ltdl_substitute_plain(chains, (H, D), b))


def test_cpu_entry_points_run_the_plain_version():
    chains = TREES["shadow_hand"]
    H, _, b = _factor(chains, 5, k=4)
    before = launch_counts()
    assert torch.equal(tts.tree_upsolve(chains, H, b),
                       tts.ltdl_upsolve_plain(chains, H, b))
    assert torch.equal(tts.tree_downsolve(chains, H, b[0]),
                       tts.ltdl_downsolve_plain(chains, H, b[0]))
    assert launch_counts() == before


@pytest.mark.parametrize("fn", ["ltdl_upsolve_cuda", "ltdl_downsolve_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    chains = TREES["forest"]
    E = len(tts.ancestor_pairs(chains))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tts, fn)(chains, torch.zeros(E, 4),
                         torch.zeros(len(chains), 4))


class _Sym:
    """A symbolic value, hash-consed: two values are equal iff they are the
    same sequence of operations on the same leaves. ``h * x`` is a pending
    product, ``acc - h * x`` one fused multiply-add."""
    ids: dict = {}

    def __init__(self, *key):
        self.id = _Sym.ids.setdefault(key, len(_Sym.ids))

    def __mul__(self, other):
        return self, other

    def __sub__(self, prod):
        l, a = prod
        return _Sym("fma", l.id, a.id, self.id)


_ZERO = _Sym("zero")


def _kernel_walk(tree, H, b, up, fma):
    """One thread's walk in csrc/tree_half.cu over the table head the
    kernels read (off, anc of ``kernel_table``), replayed on the nv rows
    ``b`` with factor rows ``H``. ``fma(l, a, acc)`` is acc - l a; pairs
    past a chain in a batch of ``BATCH`` carry 0: the upsolve leaves them
    out, the downsolve adds fma(0, 0, acc)."""
    tt = tts.tree_tables(tree)
    table = tts.kernel_table(tt)[0]
    nv, E = tt.nv, tt.E
    off, anc = table[:nv + 1], table[nv + 1:nv + 1 + E]
    x = list(b)
    zero = _ZERO if isinstance(b[0], _Sym) else 0.0
    order = range(nv - 1, -1, -1) if up else range(nv)
    for k in order:
        p1 = off[k + 1]
        acc = x[k]
        for p in range(off[k] + 1, p1, BATCH):
            live = [p + u < p1 for u in range(BATCH)]
            a = [anc[p + u] if live[u] else k for u in range(BATCH)]
            l = [H[p + u] if live[u] else zero for u in range(BATCH)]
            if up:  # the chain's ancestors are distinct: read, then write
                v = [x[a[u]] for u in range(BATCH)]
                for u in range(BATCH):
                    if live[u]:
                        x[a[u]] = fma(l[u], acc, v[u])
            else:
                v = [x[a[u]] if live[u] else zero for u in range(BATCH)]
                for u in range(BATCH):
                    acc = fma(l[u], v[u], acc)
        if not up:
            x[k] = acc
    return x


def _sym_fma(l, a, acc):
    """acc - l a; fma(0, 0, acc) is acc exactly in IEEE arithmetic
    (acc + -0 = acc for every acc, signed zeros and NaN included)."""
    if l is _ZERO and a is _ZERO:
        return acc
    return acc - l * a


@pytest.mark.parametrize("tree", list(WALK_TREES))
@pytest.mark.parametrize("up", [True, False], ids=["upsolve", "downsolve"])
def test_kernel_walk_applies_the_plain_updates_in_order(tree, up):
    """Every row gets the plain version's updates (``_upsolve_rows``,
    ``_downsolve_rows``) from the same sources in the same order, so the
    kernels' fused multiply-adds round as the substitute kernel's passes
    do, bit for bit."""
    chains = WALK_TREES[tree]
    tt = tts.tree_tables(chains)
    H = [_Sym("H", p) for p in range(tt.E)]
    b = [_Sym("b", k) for k in range(tt.nv)]
    plain = (tts._upsolve_rows if up else tts._downsolve_rows)(tt, H, b)
    walk = _kernel_walk(chains, H, b, up, _sym_fma)
    assert [r.id for r in walk] == [r.id for r in plain]


@pytest.mark.parametrize("tree", list(WALK_TREES))
def test_kernel_walk_matches_jax_in_float64(tree):
    """The replayed walk in float64 against the JAX package's
    ``ltdl_upsolve`` / ``ltdl_downsolve`` run in float64 (3 right-hand
    sides, N 6)."""
    chains = WALK_TREES[tree]
    H, _, b = _factor(chains, 8, k=3)
    H, b = H.double().numpy(), b.double().numpy()
    nv = len(chains)
    pairs = tts.ancestor_pairs(chains)
    with jax.enable_x64(True):
        jH = {p: jnp.asarray(H[r]) for r, p in enumerate(pairs)}
        jz = jts.ltdl_upsolve(chains, jH, {d: jnp.asarray(b[:, d])
                                           for d in range(nv)}, range(nv))
        jz = np.stack([np.asarray(jz[d]) for d in range(nv)], 1)
        jx = jts.ltdl_downsolve(chains, jH, [jnp.asarray(b[:, d])
                                             for d in range(nv)])
        jx = np.stack([np.asarray(r) for r in jx], 1)
    assert jz.dtype == jx.dtype == np.float64

    def fma(l, a, acc):
        return acc - l * a
    for up, want in ((True, jz), (False, jx)):
        got = np.stack(_kernel_walk(chains, list(H), list(b.transpose(1, 0,
                                                                      2)),
                                    up, fma), 1)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_half_plan_fits_every_shape_the_wrappers_take():
    """For nv 1-256 and E nv-1,024: Kb right-hand sides a block at least 1,
    at most 8 and K, as many as 227 KB hold, at least 4 warps, every
    launch inside the 227 KB and the 65,535 blocks of the grid's y;
    ShadowHand's tree at K = 51 takes 8 a block (7 blocks per 32 envs),
    the edge 2."""
    limit = 232448
    for nv in range(1, tts.MAX_NV + 1):
        for E in range(nv, tts.MAX_PAIRS + 1):
            for K in (1, 5, 51, 65535):
                _, kb, warps, nbytes = tts.half_plan(nv, E, K, 1024,
                                                     H100_SMS)
                assert 1 <= kb <= min(tts.HALF_KB, K)
                assert warps == max(kb, tts.HALF_MIN_WARPS)
                assert nbytes <= limit
                assert -(-K // kb) <= 65535
                if kb < min(tts.HALF_KB, K):  # the shared memory caps it
                    assert nbytes + 4 * tts.HALF_ENVS * nv > limit
    # Table head: 31 + 128 words, padded to 160.
    assert tts.half_plan(30, 128, 51, 1024, H100_SMS) == (False, 8, 8, 4 * (
        160 + 32 * 128 + 8 * 32 * 30))
    assert tts.half_plan(256, 1024, 13, 333, H100_SMS)[:3] == (False, 2, 4)
    for nv, E, K, N in ((0, 1, 1, 1), (257, 300, 1, 1), (30, 29, 1, 1),
                        (30, 1025, 1, 1), (30, 128, 0, 1),
                        (30, 128, 65536, 1), (30, 128, 1, 0)):
        with pytest.raises(ValueError, match="half-solve"):
            tts.half_plan(nv, E, K, N, H100_SMS)


@pytest.mark.parametrize("N,K,lanes", [
    (1024, 1, True), (4096, 1, True), (4224, 1, False), (10000, 1, False),
    (1024, 51, False), (17, 51, True), (1025, 3, True), (1027, 4, False)])
def test_half_plan_route(N, K, lanes):
    """The lane-group pass takes a shape whose thread kernel would walk
    with fewer warps, ceil(N / 32) K, than an H100's 132 SMs: ShadowHand's
    downsolve at its 1024 envs (32 warps), not at 10000 (313)."""
    assert tts.half_plan(30, 128, K, N, H100_SMS)[0] is lanes


def test_half_solve_bound_counts():
    """ShadowHand's tree at 1024 envs and K = 51: the 98 off-diagonal
    pairs read once, b read and x written (51 x 30 floats a env); 98
    multiply-adds a right-hand side."""
    b = bounds.tree_half_solve(TREES["shadow_hand"], 1024, 51)
    assert b.bytes == 4 * 1024 * (98 + 2 * 51 * 30)
    assert b.flops == 1024 * 51 * 2 * 98
    assert b.by == "bytes"


def _card(tree, n, k, seed=6):
    chains = (WALK_TREES[tree] if tree in WALK_TREES
              else _random_chains(30, int(tree.rsplit("_", 1)[1])))
    H, D, b = _factor(chains, seed, n=n, k=k)
    return chains, H.cuda(), D.cuda(), b.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n,k", [
    ("shadow_hand", 1024, 51), ("shadow_hand", 1024, None),
    ("shadow_hand", 10000, 51), ("shadow_hand", 10001, None),
    ("forest", 1027, 3), ("random_7", 33, 2), ("shadow_hand", 1, 1),
    ("edge", 333, 13)])
def test_half_solve_kernels_match_plain_on_card(tree, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, H, D, b = _card(tree, n, k)
    before = launch_counts()
    z = tts.tree_upsolve(chains, H, b)
    x = tts.tree_downsolve(chains, H, b)
    torch.cuda.synchronize()
    after = launch_counts()
    for kind in ("tree_ltdl_upsolve", "tree_ltdl_downsolve"):
        assert after[kind] == before[kind] + 1
    torch.testing.assert_close(z, tts.ltdl_upsolve_plain(chains, H, b),
                               **TOL)
    torch.testing.assert_close(x, tts.ltdl_downsolve_plain(chains, H, b),
                               **TOL)


@pytest.mark.cuda
def test_half_plan_of_the_card_is_the_hosts():
    """csrc/tree_half.cu plans every launch as ``half_plan`` does with the
    card's SM count (nv
    1-256, E from nv to 1,024 in steps of 7 and 1,024, (K, N) (1, 1024),
    (5, 333), (51, 1024), (65,535, 1))."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    for nv in range(1, tts.MAX_NV + 1):
        for E in [*range(nv, tts.MAX_PAIRS + 1, 7), tts.MAX_PAIRS]:
            for K, N in ((1, 1024), (5, 333), (51, 1024), (65535, 1)):
                assert (tts.half_plan_cuda(nv, E, K, N)
                        == tts.half_plan(nv, E, K, N, sms))


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n", [("shadow_hand", 1024), ("forest", 129),
                                    ("shadow_hand", 4500)])
def test_half_solve_kernels_nan_policy_on_card(tree, n):
    """An env whose factor went non-finite (H NaN) comes out non-finite,
    at the plain version's NaN positions; every other env is bit for bit
    its clean run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, H, _, b = _card(tree, n, 3)
    bad = H.clone()
    bad[:, 5] = float("nan")
    for fn, plain in ((tts.ltdl_upsolve_cuda, tts.ltdl_upsolve_plain),
                      (tts.ltdl_downsolve_cuda, tts.ltdl_downsolve_plain)):
        clean, got = fn(chains, H, b), fn(chains, bad, b)
        torch.cuda.synchronize()
        assert not torch.isfinite(got[..., 5]).all()
        assert torch.equal(torch.isnan(got), torch.isnan(plain(chains, bad,
                                                               b)))
        assert torch.equal(got[..., :5], clean[..., :5])
        assert torch.equal(got[..., 6:], clean[..., 6:])


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n", [("shadow_hand", 1024), ("forest", 129),
                                    ("shadow_hand", 4500)])
def test_substitute_kernel_is_its_half_solves_on_card(tree, n):
    """The substitute kernel is the up pass, the division by D and the
    down pass in one launch: the two half-solve launches around a
    division give it bit for bit, on the lane route and (4,500 envs, K 4:
    564 warps) on the one-thread-per-(env, right-hand side) kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, H, D, b = _card(tree, n, 4)
    x = tts.ltdl_downsolve_cuda(chains, H,
                                tts.ltdl_upsolve_cuda(chains, H, b) / D)
    assert torch.equal(x, tts.ltdl_substitute_cuda(chains, (H, D), b))
