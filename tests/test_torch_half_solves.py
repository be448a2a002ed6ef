"""The tree solve's half-solves in tensor form (ops/tree_solve.py
``tree_upsolve``: z = L^-T b, ``tree_downsolve``: x = L^-1 z), the entry
points of the contact impulse pass: the plain versions equal the JAX
API's dict forms (``ltdl_upsolve`` on every ancestor-closed dof set,
``ltdl_downsolve``) bit for bit, and JAX's within 1e-6, at ShadowHand's
dof tree and at a random forest; composed with D^-1 they are the
substitute bit for bit; the wrappers' dispatch and checks; the bound's
counts; and, on a CUDA card only, the kernel's up and down passes
(csrc/tree_ltdl.cu) against the plain versions with the NaN policy, and
the kernel's substitute as its two half-solves around the division."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayes_sim_ig_tpu.ops import tree_solve as jts
from bayes_sim_ig_tpu.sim.shadow_hand import build_hand_model
from bayes_sim_ig_tpu_torch.ops import bounds
from bayes_sim_ig_tpu_torch.ops import tree_solve as tts

from .test_torch_tree_solve import _random_chains, _system

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
N = 6


def _forest():
    """Three random trees side by side (roots 0, 12 and 20)."""
    chains = []
    for nv, seed in ((12, 3), (8, 4), (10, 5)):
        base = len(chains)
        tree = _random_chains(nv, seed)
        chains += [[base + d for d in ch] for ch in tree]
    return chains


TREES = {"shadow_hand": build_hand_model()[0].dof_anc_chains,
         "forest": _forest()}


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
    before = dict(tts.LAUNCHES)
    assert torch.equal(tts.tree_upsolve(chains, H, b),
                       tts.ltdl_upsolve_plain(chains, H, b))
    assert torch.equal(tts.tree_downsolve(chains, H, b[0]),
                       tts.ltdl_downsolve_plain(chains, H, b[0]))
    assert tts.LAUNCHES == before


@pytest.mark.parametrize("fn", ["ltdl_upsolve_cuda", "ltdl_downsolve_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    chains = TREES["forest"]
    E = len(tts.ancestor_pairs(chains))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(tts, fn)(chains, torch.zeros(E, 4),
                         torch.zeros(len(chains), 4))


def test_half_solve_bound_counts():
    """ShadowHand's tree at 1024 envs and K = 51: the 98 off-diagonal
    pairs read once, b read and x written (51 x 30 floats a env); 98
    multiply-adds a right-hand side."""
    b = bounds.tree_half_solve(TREES["shadow_hand"], 1024, 51)
    assert b.bytes == 4 * 1024 * (98 + 2 * 51 * 30)
    assert b.flops == 1024 * 51 * 2 * 98
    assert b.by == "bytes"


def _card(tree, n, k, seed=6):
    chains = (TREES[tree] if tree in TREES
              else _random_chains(30, int(tree.rsplit("_", 1)[1])))
    H, D, b = _factor(chains, seed, n=n, k=k)
    return chains, H.cuda(), D.cuda(), b.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n,k", [
    ("shadow_hand", 1024, 51), ("shadow_hand", 1024, None),
    ("shadow_hand", 10000, 51), ("shadow_hand", 10001, None),
    ("forest", 1027, 3), ("random_7", 33, 2), ("shadow_hand", 1, 1)])
def test_half_solve_kernels_match_plain_on_card(tree, n, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, H, D, b = _card(tree, n, k)
    before = dict(tts.LAUNCHES)
    z = tts.tree_upsolve(chains, H, b)
    x = tts.tree_downsolve(chains, H, b)
    torch.cuda.synchronize()
    assert tts.LAUNCHES["upsolve"] == before["upsolve"] + 1
    assert tts.LAUNCHES["downsolve"] == before["downsolve"] + 1
    torch.testing.assert_close(z, tts.ltdl_upsolve_plain(chains, H, b),
                               **TOL)
    torch.testing.assert_close(x, tts.ltdl_downsolve_plain(chains, H, b),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("tree,n", [("shadow_hand", 1024), ("forest", 129)])
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
@pytest.mark.parametrize("tree,n", [("shadow_hand", 1024), ("forest", 129)])
def test_substitute_kernel_is_its_half_solves_on_card(tree, n):
    """The substitute kernel is the up pass, the division by D and the
    down pass in one launch: the two half-solve launches around a
    division give it bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    chains, H, D, b = _card(tree, n, 4)
    x = tts.ltdl_downsolve_cuda(chains, H,
                                tts.ltdl_upsolve_cuda(chains, H, b) / D)
    assert torch.equal(x, tts.ltdl_substitute_cuda(chains, (H, D), b))
