"""The port's batched SPD factor/solve (ops/spd_kernel.py): its plain
versions against the JAX package's lanes Cholesky and its Pallas kernel
(interpret mode, as tests/test_ops.py runs it), the NaN-pivot policy, K
right-hand sides, the autograd backward against the Pallas VJP, the
wrappers' dispatch on CPU tensors, the kernels' lane algorithm replayed
in numpy, the bound counts, and, on a CUDA card only, the hand-written
kernels against the plain versions (at odd n and env counts too).

Tolerances: the plain Cholesky against JAX's is the same algorithm in
float32 with sums taken in another order, rtol 1e-5 / atol 1e-6 on
systems A = M M^T + n I (condition number ~5); a Cholesky solve against
the Pallas Gauss elimination, and gradients through two solves, rtol
1e-4 / atol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from bayes_sim_ig_tpu.ops import spd_kernel as jspd
from bayes_sim_ig_tpu_torch.ops import bounds, spd_kernel
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)


def _spd(n, N, seed=0, k=None):
    """Env-last SPD systems At (n, n, N) = M M^T + n I and right-hand
    sides (n, N), or (k, n, N) with ``k``."""
    rs = np.random.RandomState(seed)
    M = rs.randn(N, n, n)
    A = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    At = np.ascontiguousarray(A.transpose(1, 2, 0)).astype(np.float32)
    shape = (n, N) if k is None else (k, n, N)
    return At, rs.randn(*shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [3, 14, 30])
def test_plain_factor_matches_jax_lanes_cholesky(n):
    At, _ = _spd(n, 7, seed=n)
    want = np.asarray(jspd._chol_lanes_factor(jnp.asarray(At)))
    got = spd_kernel._chol_lanes_factor(_t(At)).numpy()
    np.testing.assert_allclose(got, want, **TIGHT)
    # Lt[k] holds column k of L: zeros above the diagonal, exactly.
    rows, cols = np.triu_indices(n, 1)
    assert (got[cols, rows] == 0).all()


@pytest.mark.parametrize("n", [3, 14, 30])
def test_plain_substitute_matches_jax(n):
    At, bt = _spd(n, 7, seed=n + 1)
    Lt = np.asarray(jspd._chol_lanes_factor(jnp.asarray(At)))
    want = np.asarray(jspd._chol_lanes_substitute(jnp.asarray(Lt),
                                                  jnp.asarray(bt)))
    got = spd_kernel._chol_lanes_substitute(_t(Lt), _t(bt)).numpy()
    np.testing.assert_allclose(got, want, **TIGHT)
    # And it solves the system.
    x = got.astype(np.float64)
    resid = np.einsum("ijn,jn->in", At.astype(np.float64), x) - bt
    assert np.abs(resid).max() < 1e-4


@pytest.mark.parametrize("n,N", [(3, 5), (14, 9)])
def test_plain_solve_matches_pallas_interpret(n, N):
    At, bt = _spd(n, N, seed=2 * n)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jspd._pallas_lanes(jnp.asarray(At),
                                             jnp.asarray(bt)))
    got = spd_kernel._chol_lanes_core(_t(At), _t(bt)).numpy()
    np.testing.assert_allclose(got, want, **LOOSE)


def test_nan_pivot_poisons_only_its_env():
    """A pivot that is not > 0 (a negative one in env 1, an exact 0 in env
    3) gives NaN in that env's column, as JAX's lanes Cholesky does (NaN,
    not inf, for 0), and leaves the other envs' solutions untouched."""
    n, N = 6, 5
    At, bt = _spd(n, N, seed=3)
    bad = At.copy()
    bad[:, :, 1] = -np.eye(n, dtype=np.float32)
    bad[:, :, 3] = 0.0
    Lt = spd_kernel._chol_lanes_factor(_t(bad))
    want_L = np.asarray(jspd._chol_lanes_factor(jnp.asarray(bad)))
    np.testing.assert_array_equal(np.isnan(Lt.numpy()), np.isnan(want_L))
    x = spd_kernel._chol_lanes_substitute(Lt, _t(bt)).numpy()
    assert np.isnan(x[:, [1, 3]]).all()
    good = [0, 2, 4]
    ref = spd_kernel._chol_lanes_core(_t(At), _t(bt)).numpy()
    np.testing.assert_array_equal(x[:, good], ref[:, good])
    assert np.isfinite(x[:, good]).all()


def test_k_right_hand_sides_equal_k_single_substitutes():
    n, N, k = 14, 6, 4
    At, bt = _spd(n, N, seed=5, k=k)
    fac = spd_kernel.spd_factor_lanes(_t(At))
    got = spd_kernel.spd_substitute_lanes(fac, _t(bt))
    assert got.shape == (k, n, N)
    for r in range(k):
        one = spd_kernel.spd_substitute_lanes(fac, _t(bt[r]))
        np.testing.assert_array_equal(got[r].numpy(), one.numpy())


def test_autograd_backward_matches_pallas_vjp():
    n, N = 5, 4
    At, bt = _spd(n, N, seed=6)
    g = np.random.RandomState(7).randn(n, N).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        x_j, vjp = jax.vjp(jspd._pallas_lanes_vjp, jnp.asarray(At),
                           jnp.asarray(bt))
        dA_j, db_j = vjp(jnp.asarray(g))
    A_t = _t(At).requires_grad_(True)
    b_t = _t(bt).requires_grad_(True)
    x_t = spd_kernel.spd_solve_lanes(A_t, b_t)
    x_t.backward(_t(g))
    np.testing.assert_allclose(x_t.detach().numpy(), np.asarray(x_j),
                               **LOOSE)
    np.testing.assert_allclose(A_t.grad.numpy(), np.asarray(dA_j), **LOOSE)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(db_j), **LOOSE)


def test_cpu_factor_uses_the_plain_version_and_agrees_with_jax():
    At, bt = _spd(14, 8, seed=8)
    before = launch_counts()
    kind, Lt = spd_kernel.spd_factor_lanes(_t(At))
    assert kind == "chol_lanes"
    assert torch.equal(Lt, spd_kernel._chol_lanes_factor(_t(At)))
    np.testing.assert_allclose(
        Lt.numpy(), np.asarray(jspd._chol_lanes_factor(jnp.asarray(At))),
        **TIGHT)
    # The JAX package's own CPU route (XLA Cholesky) solves the same x.
    fac_j = jspd.spd_factor_lanes(jnp.asarray(At))
    np.testing.assert_allclose(
        spd_kernel.spd_substitute_lanes((kind, Lt), _t(bt)).numpy(),
        np.asarray(jspd.spd_substitute_lanes(fac_j, jnp.asarray(bt))),
        **LOOSE)
    assert launch_counts() == before


def test_standard_layout_solve():
    rs = np.random.RandomState(9)
    M = rs.randn(2, 3, 4, 4)
    A = (M @ np.swapaxes(M, -1, -2) + 4 * np.eye(4)).astype(np.float32)
    b = rs.randn(2, 3, 4).astype(np.float32)
    got = spd_kernel.spd_solve(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, np.linalg.solve(A, b[..., None])[..., 0],
                               **LOOSE)


def _replay_lanes(At, bt):
    """csrc/spd_lanes.cu's lane algorithm in numpy float32, lanes as the
    row axis: the right-looking factor (column step k: the pivot lane's
    raw pivot, every lane's own divide, the rank-1 update of the trailing
    rows with L[j][k] from lane j), then the forward pass and the back
    pass, one broadcast value a step. Returns (Lt, x)."""
    n, _, N = At.shape
    a = np.array(At.transpose(2, 0, 1))                     # (N, i, j)
    for k in range(n):
        raw = a[:, k, k]
        d = np.where(raw > 0, np.sqrt(np.maximum(raw, 1e-30)),
                     np.float32(np.nan)).astype(np.float32)
        lik = a[:, :, k] / d[:, None]
        a[:, k:, k] = lik[:, k:]
        for j in range(k + 1, n):
            a[:, j:, j] -= lik[:, j:] * lik[:, j, None]
    L = np.tril(a)
    diag = np.diagonal(L, axis1=1, axis2=2)
    acc, y = bt.T.copy(), np.zeros_like(bt.T)               # (N, i)
    for k in range(n):
        y[:, k] = acc[:, k] / diag[:, k]
        acc[:, k + 1:] -= L[:, k + 1:, k] * y[:, k, None]
    acc, x = y, np.zeros_like(y)
    for k in range(n - 1, -1, -1):
        x[:, k] = acc[:, k] / diag[:, k]
        acc[:, :k] -= L[:, k, :k] * x[:, k, None]
    return L.transpose(2, 1, 0), x.T


@pytest.mark.parametrize("n,N", [(1, 3), (10, 4), (13, 5), (14, 9),
                                 (17, 4), (18, 6), (32, 3)])
def test_lane_algorithm_replay_matches_plain(n, N):
    """The kernels' order of operations against the plain versions: the
    factor and both passes within rtol 1e-4 / atol 1e-5 (sums in another
    order), zeros above the diagonal exact, and a NaN pivot (env 0) NaN
    in its env only."""
    At, bt = _spd(n, N, seed=4 * n)
    At[:, :, 0] = -np.eye(n, dtype=np.float32)
    Lt, x = _replay_lanes(At, bt)
    Lp = spd_kernel._chol_lanes_factor(_t(At))
    np.testing.assert_allclose(Lt, Lp.numpy(), **LOOSE)
    rows, cols = np.triu_indices(n, 1)
    assert (Lt[cols, rows] == 0).all()
    xp = spd_kernel._chol_lanes_substitute(Lp, _t(bt)).numpy()
    np.testing.assert_allclose(x, xp, **LOOSE)
    assert np.isnan(x[:, 0]).all() and np.isfinite(x[:, 1:]).all()


def test_full_warp_replay_at_anymal_systems():
    """The n = 18 instance (a full warp an env, 14 lanes idle) replayed on
    Anymal-like systems: a CRBA-shaped SPD matrix per env (A = B B^T + 18
    I kept at the dense pattern, scaled by per-env masses over 0.01-5x),
    factor and solve within rtol 1e-4 / atol 1e-5 of the plain versions,
    which also solve the system in float64 to 1e-4 of |x|."""
    rs = np.random.RandomState(18)
    n, N = 18, 5
    B = rs.randn(N, n, n)
    A = (B @ B.transpose(0, 2, 1) + n * np.eye(n)) * rs.uniform(
        0.01, 5.0, (N, 1, 1))
    At = np.ascontiguousarray(A.transpose(1, 2, 0)).astype(np.float32)
    bt = rs.randn(n, N).astype(np.float32)
    Lt, x = _replay_lanes(At, bt)
    Lp = spd_kernel._chol_lanes_factor(_t(At))
    np.testing.assert_allclose(Lt, Lp.numpy(), **LOOSE)
    xp = spd_kernel._chol_lanes_substitute(Lp, _t(bt)).numpy()
    np.testing.assert_allclose(x, xp, **LOOSE)
    want = np.linalg.solve(A, bt.T.astype(np.float64)[..., None])[..., 0].T
    assert np.abs(xp - want).max() <= 1e-4 * np.abs(want).max()


def test_bounds_hand_counts():
    """Bytes at Ant's path shape (n 14, N 1024): the factor reads A's
    lower triangle (105 floats an env) and writes all of Lt (196); the
    substitute reads L's lower triangle and b, writes x (14 each)."""
    f = bounds.spd_factor(14, 1024)
    assert f.bytes == 4 * 1024 * (105 + 196) == 1_232_896
    assert f.flops == 1024 * (2 * 455 + 91 + 14)
    s = bounds.spd_substitute(14, 1024)
    assert s.bytes == 4 * 1024 * (105 + 14 + 14) == 544_768
    assert s.flops == 1024 * (2 * 14 * 13 + 28)
    assert bounds.spd_substitute(14, 1024, K=4).bytes == \
        4 * 1024 * (105 + 8 * 14)
    solve = bounds.spd_solve(14, 1024)
    assert solve.bytes == 544_768 and solve.flops == f.flops + s.flops
    assert f.by == s.by == solve.by == "bytes"
    assert f.ms == pytest.approx(1_232_896 / 3.35e12 * 1e3)
    assert s.ms == pytest.approx(0.00016261731, rel=1e-6)


@pytest.mark.parametrize("fn,args", [
    ("spd_factor_lanes_cuda", ((3, 3, 4),)),
    ("spd_substitute_lanes_cuda", ((3, 3, 4), (3, 4))),
    ("spd_solve_lanes_cuda", ((3, 3, 4), (3, 4))),
])
def test_kernel_wrappers_refuse_cpu_tensors(fn, args):
    with pytest.raises(ValueError, match="CUDA"):
        getattr(spd_kernel, fn)(*[torch.zeros(s) for s in args])


@pytest.mark.cuda
@pytest.mark.parametrize("n,N,k", [(14, 1024, 1), (14, 1, 1), (5, 17, 4),
                                   (30, 1024, 4), (18, 4000, 1),
                                   (14, 8192, 1), (10, 4096, 2),
                                   (10, 2048, 1)])
def test_kernels_match_plain_on_card(n, N, k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    At, bt = _spd(n, N, seed=n, k=k)
    At[:, :, 0] = -np.eye(n, dtype=np.float32)  # a NaN pivot in env 0
    A_c, b_c = _t(At).cuda(), _t(bt).cuda()
    before = launch_counts()
    Lt = spd_kernel.spd_factor_lanes(A_c)[1]
    x = spd_kernel.spd_substitute_lanes(("chol_lanes", Lt), b_c)
    torch.cuda.synchronize()
    after = launch_counts()
    for kind in ("spd_factor_lanes", "spd_substitute_lanes"):
        assert after[kind] == before[kind] + 1
    torch.testing.assert_close(Lt, spd_kernel._chol_lanes_factor(A_c),
                               equal_nan=True, **LOOSE)
    torch.testing.assert_close(
        x, spd_kernel._chol_lanes_substitute(Lt, b_c), equal_nan=True,
        **LOOSE)
    assert torch.isnan(x[..., 0]).all() and torch.isfinite(x[..., 1:]).all()
    fused = spd_kernel.spd_solve_lanes(A_c, b_c[0])
    torch.testing.assert_close(fused, x[0], equal_nan=True, **LOOSE)


@pytest.mark.cuda
@pytest.mark.parametrize("n,N,k", [(1, 9, 1), (13, 1027, 2), (16, 1, 1),
                                   (16, 1029, 3), (17, 9, 1), (32, 1027, 2),
                                   (32, 5, 1)])
def test_odd_shapes_on_card(n, N, k):
    """The half-warp (n <= 16) and full-warp instances at n that leave
    lanes idle and env counts that leave a partial block (8 or 4 envs a
    block), against the plain versions; env 0 indefinite is NaN in its
    env only, every other env bit for bit its clean run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    At, bt = _spd(n, N, seed=n + N, k=k)
    clean_A, b_c = _t(At).cuda(), _t(bt).cuda()
    A_c = clean_A.clone()
    A_c[:, :, 0] = -torch.eye(n, device="cuda")
    Lt = spd_kernel.spd_factor_lanes_cuda(A_c)
    x = spd_kernel.spd_substitute_lanes_cuda(Lt, b_c)
    fused = spd_kernel.spd_solve_lanes_cuda(A_c, b_c[0])
    Lp = spd_kernel._chol_lanes_factor(A_c)
    torch.testing.assert_close(Lt, Lp, equal_nan=True, **LOOSE)
    torch.testing.assert_close(x, spd_kernel._chol_lanes_substitute(Lp, b_c),
                               equal_nan=True, **LOOSE)
    torch.testing.assert_close(fused, x[0], equal_nan=True, **LOOSE)
    Lc = spd_kernel.spd_factor_lanes_cuda(clean_A)
    xc = spd_kernel.spd_substitute_lanes_cuda(Lc, b_c)
    fc = spd_kernel.spd_solve_lanes_cuda(clean_A, b_c[0])
    torch.cuda.synchronize()
    assert torch.isnan(x[..., 0]).all() and torch.isnan(fused[:, 0]).all()
    assert torch.equal(Lt[..., 1:], Lc[..., 1:])
    assert torch.equal(x[..., 1:], xc[..., 1:])
    assert torch.equal(fused[:, 1:], fc[:, 1:])
