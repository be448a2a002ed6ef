"""The counts from shapes against hand-worked examples, and the reading of
a profiler slice on made-up intervals."""

import pytest

from benchkit import counts, readers
from benchkit.trace import Slice, idle_gaps, innermost, union_seconds

# A three-dof chain: dof 1's ancestors [0], dof 2's [1, 0]. Pairs with the
# diagonal: E = 3 + 0 + 1 + 2 = 6.
CHAIN = [[], [0], [1, 0]]


def test_tree_factor_bytes_and_flops():
    b = counts.tree_factor(CHAIN, N=2)
    # Reads M (6), writes H (6) and D (3): 15 floats an env.
    assert b.bytes == 4 * 2 * 15
    # sum_k dk (dk + 1) / 2 = 0 + 1 + 3 updates, 3 FLOPs each, and
    # E - nv = 3 divides: 15 an env.
    assert b.flops == 2 * 15


def test_tree_substitute_and_half_solve():
    s = counts.tree_substitute(CHAIN, N=2, K=1)
    # Off-diagonal pairs (3), D (3), b and x (3 each).
    assert s.bytes == 4 * 2 * 12
    assert s.flops == 2 * (4 * 3 + 3)
    h = counts.tree_half_solve(CHAIN, N=2, K=2)
    assert h.bytes == 4 * 2 * (3 + 2 * 2 * 3)
    assert h.flops == 2 * 2 * 2 * 3


def test_a_steps_bound_is_the_sum_of_its_solves():
    solves = [{"kind": "factor", "count": 2},
              {"kind": "upsolve", "count": 1, "K": 2}]
    want = (2 * counts.tree_factor(CHAIN, 2).seconds
            + counts.tree_half_solve(CHAIN, 2, 2).seconds)
    assert counts.tree_step_seconds(CHAIN, 2, solves) == pytest.approx(want)
    f = counts.tree_factor(CHAIN, 2)
    assert f.seconds == max(f.bytes / 3.35e12, f.flops / 67e12)


def test_mlp_flops():
    # 3 -> 4 -> 2: 12 + 8 multiply-adds a row.
    assert counts.mlp_macs([3, 4, 2]) == 20
    assert counts.forward_flops([3, 4, 2], rows=5) == 2 * 5 * 20
    # Forward (20), weight gradients (20), input gradients of the second
    # layer only (8): 48 multiply-adds a row.
    assert counts.train_flops([3, 4, 2], rows=5) == 2 * 5 * 48


def test_a_ppo_iterations_flops():
    net = counts.ActorCritic(obs=3, act=2, pi=[4], vf=[4], critic_in=3)
    # Actor 3-4-2 (20 multiply-adds), critic 3-4-1 (16).
    envs, nsteps, epochs = 10, 2, 3
    rollout = nsteps * 2 * envs * (20 + 16)
    last = 2 * envs * 16
    rows = nsteps * envs
    update = epochs * 2 * rows * ((3 * 20 - 12) + (3 * 16 - 12))
    assert counts.ppo_iteration_flops(net, envs, nsteps, epochs) == (
        rollout + last + update)


def test_an_mdn_fits_flops():
    # Input 3, one hidden layer of 4, D = 2 labels, K = 2 components: the
    # heads 4 -> 2, 4 -> 4, 4 -> 4 (40 multiply-adds); trunk 12.
    fwd = counts.mdn_forward_flops(3, [4], 2, 2, rows=7)
    assert fwd == 2 * 7 * (12 + 40)
    fit = counts.mdn_fit_flops(3, [4], 2, 2, batch=5, updates=10,
                               test_rows=7, evals=6)
    per_update = 2 * 5 * (2 * 12) + 2 * 5 * 3 * 40
    assert fit == 10 * per_update + 6 * fwd


def test_union_and_gaps_of_intervals():
    iv = [(1.0, 2.0), (1.5, 3.0), (4.0, 5.0)]
    assert union_seconds(iv, 0.0, 6.0) == pytest.approx(3.0)
    assert union_seconds(iv, 1.75, 4.5) == pytest.approx(1.75)
    assert idle_gaps(iv, 0.0, 6.0) == [(0.0, 1.0), (3.0, 4.0), (5.0, 6.0)]
    ranges = [("outer", 0.0, 6.0), ("frames", 2.5, 4.5)]
    assert innermost(ranges, 3.5, "slice") == "frames"
    assert innermost(ranges, 5.5, "slice") == "outer"
    assert innermost([], 1.0, "slice") == "slice"


def test_a_slices_readings():
    s = Slice(label="s", lo=0.0, hi=10.0,
              ops=[("tree_factor_kernel<8>", 1.0, 2.0),
                   ("tree_half_kernel", 2.0, 2.5),
                   ("gemm", 2.25, 4.0)],
              ranges=[("frames", 4.0, 9.0)], host_seconds=10.0)
    assert s.busy_s == pytest.approx(3.0)
    assert s.device_seconds(r"tree_\w*kernel") == pytest.approx(1.5)
    assert s.top_ops(2) == [["gemm", pytest.approx(1.75)],
                            ["tree_factor_kernel<8>", pytest.approx(1.0)]]
    assert s.top_gaps() == [["frames", pytest.approx(6.0)],
                            ["s", pytest.approx(1.0)]]
    # A gap is labelled by the range that holds its middle.
    early = Slice(label="s", lo=0.0, hi=4.0, ops=[("k", 3.0, 4.0)],
                  ranges=[("frames", 0.1, 3.0)], host_seconds=4.0)
    assert early.top_gaps() == [["frames", pytest.approx(3.0)]]


def test_percentile_and_empty_readings():
    assert readers.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 50) == 3.0
    assert readers.percentile([1.0, 2.0], 95) == pytest.approx(1.95)
    assert readers.percentile([], 95) is None
