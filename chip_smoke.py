"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit, and
     holds float32 products to full precision (no TF32);
  2. build: compiles the port's CUDA kernels from csrc/ (one nvcc per
     source, started together);
  3. kernels vs plain, on the card at the main paths' shapes with the
     stated tolerances; the median time per call of both over 50 calls
     (CUDA events) and their device time per call (torch.profiler):
     - rff_features (csrc/rff_features.cu) at the MDRFF shapes (timed
       at B = 1, 100, 200 and 1000), with x one row into a larger tensor
       (8-B and 4-B aligned bases), and at phases of ~500 rad against
       float64 under a d 2^-23 sum|x coeff| bound;
     - the SPD factor, substitute (K = 1 and K = 4), fused solve and the
       solve's autograd backward (csrc/spd_lanes.cu) at the ADR paths'
       mass matrices (n, N) = (14, 1024) (Ant), (18, 4000) (Anymal, the
       full-warp instance), (14, 8192) (Quadcopter), (10, 4096)
       (Ingenuity) and (10, 2048) (FrankaCabinet), and at (14, 1),
       (14, 4096), (30, 1024), (5, 17) and the odd n and env counts the
       lane groups must mask (1, 9), (13, 1027), (16, 1029), (17, 9) and
       (32, 1027); at each path shape the times against the plain
       versions and the library yardsticks, each one PyTorch call on the
       same systems env-first and contiguous (the permute excluded):
       cholesky_ex for the factor, cholesky_solve for the substitute,
       linalg.solve for the fused solve; and the NaN-pivot policy (one
       indefinite system: NaN in its env only, every other env bit for bit
       the clean run, factor, substitute and fused solve);
     - the tree L^T D L factor and substitute (csrc/tree_ltdl.cu) on
       Humanoid's dof tree at N = 4096, 1 and 17, BallBalance's two-root
       forest at 128 and 129, ShadowHand's tree at 1024, 10000
       (shadow_hand_more.yaml) and 16384 (phase 9c), Ant's (nearly
       dense) tree at 1024 and 1025,
       Anymal's at 4000, a random 30-dof tree (numpy, seed 0) at 1024 and
       1027 and a 40-deep chain (chains longer than the 16 lanes of an
       env) at 1027: the factor against the right-looking plain factor,
       the substitute at K = 1 and K = 4, factor + substitute against the
       plain dense Cholesky solve of the same M; the NaN-pivot policy on
       Humanoid's tree and BallBalance's forest (one indefinite env: NaN
       in its env only, every other env bit for bit the clean run); at
       (Humanoid, 4096), (BallBalance, 128) and (ShadowHand, 1024, 10000
       and 16384) the times of both kernels
       against the path's plain version and the dense yardstick of the
       pair (cholesky_ex + cholesky_solve on the same systems made dense,
       env-first); and at Humanoid's, BallBalance's, Anymal's and Ant's
       trees the tree-vs-dense A/B: the two tree kernels against the two
       SPD kernels on the same M made dense;
     - the tree half-solves, L^-T (upsolve) and L^-1 (downsolve), the
       passes of the impulse contact pass (csrc/tree_half.cu: one thread
       per env and right-hand side, or the substitute's 16-lane pass below
       one walking warp an SM), on ShadowHand's dof tree at 1024
       envs (K = 51, the 51 impulse rows, and K = 1), at 10000 envs
       (shadow_hand_more.yaml's width) and at 16384, a random 30-dof tree,
       odd env
       counts and a 256-dof tree of 1,024 pairs (the wrappers' edge, 2
       right-hand sides a block), against their plain versions, with the
       NaN policy (an env whose H is NaN comes out non-finite, every
       other env bit for bit its clean run); at the ShadowHand shapes
       their times against the plain versions, the bound and the
       one-call yardstick solve_triangular(unitriangular) on L made
       dense;
     - the integration kernel (csrc/integrate.cu: a substep's integrate
       and clamp_limits in one launch) on every articulated task's model at
       its ADR width and on ShadowHand's at 10000, at states that drive
       every clamp, against the torch chain it replaces on the card, bit
       for bit; at the benchmark cells' widths (Anymal 4000, Humanoid 4096,
       ShadowHand 10000) the times of both alone and in a CUDA graph of 20
       calls, the chain's launches a call and the bound;
  4. the step graphs (utils/step_graph.py): each of the ten tasks at the
     full width of its ADR phase (below; Cartpole 512, Pendulum 100
     envs) runs 20 collection steps (its config's collection policy, the
     prior) and one PPO rollout of nsteps (a 10-component posterior;
     ShadowHand's with the asymmetric critic) as CUDA graph replays
     and as the eager body from the same state and generators: every
     trajectory entry, state leaf, observation and generator state bit
     for bit equal, the replays' kernel launches equal the body's, one
     eager step under sync debug mode "error" (no host sync, no
     host-to-device copy); prints the wall ms per step graphed and
     eager, the graphed step's device ms and the capture seconds; then
     the programs around the steps against their eager bodies, bit for
     bit with equal launches: one whole collection round (its reset,
     trainTrajLen steps and episode extraction: labels, states, actions,
     rewards, generator), VecEnv.reset and 20 VecEnv.step calls (every
     obs, reward, done, state leaf, the generator), PPO.act stochastic
     and deterministic; with the round's wall ms, the VecEnv reset's and
     step's wall ms graphed and eager, the step's device ms, device
     operations and busy share, and the captures' seconds;
  4a. the update and fit graphs: the PPO update (rl/ppo.py: prepare,
     which draws the epochs' permutations, noptepochs x nminibatches
     minibatch steps, finish) of Ant (1024 x 16
     rows, 4 x 4), Humanoid (4096 x 32, 5 x 4), ShadowHand with the
     asymmetric critic (1024 x 8, 5 x 4) and Pendulum (100 x 64, 8 x 8)
     on a rollout at full width, and the MDN fit (models/mdnn.py) of
     Pendulum's MDNN (a 1000-row chunk, 100 updates of 100), Cartpole's
     MDRFF (the RFF kernel inside the graph), the posterior refit (10,000
     rows, 500 updates) and a small full-covariance MDNN: replays against
     the eager bodies bit for bit (params, Adam state, lr, permutations,
     metrics, losses, generators) with equal launches; wall ms per update
     graphed and eager, device ms, operations, busy share and capture
     seconds, with the card's name and power limit;
  4b. the ADR loop on Ant at full width (1024 envs, 17 params,
     trainTrajLen 50, summary_corrdiff, MDNN [128, 128] x 10 components,
     PPO [256, 128, 64] with nsteps 16) for 2 ADR iterations through
     ``bayes_sim_main.main`` (ADR_PHASES); checks that the SPD factor and
     substitute kernels and the integration kernel were launched and no
     other kernel, the posteriors are finite with 17 dims and every model and env tensor is on the
     card; prints the seconds of each iteration and of its phases;
  5. the ADR loop on Cartpole + MDRFF at full width (512 envs,
     summary_corrdiff features d = 302, 200 RFF features, 10 components
     over 13 params) for 2 ADR iterations; checks that rff_features was
     launched, and the same as phase 4;
  5a. one Cartpole + MDRFF ADR iteration from seed 0 with every graph and
     with every graph bound to its eager body by this script: every
     collected batch, the PPO and MDN params, the RFF frequencies and the
     posterior compared bit for bit (the first differing array printed),
     with the captures and replays of each program by phase;
  6. the ADR loop on Humanoid at full width (4096 envs, 37 params,
     trainTrajLen 50, summary_corrdiff, MDNN [128, 128] x 10 components,
     PPO [400, 200, 100] elu with nsteps 32) for 2 ADR iterations
     (ADR_PHASES); checks that both tree kernels and the integration
     kernel were launched and no other kernel, and the same as phase 4;
  7. the README quick start, Pendulum + MDNN with summary_start at full
     width (100 envs), for 2 ADR iterations; it launches no kernel;
  8. the ADR loop on each of Anymal (4000 envs, 13 params), Quadcopter
     (8192, 9), Ingenuity (4096, 9), BallBalance (128, 7) and
     FrankaCabinet (2048, 19) at full width (ADR_PHASES; 1 ADR iteration
     each): checks the SPD
     factor and substitute kernels and no tree kernel on the four dense
     tasks, the tree kernels and no SPD kernel on BallBalance, the
     integration kernel on all five, and the same as phase 4;
  9. the ADR loop on ShadowHand at full width (1024 envs, 32 params,
     89-dim obs, trainTrajLen 30, MDNN [128, 128] x 10, PPO [512, 256,
     128] with nsteps 8) for 2 ADR iterations (ADR_PHASES): checks the
     tree factor, substitute, upsolve and downsolve kernels, the
     integration kernel and no SPD kernel, and the same as phase 4; then the same for 1 ADR iteration
     at the JAX package's own scale
     (HAND_SCALE_PHASES, trainTrajs cut to 1000, the evaluation's 600-step
     episodes uncut): 9a. shadow_hand_more.yaml at 10000 envs (111
     params, 89-dim obs, PPO nsteps 8 x 10000 = 80,000 rows), 9b.
     shadow_hand_grasp.yaml at 2048 envs (policy_grasp, which must run in
     the collection's step bodies and only there, the 107-dim force-sensor
     obs, 32 params); each [adr] line carries the peak device memory;
     9c. one ShadowHand collection round at 16384 envs (shadow_hand.yaml,
     episodes of 51, policy_random, the prior): 50 step replays against
     the eager body bit for bit (trajectory, state leaves, obs, generator)
     with equal launches, then the whole round's programs against their
     bodies, with the step's wall and device ms and the peak memory;
     9d. the grasp-ADR experiment's pair (experiments/
     adr_grasp_vs_ctl_torch.py::run_pair, seed 7) at full width
     (shadow_hand_grasp.yaml, 2048 envs, realEvals 400) cut in depth
     only (realIters 3, 5 PPO iterations): the control arm (modelClass
     None) builds no BayesSim, fits nothing, writes no posterior, captures
     no rollout or update program after its first PPO run and
     returns 3 finite surrogate-real means; the grasp arm replays its
     fits and writes finite posteriors; both launch the tree kernels,
     half-solves and integration kernel only and free every graph; allocated memory (without
     cuBLAS's per-stream workspaces) comes back within 64 MiB;
     experiments/adr_pooled_analysis.py reads the pair;
     then 20 steps of shadow_hand_grasp_full.yaml (2048 envs, the 211-dim
     full_state obs) under its grasp policy: the obs and the force, torque
     and dof-force blocks finite, and VecEnv.step's time graphed and
     eager;
 10. path signatures on the card (summarizers/signature.py: plain
     einsum/cumsum, no kernel of their own) at cartpole_more.yaml's
     collection shape (10000 time-augmented paths of 20 steps, 6
     channels, depth 3) and at a depth-2 shape (2000 paths of 50 steps,
     23 channels), against float64 on the CPU (rtol 1e-4, atol 1e-5 of
     each level's largest entry), with the device time per call;
 11. the ADR loop on cartpole_more.yaml at full width (512 envs, 13
     params, summary_signatory: 258 features, MDNN [128, 128] x 10,
     trainTrajs 10000 uncut) for 2 ADR iterations; it launches no kernel;
 12. parallel: a one-rank NCCL process group (initialize_distributed on
     a free local port), an all_gather and a broadcast of a CUDA tensor
     checked for values, and setup_parallelism(512), which must leave a
     single device and no mesh; the group is destroyed after.
Each ADR phase runs its collection rounds (reset, steps, extraction),
its VecEnv resets, PPO rollouts (steps, last value), PPO updates and MDN
fits as CUDA graphs (utils/step_graph.py), checks that it replayed the
rounds' resets, steps and extractions, the rollouts, the updates and the
fits and freed every graph it captured, and times the phases and, inside
them, the summarizer, the fits, and predict's refit, mixtures and
sampling; it breaks the collection's seconds down (the rounds' resets,
step replays with their device time from phase 4, extractions,
gather_envs, frames, captures, the rest) and times the evaluation video
and the loop's .cpu() copies. Each ADR phase sets every kernel's
launch count to 0 just before it runs and reads the counts just after
(a graph replay adds the launches its capture counted). The line before
the card's line is a JSON object with each kernel's numbers, its bound
(ops/bounds.py: the larger of its bytes over 3.35 TB/s and its FLOPs
over 67 TFLOP/s) and its library yardstick's time; the line before that
the script's total seconds; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import gc
import glob
import io
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "runs", "chip_smoke")

# rtol/atol of the JAX package's own kernel test (tests/test_ops.py:31-32).
RFF_RTOL, RFF_ATOL = 2e-4, 1e-5
# (B, d, m): a training minibatch, the test split, one prediction, a whole
# chunk, one row past a chunk, the 16-row tile, and a ragged toy shape.
RFF_SHAPES = [(100, 302, 100), (200, 302, 100), (1, 302, 100),
              (1000, 302, 100), (1025, 302, 100), (300, 302, 100),
              (17, 3, 64)]
RFF_TIMED = (100, 302, 100)
# Shapes whose times go into the kernels line: the path's B at d 302.
RFF_TIMED_B = (1, 100, 200, 1000)
# x one row into a larger tensor (the test split x_data[n_train:]): base
# offsets of 1,208 B (d 302) and 1,204 B (d 301).
RFF_MISALIGNED = [(100, 302, 100), (1, 302, 100), (100, 301, 100)]
# Phases of ~500 rad, held against float64 under a d 2^-23 sum|x coeff|
# bound (a reordered float32 sum stays inside it).
RFF_LARGE_PHASE = 500.0

# The SPD kernels against their plain versions: float32 with sums in
# another order, on systems A = M M^T + n I (condition number ~5).
SPD_RTOL, SPD_ATOL = 1e-4, 1e-5
# The mass matrices of the ADR paths at their full widths, timed with
# their library yardsticks and held to the NaN-pivot policy: Ant's,
# Anymal's (n 18: the full-warp instance), Quadcopter's, Ingenuity's and
# FrankaCabinet's. SPD_MAIN's times are the kernels line's own.
SPD_PATHS = {(14, 1024): "Ant", (18, 4000): "Anymal",
             (14, 8192): "Quadcopter", (10, 4096): "Ingenuity",
             (10, 2048): "FrankaCabinet"}
SPD_MAIN = (14, 1024)
# (n, N): the paths', one env, 4x Ant's envs, the widest nv the JAX
# package names (30), and a ragged toy shape. Then n that leaves lanes of
# a half or full warp idle, and env counts that leave a partial block (8
# envs a block at n <= 16, 4 above).
SPD_SHAPES = list(SPD_PATHS) + [
    (14, 1), (14, 4096), (30, 1024), (5, 17), (1, 9), (13, 1027),
    (16, 1029), (17, 9), (32, 1027)]
SPD_RHS = 4  # K for the multi-right-hand-side substitute

# The tree kernels against their plain versions: float32 with the same
# order of operations up to fused multiply-adds, on CRBA-like systems
# (A = B B^T + nv I kept at the ancestor pairs, made diagonally dominant).
TREE_RTOL, TREE_ATOL = 1e-4, 1e-5
# (tree, N): Humanoid's at its full width, one env and a ragged count,
# BallBalance's two-root forest (tray tree + free ball) at its width and
# one env past it, ShadowHand's and Ant's nearly dense tree at their
# widths, a random 30-dof tree, then env counts that leave a partial
# block (16 envs a block) and a chain 40 deep (longer than an env's 16
# lanes).
TREE_SHAPES = [("humanoid", 4096), ("humanoid", 1), ("humanoid", 17),
               ("ball_balance", 128), ("ball_balance", 129),
               ("shadow_hand", 1024), ("shadow_hand", 10000),
               ("shadow_hand", 16384), ("ant", 1024), ("random30", 1024),
               ("ant", 1025), ("random30", 1027), ("chain40", 1027)]
# The trees the ADR paths factor, timed: Humanoid's (the kernels line's
# own times), BallBalance's and ShadowHand's at its three widths
# (shadow_hand.yaml's 1024 envs, shadow_hand_more.yaml's 10000 and the
# 16384 of the collection round of phase 9c).
TREE_PATHS = {("humanoid", 4096): "Humanoid",
              ("ball_balance", 128): "BallBalance",
              ("shadow_hand", 1024): "ShadowHand",
              ("shadow_hand", 10000): "ShadowHand (shadow_hand_more.yaml)",
              ("shadow_hand", 16384): "ShadowHand (16384 envs)"}
TREE_MAIN = ("humanoid", 4096)
# The NaN-pivot policy on Humanoid's tree and on BallBalance's forest.
TREE_NAN = [("humanoid", 4096), ("ball_balance", 128), ("ball_balance", 129)]
# The tree-vs-dense A/B behind the 0.66 pick, each at its path width:
# Humanoid's tree (fill 0.643), BallBalance's (0.509), Anymal's (0.684)
# and Ant's (0.771).
TREE_AB = [("humanoid", 4096), ("ball_balance", 128), ("anymal", 4000),
           ("ant", 1024)]
TREE_RHS = 4
# The half-solves at the impulse pass's shapes, (tree, N, K): ShadowHand's
# tree at its 1024 envs with K = 51 (the 35 normal and 16 friction rows,
# up-solved once a control step) and K = 1 (the down-solve of every
# substep), the same at shadow_hand_more.yaml's 10000 envs and at the
# 16384 envs of phase 9c's collection round; then a random
# 30-dof tree, env counts that leave a partial block (32 envs a block),
# and the wrappers' edge: a 256-dof tree of 1,024 pairs at 333 envs, K 13
# (2 right-hand sides a block: the last block holds one).
HALF_SHAPES = [("shadow_hand", 1024, 51), ("shadow_hand", 1024, 1),
               ("shadow_hand", 10000, 51), ("shadow_hand", 10000, 1),
               ("shadow_hand", 16384, 51), ("shadow_hand", 16384, 1),
               ("random30", 1027, 4), ("shadow_hand", 1025, 3),
               ("shadow_hand", 17, 51), ("edge256", 333, 13)]
# The shapes each entry point is timed at (the kernels line's own times
# are the first): the upsolve at K = 51, the downsolve at K = 1.
HALF_TIMED = {"upsolve": [("shadow_hand", 1024, 51),
                          ("shadow_hand", 10000, 51),
                          ("shadow_hand", 16384, 51)],
              "downsolve": [("shadow_hand", 1024, 1),
                            ("shadow_hand", 10000, 1),
                            ("shadow_hand", 16384, 1)]}


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # Full float32 for every product: the physics' structure folds and
    # every plain version the kernels are compared with.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} card(s) | "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}", flush=True)
    return smi


def phase_build():
    from bayes_sim_ig_tpu_torch.ops import build, launch
    libraries = list(launch.LIBRARIES)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
        for fut in [pool.submit(launch.load, name) for name in libraries]:
            fut.result()
    secs = time.perf_counter() - t0
    for name in libraries:
        log = build.BUILD_LOG.get(name, {})
        ptxas = " ".join(line.strip() for line in log.get(
            "ptxas", "").split("\n")
            if "registers" in line or "stack frame" in line)
        print(f"[build] {name}: "
              f"{'compiled in %.2f s' % log['seconds'] if log else 'cached'}"
              f"; {ptxas}", flush=True)
    print(f"[build] {len(libraries)} libraries built and loaded in "
          f"{secs:.2f} s", flush=True)


def _median_ms(fn, n=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_profile(fn, n=50, traces=3):
    """Mean device time per call of the kernels ``fn`` launches and their
    count per call (kernels, copies and fills), from torch.profiler traces
    of n calls: the trace with the largest device time of ``traces`` (a
    trace that drops kernel records reads low, never high); (None, None)
    when no trace holds device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best, count = None, None
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0.0) > 0]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0 and total_us / 1000.0 / n > (best or 0.0):
            best = total_us / 1000.0 / n
            count = sum(e.count for e in events) / n
    return best, count


def _device_ms(fn, n=50, traces=3):
    """Mean device time per call of ``fn``'s kernels (``_device_profile``);
    None when no trace holds device time."""
    return _device_profile(fn, n, traces)[0]


def _fmt(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def _times(kernel_fn, plain_fn):
    # A plain version launches tens to thousands of kernels a call: its
    # traces hold 5 calls, which keeps the profiler's own work short.
    return {"ms": _median_ms(kernel_fn), "plain_ms": _median_ms(plain_fn),
            "dev_ms": _device_ms(kernel_fn),
            "plain_dev_ms": _device_ms(plain_fn, n=5)}


def _library_times(fn):
    return {"ms": _median_ms(fn), "dev_ms": _device_ms(fn)}


def _library_line(name, t):
    return (f"{name}: {t['ms']:.4f} ms per call (median of 50, CUDA "
            f"events), device {_fmt(t['dev_ms'])} per call (profiler)")


def _bound_line(b):
    return (f"bound {b.ms:.5f} ms by {b.by} ({b.bytes} B, {b.flops} "
            f"FLOP)")


def _time_line(t):
    return (f"median of 50 (CUDA events per call): kernel {t['ms']:.4f} ms, "
            f"plain {t['plain_ms']:.4f} ms | device time per call "
            f"(profiler): kernel {_fmt(t['dev_ms'])}, plain "
            f"{_fmt(t['plain_dev_ms'])}")


def _rff_inputs(b, d, m, rows_before=0):
    """x (B, d) and coeff (d, m) on the card; with rows_before, x is a
    view that many rows into a larger tensor."""
    rs = np.random.RandomState(0)
    dev = torch.device("cuda:0")
    big = torch.as_tensor(rs.randn(b + rows_before, d), dtype=torch.float32,
                          device=dev)
    coeff = torch.as_tensor(rs.randn(d, m) * 0.3, dtype=torch.float32,
                            device=dev)
    return big[rows_before:], coeff


def _rff_check(what, got, want, b, m):
    torch.cuda.synchronize()
    assert got.shape == (b, 2 * m) and torch.isfinite(got).all()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=RFF_RTOL, atol=RFF_ATOL))
    line = (f"[kernel] rff_features {what}: max_abs_err {max_abs:.3e} "
            f"max_rel_err {max_rel:.3e} (rtol {RFF_RTOL}, atol {RFF_ATOL}) "
            f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        print(line, flush=True)
        raise AssertionError(f"rff_features disagrees with its plain "
                             f"version at {what}")
    return max_abs, line


def _rff_large_phase(b, d, m, a):
    """The kernel and its plain version against float64 at phases of
    RFF_LARGE_PHASE rad, under a d 2^-23 sum_k |x_k coeff_k| + atol bound."""
    from bayes_sim_ig_tpu_torch.ops import rff_kernel
    x, coeff = _rff_inputs(b, d, m)
    x64, c64 = x.double(), coeff.double()
    x = (x * (RFF_LARGE_PHASE / float((x64 @ c64).abs().max()))).contiguous()
    x64 = x.double()
    inner = x64 @ c64
    want = a * torch.cat([torch.cos(inner), torch.sin(inner)], dim=-1)
    mag = a * d * 2.0 ** -23 * (x64.abs() @ c64.abs()) + RFF_ATOL
    bound = torch.cat([mag, mag], dim=-1)
    got = rff_kernel.rff_features_cuda(x, coeff, a)
    plain = rff_kernel.rff_features_reference(x, coeff, a)
    torch.cuda.synchronize()
    err = (got.double() - want).abs()
    plain_err = (plain.double() - want).abs()
    ok = bool((err <= bound).all()) and bool((plain_err <= bound).all())
    print(f"[kernel] rff_features large phase B={b} d={d} m={m} (max |phase|"
          f" {float(inner.abs().max()):.1f} rad) vs float64: kernel max_abs"
          f"_err {float(err.max()):.3e}, plain {float(plain_err.max()):.3e}, "
          f"bound >= {float(bound.min()):.3e}, worst share of the bound "
          f"kernel {float((err / bound).max()):.3e} plain "
          f"{float((plain_err / bound).max()):.3e} "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"rff_features leaves the float64 bound at "
                             f"large phases, B={b} d={d} m={m}")


def phase_rff_kernel():
    from bayes_sim_ig_tpu_torch.ops import bounds, rff_kernel
    a = 0.1
    worst = 0.0
    times = {}
    for b, d, m in RFF_SHAPES:
        x, coeff = _rff_inputs(b, d, m)
        max_abs, line = _rff_check(
            f"B={b} d={d} m={m}", rff_kernel.rff_features_cuda(x, coeff, a),
            rff_kernel.rff_features_reference(x, coeff, a), b, m)
        worst = max(worst, max_abs)
        if d == 302 and m == 100 and b in RFF_TIMED_B:
            times[b] = _times(
                lambda: rff_kernel.rff_features_cuda(x, coeff, a),
                lambda: rff_kernel.rff_features_reference(x, coeff, a))
            bound = bounds.rff_features(b, d, m)
            times[b]["bound_ms"] = bound.ms
            line += f" | {_time_line(times[b])} | {_bound_line(bound)}"
        print(line, flush=True)
    for b, d, m in RFF_MISALIGNED:
        x, coeff = _rff_inputs(b, d, m, rows_before=1)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
        max_abs, line = _rff_check(
            f"B={b} d={d} m={m}, x at a {x.data_ptr() % 16} B offset from 16 "
            f"B", rff_kernel.rff_features_cuda(x, coeff, a),
            rff_kernel.rff_features_reference(x.clone(), coeff, a), b, m)
        worst = max(worst, max_abs)
        print(line, flush=True)
    for b in (1, 100, 1000):
        _rff_large_phase(b, 302, 100, a)
    return {"max_abs_err": worst, **times[RFF_TIMED[0]],
            "bound": bounds.rff_features(*RFF_TIMED),
            "times": {f"B={b}": times[b] for b in RFF_TIMED_B}}


def _spd_inputs(n, N, k=None, seed=0):
    rs = np.random.RandomState(seed)
    M = rs.randn(N, n, n)
    A = M @ M.transpose(0, 2, 1) + n * np.eye(n)
    dev = torch.device("cuda:0")
    At = torch.as_tensor(A.transpose(1, 2, 0), dtype=torch.float32,
                         device=dev).contiguous()
    shape = (n, N) if k is None else (k, n, N)
    return At, torch.as_tensor(rs.randn(*shape), dtype=torch.float32,
                               device=dev)



# The integration kernel (csrc/integrate.cu) at each articulated task's ADR
# width and at the benchmark cells' (ShadowHand 10,000); the timed ones are
# the cells' tasks. (task, config stem, numEnvs).
INTEG_SHAPES = [("Ant", "ant", 1024), ("Humanoid", "humanoid", 4096),
                ("Anymal", "anymal", 4000),
                ("Quadcopter", "quadcopter", 8192),
                ("Ingenuity", "ingenuity", 4096),
                ("BallBalance", "ball_balance", 128),
                ("FrankaCabinet", "franka_cabinet", 2048),
                ("ShadowHand", "shadow_hand", 1024),
                ("ShadowHand", "shadow_hand_more", 10000)]
INTEG_TIMED = [("Anymal", "anymal", 4000), ("Humanoid", "humanoid", 4096),
               ("ShadowHand", "shadow_hand_more", 10000)]
INTEG_MAIN = ("Anymal", "anymal", 4000)
INTEG_DT = 1 / 120


def _graph_ms(fn, calls=20, n=50):
    """Per call ms of ``fn`` inside a CUDA graph of ``calls`` calls: the
    median of ``n`` replays (CUDA events) over ``calls``, what the call
    costs in a step graph, launch gaps included."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _median_ms(graph.replay, n=n) / calls
    del graph
    return ms


def phase_integrate_kernel():
    """The integration kernel against the torch chain it replaces
    (dynamics.integrate then clamp_limits, on the card) at INTEG_SHAPES,
    bit for bit; at INTEG_TIMED the times of both alone and inside a CUDA
    graph of 20 calls, and the bound."""
    from bayes_sim_ig_tpu_torch.ops import bounds
    from bayes_sim_ig_tpu_torch.ops import integrate_kernel as ik
    from bayes_sim_ig_tpu_torch.physics import dynamics
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    from tests.integrate_states import clamp_driving_states
    worst, timed = 0.0, {}
    for task, stem, N in INTEG_SHAPES:
        cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                       f"{stem}.yaml"))
        cfg["env"]["numEnvs"] = 1
        model = make_env(task, cfg, seed=0, device="cpu").task.model
        q, v, qdd = clamp_driving_states(model, N, device="cuda")
        st = dynamics._structure(model, "cuda")
        n_free = len(model.free_list)

        def kernel():
            return ik.integrate_clamp_cuda(q, v, qdd, INTEG_DT,
                                           st["integ_table"],
                                           st["integ_limits"], n_free,
                                           dynamics.MAX_LIN_VEL,
                                           dynamics.MAX_ANG_VEL)

        def plain():
            return dynamics.clamp_limits(model, *dynamics.integrate(
                model, q, v, qdd, INTEG_DT))
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        worst = max(worst, err)
        shape = (f"({task} {stem}: nq {model.nq}, nv {model.nv}, "
                 f"{n_free} free, {model.j1_q.size} 1-dof, N {N})")
        print(f"[kernel] integrate_clamp {shape}: max_abs_err {err:.3e} "
              f"{'ok, bit for bit' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            raise AssertionError(f"integrate_clamp disagrees with the torch "
                                 f"chain at {shape}")
        if (task, stem, N) in INTEG_TIMED:
            t = _times(kernel, plain)
            t["graph_ms"], t["plain_graph_ms"] = (_graph_ms(kernel),
                                                  _graph_ms(plain))
            t["plain_launches"] = _device_profile(plain, n=5)[1]
            t["bound"] = bounds.integrate_clamp(model.nq, model.nv, N, n_free,
                                                model.j1_q.size)
            timed[(task, stem, N)] = t
            print(f"[kernel] integrate_clamp {shape}: {_time_line(t)} | in "
                  f"a graph of 20 calls: kernel {t['graph_ms']:.4f} ms, "
                  f"plain {t['plain_graph_ms']:.4f} ms a call "
                  f"({t['plain_launches']} launches) | "
                  f"{_bound_line(t['bound'])}", flush=True)
    return {"max_abs_err": worst, **timed[INTEG_MAIN],
            "times": {f"{task} N={N}": dict(
                _time_entry(t), graph_ms=t["graph_ms"],
                plain_graph_ms=t["plain_graph_ms"],
                plain_launches=t["plain_launches"])
                for (task, _, N), t in timed.items()}}

def _check(name, got, want, shape):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = (bool(torch.isfinite(got).all())
          and torch.allclose(got, want, rtol=SPD_RTOL, atol=SPD_ATOL))
    print(f"[kernel] {name} (n, N) = {shape}: max_abs_err {err:.3e} (rtol "
          f"{SPD_RTOL}, atol {SPD_ATOL}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"(n, N) = {shape}")
    return err


# The library call that computes each SPD entry point's function.
LIBRARY = {"factor": "torch.linalg.cholesky_ex",
           "substitute": "torch.cholesky_solve",
           "solve": "torch.linalg.solve"}


def _spd_library(sk, At, bt, Lt):
    """Each SPD entry point's library yardstick on the same systems,
    env-first and contiguous: A (N, n, n), L (N, n, n), b (N, n, 1); the
    permutes are made before the timing. Checks each against the plain
    versions first."""
    A = At.permute(2, 0, 1).contiguous()
    L = Lt.permute(2, 1, 0).contiguous()  # Lt[k][i] = L[i][k]
    b = bt.T.contiguous()[..., None]
    fac, info = torch.linalg.cholesky_ex(A)
    torch.cuda.synchronize()
    assert int(info.abs().max()) == 0
    x_plain = sk._chol_lanes_substitute(Lt, bt)
    for name, got, want in (
            ("cholesky_ex", fac, L),
            ("cholesky_solve", torch.cholesky_solve(b, L)[..., 0].T, x_plain),
            ("linalg.solve", torch.linalg.solve(A, b)[..., 0].T, x_plain)):
        _check(f"library {name} vs the plain version", got, want,
               tuple(At.shape[1:]))
    return {"factor": _library_times(lambda: torch.linalg.cholesky_ex(A)),
            "substitute": _library_times(lambda: torch.cholesky_solve(b, L)),
            "solve": _library_times(lambda: torch.linalg.solve(A, b))}


def _spd_nan_policy(sk, n, N):
    """One negative-definite system (env 5) poisons only its own column;
    every other env of the factor, substitute and fused solve is bit for
    bit the clean result."""
    At, bt = _spd_inputs(n, N, seed=n)
    clean_L = sk.spd_factor_lanes_cuda(At)
    clean = sk.spd_substitute_lanes_cuda(clean_L, bt)
    clean_fused = sk.spd_solve_lanes_cuda(At, bt)
    bad = At.clone()
    bad[:, :, 5] = -torch.eye(n, device=At.device)
    L = sk.spd_factor_lanes_cuda(bad)
    x = sk.spd_substitute_lanes_cuda(L, bt)
    fused = sk.spd_solve_lanes_cuda(bad, bt)
    torch.cuda.synchronize()
    others = torch.ones(N, dtype=torch.bool, device=At.device)
    others[5] = False
    ok = (bool(torch.isnan(x[:, 5]).all()) and bool(torch.isnan(
        fused[:, 5]).all()) and torch.equal(x[:, others], clean[:, others])
        and torch.equal(L[..., others], clean_L[..., others])
        and torch.equal(fused[:, others], clean_fused[:, others]))
    print(f"[kernel] spd NaN policy (n, N) = {(n, N)}: negative pivot in env"
          f" 5 -> NaN in its column only, every other env of the factor, "
          f"substitute and fused solve bit-equal to the clean run: "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"the SPD kernels break the NaN-pivot policy "
                             f"at (n, N) = {(n, N)}")


def _spd_path_times(sk, bounds, At, bt, Lp, n, N):
    """At a path's shape: each entry point against its plain version, its
    bound and its library yardstick."""
    timed = {"factor": _times(lambda: sk.spd_factor_lanes_cuda(At),
                              lambda: sk._chol_lanes_factor(At)),
             "substitute": _times(
                 lambda: sk.spd_substitute_lanes_cuda(Lp, bt),
                 lambda: sk._chol_lanes_substitute(Lp, bt)),
             "solve": _times(lambda: sk.spd_solve_lanes_cuda(At, bt),
                             lambda: sk._chol_lanes_core(At, bt))}
    library = _spd_library(sk, At, bt, Lp)
    for entry, t in timed.items():
        t["library"] = library[entry]
        t["bound"] = getattr(bounds, f"spd_{entry}")(n, N)
        print(f"[kernel] spd_{entry}_lanes (n, N) = {(n, N)} "
              f"({SPD_PATHS[(n, N)]}'s path; {t['dev_ms'] * 1e3 / N:.5f} us"
              f" a system): {_time_line(t)} | {_bound_line(t['bound'])} | "
              f"library {_library_line(LIBRARY[entry], t['library'])}",
              flush=True)
    return timed


def phase_spd_kernel():
    from bayes_sim_ig_tpu_torch.ops import bounds
    from bayes_sim_ig_tpu_torch.ops import spd_kernel as sk
    worst = collections.defaultdict(float)
    timed = {}
    for n, N in SPD_SHAPES:
        At, bt = _spd_inputs(n, N, seed=n)
        _, bk = _spd_inputs(n, N, k=SPD_RHS, seed=n + 1)
        Lt = sk.spd_factor_lanes_cuda(At)
        Lp = sk._chol_lanes_factor(At)
        worst["factor"] = max(worst["factor"],
                              _check("spd_factor_lanes", Lt, Lp, (n, N)))
        x = sk.spd_substitute_lanes_cuda(Lp, bt)
        worst["substitute"] = max(worst["substitute"], _check(
            "spd_substitute_lanes K=1", x,
            sk._chol_lanes_substitute(Lp, bt), (n, N)))
        worst["substitute"] = max(worst["substitute"], _check(
            f"spd_substitute_lanes K={SPD_RHS}",
            sk.spd_substitute_lanes_cuda(Lp, bk),
            sk._chol_lanes_substitute(Lp, bk), (n, N)))
        x_plain = sk._chol_lanes_core(At, bt)
        worst["solve"] = max(worst["solve"], _check(
            "spd_solve_lanes", sk.spd_solve_lanes_cuda(At, bt), x_plain,
            (n, N)))
        # The autograd backward runs the solve kernel on the incoming
        # gradient; its plain version is the Pallas VJP's formula on
        # plain solves.
        A_g = At.clone().requires_grad_(True)
        b_g = bt.clone().requires_grad_(True)
        g = torch.cos(bt)
        sk.spd_solve_lanes(A_g, b_g).backward(g)
        y = sk._chol_lanes_core(At, g)
        worst["backward"] = max(
            worst["backward"],
            _check("spd_solve_lanes backward dA", A_g.grad,
                   -y[:, None, :] * x_plain[None, :, :], (n, N)),
            _check("spd_solve_lanes backward db", b_g.grad, y, (n, N)))
        if (n, N) in SPD_PATHS:
            timed[(n, N)] = _spd_path_times(sk, bounds, At, bt, Lp, n, N)
    for n, N in SPD_PATHS:
        _spd_nan_policy(sk, n, N)
    out = {}
    for entry in ("factor", "substitute", "solve"):
        out[entry] = {"max_abs_err": worst[entry], **timed[SPD_MAIN][entry],
                      "times": {f"n={n} N={N}": _time_entry(t[entry])
                                for (n, N), t in timed.items()}}
    return out


def _time_entry(t):
    """A timed shape's numbers for the kernels line."""
    lib = t.get("library")
    return {"ms": t["ms"], "plain_ms": t["plain_ms"], "dev_ms": t["dev_ms"],
            "plain_dev_ms": t["plain_dev_ms"], "bound_ms": t["bound"].ms,
            "bound_by": t["bound"].by,
            "library_ms": None if lib is None else lib["ms"],
            "library_dev_ms": None if lib is None else lib["dev_ms"]}


def _random_chains(nv, seed):
    """A random dof tree in topological order: each dof's parent is an
    earlier dof, or a root with probability 0.1."""
    rs = np.random.RandomState(seed)
    chains = [[]]
    for k in range(1, nv):
        p = -1 if rs.rand() < 0.1 else int(rs.randint(k))
        chains.append([] if p < 0 else [p] + chains[p])
    return chains


def _edge_chains(nv=256, pairs=1024, seed=0):
    """A random tree at the tree kernels' edge: nv dofs and at most
    ``pairs`` ancestor pairs (1,024, chains up to 9 deep at seed 0). Each
    dof hangs from a random earlier dof while the pairs allow, else starts
    a new root."""
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


def _tree_chains(tree):
    from bayes_sim_ig_tpu_torch.sim.ant import build_ant_model
    from bayes_sim_ig_tpu_torch.sim.anymal import build_anymal_model
    from bayes_sim_ig_tpu_torch.sim.ball_balance import build_bbot_model
    from bayes_sim_ig_tpu_torch.sim.humanoid import build_humanoid_model
    from bayes_sim_ig_tpu_torch.sim.shadow_hand import build_hand_model
    models = {"humanoid": build_humanoid_model, "ant": build_ant_model,
              "anymal": build_anymal_model, "ball_balance": build_bbot_model,
              "shadow_hand": lambda: build_hand_model()[0]}
    if tree in models:
        return models[tree]().dof_anc_chains
    if tree == "chain40":
        return [list(range(k - 1, -1, -1)) for k in range(40)]
    if tree == "edge256":
        return _edge_chains()
    return _random_chains(30, 0)


def _tree_inputs(chains, N, seed=0):
    """Pair values Mp (E, N), the same systems dense At (nv, nv, N), and
    right-hand sides (nv, N) and (TREE_RHS, nv, N), on the card."""
    from bayes_sim_ig_tpu_torch.ops.tree_solve import ancestor_pairs
    rs = np.random.RandomState(seed)
    nv = len(chains)
    B = rs.randn(N, nv, nv)
    A = B @ B.transpose(0, 2, 1) + nv * np.eye(nv)
    keep = np.eye(nv, dtype=bool)
    for c, ch in enumerate(chains):
        keep[c, ch] = keep[ch, c] = True
    A = np.where(keep, A, 0.0)
    A[:, np.arange(nv), np.arange(nv)] += np.abs(A).sum(-1)
    pairs = ancestor_pairs(chains)
    dev = torch.device("cuda:0")

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=dev)
    Mp = f32(np.stack([A[:, k, i] for k, i in pairs]))
    return (Mp, f32(A.transpose(1, 2, 0)), f32(rs.randn(nv, N)),
            f32(rs.randn(TREE_RHS, nv, N)))


def _tree_check(name, got, want, shape):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = (bool(torch.isfinite(got).all())
          and torch.allclose(got, want, rtol=TREE_RTOL, atol=TREE_ATOL))
    print(f"[kernel] {name} {shape}: max_abs_err {err:.3e} (rtol "
          f"{TREE_RTOL}, atol {TREE_ATOL}) {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}")
    return err


def _tree_times(ts, chains, Mp, At, b, H, D, shape):
    """At a path's shape: both kernels against the path's plain version
    (the left-looking form on deep trees, as forward_dynamics picks), the
    bounds, and the dense library yardstick of the pair."""
    from bayes_sim_ig_tpu_torch.ops import bounds
    from bayes_sim_ig_tpu_torch.physics.dynamics import (
        TREE_LL_MIN_MEAN_DEPTH,
    )
    left = ts.tree_tables(chains).mean_depth >= TREE_LL_MIN_MEAN_DEPTH
    timed = {
        "factor": _times(lambda: ts.ltdl_factor_cuda(chains, Mp),
                         lambda: ts.ltdl_factor_plain(chains, Mp, left)),
        "substitute": _times(
            lambda: ts.ltdl_substitute_cuda(chains, (H, D), b),
            lambda: ts.ltdl_substitute_plain(chains, (H, D), b))}
    N = Mp.shape[1]
    timed["factor"]["bound"] = bounds.tree_factor(chains, N)
    timed["substitute"]["bound"] = bounds.tree_substitute(chains, N)
    for entry in ("factor", "substitute"):
        print(f"[kernel] tree_ltdl_{entry} {shape} (plain: the path's "
              f"{'left' if left else 'right'}-looking form; {ts.GROUP} "
              f"lanes an env): "
              f"{_time_line(timed[entry])} | "
              f"{_bound_line(timed[entry]['bound'])}", flush=True)
    # No single call computes a branch-sparse L^T D L: the yardstick of the
    # pair is the dense Cholesky factor + solve of the same systems,
    # env-first and contiguous (the permute excluded).
    A = At.permute(2, 0, 1).contiguous()
    bb = b.T.contiguous()[..., None]

    def dense_pair():
        return torch.cholesky_solve(bb, torch.linalg.cholesky_ex(A)[0])
    _tree_check("dense cholesky_ex + cholesky_solve vs the tree kernels",
                dense_pair()[..., 0].T, ts.ltdl_substitute_cuda(
                    chains, ts.ltdl_factor_cuda(chains, Mp), b), shape)
    pair = _library_times(dense_pair)
    timed["factor"]["dense_pair"] = timed["substitute"]["dense_pair"] = pair
    print(f"[kernel] tree pair yardstick {shape}, "
          f"{_library_line('cholesky_ex + cholesky_solve (dense)', pair)}",
          flush=True)
    return timed


def _tree_vs_dense(ts, sk, chains, Mp, At, b, shape):
    """The H100 A/B behind the 0.66 pick: both tree kernels against both
    dense SPD kernels on the same systems."""
    def tree_pair_solve():
        return ts.ltdl_substitute_cuda(chains, ts.ltdl_factor_cuda(chains, Mp),
                                       b)

    def dense_solve():
        return sk.spd_substitute_lanes_cuda(sk.spd_factor_lanes_cuda(At), b)
    torch.cuda.synchronize()
    _tree_check("tree vs dense SPD kernels", tree_pair_solve(), dense_solve(),
                shape)
    t = _times(tree_pair_solve, dense_solve)
    fill = ts.tree_tables(chains).E / (len(chains) * (len(chains) + 1) / 2)
    print(f"[kernel] tree vs dense A/B {shape}, fill {fill:.3f}, factor + "
          f"substitute: tree {t['ms']:.4f} ms, dense {t['plain_ms']:.4f} ms per"
          f" call (median of 50, CUDA events); device time per call tree "
          f"{_fmt(t['dev_ms'])}, dense {_fmt(t['plain_dev_ms'])}", flush=True)


def _tree_nan_policy(ts, tree, N):
    """Env 5 negated (every pivot negative) is NaN in D and x only in its
    own column, at the plain version's positions; every other env bit for
    bit the clean run."""
    chains = _tree_chains(tree)
    Mp, _, b, _ = _tree_inputs(chains, N)
    H, D = ts.ltdl_factor_cuda(chains, Mp)
    clean = ts.ltdl_substitute_cuda(chains, (H, D), b)
    bad = Mp.clone()
    bad[:, 5] = -bad[:, 5]
    Hb, Db = ts.ltdl_factor_cuda(chains, bad)
    x = ts.ltdl_substitute_cuda(chains, (Hb, Db), b)
    Dp = ts.ltdl_factor_plain(chains, bad)[1]
    torch.cuda.synchronize()
    others = torch.ones(N, dtype=torch.bool, device=Mp.device)
    others[5] = False
    ok = (bool(torch.isnan(Db[:, 5]).all()) and bool(torch.isnan(
        x[:, 5]).all()) and torch.equal(torch.isnan(Db), torch.isnan(Dp))
        and torch.equal(x[:, others], clean[:, others])
        and torch.equal(Db[:, others], D[:, others])
        and torch.equal(Hb[:, others], H[:, others]))
    print(f"[kernel] tree NaN policy ({tree}, N {N}): indefinite env 5 -> "
          f"NaN in its D and x only, NaN positions as the plain version's, "
          f"other envs bit-equal: {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"the tree kernels break the NaN-pivot policy "
                             f"on {tree} at N {N}")


def phase_tree_kernel():
    from bayes_sim_ig_tpu_torch.ops import spd_kernel as sk
    from bayes_sim_ig_tpu_torch.ops import tree_solve as ts
    worst = collections.defaultdict(float)
    timed = {}
    for tree, N in TREE_SHAPES + [s for s in TREE_AB if s not in
                                  TREE_SHAPES]:
        chains = _tree_chains(tree)
        shape = f"({tree}: nv {len(chains)}, E {ts.tree_tables(chains).E}, " \
                f"N {N})"
        Mp, At, b, bk = _tree_inputs(chains, N)
        H, D = ts.ltdl_factor_cuda(chains, Mp)
        Hp, Dp = ts.ltdl_factor_plain(chains, Mp)
        worst["factor"] = max(worst["factor"],
                              _tree_check("tree_ltdl_factor H", H, Hp, shape),
                              _tree_check("tree_ltdl_factor D", D, Dp, shape))
        for rhs, what in ((b, "K=1"), (bk, f"K={TREE_RHS}")):
            worst["substitute"] = max(worst["substitute"], _tree_check(
                f"tree_ltdl_substitute {what}",
                ts.ltdl_substitute_cuda(chains, (Hp, Dp), rhs),
                ts.ltdl_substitute_plain(chains, (Hp, Dp), rhs), shape))
        x = ts.ltdl_substitute_cuda(chains, (H, D), b)
        worst["solve"] = max(worst["solve"], _tree_check(
            "tree_ltdl factor+substitute vs the dense Cholesky solve", x,
            sk._chol_lanes_core(At, b), shape))
        if (tree, N) in TREE_PATHS:
            timed[(tree, N)] = _tree_times(ts, chains, Mp, At, b, H, D,
                                           shape)
        if (tree, N) in TREE_AB:
            _tree_vs_dense(ts, sk, chains, Mp, At, b, shape)
    for tree, N in TREE_NAN:
        _tree_nan_policy(ts, tree, N)
    out = {}
    for entry in ("factor", "substitute"):
        main = timed[TREE_MAIN][entry]
        out[entry] = {"max_abs_err": worst[entry], **main,
                      "times": {f"{tree} N={N}": {
                          **_time_entry(t[entry]),
                          "dense_pair_ms": t[entry]["dense_pair"]["ms"],
                          "dense_pair_dev_ms": t[entry]["dense_pair"][
                              "dev_ms"]} for (tree, N), t in timed.items()}}
    return out


def _dense_l(ts, chains, H):
    """L (N, nv, nv) env-first, unit diagonal, from the factor's pairs."""
    tt = ts.tree_tables(chains)
    N = H.shape[1]
    L = torch.zeros(N, tt.nv, tt.nv, device=H.device)
    k = torch.as_tensor([p[0] for p in tt.pairs], device=H.device)
    i = torch.as_tensor([p[1] for p in tt.pairs], device=H.device)
    off = k != i
    L[:, k[off], i[off]] = H[off].T
    eye = torch.arange(tt.nv, device=H.device)
    L[:, eye, eye] = 1.0
    return L


def _half_times(ts, bounds, entry, chains, H, b, shape):
    """One half-solve at a path shape: the kernel against its plain
    version, the bound, and solve_triangular(unitriangular) on L made
    dense (L^T for the upsolve), env-first and contiguous (the permutes
    before the timing), checked first against the plain version."""
    kernel = getattr(ts, f"ltdl_{entry}_cuda")
    plain = getattr(ts, f"ltdl_{entry}_plain")
    t = _times(lambda: kernel(chains, H, b), lambda: plain(chains, H, b))
    N, K = H.shape[1], (b.shape[0] if b.ndim == 3 else 1)
    t["bound"] = bounds.tree_half_solve(chains, N, K)
    L = _dense_l(ts, chains, H)
    A = (L.transpose(1, 2) if entry == "upsolve" else L).contiguous()
    rhs = (b if b.ndim == 3 else b[None]).permute(2, 1, 0).contiguous()
    upper = entry == "upsolve"

    def library():
        return torch.linalg.solve_triangular(A, rhs, upper=upper,
                                             unitriangular=True)
    got = library().permute(2, 1, 0).reshape(b.shape)
    _tree_check(f"library solve_triangular vs the plain {entry}", got,
                plain(chains, H, b), shape)
    t["library"] = _library_times(library)
    print(f"[kernel] tree_ltdl_{entry} {shape}: {_time_line(t)} | "
          f"{_bound_line(t['bound'])} | library "
          f"{_library_line('solve_triangular(unitriangular)', t['library'])}",
          flush=True)
    return t


def _half_nan_policy(ts, tree, N, K):
    """An env whose factor went non-finite (H NaN in env 5) comes out
    non-finite from both half-solves, at the plain versions' NaN
    positions; every other env bit for bit its clean run."""
    chains = _tree_chains(tree)
    Mp, _, _, _ = _tree_inputs(chains, N)
    H, _ = ts.ltdl_factor_cuda(chains, Mp)
    b = torch.randn(K, len(chains), N, device=H.device,
                    generator=torch.Generator(device=H.device).manual_seed(1))
    bad = H.clone()
    bad[:, 5] = float("nan")
    others = torch.ones(N, dtype=torch.bool, device=H.device)
    others[5] = False
    ok = True
    for entry in ("upsolve", "downsolve"):
        kernel = getattr(ts, f"ltdl_{entry}_cuda")
        plain = getattr(ts, f"ltdl_{entry}_plain")
        clean, got = kernel(chains, H, b), kernel(chains, bad, b)
        torch.cuda.synchronize()
        ok &= (not bool(torch.isfinite(got[..., 5]).all())
               and torch.equal(torch.isnan(got),
                               torch.isnan(plain(chains, bad, b)))
               and torch.equal(got[..., others], clean[..., others]))
    print(f"[kernel] tree half-solve NaN policy ({tree}, N {N}, K {K}): H "
          f"NaN in env 5 -> non-finite in its column only, at the plain "
          f"versions' positions, other envs bit-equal: "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"the half-solves break the NaN policy on "
                             f"{tree} at N {N}")


def phase_half_solves():
    from bayes_sim_ig_tpu_torch.ops import bounds
    from bayes_sim_ig_tpu_torch.ops import tree_solve as ts
    worst = collections.defaultdict(float)
    timed = collections.defaultdict(dict)
    for tree, N, K in HALF_SHAPES:
        chains = _tree_chains(tree)
        E = ts.tree_tables(chains).E
        lanes, kb, _, _ = ts.half_plan_cuda(len(chains), E, K, N)
        shape = (f"({tree}: nv {len(chains)}, E {E}, N {N}, K {K}; "
                 f"{'16 lanes an env' if lanes else f'Kb {kb}'})")
        Mp, _, _, _ = _tree_inputs(chains, N)
        H, _ = ts.ltdl_factor_cuda(chains, Mp)
        b = torch.randn(K, len(chains), N, device=H.device,
                        generator=torch.Generator(
                            device=H.device).manual_seed(K))
        b = b[0] if K == 1 else b
        for entry in ("upsolve", "downsolve"):
            kernel = getattr(ts, f"ltdl_{entry}_cuda")
            plain = getattr(ts, f"ltdl_{entry}_plain")
            worst[entry] = max(worst[entry], _tree_check(
                f"tree_ltdl_{entry}", kernel(chains, H, b),
                plain(chains, H, b), shape))
            if (tree, N, K) in HALF_TIMED[entry]:
                timed[entry][(tree, N, K)] = _half_times(
                    ts, bounds, entry, chains, H, b, shape)
    for tree, N, K in (("shadow_hand", 1024, 1), ("shadow_hand", 1024, 5),
                       ("random30", 1027, 3), ("random30", 1027, 5)):
        _half_nan_policy(ts, tree, N, K)
    out = {}
    for entry, shapes in HALF_TIMED.items():
        t = timed[entry]
        out[entry] = {"max_abs_err": worst[entry], **t[shapes[0]],
                      "times": {f"{tree} N={N} K={K}": _time_entry(v)
                                for (tree, N, K), v in t.items()}}
    return out


def _on_cuda(tensors, what):
    bad = [tuple(t.shape) for t in tensors if t.device.type != "cuda"]
    if bad:
        raise AssertionError(f"{what}: tensors off the card: {bad}")


def _reset_launches():
    from bayes_sim_ig_tpu_torch.ops.launch import (
        launch_counts, set_launch_counts,
    )
    set_launch_counts({k: 0 for k in launch_counts()})


def _read_launches():
    from bayes_sim_ig_tpu_torch.ops.launch import launch_counts
    return launch_counts()


# The collection step's device ms at each task's ADR width (phase 4), by
# (task, numEnvs): an ADR phase's replay count times it is its replays'
# device time (not measured at a width phase 4 does not run).
STEP_DEV_MS = {}


class _PhaseTimer:
    """Seconds spent in the ADR loop's phases (PPO, collection, MDN
    training, posterior), each timed between two synchronizes, and inside
    them: the summarizer, the model's fits (``MDNN.run_training``), and in
    ``predict`` the refit's fit, ``predict_MoGs`` (the forward and the
    host's mixtures) and the host's sampling of the mixtures
    (``MoG.gen``). A nested time is part of its caller's.

    The collection is broken down into exclusive seconds (``parts``), each
    piece between two synchronizes: the round's reset, its step replays
    (counted), its episode extraction (each a ``Graphed`` program by phase,
    or in a tree where they are eager, ``env_full_reset`` and
    ``_postprocess_round`` called by ``collect.py``), ``gather_envs``, the
    frames (``_render_env0``) and the captures (a program's first call:
    its eager body and its capture); what is left (the concatenation, the
    copies, ``.cpu()`` of the rendered episode) is the rest of the
    collection's seconds. Outside it: ``_write_video`` and the loop's own
    ``.cpu()`` copies. Nothing is timed inside a capture."""

    _PROGRAMS = {"reset": "reset", "collect": "replays",
                 "extract": "extract"}

    def __init__(self, task=None, envs=None):
        self.peak = None  # (allocated, reserved) bytes, set by _run_adr
        self.secs = collections.defaultdict(float)
        self.parts = collections.defaultdict(float)
        self.replays = 0
        self.step_dev_ms = STEP_DEV_MS.get((task, envs))
        self._open = []  # seconds of the pieces nested in each open piece
        self._in_collect = False
        self._in_predict = False
        self._saved = []

    def _timed(self, fn, label):
        """``fn`` timed into ``label`` (a name, or a function giving it)."""
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            name = label() if callable(label) else label
            self.secs[name] += time.perf_counter() - t0
            return out
        return timed

    def _predict(self, fn):
        timed = self._timed(fn, "bsim.predict")

        def predict(*args, **kwargs):
            self._in_predict = True
            try:
                return timed(*args, **kwargs)
            finally:
                self._in_predict = False
        return predict

    def _piece(self, fn, label, outermost=False):
        """``fn`` timed into ``parts[label]`` while a collection runs (not
        inside a capture), less the seconds of the pieces nested in it;
        ``label`` is a name, or a function of the call's arguments giving
        it (None: untimed). ``outermost``: timed only outside every other
        piece (an eager function that a program's body may call too)."""
        def piece(*args, **kwargs):
            name = label(*args) if callable(label) else label
            if (name is None or not self._in_collect
                    or (outermost and self._open)
                    or torch.cuda.is_current_stream_capturing()):
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            self._open.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.parts[name] += dt - self._open.pop()
                if self._open:
                    self._open[-1] += dt
        return piece

    def _program(self, graphed):
        """A program's call, as a piece named by its phase; counts the
        collection step's replays."""
        def name(program):
            label = self._PROGRAMS.get(program.phase)
            if (label == "replays" and self._in_collect
                    and program._graph is not None):
                self.replays += 1
            return label
        return self._piece(graphed, name)

    def _collect(self, fn):
        timed = self._timed(fn, "collect")

        def collect(*args, **kwargs):
            self._in_collect = True
            try:
                return timed(*args, **kwargs)
            finally:
                self._in_collect = False
        return collect

    def _patch(self, owner, attr, new):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def __enter__(self):
        from bayes_sim_ig_tpu_torch import bayes_sim_main, engine
        from bayes_sim_ig_tpu_torch.distributions import pdf
        from bayes_sim_ig_tpu_torch.models import MDNN
        from bayes_sim_ig_tpu_torch.rl import ppo
        from bayes_sim_ig_tpu_torch.utils import collect, step_graph
        get_summarizer = engine.get_summarizer
        self._patch(ppo.PPO, "run", self._timed(ppo.PPO.run, "ppo.run"))
        self._patch(bayes_sim_main, "collect_trajectories", self._collect(
            bayes_sim_main.collect_trajectories))
        graphed = step_graph.Graphed
        self._patch(graphed, "__call__", self._program(graphed.__call__))
        self._patch(graphed, "_capture", self._piece(graphed._capture,
                                                     "captures"))
        for attr, label in (("env_full_reset", "reset"),
                            ("_postprocess_round", "extract")):
            if hasattr(collect, attr):
                self._patch(collect, attr, self._piece(
                    getattr(collect, attr), label, outermost=True))
        self._patch(collect, "gather_envs", self._piece(collect.gather_envs,
                                                        "gather_envs"))
        self._patch(collect, "_render_env0", self._piece(
            collect._render_env0, "render"))
        self._patch(bayes_sim_main, "_write_video", self._timed(
            bayes_sim_main._write_video, "video"))
        cpu = torch.Tensor.cpu
        timed_cpu = self._timed(cpu, "loop .cpu()")

        def loop_cpu(tensor, *args, **kwargs):
            # The ADR loop's own copies (evaluation rewards, surrogate-real
            # states and actions), not those of the functions it calls.
            if sys._getframe(1).f_code.co_name == "_adr_loop":
                return timed_cpu(tensor, *args, **kwargs)
            return cpu(tensor, *args, **kwargs)
        self._patch(torch.Tensor, "cpu", loop_cpu)
        self._patch(engine.BayesSim, "run_training", self._timed(
            engine.BayesSim.run_training, "bsim.run_training"))
        self._patch(engine.BayesSim, "predict",
                    self._predict(engine.BayesSim.predict))
        self._patch(engine, "get_summarizer", lambda name: self._timed(
            get_summarizer(name), "summarizer"))
        self._patch(MDNN, "run_training", self._timed(
            MDNN.run_training,
            lambda: "refit.fit" if self._in_predict else "mdn.fit"))
        self._patch(MDNN, "predict_MoGs", self._timed(MDNN.predict_MoGs,
                                                      "predict_MoGs"))
        self._patch(pdf.MoG, "gen", self._timed(pdf.MoG.gen, "MoG.gen"))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()

    def breakdown(self):
        """{piece: seconds} of the collection, with "left over" (the rest
        of its seconds), and the replays' count and device seconds."""
        parts = {k: self.parts.get(k, 0.0) for k in (
            "reset", "replays", "extract", "gather_envs", "render",
            "captures")}
        parts["left over"] = self.secs.get("collect", 0.0) - sum(
            parts.values())
        dev = (None if self.step_dev_ms is None
               else self.replays * self.step_dev_ms / 1e3)
        return parts, self.replays, dev

    def line(self):
        graphs = "; ".join(
            f"{k} graphs {v['captures']} captured in {v['capture_s']:.2f} "
            f"s, {v['replays']} replays"
            for k, v in getattr(self, "graphs", {}).items())
        parts, replays, dev = self.breakdown()
        dev = ("not measured" if dev is None else
               f"{dev:.2f} s at {self.step_dev_ms:.4f} ms a replay")
        collect = ", ".join(
            f"{k} {v:.2f} s" + (f" ({replays} replays, device {dev})"
                                if k == "replays" else "")
            for k, v in parts.items())
        peak = ("" if self.peak is None else
                f"; peak device memory {self.peak[0] / 2**30:.2f} GiB "
                f"allocated, {self.peak[1] / 2**30:.2f} GiB reserved")
        return (", ".join(f"{k} {v:.2f} s" for k, v in self.secs.items())
                + f"; collect: {collect}"
                + (f"; {graphs}" if graphs else "") + peak)


def _run_main(task, cfg, name, timer=None):
    """``bayes_sim_main.main`` on ``cfg`` with seed 0 and 5 PPO iterations
    an ADR iteration, its output in runs/chip_smoke/<name>/loop.log."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    run_dir = os.path.join(RUN_DIR, name)
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    cfg_path = os.path.join(run_dir, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["--task", task, "--cfg_env", cfg_path, "--logdir",
            os.path.join(run_dir, "logs"), "--max_iterations", "5",
            "--seed", "0", "--rl_device", "cuda:0"]
    # The loop's own printing (configs, posteriors) goes to a log file, so
    # that this script's summary lines stay short.
    log_path = os.path.join(run_dir, "loop.log")
    with open(log_path, "w") as log, contextlib.redirect_stdout(log), \
            timer or contextlib.nullcontext():
        out = bayes_sim_main.main(argv)
    torch.cuda.synchronize()
    return out


def _run_adr(task, cfg, name, iters=2):
    from bayes_sim_ig_tpu_torch.utils import step_graph
    step_graph.STATS.clear()
    gc.collect()  # the garbage of earlier phases, graphs included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    timer = _PhaseTimer(task, cfg["env"]["numEnvs"])
    out = _run_main(task, cfg, name, timer)
    secs = time.perf_counter() - t0
    launches = _read_launches()
    timer.peak = (torch.cuda.max_memory_allocated(),
                  torch.cuda.max_memory_reserved())
    # The collection rounds (reset, steps, extraction), the PPO rollouts
    # and updates and the MDN fits ran as graph replays, and the loop freed
    # every graph it captured.
    for phase in ("reset", "collect", "extract", "rollout", "update",
                  "fit"):
        if step_graph.STATS.get(phase, {}).get("replays", 0) <= 0:
            raise AssertionError(f"{name}: no {phase} program was "
                                 f"replayed from a CUDA graph")
    timer.graphs = {k: dict(v) for k, v in step_graph.STATS.items()}
    if out["env"].step_graphs or step_graph.live_graphs():
        raise AssertionError(f"{name}: the ADR loop kept its graphs: "
                             f"{step_graph.live_graphs()}")
    _on_cuda(list(out["bsim"].model.net.parameters()), "BayesSim model")
    # The refit combines the posteriors of the surrogate-real trajectories
    # accumulated over iterations: the first iteration has one.
    if iters > 1:
        _on_cuda(list(out["bsim"]._refit_model.net.parameters()),
                 "refit MDNN")
    _on_cuda(list(out["ppo"].net.parameters()), "PPO policy")
    st = out["env"].state
    _on_cuda(list(st.task_state) + [st.params, st.progress, st.reset_buf,
                                    st.obs_corr, st.act_corr], "env state")
    dim = out["env"].task.params_spec.dim
    ckpt = os.path.join(out["logdir"], "checkpoints")
    for it in range(iters):
        with open(os.path.join(ckpt, f"posterior_{it}.pkl"), "rb") as f:
            post = pickle.load(f)
        for k in ("weights", "means", "covs"):
            if not np.isfinite(post[k]).all():
                raise AssertionError(f"{name} posterior_{it} {k} is not "
                                     f"finite")
        assert post["means"].shape[1] == dim, post["means"].shape
    assert len(out["iter_secs"]) == iters
    return out, launches, secs, timer


def phase_adr_cartpole():
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "cartpole.yaml"))
    cfg["bayessim"].update(modelClass="MDRFF", trainTrajs=2000, realIters=2)
    assert cfg["env"]["numEnvs"] == 512
    assert cfg["bayessim"]["trainTrajLen"] == 20
    assert cfg["bayessim"]["components"] == 10
    out, launches, secs, timer = _run_adr("Cartpole", cfg,
                                          "cartpole_mdrff")
    if launches["rff_features"] <= 0:
        raise AssertionError("the ADR loop never launched rff_features")
    model = out["bsim"].model
    assert type(model).__name__ == "MDRFF"
    assert tuple(model.rff.coeff.shape) == (302, 100), model.rff.coeff.shape
    assert tuple(model.net.mu.weight.shape) == (130, 200)
    _on_cuda([model.rff.coeff], "MDRFF frequencies")
    print(f"[adr] Cartpole+MDRFF 512 envs, 2 ADR iterations in {secs:.2f} s"
          f" (per iteration: "
          f"{', '.join(f'{s:.2f}' for s in out['iter_secs'])} s; phases: "
          f"{timer.line()}); launches {launches}; posteriors finite; model, "
          f"refit, policy and env tensors on cuda", flush=True)
    return launches


def phase_adr_graph_vs_eager():
    """One Cartpole + MDRFF ADR iteration (512 envs, trainTrajs 2000,
    5 PPO iterations) twice from seed 0 (numpy's global state and torch's
    seeded too): with every graph, then with every Graphed bound to its
    eager body by this script. Compares every collected batch (params,
    states, actions, rewards), the PPO params, the MDN params and RFF
    frequencies, and the posterior, bit for bit; prints the first array
    that differs, if one does."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    from bayes_sim_ig_tpu_torch.utils import step_graph
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "cartpole.yaml"))
    cfg["bayessim"].update(modelClass="MDRFF", trainTrajs=2000, realIters=1)
    runs, secs = [], []
    for bodies in (False, True):
        np.random.seed(0)
        torch.manual_seed(0)
        step_graph.STATS.clear()
        got = collections.OrderedDict()
        collect = bayes_sim_main.collect_trajectories

        def recording(*args, **kwargs):
            out = collect(*args, **kwargs)
            i = len(got) // 4
            for k, v in zip(("params", "states", "actions", "rewards"),
                            out[:4]):
                got[f"collection {i} {k}"] = v.detach().clone()
            return out
        bayes_sim_main.collect_trajectories = recording
        t0 = time.perf_counter()
        try:
            with _eager_bodies() if bodies else contextlib.nullcontext():
                out = _run_main("Cartpole", cfg, "adr_graph_vs_eager_"
                                + ("bodies" if bodies else "graphs"))
        finally:
            bayes_sim_main.collect_trajectories = collect
        secs.append(time.perf_counter() - t0)
        if not bodies:
            programs = ", ".join(
                f"{k} {v['captures']} captured, {v['replays']} replays"
                for k, v in step_graph.STATS.items())
        for k, p in out["ppo"].net.named_parameters():
            got[f"ppo {k}"] = p.detach().clone()
        model = out["bsim"].model
        for k, p in model.net.named_parameters():
            got[f"mdn {k}"] = p.detach().clone()
        got["rff coeff"] = model.rff.coeff.clone()
        with open(os.path.join(out["logdir"], "checkpoints",
                               "posterior_0.pkl"), "rb") as f:
            post = pickle.load(f)
        for k in ("weights", "means", "covs"):
            got[f"posterior {k}"] = torch.as_tensor(np.asarray(post[k]))
        runs.append(got)
    diffs = _bit_diffs(*runs)
    first = next(iter(diffs), None)
    verdict = ("equal bit for bit" if not diffs else
               f"DIFFER: first {first} (max abs {diffs[first][0]:.3g}, max "
               f"rel {diffs[first][1]:.3g}); {len(diffs)} arrays differ: "
               f"{', '.join(diffs)}")
    print(f"[adr-graphs-vs-eager] Cartpole+MDRFF 512 envs, 1 ADR iteration "
          f"with every graph ({secs[0]:.2f} s; programs by phase: "
          f"{programs}) and through the eager bodies ({secs[1]:.2f} s): "
          f"{len(runs[0])} arrays (every collected batch, PPO params, MDN "
          f"params, RFF frequencies, posterior) {verdict}", flush=True)
    return diffs


def phase_adr_pendulum():
    """The README quick start at full width (cfg/pendulum.yaml: 100 envs,
    MDNN [128, 128] x 10 components, summary_start, policy_random;
    cfg/train/ppo_pendulum.yaml), cut in depth only: realIters 2 (of 20)
    and 5 PPO iterations per ADR iteration."""
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "pendulum.yaml"))
    cfg["bayessim"].update(realIters=2)
    bs = cfg["bayessim"]
    assert cfg["env"]["numEnvs"] == 100 and bs["modelClass"] == "MDNN"
    assert bs["summarizerFxn"] == "summary_start"
    assert bs["trainTrajs"] == 10000
    out, launches, secs, timer = _run_adr("Pendulum", cfg, "pendulum")
    if any(launches.values()):
        raise AssertionError(f"the Pendulum path launched a kernel: "
                             f"{launches}")
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert out["env"].num_envs == 100
    print(f"[adr] Pendulum (quick start) 100 envs, 2 ADR iterations in "
          f"{secs:.2f} s (per iteration: "
          f"{', '.join(f'{s:.2f}' for s in out['iter_secs'])} s; phases: "
          f"{timer.line()}); launches no kernel (all counts 0); 2-dim "
          f"posteriors finite; model, refit, policy and env tensors on cuda",
          flush=True)


def _env_step_profile(env, steps=20, act=None):
    """One env step at the phase's width (zero actions unless ``act``)
    through ``VecEnv.step``: its program (a CUDA graph replay of
    ``env_step``, with its buffers' copies) and its eager body
    (``_eager_bodies``): wall ms per step (host clock, synchronized),
    device ms per step (torch.profiler, the largest of three traces),
    device operations per step and the device's busy share of the
    wall."""
    if act is None:
        act = torch.zeros(env.num_envs, env.task.act_dim, device="cuda:0")

    def step():
        env.step(act)
    g_wall = _wall_ms(step, steps, warmup=3)  # the first call captures
    g_dev, g_kernels = _device_profile(step, n=steps)
    with _eager_bodies():
        wall = _wall_ms(step, steps, warmup=1)
        dev, kernels = _device_profile(step, n=steps)
    program = [v for k, v in env.step_graphs.items() if k[0] == "step"][0]
    return {"wall_ms": wall, "dev_ms": dev, "kernels": kernels,
            "busy": None if dev is None else dev / wall,
            "graph_wall_ms": g_wall, "graph_dev_ms": g_dev,
            "graph_kernels": g_kernels,
            "capture_s": program._graph.capture_s,
            "graph_busy": None if g_dev is None else g_dev / g_wall}


def _step_line(step):
    """The env step's numbers, eager and graphed."""
    def busy(b):
        return "not measured" if b is None else f"{b:.3f}"
    return (f"env step eager {step['wall_ms']:.2f} ms wall, device "
            f"{_fmt(step['dev_ms'])} (busy share {busy(step['busy'])}), "
            f"{step['kernels']} device operations a step; graphed "
            f"{step['graph_wall_ms']:.3f} ms wall, device "
            f"{_fmt(step['graph_dev_ms'])} (busy share "
            f"{busy(step['graph_busy'])}), {step['graph_kernels']} device "
            f"operations a step, captured in {step['capture_s']:.3f} s")


# ------------------------------------------------------------------ #
# The step graphs against their eager bodies
# ------------------------------------------------------------------ #
def _state_leaves(state):
    """(name, tensor) of every EnvState field, task-state leaves named."""
    return ([(f"task_state.{k}", v)
             for k, v in state.task_state._asdict().items()]
            + [(k, v) for k, v in state._asdict().items()
               if k != "task_state"])


def _bits(x):
    """A tensor's bit pattern: float32 NaNs of one payload compare equal."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _graph_vs_eager(g, load, gens, n):
    """n replays of StepGraph ``g`` against n calls of its eager body,
    each from ``load()`` and the generators' states at entry (a new graph
    is captured first). Returns ({name: (max abs, max relative deviation)}
    of every trajectory entry, state leaf, observation or generator state
    that is not bit for bit equal, graph launches, eager launches, and the
    wall ms per step of the replays and of the bodies (host clock,
    synchronized on each side))."""
    starts = [gen.get_state() for gen in gens]
    if g.capture_s is None:
        load()
        g.step()

    def run(step):
        for gen, st in zip(gens, starts):
            gen.set_state(st)
        load()
        before = _read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n
        after = _read_launches()
        got = {f"traj.{k}": v[:n].clone() for k, v in g.traj.items()}
        got.update({name: v.clone() for name, v in _state_leaves(g.state)})
        got["obs"] = g.obs.clone()
        got.update({f"generator {i}": gen.get_state()
                    for i, gen in enumerate(gens)})
        return got, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}, ms

    (graph, g_launches, g_ms), (eager, e_launches, e_ms) = (run(g.step),
                                                           run(g.body))
    return _bit_diffs(graph, eager), g_launches, e_launches, g_ms, e_ms


def _bit_diffs(got, want):
    """{name: (max abs, max relative deviation)} of every array of ``got``
    that is not bit for bit ``want``'s, in ``got``'s order."""
    diffs = {}
    for name, a in got.items():
        b = want[name]
        if (a.dtype != b.dtype or a.shape != b.shape
                or not torch.equal(_bits(a), _bits(b))):
            if a.shape != b.shape:
                diffs[name] = (float("inf"), float("inf"))
                continue
            d = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
            rel = d / b.double().abs().clamp(min=1e-30)
            diffs[name] = (float(d.max()), float(rel.max()))
    return diffs


def _diff_line(diffs):
    return "; ".join(f"{k} (max abs {a:.3g}, max rel {r:.3g})"
                     for k, (a, r) in diffs.items())


def _wall_ms(fn, n, warmup=1):
    """Host ms per call of n calls after ``warmup``, synchronized on each
    side."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _no_sync_step(g, load):
    """One eager body under torch.cuda.set_sync_debug_mode("error"): a host
    sync or a host-to-device copy in the step raises."""
    load()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g.body()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _posterior(spec, k=10, seed=0):
    """A k-component mixture inside the param box (the ADR posterior's
    kind, drawn through torch.multinomial) on the card."""
    from bayes_sim_ig_tpu_torch.distributions import MoG, to_device_distr
    lo, hi = np.asarray(spec.lows), np.asarray(spec.highs)
    rs = np.random.RandomState(seed)
    ms = [lo + (hi - lo) * rs.uniform(0.2, 0.8, lo.shape) for _ in range(k)]
    Ss = [np.diag(((hi - lo) * 0.05) ** 2 + 1e-12) for _ in range(k)]
    w = rs.uniform(0.5, 1.0, k)
    return to_device_distr(MoG(a=w / w.sum(), ms=ms, Ss=Ss), lo, hi,
                           device="cuda:0")


GRAPH_STEPS = 20  # collection steps compared


def phase_step_graphs():
    """``step_graph_check`` for each of GRAPH_TASKS."""
    return {spec[0]: step_graph_check(*spec) for spec in GRAPH_TASKS}


def step_graph_check(task_name, stem, envs, edits):
    """One task at the full width of its ADR phase: the collection step
    (its config's collection policy, the prior, episodes of trainTrajLen
    + 1) for 20 steps and one PPO rollout of nsteps (a 10-component
    posterior) as graph replays and as the eager body from the same state
    and generators, held equal bit for bit (trajectory, state leaves,
    observations, generators) with equal kernel launches; one eager step
    under sync debug mode "error"; wall ms per step graphed and eager, the
    graphed step's device ms and its capture seconds."""
    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.sim.task import env_full_reset
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    from bayes_sim_ig_tpu_torch.utils.collect import (
        collect_step_graph, get_collect_policy,
    )
    cfg_dir = os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg")
    t_task = time.perf_counter()
    cfg = load_config(os.path.join(cfg_dir, f"{stem}.yaml"))
    cfg["env"].update(edits)
    assert cfg["env"]["numEnvs"] == envs
    cfg_train = load_config(os.path.join(cfg_dir, "train",
                                         f"ppo_{stem}.yaml"))
    env = make_env(task_name, cfg, seed=0, device="cuda:0")
    ppo = process_ppo(env, cfg_train,
                      logdir=os.path.join(RUN_DIR, "graphs", stem),
                      seed=0)
    task, spec = env.task, env.task.params_spec
    cpol_name = cfg["bayessim"]["collectPolicy"]
    cpol = get_collect_policy(cpol_name, task)
    prior = to_device_distr(Uniform(spec.lows, spec.highs),
                            device="cuda:0")
    mel = cfg["bayessim"]["trainTrajLen"] + 1
    st0, obs0 = env_full_reset(task, prior, ppo.gen)
    cg = collect_step_graph(env, ppo.policy_apply, cpol, mel, ppo.net,
                            prior, ppo.gen, st0, obs0, steps=100)

    def cload():
        cg.load(st0, obs0, prior)
    c_diffs, c_graph, c_eager, c_wall, c_eager_wall = _graph_vs_eager(
        cg, cload, [ppo.gen], GRAPH_STEPS)
    _no_sync_step(cg, cload)
    cload()
    c_dev, c_ops = _device_profile(cg.step, n=GRAPH_STEPS)
    if c_dev is not None:
        STEP_DEV_MS[(task_name, envs)] = c_dev

    post = _posterior(spec)
    env.set_distr(post)
    obs_r = env.reset()
    st_r = env.state
    ppo.rollout(post, st_r, obs_r)  # the API's first call captures
    rg = ppo.rollout_graph(post, st_r, obs_r)

    def rload():
        rg.load(st_r, obs_r, post)
    r_diffs, r_graph, r_eager, r_wall, r_eager_wall = _graph_vs_eager(
        rg, rload, [ppo.gen, env.gen], ppo.nsteps)
    _no_sync_step(rg, rload)
    diffs = {**{f"collect {k}": v for k, v in c_diffs.items()},
             **{f"rollout {k}": v for k, v in r_diffs.items()}}
    if diffs:
        raise AssertionError(f"{task_name}: graph and eager differ in "
                             + _diff_line(diffs))
    for what, gl, el in (("collect", c_graph, c_eager),
                         ("rollout", r_graph, r_eager)):
        if gl != el:
            raise AssertionError(f"{task_name} {what}: launches of the "
                                 f"replays {gl} != eager {el}")
    n_leaves = len(_state_leaves(cg.state))
    record = {
        "envs": envs, "collect_wall_ms": c_wall,
        "collect_eager_wall_ms": c_eager_wall, "collect_dev_ms": c_dev,
        "collect_ops": c_ops, "collect_capture_s": cg.capture_s,
        "rollout_wall_ms": r_wall, "rollout_eager_wall_ms": r_eager_wall,
        "rollout_capture_s": rg.capture_s,
        "launches_per_step": {k: v / GRAPH_STEPS
                              for k, v in c_graph.items()}}
    busy = "not measured" if c_dev is None else f"{c_dev / c_wall:.3f}"
    print(f"[graphs] {task_name} {envs} envs: collection ({cpol_name}, "
          f"prior, episodes of {mel}) {GRAPH_STEPS} replays and rollout "
          f"({ppo.nsteps} steps, 10-component posterior"
          f"{', asymmetric' if ppo.asymmetric else ''}) "
          f"equal their eager bodies bit for bit (trajectory, "
          f"{n_leaves} state leaves, obs, generators); launches of "
          f"{GRAPH_STEPS} replays {c_graph or 'none'} == eager; no "
          f"host sync in a step; collection step graphed "
          f"{c_wall:.3f} ms wall against eager {c_eager_wall:.2f} ms, "
          f"device {_fmt(c_dev)} ({c_ops} device operations, busy "
          f"share {busy}), captured in {cg.capture_s:.3f} s; rollout "
          f"step {r_wall:.3f} ms against {r_eager_wall:.2f} ms, "
          f"captured in {rg.capture_s:.3f} s; "
          f"{time.perf_counter() - t_task:.1f} s", flush=True)
    t_task = time.perf_counter()
    record["round"] = round_check(env, ppo, cpol, mel, prior)
    record["vec_env"] = vec_env_check(env, post)
    act_check(ppo, obs_r)
    rnd, venv = record["round"], record["vec_env"]
    busy = ("not measured" if venv["dev_ms"] is None
            else f"{venv['dev_ms'] / venv['wall_ms']:.3f}")
    print(f"[graphs] {task_name} {envs} envs, programs against their eager "
          f"bodies, bit for bit with equal launches: a collection round "
          f"(reset, {mel - 1} steps, extraction; {rnd['arrays']} arrays: "
          f"labels, states, actions, rewards, generator) "
          f"{rnd['wall_s'] * 1e3:.2f} ms against {rnd['eager_s'] * 1e3:.2f} "
          f"ms, programs captured in {rnd['capture_s']:.3f} s; VecEnv.reset "
          f"+ {venv['steps']} VecEnv.step ({venv['arrays']} arrays: obs, "
          f"rewards, dones, {n_leaves} state leaves, generator) reset "
          f"{venv['reset_ms']:.3f} ms against {venv['eager_reset_ms']:.2f} "
          f"ms, step {venv['wall_ms']:.3f} ms wall against "
          f"{venv['eager_wall_ms']:.2f} ms, device {_fmt(venv['dev_ms'])} "
          f"({venv['ops']} device operations, busy share {busy}), captured "
          f"in {venv['capture_s']:.3f} s; PPO.act stochastic and "
          f"deterministic (actions, log-probabilities, generator); "
          f"{time.perf_counter() - t_task:.1f} s", flush=True)
    ppo.free_update_graphs()
    env.free_step_graphs()
    return record


def _capture_s(programs):
    return sum(p.capture_s or 0.0 for p in programs)


def round_check(env, ppo, cpol, mel, distr):
    """One collection round (``_collect_round``: its reset, ``mel - 1``
    steps and extraction) through its programs, after a round that
    captures them, against the same round through their eager bodies from
    the same generator state: labels, states, actions, rewards and the
    generator bit for bit, the launches equal; the wall seconds of each."""
    from bayes_sim_ig_tpu_torch.utils.collect import (
        _collect_round, collect_step_graph,
    )
    from bayes_sim_ig_tpu_torch.utils.step_graph import distr_key

    def run():
        return _collect_round(env, ppo.policy_apply, cpol, mel, ppo.net,
                              distr, ppo.gen)
    run()  # captures the reset, the step and the extraction
    start = ppo.gen.get_state()
    runs = []
    for bodies in (False, True):
        ppo.gen.set_state(start)
        before = _read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _eager_bodies() if bodies else contextlib.nullcontext():
            out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = _read_launches()
        got = dict(zip(("labels", "states", "actions", "rewards"), out))
        got["generator"] = ppo.gen.get_state()
        runs.append((got, secs, {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]}))
    (graph, g_s, g_l), (eager, e_s, e_l) = runs
    diffs = _bit_diffs(graph, eager)
    if diffs:
        raise AssertionError(f"collection round: programs and eager differ "
                             f"in {_diff_line(diffs)}")
    if g_l != e_l:
        raise AssertionError(f"collection round: launches {g_l} != eager "
                             f"{e_l}")
    programs = [
        env.step_graphs[("reset", ppo.gen, distr_key(distr))]._program,
        collect_step_graph(env, ppo.policy_apply, cpol, mel, ppo.net, distr,
                           ppo.gen, None, None)._program,
        env.step_graphs[("round", mel - 1)].extract]
    return {"arrays": len(graph), "wall_s": g_s, "eager_s": e_s,
            "capture_s": _capture_s(programs), "launches": g_l}


def vec_env_check(env, distr, steps=GRAPH_STEPS):
    """``VecEnv.reset`` and ``steps`` ``VecEnv.step`` calls (actions in
    [-1, 1] from a generator of their own) through their programs, after
    calls that capture them, against the same calls through their eager
    bodies, from the same env generator and state (the reset carries the
    frame counter on): every returned obs, reward and done, every state
    leaf and the generator bit for bit, the launches equal. Returns the
    wall ms of the reset and of a step (host clock, synchronized) of each,
    the graphed step's device ms and operations (profiler) and the two
    captures' seconds."""
    from bayes_sim_ig_tpu_torch.utils.step_graph import distr_key
    gen = torch.Generator(device="cuda:0").manual_seed(1)
    acts = [torch.rand(env.num_envs, env.task.act_dim, generator=gen,
                       device="cuda:0") * 2.0 - 1.0 for _ in range(steps)]
    env.set_distr(distr)
    env.reset()
    env.step(acts[0])  # both programs captured
    start_gen, start_state = env.gen.get_state(), env.state

    def run(bodies):
        env.gen.set_state(start_gen)
        env.state = start_state
        before = _read_launches()
        with _eager_bodies() if bodies else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = {"reset obs": env.reset()}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for t, act in enumerate(acts):
                obs, rew, done, _ = env.step(act)
                got.update({f"step {t} obs": obs, f"step {t} rew": rew,
                            f"step {t} done": done})
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        after = _read_launches()
        got.update(_state_leaves(env.state))
        got["generator"] = env.gen.get_state()
        return (got, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / steps,
                {k: after[k] - before[k] for k in after
                 if after[k] != before[k]})
    (graph, g_reset, g_step, g_l), (eager, e_reset, e_step, e_l) = (
        run(False), run(True))
    diffs = _bit_diffs(graph, eager)
    if diffs:
        raise AssertionError(f"VecEnv: programs and eager differ in "
                             f"{_diff_line(diffs)}")
    if g_l != e_l:
        raise AssertionError(f"VecEnv: launches {g_l} != eager {e_l}")
    dev, ops = _device_profile(lambda: env.step(acts[0]), n=steps)
    programs = [
        env.step_graphs[("reset", env.gen, distr_key(distr))]._program,
        env.step_graphs[("step", env.max_episode_length,
                         distr_key(distr))]._graph._program]
    return {"steps": steps, "arrays": len(graph), "reset_ms": g_reset,
            "eager_reset_ms": e_reset, "wall_ms": g_step,
            "eager_wall_ms": e_step, "dev_ms": dev, "ops": ops,
            "capture_s": _capture_s(programs)}


def act_check(ppo, obs):
    """``PPO.act``, stochastic and deterministic, through its programs
    (after calls that capture them) and through their bodies from the same
    generator state: actions, log-probabilities and the generator bit for
    bit."""
    ppo.act(obs)
    ppo.act(obs, deterministic=True)
    start = ppo.gen.get_state()

    def run(bodies):
        ppo.gen.set_state(start)
        with _eager_bodies() if bodies else contextlib.nullcontext():
            act, logp = ppo.act(obs)
            mean, _ = ppo.act(obs, deterministic=True)
        return {"act": act, "logp": logp, "mean": mean,
                "generator": ppo.gen.get_state()}
    diffs = _bit_diffs(run(False), run(True))
    if diffs:
        raise AssertionError(f"PPO.act: programs and eager differ in "
                             f"{_diff_line(diffs)}")


# ------------------------------------------------------------------ #
# The update and fit graphs against their eager bodies
# ------------------------------------------------------------------ #
@contextlib.contextmanager
def _eager_bodies():
    """Every ``Graphed`` (the step, update and fit programs) bound to its
    eager body: this script's own binding, which the package has no switch
    for."""
    from bayes_sim_ig_tpu_torch.utils.step_graph import Graphed
    call = Graphed.__call__
    Graphed.__call__ = lambda self: self.body()
    try:
        yield
    finally:
        Graphed.__call__ = call


def _ppo_state(ppo):
    """Copies of the policy, the Adam state, the lr and both generators."""
    got = {f"param {k}": p.detach().clone()
           for k, p in ppo.net.named_parameters()}
    got["adam count"] = ppo.adam.count.clone()
    for i, (m, v) in enumerate(zip(ppo.adam.mu, ppo.adam.nu)):
        got[f"adam mu {i}"], got[f"adam nu {i}"] = m.clone(), v.clone()
    got["lr"] = ppo.lr.clone()
    got["generator ppo"] = ppo.gen.get_state()
    got["generator env"] = ppo.vec_env.gen.get_state()
    return got


def _set_ppo_state(ppo, st):
    with torch.no_grad():
        for k, p in ppo.net.named_parameters():
            p.copy_(st[f"param {k}"])
        ppo.adam.count.copy_(st["adam count"])
        for i, (m, v) in enumerate(zip(ppo.adam.mu, ppo.adam.nu)):
            m.copy_(st[f"adam mu {i}"])
            v.copy_(st[f"adam nu {i}"])
        ppo.lr.copy_(st["lr"])
    ppo.gen.set_state(st["generator ppo"])
    ppo.vec_env.gen.set_state(st["generator env"])


# The PPO updates held to their bodies at full width: (task, config stem,
# numEnvs, env edits, noptepochs x nminibatches); ShadowHand with the
# asymmetric critic.
UPDATE_TASKS = [("Ant", "ant", 1024, {}, (4, 4)),
                ("Humanoid", "humanoid", 4096, {}, (5, 4)),
                ("ShadowHand", "shadow_hand", 1024,
                 {"asymmetric_observations": True}, (5, 4)),
                ("Pendulum", "pendulum", 100, {}, (8, 8))]


def update_graph_check(task_name, stem, envs, edits, shape, smi):
    """One PPO update (``update_from_traj``: prepare, which draws the
    epochs' permutations, noptepochs x nminibatches minibatch steps,
    finish) on a rollout of the task at full width, as graph replays
    (after the call that captures) and as the eager bodies from the same
    params, Adam state, lr and generators: every one of them, the
    permutations and the update's metrics bit for bit, the launches
    equal; wall ms per update graphed and eager, its device ms, operations
    and busy share, and the three programs' capture seconds."""
    from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg_dir = os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg")
    t_task = time.perf_counter()
    cfg = load_config(os.path.join(cfg_dir, f"{stem}.yaml"))
    cfg["env"].update(edits)
    assert cfg["env"]["numEnvs"] == envs
    env = make_env(task_name, cfg, seed=0, device="cuda:0")
    ppo = process_ppo(env, load_config(os.path.join(
        cfg_dir, "train", f"ppo_{stem}.yaml")),
        logdir=os.path.join(RUN_DIR, "updates", stem), seed=0)
    assert (ppo.noptepochs, ppo.nminibatches) == shape
    post = _posterior(env.task.params_spec)
    env.set_distr(post)
    obs = env.reset()
    _, _, traj, last_val = ppo.rollout(post, env.state, obs)
    start = _ppo_state(ppo)

    def update():  # the permutations drawn by prepare, as on the ADR path
        return ppo.update_from_traj(traj, last_val)
    update()  # captures prepare, minibatch and finish
    program = ppo.update_program(traj, last_val, draw=True)

    def run(bodies):
        _set_ppo_state(ppo, start)
        before = _read_launches()
        with _eager_bodies() if bodies else contextlib.nullcontext():
            out = update()
        torch.cuda.synchronize()
        after = _read_launches()
        got = _ppo_state(ppo)
        got["permutations"] = program._rows.clone()
        got["metrics"] = program.metrics.clone()
        got.update({f"out {k}": v for k, v in out.items()})
        return got, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
    replays = program.minibatch.replays
    (graph, g_launches), (eager, e_launches) = run(False), run(True)
    if program.minibatch.replays - replays != ppo.noptepochs * \
            ppo.nminibatches:
        raise AssertionError(f"{task_name}: the update did not replay")
    diffs = _bit_diffs(graph, eager)
    if diffs:
        raise AssertionError(f"{task_name} update: graph and eager differ "
                             f"in {_diff_line(diffs)}")
    if g_launches != e_launches:
        raise AssertionError(f"{task_name} update: launches {g_launches} "
                             f"!= eager {e_launches}")
    n_mb = ppo.noptepochs * ppo.nminibatches
    wall = _wall_ms(update, 5)
    with _eager_bodies():
        eager_wall = _wall_ms(update, 2)
    # One update a trace: Pendulum's is tens of thousands of operations.
    dev, ops = _device_profile(update, n=1)
    with _eager_bodies():
        eager_dev, eager_ops = _device_profile(update, n=1, traces=2)
    capture = sum(p.capture_s for p in (program.prepare, program.minibatch,
                                        program.finish))
    busy = "not measured" if dev is None else f"{dev / wall:.3f}"
    rows = ppo.nsteps * envs // ppo.nminibatches
    print(f"[train-graphs] {task_name} PPO update ({ppo.nsteps} x {envs} "
          f"rows, {ppo.noptepochs} x {ppo.nminibatches} minibatches of "
          f"{rows}{', asymmetric' if ppo.asymmetric else ''}; "
          f"permutations of {ppo.nsteps * envs} drawn by prepare): replays "
          f"equal the eager bodies bit for bit ({len(graph)} arrays: "
          f"params, Adam state, lr, permutations, metrics, generators); "
          f"update graphed "
          f"{wall:.2f} ms wall ({wall / n_mb:.3f} ms a minibatch) against "
          f"eager {eager_wall:.2f} ms ({eager_wall / n_mb:.3f}), device "
          f"{_fmt(dev)} ({ops} device operations, busy share {busy}) "
          f"against eager {_fmt(eager_dev)} ({eager_ops}), "
          f"3 programs captured in {capture:.3f} s; "
          f"{time.perf_counter() - t_task:.1f} s | {smi}", flush=True)
    record = {"rows": ppo.nsteps * envs, "minibatches": n_mb,
              "wall_ms": wall, "eager_wall_ms": eager_wall, "dev_ms": dev,
              "eager_dev_ms": eager_dev, "ops": ops, "capture_s": capture}
    ppo.free_update_graphs()
    env.free_step_graphs()
    return record


def _model_state(model):
    got = {f"param {k}": p.detach().clone()
           for k, p in model.net.named_parameters()}
    got["adam count"] = model.adam_count.clone()
    for i, (m, v) in enumerate(zip(model.adam_mu, model.adam_nu)):
        got[f"adam mu {i}"], got[f"adam nu {i}"] = m.clone(), v.clone()
    got["generator"] = model._gen.get_state()
    return got


def fit_graph_check(name, model, x, y, n_updates, batch_size, smi):
    """``run_training`` of ``model`` on (x, y) as replays of its fit step
    (after the call that captures) and as the eager body from the same
    weights and generator: weights, Adam state, every train loss, the six
    test losses and the generator bit for bit, the launches equal; wall ms
    per update graphed and eager, device ms per update, operations, busy
    share and capture seconds."""
    t0 = time.perf_counter()
    start = _model_state(model)

    def fit():
        return model.run_training(x, y, n_updates, batch_size)
    fit()  # captures the step
    n_train = max(int(x.shape[0] * 0.8), 1)
    program = model.fit_program(n_train, x.shape[1], batch_size, n_updates)

    def run(bodies):
        with torch.no_grad():
            for k, p in model.net.named_parameters():
                p.copy_(start[f"param {k}"])
        model._gen.set_state(start["generator"])
        before = _read_launches()
        with _eager_bodies() if bodies else contextlib.nullcontext():
            log = fit()
        torch.cuda.synchronize()
        after = _read_launches()
        got = _model_state(model)
        got["train losses"] = program.losses.clone()
        got["test losses"] = torch.tensor(log["test_loss"])
        return got, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
    (graph, g_launches), (eager, e_launches) = run(False), run(True)
    diffs = _bit_diffs(graph, eager)
    if diffs:
        raise AssertionError(f"{name} fit: graph and eager differ in "
                             f"{_diff_line(diffs)}")
    if g_launches != e_launches:
        raise AssertionError(f"{name} fit: launches {g_launches} != eager "
                             f"{e_launches}")
    steps = min(n_updates, 20)
    xt, yt = program.x_train.clone(), program.y_train.clone()

    def updates():
        program.load(xt, yt)
        for _ in range(steps):
            program.step()
    wall = _wall_ms(updates, 3) / steps
    with _eager_bodies():
        eager_wall = _wall_ms(updates, 1) / steps
    dev, ops = _device_profile(updates, n=1)
    dev = None if dev is None else dev / steps
    with _eager_bodies():
        eager_dev = _device_ms(updates, n=1, traces=2)
    eager_dev = None if eager_dev is None else eager_dev / steps
    busy = "not measured" if dev is None else f"{dev / wall:.3f}"
    width = "x".join(str(h) for h in model.hidden_layers) or "no hidden"
    print(f"[train-graphs] {name} fit ({x.shape[0]} rows of {x.shape[1]}, "
          f"MDN [{width}] x {model.n_gaussians} over {model.output_dim} "
          f"dims{', full covariance' if model.full_covariance else ''}, "
          f"{n_updates} updates of {batch_size}): replays equal the eager "
          f"body bit for bit ({len(graph)} arrays: weights, Adam state, "
          f"losses, generator); launches of a fit {g_launches or 'none'} == "
          f"eager; update graphed {wall:.3f} ms wall against eager "
          f"{eager_wall:.3f} ms, device {_fmt(dev)} "
          f"({None if ops is None else ops / steps} device operations, "
          f"busy share {busy}) against eager {_fmt(eager_dev)}, captured "
          f"in {program._program.capture_s:.3f} s; "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    record = {"wall_ms": wall, "eager_wall_ms": eager_wall, "dev_ms": dev,
              "eager_dev_ms": eager_dev,
              "ops": None if ops is None else ops / steps,
              "capture_s": program._program.capture_s,
              "launches": g_launches}
    model.free_graphs()
    return record


def phase_train_graphs(smi):
    """The update and fit graphs at full width: the PPO update of each of
    UPDATE_TASKS, and the MDN fits of Pendulum's MDNN (a 1000-row chunk,
    100 updates of 100), of Cartpole's MDRFF (the RFF kernel inside the
    graph), of the posterior refit (10,000 rows, 500 updates, [128, 128]
    x 10 over Cartpole's 13 params) and a small full-covariance MDNN."""
    from bayes_sim_ig_tpu_torch.engine import BayesSim
    from bayes_sim_ig_tpu_torch.models import MDNN
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    records = {t[0]: update_graph_check(*t, smi) for t in UPDATE_TASKS}
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    n_up, bs = BayesSim.NUM_GRAD_UPDATES, BayesSim.MINIBATCH_SIZE
    for task_name, stem, model_class in (("Pendulum", "pendulum", "MDNN"),
                                         ("Cartpole", "cartpole", "MDRFF")):
        cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                       f"{stem}.yaml"))
        cfg["bayessim"]["modelClass"] = model_class
        task = make_env(task_name, cfg, seed=0, device="cuda:0").task
        spec = task.params_spec
        bsim = BayesSim(cfg["bayessim"], task.obs_dim, task.act_dim,
                        spec.dim, spec.lows, spec.highs, seed=0,
                        device="cuda:0")
        model = bsim.model
        lo = torch.as_tensor(spec.lows, dtype=torch.float32, device="cuda:0")
        hi = torch.as_tensor(spec.highs, dtype=torch.float32,
                             device="cuda:0")
        x = torch.randn(BayesSim.NUM_TRAIN_TRAJ_PER_BATCH,
                        model.rff.d if model_class == "MDRFF"
                        else model.input_dim, generator=gen, device="cuda:0")
        y = lo + (hi - lo) * torch.rand(x.shape[0], spec.dim, generator=gen,
                                        device="cuda:0")
        records[f"{task_name} {model_class}"] = fit_graph_check(
            f"{task_name} {model_class}", model, x, y, n_up, bs, smi)
        if model_class == "MDRFF":
            if not records[f"{task_name} {model_class}"]["launches"].get(
                    "rff_features"):
                raise AssertionError("the MDRFF fit launched no RFF kernel")
            # The refit of this model, as BayesSim.predict builds it.
            refit = MDNN(input_dim=1, output_dim=model.output_dim,
                         output_lows=model.output_lows,
                         output_highs=model.output_highs,
                         n_gaussians=model.n_gaussians,
                         hidden_layers=(128, 128), lr=model.lr,
                         activation=model.activation,
                         full_covariance=model.full_covariance,
                         device="cuda:0")
            samples = lo + (hi - lo) * torch.rand(10000, spec.dim,
                                                  generator=gen,
                                                  device="cuda:0")
            records["refit"] = fit_graph_check(
                "Cartpole refit", refit,
                torch.zeros(10000, 1, device="cuda:0"), samples, 500, 100,
                smi)
    full = MDNN(input_dim=8, output_dim=4, output_lows=np.zeros(4),
                output_highs=np.ones(4), n_gaussians=5,
                full_covariance=True, hidden_layers=(32, 32),
                activation="tanh", lr=1e-3, seed=1, device="cuda:0")
    records["full covariance"] = fit_graph_check(
        "full-covariance", full,
        torch.randn(500, 8, generator=gen, device="cuda:0"),
        torch.rand(500, 4, generator=gen, device="cuda:0"), 100, 100, smi)
    return records


# The ADR phases of the articulated tasks: (task, config stem, numEnvs, DR
# dims, PPO widths, nsteps, trainTrajLen, summarizer, the kernels its
# physics launches, trainTrajs after the cut, env edits, ADR iterations).
# Each runs through bayes_sim_main.main at the config's widths for 2 ADR
# iterations of 5 PPO iterations (1 on Quadcopter, Ingenuity and
# FrankaCabinet, which no benchmark cell names, to keep the script inside
# its time with ShadowHand's phase, and on Anymal and BallBalance, to keep
# it there with the signature and cartpole_more phases; Ant, Humanoid and
# ShadowHand run the posterior refit); trainTrajs is cut to 1000 (Ant,
# Humanoid, ShadowHand: one collection round), 2000 or 512 (BallBalance,
# with 128 envs), and a surrogate-real episode longer than 1000 steps to
# 1000 (Anymal: episodeLength_s 50 -> 1000/60; Ingenuity:
# maxEpisodeLength 2000 -> 1000).
_SPD = ("spd_factor_lanes", "spd_substitute_lanes")
_TREE = ("tree_ltdl_factor", "tree_ltdl_substitute")
_HALF = ("tree_ltdl_upsolve", "tree_ltdl_downsolve")
_INTEG = ("integrate_clamp",)
ADR_PHASES = [
    ("Ant", "ant", 1024, 17, [256, 128, 64], 16, 50,
     "summary_corrdiff", _SPD + _INTEG, 1000, {}, 2),
    ("Humanoid", "humanoid", 4096, 37, [400, 200, 100], 32, 50,
     "summary_corrdiff", _TREE + _INTEG, 1000, {}, 2),
    ("Anymal", "anymal", 4000, 13, [256, 128, 64], 24, 50,
     "summary_corrdiff", _SPD + _INTEG, 2000,
     {"episodeLength_s": 1000 / 60}, 1),
    ("Quadcopter", "quadcopter", 8192, 9, [256, 128, 64], 16, 10,
     "summary_start", _SPD + _INTEG, 2000, {}, 1),
    ("Ingenuity", "ingenuity", 4096, 9, [256, 128, 64], 16, 10,
     "summary_start", _SPD + _INTEG, 2000,
     {"maxEpisodeLength": 1000}, 1),
    ("BallBalance", "ball_balance", 128, 7, [128, 64, 32], 16, 20,
     "summary_corrdiff", _TREE + _INTEG, 512, {}, 1),
    ("FrankaCabinet", "franka_cabinet", 2048, 19, [256, 128, 64], 16, 30,
     "summary_corrdiff", _SPD + _INTEG, 2000, {}, 1),
    ("ShadowHand", "shadow_hand", 1024, 32, [512, 256, 128], 8, 30,
     "summary_corrdiff", _TREE + _HALF + _INTEG, 1000, {}, 2),
]

# Phases 9a and 9b: ShadowHand at the JAX package's own scale, as
# ADR_PHASES' entries with the obs width and the collection policy:
# shadow_hand_more.yaml (10000 envs, 111 params, 89-dim obs, trainTrajLen
# 50, PPO nsteps 8 x 10000 = 80,000 rows) and shadow_hand_grasp.yaml
# (2048 envs, policy_grasp, the 107-dim force-sensor obs, the grasp DR
# layout's 32 params), 1 ADR iteration each with trainTrajs cut to 1000
# (one collection round; of 20000 and 4000) and 5 PPO iterations; the
# evaluation's 600-step episodes uncut.
HAND_SCALE_PHASES = [
    (("ShadowHand", "shadow_hand_more", 10000, 111, [512, 256, 128], 8, 50,
      "summary_corrdiff", _TREE + _HALF + _INTEG, 1000, {}, 1), 89,
     "policy_rl_randomized"),
    (("ShadowHand", "shadow_hand_grasp", 2048, 32, [512, 256, 128], 8, 30,
      "summary_corrdiff", _TREE + _HALF + _INTEG, 1000, {}, 1), 107,
     "policy_grasp"),
]

# The tasks of the step-graph phase: (task, config stem, numEnvs, env
# edits), the ADR phases' widths and cuts. ShadowHand runs with the
# asymmetric critic (no shipped config sets it), so that its privileged
# inputs are captured too.
GRAPH_TASKS = [("Cartpole", "cartpole", 512, {}),
               ("Pendulum", "pendulum", 100, {})] + [
    (t, stem, envs, dict(edits, **({"asymmetric_observations": True}
                                   if t == "ShadowHand" else {})))
    for t, stem, envs, *_x, edits, _it in ADR_PHASES]


def phase_adr(task, stem, envs, dim, widths, nsteps, traj_len, summarizer,
              kernels, train_trajs, env_edits, iters, obs=None, cpol=None):
    """One of ADR_PHASES (or HAND_SCALE_PHASES, with the obs width ``obs``
    and the collection policy ``cpol`` checked) at full width
    (cfg/<stem>.yaml and cfg/train/ppo_<task>.yaml), cut in depth only
    (see ADR_PHASES): checks the widths, that its physics launched exactly
    the kernels of its solve (the SPD factor and substitute on the dense
    path, the tree kernels on Humanoid's tree and BallBalance's forest,
    with the half-solves on ShadowHand's) and no other, the posteriors and
    the card."""
    from bayes_sim_ig_tpu_torch.utils import collect
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   f"{stem}.yaml"))
    cfg["bayessim"].update(trainTrajs=train_trajs, realIters=iters)
    cfg["env"].update(env_edits)
    bs = cfg["bayessim"]
    assert cfg["env"]["numEnvs"] == envs and bs["trainTrajLen"] == traj_len
    assert bs["modelClass"] == "MDNN" and bs["components"] == 10
    assert bs["hiddenLayers"] == [128, 128]
    assert bs["summarizerFxn"] == summarizer
    assert cpol is None or bs["collectPolicy"] == cpol
    # policy_grasp is called (by the step's eager body and its capture) only
    # where a collection step graph holds it.
    grasp_calls = [0]
    policy_grasp = collect.policy_grasp

    def counted(*args):
        grasp_calls[0] += 1
        return policy_grasp(*args)
    collect.policy_grasp = counted
    try:
        out, launches, secs, timer = _run_adr(task, cfg, stem, iters)
    finally:
        collect.policy_grasp = policy_grasp
    if (cpol == "policy_grasp") != (grasp_calls[0] > 0):
        raise AssertionError(f"{stem}: policy_grasp ran in "
                             f"{grasp_calls[0]} step bodies under "
                             f"collectPolicy {bs['collectPolicy']}")
    others = [k for k in launches if k not in kernels]
    for entry in kernels:
        if launches[entry] <= 0:
            raise AssertionError(f"the {task} ADR loop never launched "
                                 f"{entry}")
    for entry in others:
        if launches[entry] != 0:
            raise AssertionError(f"the {task} ADR loop launched {entry}")
    env = out["env"]
    assert env.num_envs == envs and env.task.params_spec.dim == dim
    assert env.task.max_episode_length <= 1000
    net = out["bsim"].model.net
    assert type(out["bsim"].model).__name__ == "MDNN"
    assert [l.out_features for l in net.trunk] == [128, 128]
    assert net.mu.out_features == dim * 10
    ppo = out["ppo"]
    assert [l.out_features for l in ppo.net.actor][:3] == widths
    assert ppo.nsteps == nsteps and ppo.activation == "elu"
    if task == "ShadowHand":
        assert env.task.obs_dim == (obs or 89) and env.task.act_dim == 20
    print(f"[adr] {task} ({stem}.yaml, {bs['collectPolicy']}"
          f"{f' in {grasp_calls[0]} step bodies' if grasp_calls[0] else ''}"
          f", obs {env.task.obs_dim}) {envs} envs, nv {env.task.model.nv}, "
          f"{iters} ADR iteration(s) in {secs:.2f} s (per iteration: "
          f"{', '.join(f'{s:.2f}' for s in out['iter_secs'])} s; phases: "
          f"{timer.line()}); launches {launches}; {dim}-dim posteriors "
          f"finite; model, refit, policy and env tensors on cuda",
          flush=True)
    return launches


def _allocated():
    """Allocated bytes after a garbage collection, with and without
    cuBLAS's workspaces: PyTorch keeps one for each stream that ran a
    cuBLAS call, and each capture runs on a side stream of the pool."""
    gc.collect()
    torch.cuda.empty_cache()
    with_ws = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    return with_ws, torch.cuda.memory_allocated()


def phase_adr_pair(seed=7, iters=3):
    """Phase 9d: the grasp-ADR experiment's two arms through
    ``run_pair`` (each through ``bayes_sim_main.main``) at full width, cut
    in depth only (``iters`` ADR iterations of 5 PPO iterations,
    realEvals 400), into a temporary dir under runs/chip_smoke; then the
    pooled analysis on the pair's two JSON files. Returns {arm: launches}
    (each arm's count, with every count set to 0 before the pair)."""
    import tempfile
    sys.path.insert(0, os.path.join(HERE, "experiments"))
    import adr_grasp_vs_ctl_torch as pair
    import adr_pooled_analysis
    from bayes_sim_ig_tpu_torch.utils import step_graph
    before = _allocated()[1]
    os.makedirs(RUN_DIR, exist_ok=True)
    _reset_launches()
    with tempfile.TemporaryDirectory(dir=RUN_DIR) as tmp:
        t0 = time.perf_counter()
        results = pair.run_pair(
            seed, 400, "cuda:0", {"bayessim": {"realIters": iters}},
            max_iterations=5, runs_dir=os.path.join(tmp, "runs"),
            data_dir=tmp, keep=True)
        secs = time.perf_counter() - t0
        launches = {}
        for arm, (out, rec, _) in results.items():
            if rec["error"]:
                raise AssertionError(f"the {arm} arm raised:\n"
                                     f"{rec['error']}")
            assert out["env"].num_envs == 2048
            assert out["env"].task.obs_dim == 107
            assert out["env"].task.params_spec.dim == 32
            rewards = out["real_rewards"]
            if len(rewards) != iters or not all(
                    np.isfinite(list(r.values())).all() for r in rewards):
                raise AssertionError(f"{arm}: real_rewards {rewards}")
            stats = rec["graph_stats"]
            for phase in ("rollout", "update", "collect"):
                if stats.get(phase, {}).get("replays", 0) <= 0:
                    raise AssertionError(f"{arm}: no {phase} replay")
            if rec["live_graphs"] or out["env"].step_graphs:
                raise AssertionError(f"{arm}: graphs kept: "
                                     f"{rec['live_graphs']}")
            for entry, count in rec["launches"].items():
                if (count > 0) != (entry in _TREE + _HALF + _INTEG):
                    raise AssertionError(f"{arm}: {entry} launched {count} "
                                         f"times")
            posteriors = glob.glob(os.path.join(out["logdir"], "**",
                                                "posterior_*.pkl"),
                                   recursive=True)
            if arm == "drctl":
                # No BayesSim, no fit and no posterior; the PPO restarts
                # reuse the first iteration's captures.
                assert out["bsim"] is None and out["iter_secs"] == []
                assert not posteriors, posteriors
                assert stats.get("fit", {}).get("replays", 0) == 0, stats
                first = rec["iterations"][0]["captures"]
                for phase in ("rollout", "update"):
                    if stats[phase]["captures"] != first[phase]:
                        raise AssertionError(
                            f"drctl: {phase} captures {first[phase]} after "
                            f"the first PPO run, {stats[phase]['captures']} "
                            f"after {iters}")
            else:
                assert stats.get("fit", {}).get("replays", 0) > 0, stats
                assert len(posteriors) == iters, posteriors
                for path in posteriors:
                    with open(path, "rb") as f:
                        post = pickle.load(f)
                    for k in ("weights", "means", "covs"):
                        if not np.isfinite(post[k]).all():
                            raise AssertionError(f"grasp {path} {k} is not "
                                                 f"finite")
            launches[arm] = rec["launches"]
            print(f"[adr pair] {pair.summary(rec)}; launches "
                  f"{ {k: v for k, v in rec['launches'].items() if v} }",
                  flush=True)
        total = _read_launches()
        for entry, count in total.items():
            assert count == sum(c[entry] for c in launches.values()), (
                entry, count, launches)
        paths = ":".join(results[arm][2] for arm in ("grasp", "drctl"))
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            adr_pooled_analysis.main([paths])
        del results, out
    with_ws, after = _allocated()
    if after - before > 64 * 2**20:
        raise AssertionError(f"the pair left {(after - before) / 2**20:.1f} "
                             f"MiB allocated")
    print(f"[adr pair] seed {seed}, {iters} ADR iterations an arm in "
          f"{secs:.2f} s; live graphs {step_graph.live_graphs()}; "
          f"allocated {(after - before) / 2**20:+.1f} MiB after the pair "
          f"({(with_ws - before) / 2**20:+.1f} with cuBLAS's workspaces); "
          f"analysis: {log.getvalue().strip().rsplit(' | ', 1)[-1]}",
          flush=True)
    return launches


def phase_grasp_full_probe(steps=20):
    """20 steps of cfg/shadow_hand_grasp_full.yaml at its 2048 envs (the
    211-dim full_state obs: dof forces, fingertip states and force/torque
    sensors from the impulse pass) under its grasp collection policy,
    params drawn from the spec's box: every obs and the force, torque and
    dof-force blocks finite; the step's wall and device time."""
    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    from bayes_sim_ig_tpu_torch.utils.collect import get_collect_policy
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "shadow_hand_grasp_full.yaml"))
    assert cfg["env"]["numEnvs"] == 2048
    env = make_env("ShadowHand", cfg, seed=0, device="cuda:0")
    task = env.task
    assert task.obs_dim == 211 and task.full_state_obs
    spec = task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs),
                                  device="cuda:0"))
    env.reset()
    policy = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    act = policy(torch.zeros(env.num_envs, task.act_dim, device="cuda:0"),
                 torch.Generator(device="cuda:0").manual_seed(0))
    for _ in range(steps):
        obs, _, _, _ = env.step(act)
    st = env.state.task_state
    raw = task.observe(st, env.state.params)
    torch.cuda.synchronize()
    for name, x in (("obs", obs), ("raw obs", raw), ("tip_force",
                    st.tip_force), ("tip_torque", st.tip_torque),
                    ("dof_force", st.dof_force)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"ShadowHand full_state {name} not finite")
    assert obs.shape == (2048, 211)
    step = _env_step_profile(env, act=act)
    print(f"[probe] ShadowHand full_state (shadow_hand_grasp_full.yaml) 2048 "
          f"envs, {steps} steps of policy_grasp: obs (2048, 211), force "
          f"|max| {float(st.tip_force.abs().max()):.3f}, torque |max| "
          f"{float(st.tip_torque.abs().max()):.4f}, dof force |max| "
          f"{float(st.dof_force.abs().max()):.3f}, all finite; "
          f"{_step_line(step)}", flush=True)


def phase_hand_round(envs=16384, mel=51):
    """Phase 9c: ShadowHand (shadow_hand.yaml) at 16384 envs, episodes of
    51 (bench.py's collection round: policy_random, the prior): the 50 step
    replays against 50 calls of the eager body from one state and
    generator, bit for bit (trajectory, state leaves, obs, generator) with
    equal launches, then a whole round (reset, 50 steps, extraction)
    through its programs against their eager bodies (``round_check``);
    the step's wall ms graphed and eager, its device ms and operations,
    the captures' seconds and the peak device memory."""
    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.sim.task import env_full_reset
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    from bayes_sim_ig_tpu_torch.utils.collect import (
        collect_step_graph, get_collect_policy,
    )
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg_dir = os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg")
    cfg = load_config(os.path.join(cfg_dir, "shadow_hand.yaml"))
    cfg["env"]["numEnvs"] = envs
    env = make_env("ShadowHand", cfg, seed=0, device="cuda:0")
    ppo = process_ppo(env, load_config(os.path.join(
        cfg_dir, "train", "ppo_shadow_hand.yaml")),
        logdir=os.path.join(RUN_DIR, "hand_round"), seed=0)
    task, spec = env.task, env.task.params_spec
    cpol = get_collect_policy("policy_random", task)
    prior = to_device_distr(Uniform(spec.lows, spec.highs), device="cuda:0")
    st0, obs0 = env_full_reset(task, prior, ppo.gen)
    cg = collect_step_graph(env, ppo.policy_apply, cpol, mel, ppo.net,
                            prior, ppo.gen, st0, obs0)

    def cload():
        cg.load(st0, obs0, prior)
    diffs, g_l, e_l, g_ms, e_ms = _graph_vs_eager(cg, cload, [ppo.gen],
                                                  mel - 1)
    if diffs:
        raise AssertionError(f"ShadowHand {envs} envs: graph and eager "
                             f"differ in {_diff_line(diffs)}")
    if g_l != e_l:
        raise AssertionError(f"ShadowHand {envs} envs: launches of the "
                             f"replays {g_l} != eager {e_l}")
    cload()
    dev, ops = _device_profile(cg.step, n=10)
    rnd = round_check(env, ppo, cpol, mel, prior)
    peak = torch.cuda.max_memory_allocated()
    busy = "not measured" if dev is None else f"{dev / g_ms:.3f}"
    print(f"[hand-round] ShadowHand (shadow_hand.yaml) {envs} envs, "
          f"nv {task.model.nv}: collection (policy_random, prior, episodes "
          f"of {mel}) {mel - 1} replays equal their eager bodies bit for bit"
          f" (trajectory, {len(_state_leaves(cg.state))} state leaves, obs,"
          f" generator); launches of {mel - 1} replays {g_l} == eager; a "
          f"whole round (reset, {mel - 1} steps, extraction; "
          f"{rnd['arrays']} arrays) through its programs equal to their "
          f"bodies, {rnd['wall_s']:.3f} s against {rnd['eager_s']:.3f} s; "
          f"step graphed {g_ms:.3f} ms wall against eager {e_ms:.2f} ms, "
          f"device {_fmt(dev)} ({ops} device operations, busy share "
          f"{busy}), captured in {cg.capture_s:.3f} s (round programs "
          f"{rnd['capture_s']:.3f} s); peak device memory "
          f"{peak / 2**30:.2f} GiB allocated; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ppo.free_update_graphs()
    env.free_step_graphs()


def _level_check(name, got, want, d, depth):
    """Each signature level within rtol 1e-4 and an atol of 1e-5 of its
    largest entry: a level is a float32 sum over the path's steps, and
    entries near 0 sit beside entries of the level's full scale. Returns
    the largest error over the level's scale."""
    worst, off = 0.0, 0
    for k in range(1, depth + 1):
        lvl = slice(off, off + d ** k)
        off += d ** k
        g, w = got[:, lvl], want[:, lvl]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        bad = ((g - w).abs() > 1e-4 * w.abs() + 1e-5 * scale).sum()
        if not torch.isfinite(g).all() or int(bad):
            raise AssertionError(f"{name}: level {k} off by {err:.3g} "
                                 f"(scale {scale:.3g}, {int(bad)} entries)")
        worst = max(worst, err / scale)
    return worst


def phase_signature():
    """path_signature on the card against float64 on the CPU: at
    cartpole_more.yaml's collection shape (10000 paths of 20 steps, the
    time channel, 4 obs and 1 action: depth 3, 258 features) and at a
    depth-2 shape (2000 paths of 50 steps, 23 channels: 552 features)."""
    from bayes_sim_ig_tpu_torch.summarizers import (
        path_signature, signature_depth, summary_signatory,
    )
    gen = torch.Generator().manual_seed(0)
    for b, t, d in ((10000, 20, 6), (2000, 50, 23)):
        depth = signature_depth(d)
        paths = torch.randn(b, t, d, generator=gen)
        if d == 6:  # cartpole_more's time ids 1..20 in channel 0
            paths[:, :, 0] = torch.arange(1, t + 1, dtype=torch.float32)
        x = paths.to("cuda:0")
        got = path_signature(x, depth)
        torch.cuda.synchronize()
        want = path_signature(paths.double(), depth)
        rel = _level_check(f"path_signature ({b}, {t}, {d})", got.cpu(),
                           want.float(), d, depth)
        ms = _median_ms(lambda: path_signature(x, depth), n=20)
        dev = _device_ms(lambda: path_signature(x, depth), n=10)
        print(f"[signature] ({b}, {t}, {d}) depth {depth}: "
              f"{tuple(got.shape)} on cuda, max error {rel:.3g} of its "
              f"level's largest entry against float64; {ms:.4f} ms per "
              f"call (median of 20, CUDA events), device {_fmt(dev)} per "
              f"call (profiler)", flush=True)
    states = torch.randn(64, 21, 4, generator=gen).to("cuda:0")
    actions = torch.rand(64, 21, 1, generator=gen).to("cuda:0")
    feats = summary_signatory(states, actions)
    assert feats.shape == (64, 258) and bool(torch.isfinite(feats).all())


def phase_adr_cartpole_more():
    """cfg/cartpole_more.yaml at full width, uncut but in realIters (2 of
    100) and PPO iterations (5 a ADR iteration): summary_signatory on
    time-augmented paths of 1 + 4 + 1 channels, depth 3."""
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "cartpole_more.yaml"))
    cfg["bayessim"].update(realIters=2)
    bs = cfg["bayessim"]
    assert cfg["env"]["numEnvs"] == 512 and bs["trainTrajs"] == 10000
    assert bs["summarizerFxn"] == "summary_signatory"
    assert bs["modelClass"] == "MDNN" and bs["components"] == 10
    assert bs["hiddenLayers"] == [128, 128] and bs["trainTrajLen"] == 20
    out, launches, secs, timer = _run_adr("Cartpole", cfg, "cartpole_more")
    if any(launches.values()):
        raise AssertionError(f"the cartpole_more path launched a kernel: "
                             f"{launches}")
    model = out["bsim"].model
    assert type(model).__name__ == "MDNN" and model.input_dim == 258
    assert model.net.mu.out_features == 13 * 10
    print(f"[adr] Cartpole cartpole_more.yaml (summary_signatory, 258 "
          f"features) 512 envs, 2 ADR iterations in {secs:.2f} s (per "
          f"iteration: {', '.join(f'{s:.2f}' for s in out['iter_secs'])} "
          f"s; phases: {timer.line()}); launches no kernel (all counts 0); "
          f"13-dim posteriors finite; model, refit, policy and env tensors "
          f"on cuda", flush=True)
    return launches


def phase_parallel():
    """A one-rank NCCL group: collectives on a CUDA tensor, then
    setup_parallelism, which must leave one device and no mesh."""
    import io
    import socket

    import torch.distributed as dist

    from bayes_sim_ig_tpu_torch.bayes_sim_main import setup_parallelism
    from bayes_sim_ig_tpu_torch.parallel import (
        get_global_mesh, initialize_distributed, set_global_mesh,
    )
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    if not initialize_distributed(coordinator_address=f"localhost:{port}",
                                  num_processes=1, process_id=0,
                                  backend="nccl", timeout_s=120):
        raise AssertionError("initialize_distributed did not initialize")
    try:
        assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
        if initialize_distributed() is not False:
            raise AssertionError("a second initialize_distributed joined")
        x = torch.arange(12, dtype=torch.float32, device="cuda:0")
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        y = x * 3.0 + 1.0
        dist.broadcast(y, src=0)
        torch.cuda.synchronize()
        if not (torch.equal(parts[0], x)
                and torch.equal(y, torch.arange(12, device="cuda:0") * 3.0
                                + 1.0)):
            raise AssertionError("NCCL all_gather/broadcast values differ")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mesh = setup_parallelism(512, "cuda:0")
        said = buf.getvalue().strip()
        if (mesh is not None or get_global_mesh() is not None
                or "single device (1 visible)" not in said):
            raise AssertionError(f"setup_parallelism(512): {mesh}, {said}")
    finally:
        set_global_mesh(None)
        dist.destroy_process_group()
    print(f"[parallel] NCCL world 1 on localhost:{port}: all_gather and "
          f"broadcast of a CUDA tensor exact; setup_parallelism(512): "
          f"'{said}'; group destroyed; {time.perf_counter() - t0:.2f} s",
          flush=True)


def _kernel_entry(name, source, replaces, launches, t, library_call=None,
                  **extra):
    """One kernel's object of the kernels line. ``launches`` is the sum
    over the ADR phases of {task: count} (``launches_by_task``, each read
    after its own phase). ``library_ms`` is the time of the one PyTorch
    call computing the same function (null where there is none);
    ``dense_pair_ms`` (tree kernels) is the dense factor + solve
    yardstick of the pair, not a library version of one kernel."""
    lib = t.get("library")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_task": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "dev_ms": t["dev_ms"],
            "plain_dev_ms": t["plain_dev_ms"], "bound_ms": t["bound"].ms,
            "bound_by": t["bound"].by,
            "library_ms": None if lib is None else lib["ms"],
            "library_dev_ms": None if lib is None else lib["dev_ms"],
            "library_call": library_call, **extra}


def main():
    t0 = time.perf_counter()
    smi = phase_device()
    phase_build()
    rff = phase_rff_kernel()
    spd = phase_spd_kernel()
    tree = phase_tree_kernel()
    half = phase_half_solves()
    integ = phase_integrate_kernel()
    phase_step_graphs()
    phase_train_graphs(smi)
    ant, humanoid, *rest = ADR_PHASES
    runs = {"Ant": phase_adr(*ant), "Cartpole": phase_adr_cartpole()}
    phase_adr_graph_vs_eager()
    runs["Humanoid"] = phase_adr(*humanoid)
    phase_adr_pendulum()
    for spec in rest:
        runs[spec[0]] = phase_adr(*spec)
    for spec, obs, cpol in HAND_SCALE_PHASES:
        runs[f"ShadowHand {spec[1]}"] = phase_adr(*spec, obs=obs, cpol=cpol)
    phase_hand_round()
    for arm, launches in phase_adr_pair().items():
        runs[f"ShadowHand grasp pair {arm}"] = launches
    phase_grasp_full_probe()
    phase_signature()
    runs["cartpole_more"] = phase_adr_cartpole_more()
    phase_parallel()

    def by_task(kernel):
        return {task: c[kernel] for task, c in runs.items() if c[kernel]}
    kernels = [_kernel_entry(
        "rff_features", "bayes_sim_ig_tpu_torch/csrc/rff_features.cu",
        "bayes_sim_ig_tpu/ops/rff_kernel.py:50", by_task("rff_features"),
        rff, times=rff["times"])]
    for entry in ("factor", "substitute"):
        t = spd[entry]
        kernels.append(_kernel_entry(
            f"spd_{entry}_lanes", "bayes_sim_ig_tpu_torch/csrc/spd_lanes.cu",
            "bayes_sim_ig_tpu/ops/spd_kernel.py:143",
            by_task(f"spd_{entry}_lanes"), t, library_call=LIBRARY[entry],
            times=t["times"]))
    # The factor kernel replaces both forms of the JAX factor (:50, :76);
    # Humanoid's path there takes the left-looking one.
    for entry, replaces in (
            ("factor", "bayes_sim_ig_tpu/ops/tree_solve.py:76"),
            ("substitute", "bayes_sim_ig_tpu/ops/tree_solve.py:127")):
        t = tree[entry]
        kernels.append(_kernel_entry(
            f"tree_ltdl_{entry}", "bayes_sim_ig_tpu_torch/csrc/tree_ltdl.cu",
            replaces, by_task(f"tree_ltdl_{entry}"), t,
            dense_pair_ms=t["dense_pair"]["ms"],
            dense_pair_dev_ms=t["dense_pair"]["dev_ms"], times=t["times"]))
    # The half-solves: one thread per env and right-hand side, or the
    # substitute's lane pass below one walking warp an SM.
    for entry, replaces in (
            ("upsolve", "bayes_sim_ig_tpu/ops/tree_solve.py:146"),
            ("downsolve", "bayes_sim_ig_tpu/ops/tree_solve.py:163")):
        t = half[entry]
        kernels.append(_kernel_entry(
            f"tree_ltdl_{entry}", "bayes_sim_ig_tpu_torch/csrc/tree_half.cu",
            replaces, by_task(f"tree_ltdl_{entry}"), t,
            library_call="torch.linalg.solve_triangular(unitriangular)",
            times=t["times"]))
    kernels.append(_kernel_entry(
        "integrate_clamp", "bayes_sim_ig_tpu_torch/csrc/integrate.cu",
        "none: physics/dynamics.py::integrate + clamp_limits (plain torch)",
        by_task("integrate_clamp"), integ, graph_ms=integ["graph_ms"],
        plain_graph_ms=integ["plain_graph_ms"], times=integ["times"]))
    print(f"[total] chip_smoke.py ran in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
