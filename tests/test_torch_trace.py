"""The port's spans and counters (``bayes_sim_ig_tpu_torch/utils/trace.py``,
``utils/collect.py::STATS``, ``utils/step_graph.py::STATS``) on the CPU:

  (a) tracing off leaves no record and no profiler range;
  (b) one tiny ADR iteration with tracing on (``--profile``) gives the
      span tree of the ADR loop, PPO, collection, BayesSim and the
      programs, with parent links that nest in time; collection's
      counters equal the configuration's arithmetic; the profiler's trace
      holds each span once as a ``bsig.`` range that nests as the records
      do, and tracing is off again after the profiled iteration;
  (c) with tracing on, a collection step and a rollout step make no host
      sync and copy nothing from the host;
  (d) a capture's launches are added in place at each replay, read back
      by ``launch_counts`` as before;
  (e) ``experiments/trace_readout.py``'s readings on synthetic records
      and a hand-built slice;
  (f) on a card (``cuda`` marker), a replay's device interval is positive
      and resolves only once the replay has finished.
"""

import json
import math
import os
import sys
from collections import Counter

import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch import bayes_sim_main as bsm
from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.sim.task import env_full_reset
from bayes_sim_ig_tpu_torch.utils import collect, step_graph, trace
from bayes_sim_ig_tpu_torch.utils.collect import (collect_step_graph,
                                                  collect_trajectories,
                                                  get_collect_policy)

from .torch_task_checks import NoHostTraffic

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(REPO, "experiments") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "experiments"))

import trace_readout  # noqa: E402

N, EP = 16, 20  # envs, episode length of the evaluation


@pytest.fixture(autouse=True)
def _tracing_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _pendulum(tmp_path, nsteps=4):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           "pendulum.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = N
    cfg["env"]["episodeLength"] = EP
    env = make_env("Pendulum", cfg, seed=3, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(Uniform(spec.lows, spec.highs), spec.lows,
                                  spec.highs, device="cpu"))
    ppo = process_ppo(env, {"seed": 0, "learn": {
        "nsteps": nsteps, "noptepochs": 1, "nminibatches": 2,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [16], "vf_hid_sizes": [16]}}, logdir=str(tmp_path))
    return env, ppo, cfg


# ------------------------------------------------------------------ #
# (a) off
# ------------------------------------------------------------------ #
def test_tracing_off_leaves_no_records_and_no_ranges(tmp_path):
    """A PPO iteration and an evaluation with its frames under a CPU
    profiler, tracing off: no record, no ``bsig.`` range."""
    env, ppo, _ = _pendulum(tmp_path)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        ppo.run(num_learning_iterations=1)
        collect_trajectories(4, ppo, visualize=True)
    assert trace.records() == []
    assert trace.span("x") is trace.span("y", a=1)  # the shared no-op
    assert not [e.name for e in prof.events()
                if e.name.startswith(trace.PREFIX)]


# ------------------------------------------------------------------ #
# (b) one ADR iteration, traced through --profile
# ------------------------------------------------------------------ #
TRAIN_TRAJS, TRAIN_LEN, REAL_EVALS, REAL_TRAJS, PPO_ITS = 40, 8, 4, 2, 2


@pytest.fixture(scope="module")
def adr_run(tmp_path_factory):
    """Two tiny Pendulum ADR iterations, the first under ``--profile``:
    (records, the collection counters' increments, the Chrome trace's
    ``bsig.`` events, whether tracing was on after the run, the records
    left after it). ``--profile`` drops its records when it stops: they
    are read as it drops them."""
    trace.disable()
    trace.reset()
    d = tmp_path_factory.mktemp("adr")
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           "pendulum.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update(numEnvs=N, episodeLength=EP)
    cfg["bayessim"].update(trainTrajs=TRAIN_TRAJS, trainTrajLen=TRAIN_LEN,
                           realEvals=REAL_EVALS, realTrajs=REAL_TRAJS,
                           realIters=2)
    path = str(d / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    before = dict(collect.STATS)
    dropped = []
    reset = trace.reset

    def reading_reset():
        dropped.append(trace.records())
        reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "reset", reading_reset)
        bsm.main(["--task", "Pendulum", "--cfg_env", path, "--rl_device",
                  "cpu", "--max_iterations", str(PPO_ITS), "--logdir",
                  str(d), "--profile"])
    enabled_after = trace.ENABLED
    left = trace.records()
    (records,) = dropped
    counted = {k: collect.STATS[k] - before[k] for k in before}
    (profile,) = d.glob("**/profile/trace.json")
    with open(profile) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("name", "").startswith(trace.PREFIX)]
    trace.reset()
    return records, counted, events, enabled_after, left


def _by_id(records):
    return {r["id"]: r for r in records}


def _parent_name(records, r):
    p = _by_id(records).get(r["parent"])
    return None if p is None else p["name"]


def test_adr_iteration_gives_the_span_tree(adr_run):
    records, _, _, enabled_after, left = adr_run
    assert not enabled_after, "--profile left tracing on"
    assert left == [], "--profile left its records"
    ids = [r["id"] for r in records]
    assert len(set(ids)) == len(ids)
    tops = [r for r in records if r["parent"] is None]
    assert [(r["name"], r["attrs"]) for r in tops] == [
        ("adr.iteration", {"iteration": 0})]  # the profiled one only
    pairs = Counter((r["name"], _parent_name(records, r)) for r in records
                    if r["name"] != "graph.replay")
    chunks = 1  # 40 trajectories: one chunk of BayesSim's 1000
    want = {
        ("adr.iteration", None): 1,
        ("adr.rl", "adr.iteration"): 1,
        ("ppo.iteration", "adr.rl"): PPO_ITS,
        ("ppo.rollout", "ppo.iteration"): PPO_ITS,
        ("ppo.update", "ppo.iteration"): PPO_ITS,
        ("ppo.wait", "ppo.iteration"): PPO_ITS,
        ("adr.evaluate", "adr.iteration"): 1,
        ("collect.round", "adr.evaluate"): 1,
        ("collect.gather", "adr.evaluate"): 1,
        ("collect.to_host", "adr.evaluate"): 1,
        ("collect.frames", "adr.evaluate"): 1,
        ("adr.collect_train", "adr.iteration"): chunks,
        ("collect.round", "adr.collect_train"): -(-TRAIN_TRAJS // N),
        ("collect.gather", "adr.collect_train"): -(-TRAIN_TRAJS // N),
        ("adr.fit", "adr.iteration"): chunks,
        ("bsim.summarize", "adr.fit"): chunks,
        ("bsim.fit", "adr.fit"): chunks,
        ("adr.collect_real", "adr.iteration"): 1,
        ("collect.round", "adr.collect_real"): 1,
        ("collect.gather", "adr.collect_real"): 1,
        ("adr.posterior", "adr.iteration"): 1,
        ("bsim.summarize", "adr.posterior"): 1,
        ("bsim.predict", "adr.posterior"): 1,
        ("bsim.refit", "adr.posterior"): 1,  # two surrogate-real mixtures
    }
    assert dict(pairs) == want
    replays = Counter((r["attrs"]["phase"], _parent_name(records, r))
                      for r in records if r["name"] == "graph.replay")
    assert set(replays) == {
        ("reset", "adr.rl"),  # PPO.run's VecEnv.reset
        ("rollout", "ppo.rollout"), ("update", "ppo.update"),
        ("reset", "collect.round"), ("collect", "collect.round"),
        ("extract", "collect.round"), ("fit", "bsim.fit"),
        ("fit", "bsim.refit")}
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg", "train",
                           "ppo_pendulum.yaml")) as f:
        nsteps = yaml.safe_load(f)["learn"]["nsteps"]
    # nsteps steps and the last value, an iteration.
    assert replays[("rollout", "ppo.rollout")] == PPO_ITS * (nsteps + 1)
    assert replays[("collect", "collect.round")] == (
        (EP - 1) + -(-TRAIN_TRAJS // N) * TRAIN_LEN + TRAIN_LEN)
    by = _by_id(records)
    for r in records:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"], (r["name"], p["name"])
        # The CPU times no device.
        assert r["device_ms"] is None and r["device_start_ms"] is None
    ev = [r for r in records if r["parent"] == tops[0]["id"]]
    assert [r["name"] for r in ev] == [
        "adr.rl", "adr.evaluate", "adr.collect_train", "adr.fit",
        "adr.collect_real", "adr.posterior"]
    post = [r["name"] for r in records
            if _parent_name(records, r) == "adr.posterior"]
    assert post == ["bsim.summarize", "bsim.predict", "bsim.refit"]
    frames = [r for r in records if r["name"].startswith("collect.")
              and _parent_name(records, r) == "adr.evaluate"]
    assert [r["name"] for r in frames] == [
        "collect.round", "collect.gather", "collect.to_host",
        "collect.frames"]


def test_collect_counters_equal_the_config_arithmetic(adr_run):
    """Per ADR iteration: the evaluation steps N envs for EP - 1 steps and
    keeps REAL_EVALS episodes; each training chunk steps its rounds for
    TRAIN_LEN steps and keeps its trajectories; the surrogate-real round
    keeps REAL_TRAJS. Both iterations count, traced or not."""
    _, counted, _, _, _ = adr_run
    rounds = -(-TRAIN_TRAJS // N)
    stepped = (N * (EP - 1) + rounds * N * TRAIN_LEN + N * TRAIN_LEN)
    kept = (REAL_EVALS * (EP - 1) + TRAIN_TRAJS * TRAIN_LEN
            + REAL_TRAJS * TRAIN_LEN)
    assert counted == {"stepped": 2 * stepped, "kept": 2 * kept}


def test_profiler_trace_holds_each_span_once_as_a_nested_range(adr_run):
    """The Chrome trace ``--profile`` writes holds one ``bsig.<name>``
    range per record, in the records' order, each inside its parent's."""
    records, _, events, _, _ = adr_run
    events = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    assert [trace.PREFIX + r["name"] for r in records] == [
        e["name"] for e in events]
    at = {r["id"]: e for r, e in zip(records, events)}
    for r in records:
        if r["parent"] is not None:
            e, p = at[r["id"]], at[r["parent"]]
            assert p["ts"] <= e["ts"] and (e["ts"] + e["dur"]
                                           <= p["ts"] + p["dur"] + 1e-3)


# ------------------------------------------------------------------ #
# (c) no host traffic with tracing on
# ------------------------------------------------------------------ #
def test_traced_steps_make_no_host_sync_and_no_host_copy(tmp_path):
    env, ppo, cfg = _pendulum(tmp_path, nsteps=6)
    task, gen = env.task, ppo.gen
    distr = env._distr
    cpol = get_collect_policy(cfg["bayessim"]["collectPolicy"], task)
    state, obs = env_full_reset(task, distr, gen)
    graphs = [collect_step_graph(env, ppo.policy_apply, cpol, EP, ppo.net,
                                 distr, gen, state, obs, 6),
              ppo.rollout_graph(distr, state, obs)]
    trace.enable()
    for g in graphs:
        g.load(state, obs, distr)
        g.step()
        mode = NoHostTraffic()
        with mode:
            for _ in range(5):
                g.step()
        assert not mode.hits, sorted(set(mode.hits))
    got = Counter(r["attrs"]["phase"] for r in trace.records())
    assert got == {"collect": 6, "rollout": 6}


# ------------------------------------------------------------------ #
# (d) a capture's launches, added in place at each replay
# ------------------------------------------------------------------ #
def test_launch_increments_add_in_place():
    from bayes_sim_ig_tpu_torch.ops import rff_kernel, spd_kernel, tree_solve
    from bayes_sim_ig_tpu_torch.ops.launch import (launch_counts,
                                                   launch_increments,
                                                   set_launch_counts)
    start = launch_counts()
    try:
        before = launch_counts()
        rff_kernel.LAUNCHES += 2
        spd_kernel.LAUNCHES["factor"] += 1
        tree_solve.LAUNCHES["upsolve"] += 3
        after = launch_counts()
        incs = launch_increments(before, after)
        assert sorted((k, n) for _, k, n in incs) == [
            ("LAUNCHES", 2), ("factor", 1), ("upsolve", 3)]
        set_launch_counts(before)
        for _ in range(2):  # two replays
            for counts, key, n in incs:
                counts[key] += n
        want = {k: before[k] + 2 * (after[k] - before[k]) for k in before}
        assert launch_counts() == want
        assert list(launch_counts()) == list(start)  # the names, in order
        assert rff_kernel.LAUNCHES == before["rff_features"] + 4
    finally:
        set_launch_counts(start)


# ------------------------------------------------------------------ #
# (e) experiments/trace_readout.py on synthetic records
# ------------------------------------------------------------------ #
def _rec(i, name, parent, a, b, dev=None, at=None, **attrs):
    return {"name": name, "id": i, "parent": parent, "start_ns": int(a * 1e9),
            "end_ns": int(b * 1e9), "attrs": attrs, "device_ms": dev,
            "device_start_ms": at}


def _adr_records(k, first_id):
    """ADR iteration ``k`` from t = 10 k: an evaluation of 4 s (frames
    1.5 s, replays of 0.5, 0.25 and 0.75 s on the device), 1 s of RL."""
    t, i = 10.0 * k, first_id
    return [
        _rec(i, "adr.iteration", None, t, t + 9, iteration=k),
        _rec(i + 1, "adr.rl", i, t, t + 1),
        _rec(i + 2, "adr.evaluate", i, t + 1, t + 5),
        _rec(i + 3, "collect.round", i + 2, t + 1, t + 3, round=0,
             num_trajs=4),
        _rec(i + 4, "graph.replay", i + 3, t + 1, t + 1.1, 500.0,
             phase="reset"),
        _rec(i + 5, "graph.replay", i + 3, t + 1.1, t + 1.2, 250.0,
             phase="collect"),
        _rec(i + 6, "graph.replay", i + 3, t + 1.2, t + 1.3, 750.0,
             phase="extract"),
        _rec(i + 7, "collect.frames", i + 2, t + 3.5, t + 5),
        _rec(i + 8, "adr.collect_train", i, t + 5, t + 7, chunk=0),
        _rec(i + 9, "graph.replay", i + 8, t + 5, t + 5.1, 999.0,
             phase="collect"),
    ]


def test_adr_readout_reads_the_window_iterations():
    records = _adr_records(0, 1) + _adr_records(1, 100) + _adr_records(
        2, 200)
    got = trace_readout.adr_readout(records, first=1, count=2)
    assert got["iterations"] == 2
    assert math.isclose(got["eval_s"], 4.0, rel_tol=1e-9)
    assert math.isclose(got["eval_dev_s"], 1.5, rel_tol=1e-9)
    assert math.isclose(got["frames_s"], 1.5, rel_tol=1e-9)
    assert math.isclose(got["rl_s"], 1.0, rel_tol=1e-9)
    assert math.isclose(got["collect_train_s"], 2.0, rel_tol=1e-9)
    assert trace_readout.adr_readout(records, first=3, count=1) is None
    assert trace_readout.ppo_readout(records, first=0) is None
    # The profiler's own start, 1 s inside iteration 1's frames, is left
    # out: 0.5 s a window iteration on average.
    less = [(int(13.5e9), int(14.5e9))]
    got = trace_readout.adr_readout(records, first=1, count=2, less=less)
    assert math.isclose(got["frames_s"], 1.0, rel_tol=1e-9)
    assert math.isclose(got["eval_s"], 3.5, rel_tol=1e-9)
    unresolved = [dict(r, device_ms=None) if r["id"] == 104 else r
                  for r in records]
    assert trace_readout.adr_readout(unresolved, 1, 2)["eval_dev_s"] is None


def _ppo_records(n):
    """``n`` PPO iterations, one a second; on the device, from 200 ms an
    iteration on: replays of 30 ms at 0, 40 ms at 35 and 90 ms at 80."""
    records = []
    for k in range(n):
        t, i, d = 1.0 * k, 10 * k + 1, 200.0 * k
        records += [
            _rec(i, "ppo.iteration", None, t, t + 0.5, iteration=k),
            _rec(i + 1, "ppo.rollout", i, t, t + 0.2),
            _rec(i + 2, "graph.replay", i + 1, t, t + 0.1, 30.0, d,
                 phase="rollout"),
            _rec(i + 3, "graph.replay", i + 1, t + 0.1, t + 0.2, 40.0,
                 d + 35.0, phase="rollout"),
            _rec(i + 4, "ppo.update", i, t + 0.2, t + 0.3),
            _rec(i + 5, "graph.replay", i + 4, t + 0.2, t + 0.3, 90.0,
                 d + 80.0, phase="update"),
            _rec(i + 6, "ppo.wait", i, t + 0.3, t + 0.5),
        ]
    return records


def test_ppo_readout_reads_each_iteration():
    records = _ppo_records(3)
    got = trace_readout.ppo_readout(records, first=1)
    outer = {100: {"id": 100}}
    inside = [dict(r, parent=100) if r["name"] == "ppo.iteration" else r
              for r in records[7:]]
    assert trace_readout.ppo_readout(inside, 0, within=outer)[
        "iterations"] == 2
    assert got["iterations"] == 2
    for key, want in [("iteration_ms", 500.0), ("rollout_host_ms", 200.0),
                      ("update_host_ms", 100.0), ("wait_ms", 200.0),
                      ("rollout_dev_ms", 70.0), ("update_dev_ms", 90.0),
                      ("rollout_replays", 2), ("update_replays", 1),
                      # Iteration 1: 5 + 5 ms, and 30 to iteration 2's
                      # first replay (200 ms); iteration 2: 5 + 5 (170).
                      ("replay_gap_ms", 25.0),
                      ("replay_gap_share", 100.0 * 50.0 / 370.0)]:
        assert math.isclose(got[key], want, rel_tol=1e-6), key


def test_replay_gaps_need_every_interval_and_a_traced_next_iteration():
    records = _ppo_records(3)
    roots = {r["id"]: r for r in records if r["name"] == "ppo.iteration"}
    got = trace_readout.replay_gaps(records, roots)
    assert math.isclose(got["replay_gap_ms"], (40.0 + 40.0 + 10.0) / 3)
    assert math.isclose(got["replay_gap_share"], 100.0 * 90.0 / 570.0)
    # Iteration 1 alone: its next is not among the roots.
    one = {i: r for i, r in roots.items() if r["attrs"]["iteration"] == 1}
    got = trace_readout.replay_gaps(records, one)
    assert math.isclose(got["replay_gap_ms"], 10.0)
    assert math.isclose(got["replay_gap_share"], 100.0 * 10.0 / 170.0)
    # A replay not yet resolved, and a run with no device intervals.
    pending = [dict(r, device_ms=None) if r["id"] == 13 else r
               for r in records]
    assert trace_readout.replay_gaps(pending, roots) is None
    cpu = [dict(r, device_ms=None, device_start_ms=None) for r in records]
    assert trace_readout.replay_gaps(cpu, roots) is None
    assert trace_readout.replay_gaps(records, {}) is None


def test_launch_idle_share_splits_idle_time_by_replay_ranges():
    """A slice [0, 10] with device operations on [1, 2] and [5, 6]: idle
    [0, 1], [2, 5] and [6, 10] (8 s); replays cover [0.5, 1.5] (0.5 s of
    idle), [3, 4] (1 s) and [7, 7.5] and [7.25, 8] (1 s): 2.5 of 8."""
    ops = [("k", 1.0, 2.0), ("k", 5.0, 6.0)]
    ranges = [("graph.replay", 0.5, 1.5), ("graph.replay", 3.0, 4.0),
              ("graph.replay", 7.0, 7.5), ("graph.replay", 7.25, 8.0),
              ("ppo.rollout", 0.0, 10.0)]
    got = trace_readout.launch_idle_share(ops, ranges, 0.0, 10.0)
    assert math.isclose(got, 100.0 * 2.5 / 8.0, rel_tol=1e-12)
    assert trace_readout.launch_idle_share(ops, ranges[4:], 0, 10) is None
    assert trace_readout.launch_idle_share([("k", 0.0, 10.0)], ranges, 0.0,
                                           10.0) is None
    # By the innermost range at each gap's middle (0.5, 3.5, 8).
    by = dict(trace_readout.idle_by_span(ops, ranges, 0.0, 10.0))
    assert by == {"graph.replay": 1.0 + 3.0, "ppo.rollout": 4.0}


def test_profiled_replay_gaps_split_the_iterations_at_the_slice():
    """Six iterations, one a second; the profiler starts in [1.6, 1.7] s
    and stops in [3.6, 3.7] s: iteration 0 is the warm-up, 1 ran before
    the slice, 2 and 3 inside it, 4 and 5 after it."""
    records = _ppo_records(6)
    less = [(int(1.6e9), int(1.7e9)), (int(3.6e9), int(3.7e9))]
    got = trace_readout.profiled_replay_gaps(records, less, first=1)
    assert [got[k]["iterations"] for k in ("before", "inside",
                                           "after")] == [1, 2, 2]
    for part in got.values():
        assert math.isclose(part["rollout_host_ms"], 200.0)
    # One iteration alone: 5 + 5 ms of its 170.
    assert math.isclose(got["before"]["replay_gap_ms"], 10.0)
    assert math.isclose(got["before"]["replay_gap_share"],
                        100.0 * 10.0 / 170.0)
    # Two linked: 40 of 200 ms, then 10 of 170.
    for key in ("inside", "after"):
        assert math.isclose(got[key]["replay_gap_ms"], 25.0)
        assert math.isclose(got[key]["replay_gap_share"],
                            100.0 * 50.0 / 370.0)
    assert trace_readout.profiled_replay_gaps(records, []) is None


@pytest.mark.parametrize("intervals,lo,hi,gaps,union", [
    ([(1, 2), (5, 6)], 0, 10, [(0, 1), (2, 5), (6, 10)], 2),
    ([(1, 3), (2, 4), (9, 12)], 0, 10, [(0, 1), (4, 9)], 4),
    ([(-1, 11)], 0, 10, [], 10),
    ([], 0, 10, [(0, 10)], 0),
])
def test_idle_gaps_and_union_seconds(intervals, lo, hi, gaps, union):
    assert trace_readout.idle_gaps(intervals, lo, hi) == gaps
    assert math.isclose(trace_readout.union_seconds(intervals, lo, hi),
                        union)


def test_innermost_is_the_shortest_range_holding_the_time():
    ranges = [("a", 0.0, 10.0), ("b", 2.0, 4.0), ("c", 3.0, 3.5)]
    got = [trace_readout.innermost(ranges, t, "none")
           for t in (1.0, 2.5, 3.2, 4.0, 10.0)]
    assert got == ["a", "b", "c", "a", "none"]


@pytest.mark.parametrize("xs,ys,want", [
    ([(0, 1)], [(0.5, 2)], 0.5),
    ([(0, 1), (2, 3)], [(0.5, 2.5)], 1.0),
    ([(0, 1), (0.5, 2)], [(1.5, 1.75), (1.6, 3)], 0.5),
    ([], [(0, 1)], 0.0),
])
def test_overlap_seconds(xs, ys, want):
    assert math.isclose(trace_readout.overlap_seconds(xs, ys), want,
                        abs_tol=1e-12)


# ------------------------------------------------------------------ #
# (f) on the card: a replay's device interval
# ------------------------------------------------------------------ #
@pytest.mark.cuda
def test_replay_device_interval_resolves_after_it_ends():
    """Two replays of ~50 ms of matmuls each: right after the calls
    their records have no device interval (nothing waited); after a
    synchronize each is positive, the two are no longer than the host's
    wait, and the second starts on the device after the first ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    import time
    x = torch.randn(4096, 4096, device="cuda")
    y = torch.empty_like(x)

    def body():
        z = x
        for _ in range(40):
            z = torch.tanh(z @ x * 1e-3)
        y.copy_(z)
    g = step_graph.Graphed("trace_test", body, "cuda")
    g()  # eager, then the capture
    torch.cuda.synchronize()
    trace.enable()
    g()
    g()
    pending = trace.records()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    waited_ms = 1e3 * (time.perf_counter() - t0)
    done = trace.records()
    trace.disable()
    assert [r["name"] for r in done] == ["graph.replay"] * 2
    assert all(r["attrs"] == {"phase": "trace_test"} for r in done)
    assert pending[0]["device_ms"] is None or pending[1]["device_ms"] is None
    first, second = done
    assert 0 < first["device_ms"] and 0 < second["device_ms"]
    assert waited_ms > 0.5 * (first["device_ms"] + second["device_ms"])
    assert 0 <= first["device_start_ms"]
    assert (second["device_start_ms"]
            >= first["device_start_ms"] + first["device_ms"] - 1e-3)
    g.free()
