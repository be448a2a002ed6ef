"""The Anymal configuration and what its cells read: its file against its
upstream copies, its ``spd_solves_per_step`` against the solves one step
calls, the SPD yardstick against hand-worked counts, and the two new
readers (``spd_roofline.train``, ``dense_solves_per_step.train``) on a
tiny run, a made-up slice, an empty run and a port without the
counters."""

import copy
import os
import types

import pytest
import yaml

from benchkit import spd_counts, spec
from benchkit.trace import Slice
from conftest import run_tiny, tiny

BENCH = spec.load_json(os.path.join(spec.CHECKOUT, "BENCHMARK.json"))
ENTRY = {c["name"]: c for c in BENCH["configs"]}["anymal"]
CONFIG = spec.load_json(os.path.join(spec.CHECKOUT, ENTRY["file"]))


def _reader(name, workload="anymal.train"):
    (m,) = [m for m in spec.resolve(workload).per_layer if m.name == name]
    return m


def test_the_configuration_is_the_upstream_one_uncut():
    assert ENTRY["reduced"] == [] and CONFIG["reduced"] == {}
    assert CONFIG["task"] == "Anymal"
    for key, path in CONFIG["upstream_files"].items():
        with open(os.path.join(spec.BENCH_DIR, path)) as f:
            assert CONFIG[key] == yaml.safe_load(f), key
    # The upstream copies are the JAX package's, which are the port's.
    for rel, path in (("anymal.yaml", "configs/upstream/anymal.yaml"),
                      ("train/ppo_anymal.yaml",
                       "configs/upstream/ppo_anymal.yaml")):
        for pkg in ("bayes_sim_ig_tpu", "bayes_sim_ig_tpu_torch"):
            with open(os.path.join(spec.CHECKOUT, pkg, "cfg", rel)) as a, \
                    open(os.path.join(spec.BENCH_DIR, path)) as b:
                assert yaml.safe_load(a) == yaml.safe_load(b), (pkg, rel)
    env, learn = CONFIG["cfg_env"]["env"], CONFIG["cfg_train"]["learn"]
    assert env["numEnvs"] == 4000 and env["episodeLength_s"] == 50
    assert (learn["nsteps"], learn["noptepochs"], learn["nminibatches"]) \
        == (24, 5, 4)


def test_spd_solves_per_step_are_the_steps():
    """The dense solves the configuration's file says one env step needs
    are the ones the step calls (counted on the CPU, where the plain
    versions run), at the frozen task's nv."""
    import torch
    from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu_torch.physics import dynamics
    from bayes_sim_ig_tpu_torch.sim import env_step, make_env
    from reference.frozen.sim import make_task
    cfg = copy.deepcopy(CONFIG["cfg_env"])
    cfg["env"]["numEnvs"] = 2
    env = make_env(CONFIG["task"], cfg, seed=0, device="cpu")
    s = env.task.params_spec
    distr = to_device_distr(pdf.Uniform(s.lows, s.highs), s.lows, s.highs,
                            device="cpu")
    env.set_distr(distr)
    env.reset()
    calls = []
    saved = []
    for fn, kind in (("spd_factor_lanes", "factor"),
                     ("spd_substitute_lanes", "substitute")):
        orig = getattr(dynamics, fn)

        def counted(*args, _orig=orig, _kind=kind, **kwargs):
            if _kind == "factor":
                n, K = args[0].shape[0], 1
            else:
                rhs = args[-1]
                n, K = rhs.shape[-2], 1 if rhs.ndim == 2 else rhs.shape[0]
            calls.append((_kind, n, K))
            return _orig(*args, **kwargs)
        saved.append((fn, orig))
        setattr(dynamics, fn, counted)
    try:
        env_step(env.task, distr, env.state,
                 torch.zeros(2, env.task.act_dim),
                 torch.Generator().manual_seed(0))
    finally:
        for fn, orig in saved:
            setattr(dynamics, fn, orig)
    counted = {}
    for key in calls:
        counted[key] = counted.get(key, 0) + 1
    said = {(s["kind"], int(s["n"]), int(s.get("K", 1))): int(s["count"])
            for s in CONFIG["spd_solves_per_step"]}
    assert counted == said
    nv = make_task("Anymal", cfg, "cpu").model.nv
    assert {n for _, n, _ in said} == {nv} == {18}


def test_spd_bytes_and_flops_by_hand():
    # n = 3, K = 2: a solve reads A's lower triangle (6 floats) and b,
    # writes x (2 x 3 each); the factor's 3 (9 - 1) / 6 = 4 multiply-adds
    # (8 FLOPs), 3 divides and 3 square roots (14 an env), and per
    # right-hand side 3 x 2 multiply-adds (12 FLOPs) and 6 divides.
    s = spd_counts.spd_solve(3, N=2, K=2)
    assert s.bytes == 4 * 2 * (6 + 2 * 2 * 3)
    assert s.flops == 2 * (14 + 2 * 18)
    # A substitute against a carried factor reads L's triangle instead of
    # A's, the same floats, and does the substitute's FLOPs alone.
    s = spd_counts.spd_substitute(3, N=2, K=2)
    assert s.bytes == 4 * 2 * (6 + 2 * 2 * 3) and s.flops == 2 * 2 * 18
    # n = 18, N = 4,000: A's triangle, b and x, 0.99 microseconds (bytes)
    # a solve; an Anymal step's two factors and two substitutes are two.
    one = 4 * 4000 * (171 + 36) / 3.35e12
    assert spd_counts.spd_solve(18, 4000).seconds == pytest.approx(one)
    assert spd_counts.spd_step_seconds(
        4000, CONFIG["spd_solves_per_step"]) == pytest.approx(2 * one)
    # One factor and three substitutes at n = 3, N = 2, K = 1: one solve
    # and two substitutes; a factor of another n pairs with none.
    calls = [{"kind": "factor", "count": 1, "n": 3},
             {"kind": "factor", "count": 5, "n": 4},
             {"kind": "substitute", "count": 3, "n": 3, "K": 1}]
    assert spd_counts.spd_step_seconds(2, calls) == pytest.approx(
        spd_counts.spd_solve(3, 2).seconds
        + 2 * spd_counts.spd_substitute(3, 2).seconds)


def test_spd_roofline_reads_the_slice():
    """Two traced PPO iterations of 24 steps: 48 steps' bound over the
    device time of the ``spd_*kernel`` operations alone, at the
    configuration's n (no task is built)."""
    reader = _reader("spd_roofline.train")
    step = spd_counts.spd_step_seconds(4000, CONFIG["spd_solves_per_step"])
    ops = [("void spd_factor_kernel<32>(float const*)", 0.0, 1e-3),
           ("void spd_substitute_kernel<32>(float const*)", 1e-3, 1.5e-3),
           ("void tree_ltdl_factor_kernel<8>()", 2e-3, 9e-3),
           ("gemm", 1.5e-3, 2e-3)]
    s = Slice(label="s", lo=0.0, hi=1.0, ops=ops, ranges=[],
              host_seconds=1.0, env_steps=48)
    run = types.SimpleNamespace(loop="ppo", slice=s, config=CONFIG,
                                task={"num_envs": 4000})
    assert reader.read(run) == pytest.approx(100.0 * 48 * step / 1.5e-3)


def test_the_new_readers_read_nothing_where_there_is_nothing(monkeypatch):
    from bayes_sim_ig_tpu_torch.physics import dynamics
    from bayes_sim_ig_tpu_torch.sim import task
    roof = _reader("spd_roofline.train")
    solves = _reader("dense_solves_per_step.train")
    empty = types.SimpleNamespace(loop="ppo", slice=None, config=CONFIG)
    assert roof.read(empty) is None
    idle = Slice(label="s", lo=0.0, hi=1.0, ops=[("gemm", 0.0, 0.5)],
                 ranges=[], host_seconds=1.0, env_steps=48)
    assert roof.read(types.SimpleNamespace(
        loop="ppo", slice=idle, config=CONFIG)) is None
    assert roof.read(types.SimpleNamespace(
        loop="adr", slice=idle, config=CONFIG)) is None
    monkeypatch.setattr(task, "STATS", {"env_steps": 0})
    assert solves.read(empty) is None
    monkeypatch.setattr(task, "STATS", {"env_steps": 10})
    monkeypatch.setattr(dynamics, "STATS", {
        "dense_factor": 20, "dense_substitute": 20, "tree_factor": 0,
        "tree_substitute": 0})
    assert solves.read(empty) == 4.0
    assert solves.read(types.SimpleNamespace(loop="adr")) is None
    # A port without the counters (the benchmark's files laid over an
    # older checkout): nothing, and no error.
    monkeypatch.delattr(dynamics, "STATS")
    assert solves.read(empty) is None
    monkeypatch.setattr(dynamics, "STATS", {"dense_factor": 0},
                        raising=False)
    monkeypatch.delattr(task, "STATS")
    assert solves.read(empty) is None


def test_a_tiny_anymal_run_counts_four_dense_solves_a_step(tmp_path):
    """A tiny ``anymal.train`` run on the CPU (set-up and window): four
    dense solves every env step, the run correct."""
    from bayes_sim_ig_tpu_torch.physics import dynamics
    from bayes_sim_ig_tpu_torch.sim import task
    saved = dict(dynamics.STATS), dict(task.STATS)
    for d in (dynamics.STATS, task.STATS):
        d.update({k: 0 for k in d})
    try:
        out = run_tiny(tiny(spec.resolve("anymal.train")),
                       tmp_path=tmp_path)
        got = _reader("dense_solves_per_step.train").read(out["run"])
        steps = task.STATS["env_steps"]
    finally:
        dynamics.STATS.update(saved[0])
        task.STATS.update(saved[1])
    assert out["line"]["correct"] is True, out["compared"]
    assert steps > 0 and got == sum(
        s["count"] for s in CONFIG["spd_solves_per_step"]) == 4


@pytest.mark.parametrize("name, workloads", [
    ("spd_roofline.train", ["anymal.train"]),
    ("dense_solves_per_step.train", ["anymal.train"])])
def test_the_new_metrics_keep_to_the_contract(name, workloads):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["moves"] == "train_env_steps_per_s"
    assert m["workloads"] == workloads
    assert m["layer"] in {"kernels", "env, physics"}
    for cell in ("anymal.train", "hand_more.train"):
        names = {x.name for x in spec.resolve(cell).per_layer}
        assert (name in names) == (cell in workloads)
