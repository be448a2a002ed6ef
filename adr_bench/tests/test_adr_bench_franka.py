"""The FrankaCabinet configuration and what its cell reads, and the
``humanoid.adr`` cell: the configuration against its upstream copies, its
``spd_solves_per_step`` against the port's counters over one step, the
SPD yardstick at its n, the two new readers (``pair_contacts_per_step.train``,
``kinematics_per_step.train``) on a tiny run, an empty run and a port
without the counters, and the metrics each new cell reports."""

import copy
import os
import types

import pytest
import yaml

from benchkit import checks, spd_counts, spec
from conftest import run_tiny, tiny

BENCH = spec.load_json(os.path.join(spec.CHECKOUT, "BENCHMARK.json"))
ENTRY = {c["name"]: c for c in BENCH["configs"]}["franka_cabinet"]
CONFIG = spec.load_json(os.path.join(spec.CHECKOUT, ENTRY["file"]))
NEW = ("pair_contacts_per_step.train", "kinematics_per_step.train")


def _reader(name, workload="franka.train"):
    (m,) = [m for m in spec.resolve(workload).per_layer if m.name == name]
    return m


def test_the_configuration_is_the_upstream_one_uncut():
    assert ENTRY["reduced"] == [] and CONFIG["reduced"] == {}
    assert CONFIG["task"] == "FrankaCabinet"
    for key, path in CONFIG["upstream_files"].items():
        with open(os.path.join(spec.BENCH_DIR, path)) as f:
            assert CONFIG[key] == yaml.safe_load(f), key
    # The upstream copies are the JAX package's, which are the port's.
    for rel, path in (("franka_cabinet.yaml",
                       "configs/upstream/franka_cabinet.yaml"),
                      ("train/ppo_franka_cabinet.yaml",
                       "configs/upstream/ppo_franka_cabinet.yaml")):
        for pkg in ("bayes_sim_ig_tpu", "bayes_sim_ig_tpu_torch"):
            with open(os.path.join(spec.CHECKOUT, pkg, "cfg", rel)) as a, \
                    open(os.path.join(spec.BENCH_DIR, path)) as b:
                assert yaml.safe_load(a) == yaml.safe_load(b), (pkg, rel)
    env, learn = CONFIG["cfg_env"]["env"], CONFIG["cfg_train"]["learn"]
    assert env["numEnvs"] == 2048 and env["episodeLength"] == 500
    assert (learn["nsteps"], learn["noptepochs"], learn["nminibatches"]) \
        == (16, 5, 4)
    assert CONFIG["cfg_train"]["policy"]["pi_hid_sizes"] == [256, 128, 64]
    assert CONFIG["assumed"]["cfg_train"] == CONFIG["upstream_files"][
        "cfg_train"]


def test_spd_solves_per_step_are_the_counters_of_one_step():
    """The dense solves the configuration's file says one env step needs
    are the ones the port's counters count over one step on the CPU, at
    the frozen task's nv."""
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
    before = dict(dynamics.STATS)
    env_step(env.task, distr, env.state, torch.zeros(2, env.task.act_dim),
             torch.Generator().manual_seed(0))
    counted = {kind: dynamics.STATS[f"dense_{kind}"]
               - before[f"dense_{kind}"] for kind in ("factor",
                                                      "substitute")}
    assert dynamics.STATS["tree_factor"] == before["tree_factor"]
    said = {s["kind"]: int(s["count"]) for s in CONFIG["spd_solves_per_step"]}
    assert counted == said == {"factor": 2, "substitute": 2}
    nv = make_task("FrankaCabinet", cfg, "cpu").model.nv
    assert {int(s["n"]) for s in CONFIG["spd_solves_per_step"]} == {nv} \
        == {10}
    assert [int(s.get("K", 1)) for s in CONFIG["spd_solves_per_step"]] \
        == [1, 1]


def test_spd_roofline_bound_at_frankas_shape():
    # n = 10, N = 2,048: A's lower triangle (55 floats), b and x (10 each)
    # an env; a step's two factors and two substitutes are two solves.
    one = 4 * 2048 * (55 + 20) / 3.35e12
    assert spd_counts.spd_solve(10, 2048).seconds == pytest.approx(one)
    assert spd_counts.spd_step_seconds(
        2048, CONFIG["spd_solves_per_step"]) == pytest.approx(2 * one)


def test_the_new_readers_read_nothing_where_there_is_nothing(monkeypatch):
    from bayes_sim_ig_tpu_torch.physics import contact, dynamics
    from bayes_sim_ig_tpu_torch.sim import task
    pairs, kin = (_reader(name) for name in NEW)
    run = types.SimpleNamespace(loop="ppo")
    monkeypatch.setattr(task, "STATS", {"env_steps": 0})
    assert pairs.read(run) is None and kin.read(run) is None
    monkeypatch.setattr(task, "STATS", {"env_steps": 10})
    monkeypatch.setattr(contact, "STATS", {
        "sphere_plane_pair": 40, "sphere_plane_pairs": 0,
        "sphere_box_pairs": 0, "sphere_sphere_pairs": 0})
    monkeypatch.setattr(dynamics, "STATS", {
        "dense_factor": 20, "dense_substitute": 20, "tree_factor": 0,
        "tree_substitute": 0, "kinematics": 41})
    assert pairs.read(run) == 4.0 and kin.read(run) == 4.1
    adr = types.SimpleNamespace(loop="adr")
    assert pairs.read(adr) is None and kin.read(adr) is None
    # A port without the counters (the benchmark's files laid over an
    # older checkout): nothing, and no error.
    monkeypatch.setattr(dynamics, "STATS", {
        "dense_factor": 20, "dense_substitute": 20, "tree_factor": 0,
        "tree_substitute": 0})
    assert kin.read(run) is None
    monkeypatch.delattr(contact, "STATS")
    assert pairs.read(run) is None
    monkeypatch.delattr(task, "STATS")
    assert kin.read(run) is None


def test_a_tiny_franka_run_counts_a_steps_work(tmp_path, monkeypatch):
    """A tiny ``franka.train`` run on the CPU (set-up and window): four
    dense solves, four pair contacts and four forward kinematics every
    env step, less the kinematics of the resets' observations; the run
    correct."""
    from bayes_sim_ig_tpu_torch.physics import contact, dynamics
    from bayes_sim_ig_tpu_torch.sim import task
    resets = []
    full_reset = task.env_full_reset

    def counted(*args, **kwargs):
        resets.append(1)
        return full_reset(*args, **kwargs)
    monkeypatch.setattr(task, "env_full_reset", counted)
    saved = [dict(d) for d in (dynamics.STATS, contact.STATS, task.STATS)]
    for d in (dynamics.STATS, contact.STATS, task.STATS):
        d.update({k: 0 for k in d})
    try:
        out = run_tiny(tiny(spec.resolve("franka.train")),
                       tmp_path=tmp_path)
        got = {name: _reader(name).read(out["run"]) for name in
               ("dense_solves_per_step.train",) + NEW}
        steps = task.STATS["env_steps"]
        kinematics = dynamics.STATS["kinematics"]
    finally:
        for d, s in zip((dynamics.STATS, contact.STATS, task.STATS), saved):
            d.update(s)
    assert out["line"]["correct"] is True, out["compared"]
    assert steps > 0 and resets
    assert got["dense_solves_per_step.train"] == 4.0
    assert got["pair_contacts_per_step.train"] == 4.0
    assert kinematics == 4 * steps + len(resets)
    assert got["kinematics_per_step.train"] == kinematics / steps


@pytest.mark.parametrize("name", NEW)
def test_the_new_metrics_keep_to_the_contract(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["unit"] == "count" and m["better"] == "lower"
    assert m["source"] == "program_counter"
    assert m["layer"] == "env, physics"
    assert m["moves"] == "train_env_steps_per_s"
    assert m["workloads"] == ["franka.train"]
    for cell in ("franka.train", "anymal.train", "humanoid.train",
                 "hand_more.train"):
        names = {x.name for x in spec.resolve(cell).per_layer}
        assert (name in names) == (cell == "franka.train")


def test_franka_train_reports_what_the_train_cells_report():
    cell = spec.resolve("franka.train")
    assert cell.chips == 1 and cell.traffic_name == "train"
    assert {m.name for m in cell.end_to_end} == {
        "setup_s", "train_env_steps_per_s", "peak_mem_gib"}
    assert {m.name for m in cell.per_layer} == {
        "ppo_iter_ms_p95.train", "idle_share.train", "mfu.train",
        "spd_roofline.train", "dense_solves_per_step.train"} | set(NEW)
    assert set(checks.expected("ppo")) <= set(cell.limits)


def test_humanoid_adr_resolves_with_limits_for_every_adr_number():
    cell = spec.resolve("humanoid.adr")
    assert cell.chips == 1 and cell.traffic_name == "adr"
    assert cell.config["task"] == "Humanoid" and cell.config["reduced"] == {}
    assert cell.config["cfg_env"]["bayessim"]["trainTrajs"] == 10000
    want = set(checks.expected("adr"))
    assert want <= set(cell.limits) <= want | set(checks.OPTIONAL)
    assert {m.name for m in cell.end_to_end} == {"setup_s", "adr_iter_s"}
    assert {m.name for m in cell.per_layer} == {
        m.name for m in spec.resolve("hand_more.adr").per_layer}
