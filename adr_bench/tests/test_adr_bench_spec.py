"""BENCHMARK.json, the cells' files and the configurations."""

import copy
import json
import os
import re

import pytest
import yaml

from benchkit import spec

BENCH = spec.load_json(os.path.join(spec.CHECKOUT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_resolves_to_its_files(workload):
    from benchkit import checks
    cell = spec.resolve(workload)
    assert cell.config["name"] == cell.config_entry["name"]
    assert cell.traffic["loop"] in ("adr", "ppo")
    loop = cell.traffic["loop"]
    want = set(checks.expected(loop))
    assert want <= set(cell.limits) <= want | set(checks.OPTIONAL)
    for m in cell.end_to_end + cell.per_layer:
        assert os.path.exists(m.path), m.path
    names = {m.name for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "adr_bench/run.py"]
    assert BENCH["paths"] == ["adr_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("adr_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] == 1 and len(w["why"]) <= 200
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", ["shadow_hand_more", "humanoid"])
def test_configurations_are_the_upstream_ones_but_what_is_reduced(name):
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = spec.load_json(os.path.join(spec.CHECKOUT, entry["file"]))
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    for key, path in config["upstream_files"].items():
        with open(os.path.join(spec.BENCH_DIR, path)) as f:
            upstream = yaml.safe_load(f)
        run = copy.deepcopy(config[key])
        if key == "cfg_env":
            for k, r in config["reduced"].items():
                assert upstream["bayessim"][k] == r["source"]
                assert run["bayessim"][k] == r["here"]
                run["bayessim"][k] = upstream["bayessim"][k]
        assert run == upstream


@pytest.mark.parametrize("name", ["shadow_hand_more", "humanoid"])
def test_tree_solves_per_step_are_the_steps(name):
    """The solves a configuration's file says one env step needs are the
    ones the step's algorithm calls (counted on the CPU, where the plain
    versions run)."""
    import torch
    from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu_torch.physics import contact, dynamics
    from bayes_sim_ig_tpu_torch.sim import env_step, make_env
    entry = {c["name"]: c for c in BENCH["configs"]}[name]
    config = spec.load_json(os.path.join(spec.CHECKOUT, entry["file"]))
    cfg = copy.deepcopy(config["cfg_env"])
    cfg["env"]["numEnvs"] = 2
    env = make_env(config["task"], cfg, seed=0, device="cpu")
    s = env.task.params_spec
    distr = to_device_distr(pdf.Uniform(s.lows, s.highs), s.lows, s.highs,
                            device="cpu")
    env.set_distr(distr)
    env.reset()
    calls = []
    saved = []
    for mod, fn, kind in ((dynamics, "tree_factor", "factor"),
                          (dynamics, "tree_substitute", "substitute"),
                          (contact, "tree_upsolve", "upsolve"),
                          (contact, "tree_downsolve", "downsolve")):
        orig = getattr(mod, fn)

        def counted(*args, _orig=orig, _kind=kind, **kwargs):
            rhs = args[-1] if _kind != "factor" else args[1]
            calls.append((_kind, 1 if rhs.ndim == 2 else rhs.shape[0]))
            return _orig(*args, **kwargs)
        saved.append((mod, fn, orig))
        setattr(mod, fn, counted)
    try:
        env_step(env.task, distr, env.state,
                 torch.zeros(2, env.task.act_dim),
                 torch.Generator().manual_seed(0))
    finally:
        for mod, fn, orig in saved:
            setattr(mod, fn, orig)
    counted = {}
    for kind, K in calls:
        key = (kind, 1 if kind == "factor" else K)
        counted[key] = counted.get(key, 0) + 1
    said = {(s["kind"], int(s.get("K", 1))): int(s["count"])
            for s in config["tree_solves_per_step"]}
    assert counted == said
