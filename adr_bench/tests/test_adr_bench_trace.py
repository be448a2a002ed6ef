"""The reader of the port's collection counter (``kept_steps_share.adr``):
its value on a tiny ADR run equals the configuration's arithmetic, and it
reads nothing where the run is not an ADR run or the port keeps no such
counter."""

import types

import pytest

from benchkit import spec
from conftest import run_tiny, tiny


def _reader():
    cell = spec.resolve("hand_more.adr")
    (m,) = [m for m in cell.per_layer if m.name == "kept_steps_share.adr"]
    return m


def test_kept_steps_share_is_the_config_arithmetic(tmp_path):
    """A tiny ``hand_more.adr`` run (set-up and window): each ADR
    iteration's evaluation steps every env for episodeLength - 1 steps and
    keeps realEvals episodes, each training chunk and the surrogate-real
    round step trainTrajLen steps and keep their trajectories."""
    from bayes_sim_ig_tpu_torch.utils import collect
    cell = tiny(spec.resolve("hand_more.adr"))
    saved = dict(collect.STATS)
    collect.STATS.update(stepped=0, kept=0)
    try:
        run = run_tiny(cell, tmp_path=tmp_path)["run"]
        got = _reader().read(run)
        counted = dict(collect.STATS)
    finally:
        collect.STATS.update(saved)
    env, bs = cell.config["cfg_env"]["env"], cell.config["cfg_env"][
        "bayessim"]
    n, ep, L = env["numEnvs"], env["episodeLength"], bs["trainTrajLen"]
    rounds = lambda k: -(-k // n)  # noqa: E731
    chunks = [min(1000, bs["trainTrajs"] - i)
              for i in range(0, bs["trainTrajs"], 1000)]
    stepped = (rounds(bs["realEvals"]) * n * (ep - 1)
               + sum(rounds(c) * n * L for c in chunks)
               + rounds(bs["realTrajs"]) * n * L)
    kept = (bs["realEvals"] * (ep - 1) + bs["trainTrajs"] * L
            + bs["realTrajs"] * L)
    iterations, rest = divmod(counted["kept"], kept)
    assert rest == 0 and iterations >= 2  # the set-up's and the window's
    assert counted["stepped"] == iterations * stepped
    assert counted["kept"] == iterations * kept
    assert got == 100.0 * kept / stepped


def test_kept_steps_share_reads_nothing_elsewhere(monkeypatch):
    from bayes_sim_ig_tpu_torch.utils import collect
    reader = _reader()
    monkeypatch.setattr(collect, "STATS", {"stepped": 40, "kept": 10})
    assert reader.read(types.SimpleNamespace(loop="adr")) == 25.0
    assert reader.read(types.SimpleNamespace(loop="ppo")) is None
    monkeypatch.setattr(collect, "STATS", {"stepped": 0, "kept": 0})
    assert reader.read(types.SimpleNamespace(loop="adr")) is None
    # A port without the counter (the benchmark's files laid over an
    # older checkout): nothing, and no error.
    monkeypatch.delattr(collect, "STATS")
    assert reader.read(types.SimpleNamespace(loop="adr")) is None


@pytest.mark.parametrize("name", ["kept_steps_share.adr"])
def test_the_new_metric_keeps_to_the_contract(name):
    bench = spec.load_json(spec.CHECKOUT + "/BENCHMARK.json")
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert m["source"] == "program_counter"
    assert m["layer"] in {x["layer"] for x in bench["per_layer"]
                          if x["name"] != name}
    assert m["moves"] == "adr_iter_s" and m["workloads"] == ["hand_more.adr"]
