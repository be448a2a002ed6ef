"""``bench_torch.py``, the port's counterpart of bench.py, on the CPU at
tiny widths (``--tiny``: a few envs and steps a row): its rows are
bench.py's rows by name and in order, each row's rate is its work over the
median of its repeats, ``(ep_len - 1) x envs / s`` for a collection round,
the aggregate JSON line is the last line of stdout, a row that raises
leaves the others running and the exit code non-zero (so does a run asked
for on a card where there is none), and the script imports no JAX."""

import ast
import json
import os
import statistics
import subprocess
import sys

import pytest
import torch

import bench
import bench_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--tiny"]


def _lines(out):
    return [json.loads(line) for line in out.strip().splitlines()]


@pytest.fixture(scope="module")
def tiny_run():
    """(exit code, the JSON lines of stdout) of every row at tiny widths."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(TINY)
    return rc, _lines(buf.getvalue())


def test_the_rows_are_bench_py_rows_in_its_order(monkeypatch, capsys):
    """bench.py's main with every measurement raising records each of its
    rows by name (with its error): the same names, in the same order."""
    def fail(*args, **kwargs):
        raise RuntimeError("not measured here")
    for fn in ("bench_pendulum", "bench_articulated", "bench_mdnn",
               "bench_adr_iter"):
        monkeypatch.setattr(bench, fn, fail)
    monkeypatch.setattr(bench, "ROWS", {})
    bench.main()
    capsys.readouterr()
    assert list(bench.ROWS) == bench_torch.ROW_NAMES
    assert len(bench_torch.ROW_NAMES) == 14


def test_every_row_runs_and_the_aggregate_is_the_last_line(tiny_run):
    rc, lines = tiny_run
    assert rc == 0
    *rows, agg = lines
    assert [r["metric"] for r in rows] == bench_torch.ROW_NAMES
    assert agg["metric"] == "all" and agg["failed"] == []
    assert list(agg["rows"]) == bench_torch.ROW_NAMES
    assert agg["card"] == "cpu (no card)"
    assert agg["widths"].startswith("tiny")
    assert "vs_baseline" not in json.dumps(lines)


@pytest.mark.parametrize("name", bench_torch.ROW_NAMES)
def test_each_row_is_the_median_of_its_repeats(name, tiny_run):
    """Each row: a positive value, the median of its repeats, inside its
    spread, with the card named."""
    row = {r["metric"]: r for r in tiny_run[1][:-1]}[name]
    assert row["repeats"] == bench_torch.TINY["repeats"]
    secs = row["seconds"]
    if name == "pendulum_adr_iteration_sec_warm":
        want = statistics.median(secs)
    else:
        work = row["min"] * max(secs)  # the slowest repeat's rate
        want = statistics.median([work / s for s in secs])
    assert row["value"] == pytest.approx(want, rel=1e-12)
    assert row["min"] <= row["value"] <= row["max"]
    assert row["card"] == "cpu (no card)"


@pytest.mark.parametrize("task,cfg_file,n_envs,ep_len", [
    ("Cartpole", "cartpole.yaml", 3, 4), ("Ant", "ant.yaml", 2, 3)])
def test_a_round_rate_is_steps_times_envs_over_the_median(
        task, cfg_file, n_envs, ep_len, monkeypatch):
    """bench_articulated with the repeats' seconds fixed: (ep_len - 1) x
    envs / the median seconds, the round itself run once."""
    secs = [0.5, 0.25, 2.0, 1.0, 4.0]
    runs = []

    def fixed(fn, device, repeats, warmup):
        fn()
        runs.append(repeats)
        return list(secs)
    monkeypatch.setattr(bench_torch, "timed_repeats", fixed)
    row = bench_torch.bench_articulated(task, cfg_file, n_envs, ep_len,
                                        "cpu", bench_torch.TINY)
    assert runs == [bench_torch.TINY["repeats"]]
    assert row["value"] == pytest.approx((ep_len - 1) * n_envs / 1.0)
    assert row["min"] == pytest.approx((ep_len - 1) * n_envs / 4.0)
    assert row["max"] == pytest.approx((ep_len - 1) * n_envs / 0.25)


def test_a_row_that_raises_fails_the_run(monkeypatch, capsys):
    """The MDN row raises: it is printed with its error, every other row
    (here a stand-in of its numbers) still runs, the aggregate is last and
    the exit code 1."""
    def rows(device, w):
        def fn(name):
            if name == "mdnn_train_samples_per_sec":
                raise RuntimeError("broken row")
            return bench_torch.summary([1.0, 2.0], "steps/s", 10.0)
        return {name: (lambda name=name: fn(name))
                for name in bench_torch.ROW_NAMES}
    monkeypatch.setattr(bench_torch, "_row_fns", rows)
    rc = bench_torch.main(TINY)
    *rows, agg = _lines(capsys.readouterr().out)
    assert rc == 1
    rows = {r["metric"]: r for r in rows}
    assert list(rows) == bench_torch.ROW_NAMES
    assert rows["mdnn_train_samples_per_sec"]["err"] == \
        "RuntimeError: broken row"
    assert all(r["value"] > 0 for k, r in rows.items()
               if k != "mdnn_train_samples_per_sec")
    assert agg["metric"] == "all"
    assert agg["failed"] == ["mdnn_train_samples_per_sec"]


def test_without_a_card_the_script_exits_non_zero():
    """Asked for cuda:0 where torch has no CUDA: every row is an error,
    the aggregate line is last, the exit code 1 (no fallback to the
    CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    *rows, agg = _lines(proc.stdout)
    assert proc.returncode == 1
    assert {r["err"] for r in rows} == {"torch.cuda.is_available() is False"}
    assert agg["failed"] == bench_torch.ROW_NAMES


def test_bench_torch_imports_no_jax():
    """Neither its source nor a run of a row imports jax or the JAX
    package."""
    tree = ast.parse(open(os.path.join(REPO, "bench_torch.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n and (n.split(".")[0] in (
        "jax", "bayes_sim_ig_tpu"))]
    code = ("import sys, bench_torch; rc = bench_torch.main(['--device', "
            "'cpu', '--tiny']); bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'bayes_sim_ig_tpu')]; "
            "assert rc == 0 and not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
