"""The grasp-ADR experiment's entry points in the port against the JAX
package's, on the CPU at a tiny size:

- the DR control (``modelClass: None``) through both packages' ``main``
  on Pendulum: the same checkpoint files (no posterior), the same number
  of surrogate-real scalars (JAX's read from its TensorBoard events), no
  BayesSim built;
- ``main``'s ``real_rewards`` is what the loop's writer received;
- ``experiments/adr_grasp_vs_ctl_torch.py::run_pair`` on ShadowHand's
  grasp config (2 envs, cut in depth) writes two series that
  ``experiments/adr_pooled_analysis.py`` reads;
- ``experiments/identifiability_report_torch.py``'s rows against the JAX
  ``MoG``/``Uniform`` algebra on the same posterior pickles (rtol 1e-6).
"""

import glob
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import adr_grasp_vs_ctl_torch as pair  # noqa: E402
import adr_pooled_analysis  # noqa: E402
import adr_port_vs_jax  # noqa: E402
import identifiability_report_torch  # noqa: E402

TAG = "SurrogateReal/real_rewards_mean"


class _RecordingWriter:
    """Keeps every scalar; every other writer call does nothing."""

    made: list = []

    def __init__(self, logdir, sub="bsim"):
        self.sub = sub
        self.scalars = []
        _RecordingWriter.made.append(self)

    def add_scalar(self, tag, value, step, *args, **kwargs):
        self.scalars.append((tag, float(value), int(step)))

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _control_cfg(tmp, pkg):
    with open(os.path.join(ROOT, pkg, "cfg", "pendulum.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update(numEnvs=8)
    cfg["bayessim"].update(modelClass="None", realIters=2, realEvals=2)
    path = os.path.join(tmp, f"{pkg}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def _files(logdir):
    """The checkpoint and pickle files under a run dir, relative to it."""
    return sorted(os.path.relpath(f, logdir) for ext in ("ckpt", "pkl")
                  for f in glob.glob(os.path.join(logdir, "**", f"*.{ext}"),
                                     recursive=True))


class _NoBayesSim:
    def __init__(self, *args, **kwargs):
        raise AssertionError("the control arm built a BayesSim")


@pytest.fixture(scope="module")
def control_runs(tmp_path_factory):
    """Pendulum's DR control (8 envs, 2 ADR iterations of 1 PPO iteration,
    realEvals 2) through the JAX package's main and the port's (the
    port's writers recording)."""
    from bayes_sim_ig_tpu import bayes_sim_main as jax_main
    from bayes_sim_ig_tpu_torch import bayes_sim_main as torch_main
    tmp = str(tmp_path_factory.mktemp("control"))
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jax_main, torch_main):
            mp.setattr(mod, "BayesSim", _NoBayesSim)
        mp.setattr(jax_main.plot, "plot_posterior", lambda *a, **k: None)
        mp.setattr(torch_main, "_plot_posterior", lambda *a, **k: None)
        jax_logdir = os.path.join(tmp, "jax")
        jax_main.main(["--task", "Pendulum", "--cfg_env",
                       _control_cfg(tmp, "bayes_sim_ig_tpu"), "--logdir",
                       jax_logdir, "--max_iterations", "1", "--seed", "0"])
        _RecordingWriter.made = []
        mp.setattr(torch_main, "_make_writer", _RecordingWriter)
        out = torch_main.main([
            "--task", "Pendulum", "--cfg_env",
            _control_cfg(tmp, "bayes_sim_ig_tpu_torch"), "--logdir",
            os.path.join(tmp, "torch"), "--max_iterations", "1", "--seed",
            "0", "--rl_device", "cpu"])
    finally:
        mp.undo()
    return jax_logdir, out, list(_RecordingWriter.made)


def test_control_arm_writes_what_jax_writes(control_runs):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )
    jax_logdir, out, _ = control_runs
    (jax_run,) = glob.glob(os.path.join(jax_logdir, "*", ""))
    assert os.path.basename(os.path.dirname(jax_run)) == os.path.basename(
        out["logdir"])
    files = _files(out["logdir"])
    assert files == _files(jax_run)
    assert files == [os.path.join(f"rl_{i}", "model_1.ckpt")
                     for i in (0, 1)]
    assert not os.path.exists(os.path.join(out["logdir"], "checkpoints"))
    ea = EventAccumulator(os.path.join(jax_run, "bsim"))
    ea.Reload()
    jax_means = [s.value for s in ea.Scalars(TAG)]
    assert len(jax_means) == len(out["real_rewards"]) == 2
    assert np.isfinite(jax_means).all()
    assert out["bsim"] is None and out["iter_secs"] == []


def test_real_rewards_are_what_the_writer_received(control_runs):
    _, out, writers = control_runs
    (bsim,) = [w for w in writers if w.sub == "bsim"]
    got = {(tag, step): value for tag, value, step in bsim.scalars
           if tag.startswith("SurrogateReal/")}
    want = {(f"SurrogateReal/real_rewards_{k}", it): r[k]
            for it, r in enumerate(out["real_rewards"])
            for k in ("mean", "min", "max")}
    assert got == want
    for r in out["real_rewards"]:
        assert r["min"] <= r["mean"] <= r["max"]


def test_arm_configs_differ_in_the_model_only():
    arms = pair.arm_configs(400)
    grasp, ctl = arms["grasp"], arms["drctl"]
    assert grasp["bayessim"]["modelClass"] == "MDNN"
    assert ctl["bayessim"].pop("modelClass") == "None"
    grasp["bayessim"].pop("modelClass")
    assert grasp == ctl
    assert grasp["bayessim"]["realEvals"] == 400
    assert grasp["bayessim"]["realIters"] == 20
    assert not grasp["bayessim"]["ftuneRL"]
    assert grasp["env"]["numEnvs"] == 2048


def test_run_pair_writes_what_the_analysis_reads(tmp_path, monkeypatch,
                                                 capsys):
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    monkeypatch.setattr(bayes_sim_main, "_make_writer",
                        lambda *a, **k: bayes_sim_main._NullWriter())
    edits = {"env": {"numEnvs": 2, "episodeLength": 20},
             "bayessim": {"trainTrajs": 4, "trainTrajLen": 5,
                          "realIters": 1}}
    results = pair.run_pair(3, 2, "cpu", edits, max_iterations=1,
                            runs_dir=str(tmp_path / "runs"),
                            data_dir=str(tmp_path / "data"), keep=True)
    assert list(results) == ["grasp", "drctl"]
    for arm, (out, rec, path) in results.items():
        assert path == str(tmp_path / "data" /
                           f"torch_shadowhand_{arm}_s3.json")
        with open(path) as f:
            saved = json.load(f)
        assert saved["tag"] == TAG and saved["error"] is None
        assert saved["run"] == rec["run"]
        series = adr_pooled_analysis.series(path)
        assert len(series) == 1 and np.isfinite(series).all()
        np.testing.assert_array_equal(
            series, [r["mean"] for r in out["real_rewards"]])
        assert [i["iter"] for i in saved["iterations"]] == [0]
        assert saved["live_graphs"] == []
        assert [s for s, _ in saved["ppo_log"]["rl_0"]["rl/lr"]] == [1]
        lines = adr_port_vs_jax.record_lines(saved)
        assert "1 iterations of 1 PPO iterations at 2 envs" in lines[0]
        assert out["env"].num_envs == 2
        assert out["env"].task.obs_dim == 107
    assert results["drctl"][0]["bsim"] is None
    assert results["grasp"][0]["bsim"] is not None
    assert not glob.glob(str(tmp_path / "runs" / "torch_shadowhand_drctl_s3"
                             / "**" / "posterior_*.pkl"), recursive=True)
    assert "[drctl s3] 1/1 iterations" in capsys.readouterr().out


def test_a_raising_arm_is_recorded(tmp_path, monkeypatch):
    from bayes_sim_ig_tpu_torch import bayes_sim_main

    def fail(argv):
        raise RuntimeError("no card")
    monkeypatch.setattr(bayes_sim_main, "main", fail)
    results = pair.run_pair(5, 2, "cpu", runs_dir=str(tmp_path / "runs"),
                            data_dir=str(tmp_path / "data"))
    for arm, (out, rec, path) in results.items():
        assert out is None
        with open(path) as f:
            saved = json.load(f)
        assert "RuntimeError: no card" in saved["error"]
        assert saved["real_rewards_mean"] == []


def _posteriors(rundir, dim, iters=3, k=10, seed=0):
    rng = np.random.default_rng(seed)
    ckpt = os.path.join(rundir, "Run", "checkpoints")
    os.makedirs(ckpt)
    for it in range(iters):
        a = rng.uniform(0.1, 1.0, k)
        A = rng.normal(size=(k, dim, dim)) * 0.3
        covs = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(dim)
        with open(os.path.join(ckpt, f"posterior_{it}.pkl"), "wb") as f:
            pickle.dump({"weights": a / a.sum(),
                         "means": rng.uniform(0.5, 3.0, (k, dim)),
                         "covs": covs, "real_iter_id": it}, f)


def test_identifiability_rows_equal_the_jax_algebra(tmp_path):
    from bayes_sim_ig_tpu.distributions import MoG, Uniform
    from bayes_sim_ig_tpu.sim import make_env
    with open(os.path.join(ROOT, "bayes_sim_ig_tpu", "cfg",
                           "shadow_hand_grasp.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 2
    spec = make_env("ShadowHand", cfg).task.params_spec
    _posteriors(str(tmp_path), spec.dim)
    rep = identifiability_report_torch.report(str(tmp_path))
    assert rep["names"] == list(spec.names)
    watch = [i for i, n in enumerate(spec.names)
             if "object" in n or "T_" in n][:6]
    assert rep["watch"] == watch and len(watch) == 6
    truth = np.full(spec.dim, 1.8)
    prior = Uniform(np.asarray(spec.lows), np.asarray(spec.highs))
    np.testing.assert_allclose(
        rep["lp_prior"], float(prior.eval(truth[None], log=True)[0]),
        rtol=1e-6)
    assert [r["iter"] for r in rep["rows"]] == [0, 1, 2]
    for r in rep["rows"]:
        path = tmp_path / "Run" / "checkpoints" / f"posterior_{r['iter']}.pkl"
        with open(path, "rb") as f:
            d = pickle.load(f)
        mog = MoG(a=d["weights"], ms=list(d["means"]), Ss=list(d["covs"]))
        m, S = mog.calc_mean_and_cov()
        np.testing.assert_allclose(
            r["log_p_truth"], float(mog.eval(truth[None], log=True)[0]),
            rtol=1e-6)
        np.testing.assert_allclose(r["mean"], m[watch], rtol=1e-6)
        np.testing.assert_allclose(r["std"], np.sqrt(np.diag(S))[watch],
                                   rtol=1e-6)


@pytest.mark.parametrize("seeds", [[7], [7, 23, 31]])
def test_port_vs_jax_pools_the_arms_as_the_analysis_does(tmp_path, seeds):
    """The JAX archive copied as the port's series: each arm's pooled
    values are the archive's (grasp without iteration 0) and the
    two-sided test finds no difference."""
    import shutil
    for seed in seeds:
        for arm in adr_port_vs_jax.ARMS:
            name = f"shadowhand_{arm}_s{seed}.json"
            shutil.copy(os.path.join(adr_port_vs_jax.DATA, name),
                        tmp_path / name)
            shutil.copy(os.path.join(adr_port_vs_jax.DATA, name),
                        tmp_path / f"torch_{name}")
    out = adr_port_vs_jax.compare(seeds, data=str(tmp_path))
    for arm, (mine, ref, p) in out.items():
        np.testing.assert_array_equal(mine, ref)
        assert p == pytest.approx(1.0)
    grasp = np.concatenate([adr_pooled_analysis.series(str(
        tmp_path / f"shadowhand_grasp_s{s}.json"))[1:] for s in seeds])
    np.testing.assert_array_equal(out["grasp"][0], grasp)
    assert len(out["drctl"][0]) == 20 * len(seeds)
