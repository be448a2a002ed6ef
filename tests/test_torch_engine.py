"""The slice as a whole on the port: the MDRFF golden-fixture gate of
tests/test_engine.py (judged as the median over seeds 0, 1, 2, since
torch init draws differ from JAX's), the multi-trajectory refit, a CPU
run of the ADR loop's entry point on a tiny Cartpole+MDRFF config with
a resume, and the port's independence from JAX."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch.engine import BayesSim

from .test_engine import TRUE_PARAMS, _model_cfg, load_pendulum_data

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_bsim(model_class, summarizer, seed, n_iters=10, n_traj=None):
    np.random.seed(seed)  # the RFF frequencies come from numpy's generator
    sim_params, states, actions = load_pendulum_data(
        "pendulum_train_data_ones_policy_rnd.npz")
    if n_traj is not None:
        sim_params, states, actions = (sim_params[:n_traj], states[:n_traj],
                                       actions[:n_traj])
    bsim = BayesSim(model_cfg=_model_cfg(model_class, summarizer),
                    obs_dim=3, act_dim=1, params_dim=2,
                    params_lows=np.array([0.01, 0.01]),
                    params_highs=np.array([2.0, 2.0]), seed=seed,
                    device="cpu")
    for _ in range(n_iters):
        bsim.run_training(sim_params, states, actions)
    return bsim


def test_mdrff_golden_gate_median_over_seeds():
    """test_engine.py's MDRFF+summary_corrdiff bounds: NLL < 4.0, mean
    within 0.7, truth preferred to a far point; each judged on the median
    over seeds 0, 1, 2."""
    _, real_states, real_actions = load_pendulum_data(
        "pendulum_true_data_ones_policy_rnd.npz")
    nlls, errs, margins = [], [], []
    for seed in (0, 1, 2):
        bsim = _run_bsim("MDRFF", "summary_corrdiff", seed)
        assert type(bsim.model).__name__ == "MDRFF"
        posterior = bsim.predict(real_states, real_actions)
        nll = -posterior.eval(TRUE_PARAMS.reshape(1, -1), log=True)[0]
        far = -posterior.eval(np.array([[0.2, 1.8]]), log=True)[0]
        mean, _ = posterior.calc_mean_and_cov()
        nlls.append(nll)
        errs.append(np.abs(mean - TRUE_PARAMS).max())
        margins.append(nll - far)
    assert np.median(nlls) < 4.0, nlls
    assert np.median(errs) <= 0.7, errs
    assert np.median(margins) < 0.0, margins


def test_multi_trajectory_refit():
    """test_engine.py:108-120 on the port: a duplicated real trajectory
    goes through the resample-and-refit path."""
    bsim = _run_bsim("MDNN", "summary_start", seed=1, n_iters=3,
                     n_traj=3000)
    _, real_states, real_actions = load_pendulum_data(
        "pendulum_true_data_ones_policy_rnd.npz")
    real_states = np.concatenate([real_states, real_states], axis=0)
    real_actions = np.concatenate([real_actions, real_actions], axis=0)
    posterior = bsim.predict(real_states, real_actions)
    assert posterior.ndim == 2
    mean, _ = posterior.calc_mean_and_cov()
    np.testing.assert_allclose(mean, TRUE_PARAMS, atol=0.5)
    assert bsim._refit_model.device == bsim.model.device


def test_summary_dim_probe_and_mdrff_string_parsing():
    cfg = _model_cfg("MDRFF_Matern32_2.0", "summary_waypts")
    bsim = BayesSim(model_cfg=cfg, obs_dim=3, act_dim=1, params_dim=2,
                    params_lows=np.array([0.01, 0.01]),
                    params_highs=np.array([2.0, 2.0]), device="cpu")
    assert bsim.model.rff.coeff.shape == (40, 100)  # summary dim 40, m/2
    assert type(bsim.model).__name__ == "MDRFF"


def test_all_nonfinite_chunk_skips_fit():
    cfg = _model_cfg("MDNN", "summary_waypts")
    bsim = BayesSim(model_cfg=cfg, obs_dim=3, act_dim=1, params_dim=2,
                    params_lows=np.array([0.01, 0.01]),
                    params_highs=np.array([2.0, 2.0]), device="cpu")
    n, t = 8, cfg["trainTrajLen"] + 1
    states = np.full((n, t, 3), np.nan, np.float32)
    actions = np.zeros((n, t - 1, 1), np.float32)
    before = [p.detach().clone() for p in bsim.model.net.parameters()]
    log = bsim.run_training(np.ones((n, 2), np.float32), states, actions)
    assert np.isnan(log["train_loss"][-1])
    for p, b in zip(bsim.model.net.parameters(), before):
        assert torch.equal(p.detach(), b)
    rs = np.random.RandomState(0)
    states = rs.randn(64, t, 3).astype(np.float32)
    states[3, 2, 0] = np.inf  # one bad row is dropped, the rest trains
    log2 = bsim.run_training(rs.uniform(0.1, 1.9, (64, 2)).astype(np.float32),
                             states, rs.randn(64, t - 1, 1).astype(np.float32))
    assert np.isfinite(log2["train_loss"][-1])
    assert len(log2["train_loss"]) == len(log2["test_loss"])


def test_bayes_sim_defaults_to_the_card(monkeypatch):
    """BayesSim defaults to the card; without one (torch.cuda.is_available()
    False, as on this CPU-only torch or forced so on a card's machine) the
    default raises instead of running on the CPU, and device="cpu" is what
    a caller asks the CPU with."""
    import inspect
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(model_cfg=_model_cfg("MDNN", "summary_start"), obs_dim=3,
              act_dim=1, params_dim=2, params_lows=np.array([0.01, 0.01]),
              params_highs=np.array([2.0, 2.0]))
    assert inspect.signature(BayesSim).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        BayesSim(**kw)
    bsim = BayesSim(device="cpu", **kw)
    assert bsim.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in bsim.model.net.parameters())


def test_adr_loop_runs_and_resumes_on_cpu(tmp_path, monkeypatch):
    """bayes_sim_main.main on a tiny Cartpole+MDRFF config (16 envs, 64
    training trajectories, 4 evaluation episodes): one ADR iteration,
    then a resumed run to 2 iterations, whose second goes through the
    refit with the restored ftuned model; finite posteriors on disk."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    # Posterior plots (matplotlib) cost most of a tiny run's time and are
    # covered by utils/plot.py's own JAX-package test.
    monkeypatch.setattr(bayes_sim_main, "_plot_posterior",
                        lambda *a, **k: None)
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           "cartpole.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 16
    cfg["bayessim"].update(modelClass="MDRFF", trainTrajs=64, realIters=1,
                           realEvals=4)
    argv = ["--task", "Cartpole", "--logdir", str(tmp_path / "logs"),
            "--max_iterations", "1", "--rl_device", "cpu"]
    outs = []
    for iters, extra in ((1, []), (2, ["--resume"])):
        cfg["bayessim"]["realIters"] = iters
        cfg_path = tmp_path / f"cartpole_{iters}.yaml"
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        outs.append(bayes_sim_main.main(argv + extra
                                        + ["--cfg_env", str(cfg_path)]))
    first, resumed = outs
    assert first["logdir"] == resumed["logdir"]
    assert len(first["iter_secs"]) == len(resumed["iter_secs"]) == 1
    # The resumed model kept the first run's RFF frequencies.
    assert torch.equal(resumed["bsim"].model.rff.coeff,
                       first["bsim"].model.rff.coeff)
    assert resumed["bsim"]._refit_model is not None
    ckpt = os.path.join(resumed["logdir"], "checkpoints")
    for it in (0, 1):
        with open(os.path.join(ckpt, f"posterior_{it}.pkl"), "rb") as f:
            post = pickle.load(f)
        assert post["means"].shape[1] == 13
        assert post["bsim_coeff"].shape == (302, 100)
        for k in ("weights", "means", "covs"):
            assert np.isfinite(post[k]).all(), (it, k)
    assert post["all_real_states"].shape[0] == 2  # one per ADR iteration


def test_port_imports_no_jax():
    modules = [
        "bayes_sim_ig_tpu_torch", "bayes_sim_ig_tpu_torch.bayes_sim_main",
        "bayes_sim_ig_tpu_torch.engine", "bayes_sim_ig_tpu_torch.ops.build",
        "bayes_sim_ig_tpu_torch.utils.plot",
        "bayes_sim_ig_tpu_torch.utils.convert",
    ]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'optax' or "
              "m == 'bayes_sim_ig_tpu' or m.startswith('bayes_sim_ig_tpu.')]"
              "\nassert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_unported_task_is_refused_by_the_cli(monkeypatch):
    """A task neither package has is refused; so is one listed as not yet
    ported (every task of the JAX package is ported now, so the list is
    patched for the check)."""
    from bayes_sim_ig_tpu_torch import sim
    from bayes_sim_ig_tpu_torch.utils.args import init_args
    with pytest.raises(SystemExit, match="Unknown task 'Dactyl'"):
        init_args(["--task", "Dactyl", "--rl_device", "cpu"])
    monkeypatch.setattr(sim, "NOT_YET_PORTED", ("Dactyl",))
    with pytest.raises(SystemExit, match="not yet ported"):
        init_args(["--task", "Dactyl", "--rl_device", "cpu"])
