"""The harness's runs on the CPU at a tiny size: the taps change nothing,
a sound run is correct, each fault a cell can have makes it not correct,
the control fails a number, and no JAX module is loaded."""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchkit import spec
from conftest import BENCH_DIR, SEED, run_tiny, tiny

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def hand():
    return tiny(spec.resolve("hand_more.adr"))


@pytest.fixture(scope="module")
def humanoid():
    return tiny(spec.resolve("humanoid.train"))


def test_adr_mix_equals_main_without_the_tap(hand, tmp_path):
    """Through all its iterations, the tapped loop gives what
    ``bayes_sim_main.main`` gives alone on the same seed."""
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    out = run_tiny(hand, seconds=1e9, tmp_path=tmp_path / "tapped")
    tapped = out["run"].snapshots["main_return"]
    paths = []
    for key in ("cfg_env", "cfg_train"):
        paths.append(str(tmp_path / f"{key}.json"))
        with open(paths[-1], "w") as f:
            json.dump(hand.config[key], f)
    np.random.seed(SEED % 2 ** 32)
    torch.manual_seed(SEED)
    import contextlib
    import io
    with contextlib.redirect_stdout(io.StringIO()):
        plain = bayes_sim_main.main([
            "--task", hand.config["task"], "--cfg_env", paths[0],
            "--cfg_train", paths[1], "--max_iterations", "1",
            "--seed", str(SEED), "--rl_device", "cpu",
            "--logdir", str(tmp_path / "plain")])
    assert len(plain["real_rewards"]) == 3
    assert tapped["real_rewards"] == plain["real_rewards"]
    a, b = tapped["posterior"], plain["posterior"]
    np.testing.assert_array_equal(a.a, b.a)
    for x, y in zip(a.xs, b.xs):
        np.testing.assert_array_equal(x.m, y.m)
        np.testing.assert_array_equal(x.S, y.S)


@pytest.mark.parametrize("name", ["hand", "humanoid"])
def test_a_sound_run_is_correct_and_its_line_keeps_its_keys(
        name, hand, humanoid, tmp_path):
    import run as bench_run
    cell = {"hand": hand, "humanoid": humanoid}[name]
    out = run_tiny(cell, seconds=0.5, tmp_path=tmp_path)
    line, lines = bench_run.report(out)
    assert list(line) == LINE_KEYS
    assert line["correct"] is True, out["compared"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # The CPU has no device memory to read.
    assert set(line["metrics"]) == {m.name for m in cell.end_to_end} - {
        "peak_mem_gib"}
    assert list(line["checks"]) == list(cell.limits)
    assert lines[-1].startswith("check ")
    json.dumps(line)


def _fault(name, monkeypatch):
    """Breaks the port underneath the harness, as one of the faults a
    cell can have."""
    from bayes_sim_ig_tpu_torch.models import mdnn
    from bayes_sim_ig_tpu_torch.rl import ppo
    from bayes_sim_ig_tpu_torch.sim import humanoid, shadow_hand
    if name == "step_unchanged":
        for cls in (shadow_hand.ShadowHand, humanoid.Humanoid):
            monkeypatch.setattr(cls, "physics_step",
                                lambda self, state, actions, params, gen:
                                state)
    elif name == "update_unchanged":
        monkeypatch.setattr(ppo, "apply_update", lambda *a, **k: None)
    elif name == "update_half_batch":
        orig = ppo.PPO.loss_fn

        def half(self, batch):
            n = batch["obs"].shape[0] // 2
            return orig(self, {k: v[:n] for k, v in batch.items()})
        monkeypatch.setattr(ppo.PPO, "loss_fn", half)
    elif name == "reward_altered":
        orig = ppo.env_step

        def altered(*args, **kwargs):
            state, obs, rew, done = orig(*args, **kwargs)
            return state, obs, rew + 1.0, done
        monkeypatch.setattr(ppo, "env_step", altered)
    elif name == "reset_altered":
        from bayes_sim_ig_tpu_torch.sim import task
        orig = task.env_full_reset

        def altered(*args, **kwargs):
            state, obs = orig(*args, **kwargs)
            first = (torch.arange(obs.shape[0]) == 0)[:, None]
            return state, obs + 10.0 * first
        monkeypatch.setattr(task, "env_full_reset", altered)
    elif name == "collect_action_altered":
        from bayes_sim_ig_tpu_torch.utils import collect
        orig = collect.policy_rl_randomized

        def altered(act, gen):
            act = orig(act, gen)
            first = (torch.arange(act.shape[0]) == 0)[:, None]
            return act + 10.0 * first
        monkeypatch.setitem(collect._POLICY_REGISTRY, "policy_rl_randomized",
                            altered)
    elif name == "extract_altered":
        from bayes_sim_ig_tpu_torch.utils import collect
        orig = collect._postprocess_round

        def altered(*args):
            labels, states, acts, rewards = orig(*args)
            return labels, states, acts, rewards + 1.0
        monkeypatch.setattr(collect, "_postprocess_round", altered)
    elif name == "fit_unchanged":
        monkeypatch.setattr(mdnn, "adam_step", lambda *a, **k: None)
    elif name == "fit_half_batch":
        orig = mdnn.mdn_train_step

        def half(model, x, y, ids, noise):
            n = ids.shape[0] // 2
            return orig(model, x, y, ids[:n], noise[:n])
        monkeypatch.setattr(mdnn, "mdn_train_step", half)
    elif name == "posterior_altered":
        orig = mdnn.MDNN.predict_MoGs

        def altered(self, xs, noise=None):
            mogs = orig(self, xs, noise)
            mogs[0].xs[0].m = mogs[0].xs[0].m + 0.1
            return mogs
        monkeypatch.setattr(mdnn.MDNN, "predict_MoGs", altered)


@pytest.mark.parametrize("name,cell_name,caught", [
    ("step_unchanged", "humanoid", "step_gap"),
    ("update_unchanged", "humanoid", "update_change_gap"),
    ("update_half_batch", "humanoid", "update_loss_gap"),
    ("reward_altered", "humanoid", "step_gap"),
    ("step_unchanged", "hand", "step_gap"),
    ("update_unchanged", "hand", "update_change_gap"),
    ("reset_altered", "hand", "step_gap_max"),
    ("collect_action_altered", "hand", "step_gap_max"),
    ("extract_altered", "hand", "extract_gap"),
    ("fit_unchanged", "hand", "fit_change_gap"),
    ("fit_half_batch", "hand", "fit_loss_gap"),
    ("posterior_altered", "hand", "posterior_gap"),
])
def test_a_fault_makes_the_run_not_correct(name, cell_name, caught, hand,
                                           humanoid, monkeypatch, tmp_path):
    cell = {"hand": hand, "humanoid": humanoid}[cell_name]
    _fault(name, monkeypatch)
    out = run_tiny(cell, seconds=0.5, tmp_path=tmp_path)
    assert out["line"]["correct"] is False
    c = out["compared"][caught]
    assert c["value"] is None or c["value"] > c["limit"], out["compared"]


@pytest.mark.parametrize("name", ["hand", "humanoid"])
def test_the_control_fails_a_number(name, hand, humanoid, tmp_path):
    """The reference in TF32 (its rounding emulated on the CPU), put in the
    port's place, reads above a limit."""
    import control
    cell = {"hand": hand, "humanoid": humanoid}[name]
    out = run_tiny(cell, seconds=0.5, tmp_path=tmp_path)
    r = control.readings(out["run"])
    assert all(r["program"][k] <= lim for k, lim in cell.limits.items())
    assert any(r["control"][k] > lim for k, lim in cell.limits.items()), r


def test_no_jax_module_after_a_run(tmp_path):
    code = (
        "import sys, io, time\n"
        f"sys.path[:0] = [{BENCH_DIR!r}, {os.path.dirname(BENCH_DIR)!r}, "
        f"{os.path.join(BENCH_DIR, 'tests')!r}]\n"
        "from conftest import tiny, run_tiny\n"
        "from benchkit import spec\n"
        "import run as bench_run\n"
        f"run_tiny(tiny(spec.resolve('humanoid.train')), 0.5, "
        f"tmp_path={str(tmp_path)!r})\n"
        "print(bench_run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_frozen_env_step_is_the_ports(hand, humanoid):
    """On the CPU both run the plain solves: the reference's step equals
    the port's bit for bit, in the configurations' own observation
    layouts."""
    from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu_torch.sim import env_step, make_env
    from reference.frozen.distributions import device as fdevice
    from reference.frozen.sim import env_step as ref_step
    from reference.frozen.sim import make_task
    from reference.step_ref import env_state
    from benchkit.taps import env_state as snap_state
    for cell in (hand, humanoid):
        cfg = copy.deepcopy(cell.config["cfg_env"])
        full = spec.resolve(cell.name).config["cfg_env"]["env"]
        if "observationType" in full:
            cfg["env"]["observationType"] = full["observationType"]
        env = make_env(cell.config["task"], cfg, seed=1, device="cpu")
        s = env.task.params_spec
        env.set_distr(to_device_distr(pdf.Uniform(s.lows, s.highs), s.lows,
                                      s.highs, device="cpu"))
        env.reset()
        task = make_task(cell.config["task"], cfg, "cpu")
        state = env.state
        for k in range(3):
            act = torch.randn(cfg["env"]["numEnvs"], env.task.act_dim,
                              generator=torch.Generator().manual_seed(k))
            a = env_step(env.task, env._distr, state, act,
                         torch.Generator().manual_seed(k))
            rd = fdevice.DeviceUniform(*env._distr)
            b = ref_step(task, rd, env_state(snap_state(state),
                                             cell.config["task"], "cpu"),
                         act, torch.Generator().manual_seed(k))
            for x, y in zip(torch.utils._pytree.tree_leaves(tuple(a[0])),
                            torch.utils._pytree.tree_leaves(tuple(b[0]))):
                assert torch.equal(x, y)
            for x, y in zip(a[1:], b[1:]):
                assert torch.equal(x, y)
            state = a[0]


def test_the_card_runs_a_cell_correct(cuda_device, tmp_path):
    """On the card: the train cell at 512 envs is correct, and the TF32
    control fails a number there (``python -m pytest adr_bench/tests -m
    cuda`` on the card)."""
    import io
    import time
    import control
    import run as bench_run
    cell = tiny(spec.resolve("humanoid.train"))
    cell.config["cfg_env"]["env"]["numEnvs"] = 512
    cell.config["cfg_train"]["learn"]["nsteps"] = 8
    out = bench_run.run_cell(cell, SEED, 1.0, False, cuda_device,
                             time.time(), str(tmp_path), io.StringIO())
    assert out["line"]["correct"] is True, out["compared"]
    r = control.readings(out["run"])
    assert any(r["control"][k] > lim for k, lim in cell.limits.items()), r


test_the_card_runs_a_cell_correct = pytest.mark.cuda(
    test_the_card_runs_a_cell_correct)
