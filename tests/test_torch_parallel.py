"""The port's env-sharded multi-GPU layer (``parallel/mesh.py``) on the CPU:
``auto_mesh``'s rank counts, ``initialize_distributed``'s contract, the
slicing and draw helpers, per-env steps that do not depend on the batch
they run in, and one 2-process gloo run of a tiny Cartpole ADR iteration
that must equal the same run on one process."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from bayes_sim_ig_tpu_torch.parallel import mesh as pmesh
from bayes_sim_ig_tpu_torch.parallel import (
    Mesh, auto_mesh, env_draw, env_slice, gather_envs, get_global_mesh,
    global_num_envs, initialize_distributed, set_global_mesh, sync_host_rng)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_global_mesh():
    set_global_mesh(None)
    yield
    set_global_mesh(None)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ #
# auto_mesh
# ------------------------------------------------------------------ #
@pytest.fixture
def eight_ranks(monkeypatch):
    """A world of 8 ranks seen from rank ``state['rank']``."""
    state = {"rank": 0}
    monkeypatch.setattr(pmesh, "_world", lambda: (8, state["rank"]))
    return state


@pytest.mark.parametrize("rank", [0, 5])
def test_auto_mesh_uses_every_rank(eight_ranks, rank):
    eight_ranks["rank"] = rank
    assert auto_mesh(4096) == Mesh(size=8, rank=rank)


@pytest.mark.parametrize("num_envs", [100, 7, 4095])
def test_auto_mesh_refuses_envs_the_ranks_do_not_divide(eight_ranks,
                                                        num_envs):
    # The ranks were launched to be used: none is left idle.
    with pytest.raises(ValueError, match="multiple of 8"):
        auto_mesh(num_envs)


def test_auto_mesh_single_process_is_none():
    assert auto_mesh(512) is None


# ------------------------------------------------------------------ #
# initialize_distributed
# ------------------------------------------------------------------ #
def test_initialize_distributed_single_process_gloo():
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        assert initialize_distributed(
            coordinator_address=f"localhost:{_free_port()}",
            num_processes=1, process_id=0, backend="gloo", timeout_s=30)
        assert dist.get_world_size() == 1
        # Already initialized: skipped, not an error.
        assert initialize_distributed() is False
        assert initialize_distributed(
            coordinator_address=f"localhost:{_free_port()}",
            num_processes=1, process_id=0, backend="gloo") is False
        # A one-rank world builds no mesh.
        assert auto_mesh(512) is None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_distributed_without_a_cluster(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False


@pytest.mark.parametrize("kwargs,match", [
    # Checked before any socket is opened.
    (dict(coordinator_address="localhost:1", num_processes=2,
          process_id=3), "process_id"),
    (dict(num_processes=2, process_id=0), "together"),
    (dict(coordinator_address="localhost:notaport", num_processes=1,
          process_id=0), "notaport"),
])
def test_initialize_distributed_explicit_bad_arguments_raise(kwargs, match):
    import torch.distributed as dist
    with pytest.raises(ValueError, match=match):
        initialize_distributed(backend="gloo", timeout_s=5, **kwargs)
    assert not dist.is_initialized()


# ------------------------------------------------------------------ #
# Slicing, gathering and draws
# ------------------------------------------------------------------ #
def test_slicing_helpers_round_trip():
    x = torch.arange(24.0).reshape(8, 3)
    state = {"q": x, "t": torch.tensor(3.0), "k": (x[:, 0], 7)}
    parts = [x[env_slice(8, Mesh(4, r))] for r in range(4)]
    torch.testing.assert_close(torch.cat(parts), x, rtol=0, atol=0)
    assert env_slice(8, Mesh(4, 3)) == slice(6, 8)
    with pytest.raises(ValueError):
        env_slice(7, Mesh(2, 0))
    # No mesh: the identity everywhere.
    assert env_slice(8) == slice(0, 8)
    assert gather_envs(state) is state
    np.random.seed(3)
    want = np.random.get_state()[1].copy()
    sync_host_rng()  # one process: numpy's state stays as it was
    np.testing.assert_array_equal(np.random.get_state()[1], want)
    assert global_num_envs(5) == 5
    set_global_mesh(Mesh(2, 1))
    assert get_global_mesh() == Mesh(2, 1)
    assert global_num_envs(5) == 10
    assert env_slice(8) == slice(4, 8)


@pytest.mark.parametrize("draw,shape,env_dim", [
    (torch.rand, (6, 3), 0), (torch.randn, (6,), 0),
    (torch.rand, (2, 6), 1)])
def test_env_draw_keeps_the_single_device_stream(draw, shape, env_dim):
    want = draw(shape, generator=torch.Generator().manual_seed(5))
    parts = []
    for r in range(3):
        set_global_mesh(Mesh(3, r))
        local = list(shape)
        local[env_dim] //= 3
        parts.append(env_draw(draw, local, torch.Generator().manual_seed(5),
                              env_dim=env_dim))
    torch.testing.assert_close(torch.cat(parts, dim=env_dim), want,
                               rtol=0, atol=0)


def _task_cfg(stem, num_envs, edits):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           f"{stem}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = num_envs
    cfg["env"].update(edits)
    return cfg


# Every task, its episodes cut to 6 steps so that the 10 steps below cross
# a reset (re-randomized params and state). The draws (params, done) are
# exact on every task. Cartpole and Pendulum are closed form and
# elementwise: bit for bit. The others run batched CPU products whose
# blocking depends on the batch size, so their rows differ in the last
# bits over 10 steps: Ant's obs by at most 1.3e-6, Anymal's 2.4e-7,
# Quadcopter's 7.2e-7, Ingenuity's 1.5e-8, FrankaCabinet's 2.3e-7 (held
# to 1e-5). Humanoid's mass matrix has condition numbers of ~7e3, which
# lift those bits to at most 1.5e-4 in obs (scale ~6), its bar against
# JAX (1e-3); BallBalance (obs scale ~44; the tree solve, ball contacts)
# reaches 4.2e-5 and ShadowHand (scale ~16; the contact impulse sweeps)
# 2.3e-5, held to the same 1e-3.
STEP_TASKS = [("Cartpole", "cartpole", 0.0, {}),
              ("Pendulum", "pendulum", 0.0, {}),
              ("Ant", "ant", 1e-5, {}), ("Humanoid", "humanoid", 1e-3, {}),
              ("Anymal", "anymal", 1e-5, {"episodeLength_s": 0.1}),
              ("Quadcopter", "quadcopter", 1e-5, {"maxEpisodeLength": 6}),
              ("Ingenuity", "ingenuity", 1e-5, {"maxEpisodeLength": 6}),
              ("BallBalance", "ball_balance", 1e-3, {}),
              ("FrankaCabinet", "franka_cabinet", 1e-5, {}),
              ("ShadowHand", "shadow_hand", 1e-3, {})]


@pytest.mark.parametrize("task_name,stem,atol,cut", STEP_TASKS)
def test_per_env_steps_do_not_depend_on_the_batch(task_name, stem, atol,
                                                  cut):
    """N envs in one batch against the same N as two ranks of N/2: the
    same draws (env_draw) give each rank the params, resets and done flags
    of its rows of the one-batch run, and the same per-env arithmetic its
    observations and rewards."""
    from bayes_sim_ig_tpu_torch.distributions import to_device_distr
    from bayes_sim_ig_tpu_torch.distributions import pdf
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.sim.task import env_full_reset, env_step
    n, steps = 8, 10
    acts = torch.from_numpy(np.random.RandomState(0).uniform(
        -0.5, 0.5, (steps, n, 64)).astype(np.float32))

    def run(num_envs, mesh):
        set_global_mesh(mesh)
        env = make_env(task_name,
                       _task_cfg(stem, num_envs,
                                 cut or {"episodeLength": 6}),
                       seed=3, device="cpu")
        spec = env.task.params_spec
        distr = to_device_distr(pdf.Uniform(spec.lows, spec.highs),
                                spec.lows, spec.highs, device="cpu")
        sl = env_slice(n, mesh)
        gen = torch.Generator().manual_seed(11)
        state, obs = env_full_reset(env.task, distr, gen)
        out = [obs]
        for t in range(steps):
            a = acts[t, sl, :env.task.act_dim]
            state, obs, rew, done = env_step(env.task, distr, state, a, gen)
            out += [obs, rew, done.float(), state.params]
        set_global_mesh(None)
        return out

    one = run(n, None)
    halves = [run(n // 2, Mesh(2, r)) for r in range(2)]
    assert any(float(x.sum()) > 0 for x in one[3::4]), "no reset crossed"
    for i, want in enumerate(one):
        got = torch.cat([halves[0][i], halves[1][i]])
        # obs0, then (obs, rew, done, params) per step: done and params are
        # draws and counters, exact on every task.
        exact = i > 0 and (i - 1) % 4 >= 2
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=0.0 if exact else atol,
                                   msg=f"{task_name} output {i}")


# ------------------------------------------------------------------ #
# Two gloo ranks against one process
# ------------------------------------------------------------------ #
_WORKER = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
# numpy's global generator (the refit's resampling of the posterior
# mixtures) is left unseeded by the loop; each rank seeds its own here, and
# setup_parallelism must hand every rank rank 0's state, which equals the
# one-process run's.
np.random.seed(int(os.environ.get("RANK", "0")))
from bayes_sim_ig_tpu_torch import bayes_sim_main, engine
from bayes_sim_ig_tpu_torch.parallel import mesh as pmesh

out_path, cfg_path, logdir = sys.argv[1:4]
rec = {"collect": [], "mdn_loss": []}
collect = bayes_sim_main.collect_trajectories
def recording_collect(*args, **kwargs):
    res = collect(*args, **kwargs)
    rec["collect"].append([res[0].tolist(), res[1].tolist()])
    return res
bayes_sim_main.collect_trajectories = recording_collect
train = engine.BayesSim.run_training
def recording_train(self, *args, **kwargs):
    log = train(self, *args, **kwargs)
    rec["mdn_loss"].append([log["train_loss"], log["test_loss"]])
    return log
engine.BayesSim.run_training = recording_train
checks = {}
gather = pmesh.gather_envs
def checking_gather(tree, dim=0):
    # Slicing the gathered batch back must give this rank's own part.
    out = gather(tree, dim)
    m = pmesh.get_global_mesh()
    if m is not None and isinstance(tree, torch.Tensor):
        n = tree.shape[dim]
        back = out.narrow(dim, m.rank * n, n)
        checks["round_trip"] = bool(torch.equal(back, tree))
        if not checks["round_trip"]:
            raise AssertionError("gather/slice round trip broke")
    return out
pmesh.gather_envs = checking_gather
import bayes_sim_ig_tpu_torch.rl.ppo as ppo_mod
ppo_mod.gather_envs = checking_gather
res = bayes_sim_main.main([
    "--task", "Cartpole", "--cfg_env", cfg_path, "--logdir", logdir,
    "--max_iterations", "1", "--rl_device", "cpu"])
rec["ppo"] = [p.detach().tolist() for p in res["ppo"].params]
rec["mdn"] = [p.detach().tolist() for p in
              res["bsim"].model.net.parameters()]
rec["posterior_means"] = np.stack(
    [g.m for g in res["posterior"].xs]).tolist()
rec["num_envs_local"] = res["env"].task.num_envs
rec["checks"] = checks
with open(out_path, "w") as f:
    json.dump(rec, f)
print("worker done")
'''


def test_two_gloo_ranks_equal_one_process(tmp_path):
    with open(os.path.join(REPO, "bayes_sim_ig_tpu_torch", "cfg",
                           "cartpole.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 16
    # Two ADR iterations: the second predict refits on two real
    # trajectories, resampling the mixtures from numpy's generator.
    cfg["bayessim"].update(trainTrajs=64, realIters=2, realEvals=2)
    cfg_path = tmp_path / "cartpole.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        base.pop(k, None)
    port = str(_free_port())
    runs = {"w1": dict(base)}
    for r in range(2):
        runs[f"w2r{r}"] = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                               WORLD_SIZE="2", MASTER_ADDR="localhost",
                               MASTER_PORT=port)
    procs = {k: subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / f"{k}.json"),
         str(cfg_path), str(tmp_path / f"logs_{k}")],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, env in runs.items()}
    outs = {}
    try:
        for k, p in procs.items():
            outs[k] = p.communicate(timeout=120)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for k, p in procs.items():
        assert p.returncode == 0, f"{k} failed:\n{outs[k][-4000:]}"
    rec = {}
    for k in runs:
        with open(tmp_path / f"{k}.json") as f:
            rec[k] = json.load(f)
    one, r0, r1 = rec["w1"], rec["w2r0"], rec["w2r1"]
    assert one["num_envs_local"] == 16
    assert r0["num_envs_local"] == r1["num_envs_local"] == 8
    assert r0["checks"] == r1["checks"] == {"round_trip": True}
    # Replicated learners: every rank holds the same parameters, bit for
    # bit, without a broadcast after the updates.
    for key in ("ppo", "mdn", "posterior_means", "mdn_loss"):
        assert r0[key] == r1[key], key
    # W = 2 against W = 1: the collected params and states (every
    # collection: the evaluation, the training chunks, the real
    # trajectories), the PPO parameters, the MDN losses and the
    # posterior.
    assert len(r0["collect"]) == len(one["collect"]) == 6
    for got, want in zip(r0["collect"], one["collect"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(r0["ppo"], one["ppo"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(r0["mdn"], one["mdn"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert r0["mdn_loss"] == one["mdn_loss"]
    np.testing.assert_array_equal(np.asarray(r0["posterior_means"]),
                                  np.asarray(one["posterior_means"]))
    # Rank 0 alone writes the checkpoints.
    assert os.path.isdir(tmp_path / "logs_w2r0")
    assert not os.path.exists(tmp_path / "logs_w2r1")
