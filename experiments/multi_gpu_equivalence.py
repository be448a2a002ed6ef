"""W ranks against one: the port's ADR loop sharded over torchrun ranks.

    python experiments/multi_gpu_equivalence.py --nproc 4 --device cuda
    python experiments/multi_gpu_equivalence.py --nproc 4 --device cpu \\
        --num_envs 16 --train_trajs 64 --real_evals 2     # gloo, small

Runs ``bayes_sim_main.main`` on cfg/cartpole_more.yaml (Cartpole,
summary_signatory, MDNN; 2 ADR iterations of 5 PPO iterations, the second
ending in a refit, the config's widths unless cut by the flags) once in one process and once under
``torch.distributed.run`` with ``--nproc`` ranks (NCCL on the cards, one
card a rank; gloo on the CPU). Every process records what the loop
collected (params and states of each collection), its PPO and MDN
parameters, the MDN losses and the posterior means. Prints the largest
differences of the W-rank run (rank 0) against the one-process run, of
each rank against rank 0, and each run's seconds for the ADR iteration;
writes the summary to chiprun_out/multi_gpu_equivalence.json.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def worker(out_path, cfg_path, logdir, device):
    import torch
    # numpy's global generator is left unseeded by the loop: each rank
    # seeds its own, and setup_parallelism hands every rank rank 0's state.
    np.random.seed(int(os.environ.get("RANK", "0")))
    from bayes_sim_ig_tpu_torch import bayes_sim_main, engine
    rec = {}
    collect = bayes_sim_main.collect_trajectories

    def recording_collect(*args, **kwargs):
        res = collect(*args, **kwargs)
        i = sum(k.startswith("collect_params") for k in rec)
        rec[f"collect_params_{i}"] = res[0].cpu().numpy()
        rec[f"collect_states_{i}"] = res[1].cpu().numpy()
        return res

    train = engine.BayesSim.run_training
    losses = []

    def recording_train(self, *args, **kwargs):
        log = train(self, *args, **kwargs)
        losses.append(log["train_loss"] + log["test_loss"])
        return log

    bayes_sim_main.collect_trajectories = recording_collect
    engine.BayesSim.run_training = recording_train
    t0 = time.perf_counter()
    res = bayes_sim_main.main([
        "--task", "Cartpole", "--cfg_env", cfg_path, "--logdir", logdir,
        "--max_iterations", "5", "--seed", "0", "--rl_device", device])
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    rec["seconds"] = np.asarray(time.perf_counter() - t0)
    rec["iter_secs"] = np.asarray(res["iter_secs"])
    rec["mdn_loss"] = np.asarray(losses)
    rec["ppo"] = np.concatenate([p.detach().cpu().numpy().ravel()
                                 for p in res["ppo"].params])
    rec["mdn"] = np.concatenate([p.detach().cpu().numpy().ravel()
                                 for p in res["bsim"].model.net.parameters()])
    rec["posterior_means"] = np.stack([g.m for g in res["posterior"].xs])
    rec["num_envs_local"] = np.asarray(res["env"].task.num_envs)
    rec["device"] = np.asarray(str(res["ppo"].device))
    np.savez(out_path, **rec)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _max_diff(a, b):
    return {k: float(np.abs(a[k] - b[k]).max()) for k in a.files
            if k.startswith(("collect", "ppo", "mdn", "posterior"))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--num_envs", type=int, default=None)
    ap.add_argument("--train_trajs", type=int, default=None)
    ap.add_argument("--real_evals", type=int, default=None)
    ap.add_argument("--real_iters", type=int, default=2)
    ap.add_argument("--worker", nargs=4, default=None,
                    metavar=("OUT", "CFG", "LOGDIR", "DEVICE"))
    args = ap.parse_args(argv)
    if args.worker is not None:
        return worker(*args.worker)
    import yaml
    with open(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                           "cartpole_more.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["bayessim"]["realIters"] = args.real_iters
    for key, sec, val in (("numEnvs", "env", args.num_envs),
                          ("trainTrajs", "bayessim", args.train_trajs),
                          ("realEvals", "bayessim", args.real_evals)):
        if val is not None:
            cfg[sec][key] = val
    device = "cuda:0" if args.device == "cuda" else "cpu"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cartpole_more.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        runs = {}
        for w in (1, args.nproc):
            outs = os.path.join(tmp, f"w{w}_rank")
            cmd = [sys.executable, me, "--worker", outs + "{rank}.npz",
                   cfg_path, os.path.join(tmp, f"logs_w{w}"), device]
            if w > 1:
                # Each rank writes its own file: the worker reads RANK.
                cmd = [sys.executable, "-m", "torch.distributed.run",
                       "--nproc_per_node", str(w), "--master_addr",
                       "localhost", "--master_port", str(_free_port()),
                       me, "--worker", outs + "{rank}.npz", cfg_path,
                       os.path.join(tmp, f"logs_w{w}"), device]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, env=env, capture_output=True,
                                  text=True, timeout=1500)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                print(proc.stdout[-3000:], proc.stderr[-6000:])
                raise SystemExit(f"the {w}-rank run failed")
            runs[w] = ([np.load(outs + f"{r}.npz") for r in range(w)],
                       wall)
        (one,), _ = runs[1]
        many, wall_many = runs[args.nproc]
        summary = {
            "device": str(one["device"]), "nproc": args.nproc,
            "num_envs": cfg["env"]["numEnvs"],
            "train_trajs": cfg["bayessim"]["trainTrajs"],
            "num_envs_local": [int(r["num_envs_local"]) for r in many],
            "ranks_devices": [str(r["device"]) for r in many],
            "w_vs_1_max_abs": _max_diff(many[0], one),
            "rank_vs_rank0_max_abs": [_max_diff(r, many[0])
                                      for r in many[1:]],
            "adr_iter_secs": {"1": one["iter_secs"].tolist(),
                              str(args.nproc): many[0]["iter_secs"].tolist()},
            "wall_secs": {"1": runs[1][1], str(args.nproc): wall_many},
        }
    print(json.dumps(summary))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           "multi_gpu_equivalence.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        sys.argv[i + 1] = sys.argv[i + 1].format(
            rank=os.environ.get("RANK", "0"))
    main()
