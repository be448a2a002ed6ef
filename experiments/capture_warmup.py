"""How many eager calls of an autograd body on its side stream a CUDA graph
capture needs before it holds.

    python experiments/capture_warmup.py [--warmups 0 1 2]

For each k, a fresh process (what runs first in a process matters: the
autograd engine's device thread creates its cuBLAS handle and workspace
at its first backward) builds two bodies on the card:
  * the PPO update's minibatch step (rl/ppo.py ``_Update``) at Ant's
    width: 1024 envs x 16 steps, 4 x 4 minibatches of 4096 rows, the
    actor and critic [256, 128, 64], random trajectory data from seed 0;
  * the MDN fit's step (models/mdnn.py ``_Fit``) of an MDNN [128, 128] x
    10 over 17 dims on 302 inputs, a 1000-row chunk, batches of 100;
runs k eager calls of each on a side stream, captures one call there
(the fit with its generator registered), and holds one replay against
one eager call from the same state bit for bit. ``utils/step_graph.py``'s
``Graphed`` runs one eager call before its capture. Prints one line a k
and body (captured or the error, equal or not) and writes
chiprun_out/capture_warmup.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Task:
    obs_dim, act_dim, num_envs = 60, 8, 1024


class _Env:
    task = _Task()

    def __init__(self, device):
        self.device = device


def _state(tensors):
    return [t.detach().clone() for t in tensors]


def _restore(tensors, saved):
    import torch
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)


def _probe(k, body, tensors, generators):
    """k eager calls of ``body`` on a side stream, then a capture there;
    a replay against an eager call from the same state."""
    import torch
    current, side = torch.cuda.current_stream(), torch.cuda.Stream()
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for _ in range(k):
            body()
    current.wait_stream(side)
    saved = _state(tensors)
    gens = [g.get_state() for g in generators]
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    try:
        with torch.cuda.graph(graph, stream=side):
            body()
    except Exception as exc:  # the finding: which call fails, and how
        return {"captured": False, "error": f"{type(exc).__name__}: {exc}"}
    _restore(tensors, saved)
    for g, s in zip(generators, gens):
        g.set_state(s)
    graph.replay()
    torch.cuda.synchronize()
    replayed = _state(tensors)
    _restore(tensors, saved)
    for g, s in zip(generators, gens):
        g.set_state(s)
    body()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(replayed, tensors))
    return {"captured": True, "equal": equal}


def child(k):
    import torch
    from bayes_sim_ig_tpu_torch.models import MDNN
    from bayes_sim_ig_tpu_torch.rl.ppo import PPO
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "train", "ppo_ant.yaml"))
    ppo = PPO(_Env(dev), cfg, logdir=os.path.join(HERE, "runs", "warmup"),
              seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    t, n = ppo.nsteps, _Task.num_envs
    traj = {"obs": torch.randn(t, n, _Task.obs_dim, generator=gen,
                               device=dev),
            "act": torch.randn(t, n, _Task.act_dim, generator=gen,
                               device=dev)}
    for key in ("logp", "val", "rew"):
        traj[key] = torch.randn(t, n, generator=gen, device=dev)
    traj["done"] = (torch.rand(t, n, generator=gen, device=dev)
                    < 0.05).float()
    last_val = torch.randn(n, generator=gen, device=dev)
    perms = torch.stack([torch.randperm(t * n, generator=gen, device=dev)
                         for _ in range(ppo.noptepochs)])
    update = ppo.update_program(traj, last_val)
    update.load(traj, last_val, perms)
    update.prepare.body()
    out = {"k": k, "update": _probe(
        k, update.minibatch.body,
        ppo.params + [ppo.adam.count] + ppo.adam.mu + ppo.adam.nu
        + [update.metrics, update._t], [])}
    model = MDNN(input_dim=302, output_dim=17, output_lows=[0.0] * 17,
                 output_highs=[1.0] * 17, n_gaussians=10,
                 full_covariance=False, hidden_layers=(128, 128),
                 activation="tanh", lr=1e-3, seed=0, device=dev)
    fit = model.fit_program(800, 302, 100, 100)
    fit.load(torch.randn(800, 302, generator=gen, device=dev),
             torch.rand(800, 17, generator=gen, device=dev))
    out["fit"] = _probe(
        k, fit._program.body,
        list(model.net.parameters()) + [model.adam_count] + model.adam_mu
        + model.adam_nu + [fit.losses, fit._t], [model._gen])
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmups", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--child", type=int, default=None)
    args = ap.parse_args(argv)
    if args.child is not None:
        child(args.child)
        return
    results = []
    for k in args.warmups:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", str(k)],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        res = (json.loads(lines[-1]) if lines else
               {"k": k, "exit": proc.returncode,
                "stderr": proc.stderr[-2000:]})
        results.append(res)
        print(f"[warmup] k = {k}: {json.dumps(res)}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "capture_warmup.json"),
              "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
