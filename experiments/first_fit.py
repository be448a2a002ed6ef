"""Where the first MDN fit of a fresh process spends its time on the card.

    python experiments/first_fit.py [--adr <checkout>]

Each optimizer runs in a fresh process of its own on one card: Ant's MDN
(an MDNN [128, 128] x 10 over 17 dims on 302 inputs) takes 200 eager
updates of 100 rows of a 1000-row chunk (random data from seed 0), after
one eager PPO update at Ant's width (what precedes the first fit in an
ADR iteration):
  * "torch.optim.Adam": the loop the port ran before its fit graph, a
    fresh ``torch.optim.Adam`` stepped after ``zero_grad`` and
    ``backward``;
  * "adam_step": the port's eager fit body (``mdn_train_step``, whose
    in-place Adam is optax's arithmetic).
Prints, for each, the host ms of the optimizer's construction and how
many modules it imported (``sys.modules`` before and after; whether
``torch._dynamo`` was among them), the host ms (synchronized) of the
first update's forward and backward and of its optimizer step, of
updates 2 and 3, the median of updates 4-200, and how many modules the
first update imported (with the first few names); and the card's name
and power limit. Writes chiprun_out/first_fit.json.

With ``--adr <checkout>`` it runs instead, in a fresh process in that
checkout's root, its ``chip_smoke.phase_adr`` on Ant (2 ADR iterations
at full width) with every ``mdn_train_step`` call (the fits' eager
updates before the fit graph) and every ``torch.optim.Adam.step``
timed, synchronized, and prints the first five updates of each fit, the
sum and median of each fit's updates and of its steps. Writes
chiprun_out/first_fit_adr.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(optimizer):
    import torch
    from bayes_sim_ig_tpu_torch.models import MDNN, mdn_train_step
    from bayes_sim_ig_tpu_torch.models.mdnn import mdn_loss
    from bayes_sim_ig_tpu_torch.rl.ppo import PPO
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    class Task:
        obs_dim, act_dim, num_envs = 60, 8, 1024

    class Env:
        task, device = Task(), dev
    ppo = PPO(Env(), load_config(os.path.join(
        HERE, "bayes_sim_ig_tpu_torch", "cfg", "train", "ppo_ant.yaml")),
        logdir=os.path.join(HERE, "runs", "first_fit"), seed=0)
    t, n = ppo.nsteps, Task.num_envs
    traj = {"obs": torch.randn(t, n, 60, generator=gen, device=dev),
            "act": torch.randn(t, n, 8, generator=gen, device=dev),
            "done": torch.zeros(t, n, device=dev)}
    for key in ("logp", "val", "rew"):
        traj[key] = torch.randn(t, n, generator=gen, device=dev)
    perms = torch.stack([torch.randperm(t * n, generator=gen, device=dev)
                         for _ in range(ppo.noptepochs)])
    ppo.update_from_traj(traj, torch.zeros(n, device=dev), perms)

    model = MDNN(input_dim=302, output_dim=17, output_lows=[0.0] * 17,
                 output_highs=[1.0] * 17, n_gaussians=10,
                 full_covariance=False, hidden_layers=(128, 128),
                 activation="tanh", lr=1e-3, seed=0, device=dev)
    x = torch.randn(800, 302, generator=gen, device=dev)
    y = torch.rand(800, 17, generator=gen, device=dev)
    opt, built = None, {}
    if optimizer == "torch.optim.Adam":
        modules = set(sys.modules)
        dynamo = "torch._dynamo" in sys.modules
        t0 = time.perf_counter()
        opt = torch.optim.Adam(model.net.parameters(), lr=model.lr)
        new = set(sys.modules) - modules
        built = {"construct_ms": (time.perf_counter() - t0) * 1e3,
                 "modules_imported": len(new),
                 "imported_torch._dynamo": not dynamo
                 and "torch._dynamo" in sys.modules}
    times, first = [], {}
    for i in range(200):
        ids = torch.randint(0, 800, (100,), generator=model._gen, device=dev)
        noise = model._noise(100)
        torch.cuda.synchronize()
        modules = set(sys.modules)
        t0 = time.perf_counter()
        if opt is None:
            mdn_train_step(model, x, y, ids, noise)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        else:
            loss = mdn_loss(*model(x[ids], noise), y[ids])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        times.append((t2 - t0) * 1e3)
        if i == 0:
            new = sorted(set(sys.modules) - modules)
            first = {"forward_backward_ms": (t1 - t0) * 1e3,
                     "step_ms": (t2 - t1) * 1e3,
                     "modules_imported": len(new),
                     "first_modules": new[:8]}
    print(json.dumps({"optimizer": optimizer, "construction": built,
                      "first_update": first,
                      "update_2_ms": times[1], "update_3_ms": times[2],
                      "median_4_200_ms": statistics.median(times[3:])}),
          flush=True)


_ADR = """
import statistics, sys, time, torch
import chip_smoke as c
from bayes_sim_ig_tpu_torch.models import mdnn
fits, steps = [], []
train_step, adam_step = mdnn.mdn_train_step, torch.optim.Adam.step

def timed(fn, out):
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kwargs)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        return res
    return wrapper
mdnn.mdn_train_step = timed(train_step, fits)
torch.optim.Adam.step = timed(adam_step, steps)
c.phase_device(); c.phase_build()
c.phase_adr(*[p for p in c.ADR_PHASES if p[0] == "Ant"][0])
print("FITS", fits)
print("STEPS", steps)
"""


def adr(root):
    proc = subprocess.run([sys.executable, "-c", _ADR], cwd=root,
                          capture_output=True, text=True, timeout=900)
    out = {"root": root, "exit": proc.returncode}
    for line in proc.stdout.splitlines():
        for key in ("FITS", "STEPS"):
            if line.startswith(key + " "):
                out[key.lower()] = json.loads(line[len(key) + 1:])
        if line.startswith("[adr]") or line.startswith("[device]"):
            out[line[1:line.index("]")]] = line
    if proc.returncode != 0:
        out["stderr"] = proc.stderr[-3000:]
    summary = {"exit": out["exit"], "device": out.get("device")}
    # Ant's fits: 100 updates a chunk, one chunk an ADR iteration, then the
    # refit's 500 in predict (the second iteration's only).
    for name in ("fits", "steps"):
        ms = out.get(name, [])
        chunks = [ms[i:i + 100] for i in (0, 100)] + [ms[200:]]
        summary[name] = [{"first_5_ms": c[:5], "sum_ms": sum(c),
                          "median_ms": statistics.median(c) if c else None}
                         for c in chunks]
    print(f"[first-fit-adr] {json.dumps(summary)}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "first_fit_adr.json"),
              "w") as f:
        json.dump(out, f, indent=1)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--adr":
        adr(os.path.abspath(sys.argv[2]))
        return
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    results = []
    for optimizer in ("torch.optim.Adam", "adam_step"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", optimizer],
            cwd=HERE, capture_output=True, text=True, timeout=600)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        res = (json.loads(lines[-1]) if lines else
               {"optimizer": optimizer, "exit": proc.returncode,
                "stderr": proc.stderr[-2000:]})
        results.append(res)
        print(f"[first-fit] {json.dumps(res)} | {smi}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "first_fit.json"), "w") as f:
        json.dump({"card": smi, "runs": results}, f, indent=1)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    main()
