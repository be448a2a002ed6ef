"""Is one env step on the card a function of its state alone?

    python experiments/step_determinism.py [--tasks ShadowHand Humanoid Ant]
    python experiments/step_determinism.py --root <another checkout>
    python experiments/step_determinism.py --device cpu --envs 8

Runs ``env_step`` twice at each task's full width (its shipped config)
from one state, one generator state and fixed actions, recording the
outputs of every aten op, and prints each op whose outputs differ between
the two runs with its call site and the largest difference. Buffers from
``empty``/``empty_like``/``new_empty`` are left out: they hold whatever
the memory held until a kernel fills them. A CUDA graph replays its
capture's kernels, so a graph can equal the eager step bit for bit only
where two eager steps already do. ``--root`` imports the port from
another checkout (the same script against an older tree). Writes
chiprun_out/step_determinism.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEMS = {"ShadowHand": "shadow_hand", "Humanoid": "humanoid", "Ant": "ant",
         "Anymal": "anymal", "BallBalance": "ball_balance"}
_UNFILLED = ("aten.empty", "aten.empty_like", "aten.new_empty",
             "aten.empty_strided")


def _bits(x):
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _recorder():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        """Every op's tensor outputs (copies) and its call site."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = out if isinstance(out, (tuple, list)) else [out]
            site = [f"{os.path.basename(f.filename)}:{f.lineno}"
                    for f in traceback.extract_stack()
                    if "bayes_sim_ig_tpu_torch" in f.filename][-3:]
            self.ops.append((str(func),
                             [o.detach().clone() for o in outs
                              if isinstance(o, torch.Tensor)], site))
            return out
    return Recorder


def check(task_name, device, num_envs=None):
    import torch
    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    from bayes_sim_ig_tpu_torch.sim import make_env
    from bayes_sim_ig_tpu_torch.sim.task import env_full_reset, env_step
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    root = os.path.dirname(os.path.dirname(
        sys.modules["bayes_sim_ig_tpu_torch"].__file__))
    cfg = load_config(os.path.join(root, "bayes_sim_ig_tpu_torch", "cfg",
                                   f"{STEMS[task_name]}.yaml"))
    if num_envs is not None:
        cfg["env"]["numEnvs"] = num_envs
    env = make_env(task_name, cfg, seed=0, device=device)
    task, spec = env.task, env.task.params_spec
    prior = to_device_distr(Uniform(spec.lows, spec.highs), device=device)
    state, _ = env_full_reset(task, prior, env.gen)
    act = torch.rand(task.num_envs, task.act_dim, device=device,
                     generator=torch.Generator(device=device).manual_seed(1)
                     ) * 0.6 - 0.3
    start = env.gen.get_state()
    env_step(task, prior, state, act, env.gen)  # builds the tables
    runs = []
    for _ in range(2):
        env.gen.set_state(start)
        rec = _recorder()()
        with rec:
            _, obs, _, _ = env_step(task, prior, state, act, env.gen)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        runs.append((rec.ops, obs))
    differing = []
    for i, ((name, a, site), (_, b, _)) in enumerate(zip(runs[0][0],
                                                         runs[1][0])):
        if name.startswith(_UNFILLED):
            continue
        if any(x.shape != y.shape or not torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b)):
            differing.append({"op": i, "name": name, "site": site,
                              "max_abs": max(float(
                                  (x.double() - y.double()).abs()
                                  .nan_to_num(0).max())
                                  for x, y in zip(a, b))})
    obs_diff = float((runs[0][1] - runs[1][1]).abs().max())
    return {"envs": task.num_envs, "ops": len(runs[0][0]),
            "differing": differing, "obs_max_abs": obs_diff}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="+",
                    default=["ShadowHand", "Humanoid", "Ant"])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--envs", type=int, default=None,
                    help="numEnvs (default: the config's)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    device = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    out = {"root": os.path.abspath(args.root), "torch": torch.__version__,
           "device": (torch.cuda.get_device_name(0)
                      if device.type == "cuda" else "cpu"), "tasks": {}}
    for task_name in args.tasks:
        res = out["tasks"][task_name] = check(task_name, device, args.envs)
        print(f"[determinism] {task_name} {res['envs']} envs: "
              f"{len(res['differing'])} of {res['ops']} ops differ between "
              f"two eager steps from one state (obs max abs "
              f"{res['obs_max_abs']:.3g})", flush=True)
        for d in res["differing"][:5]:
            print(f"    op {d['op']} {d['name']} at {d['site']}: max abs "
                  f"{d['max_abs']:.3g}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    name = ("step_determinism.json" if os.path.abspath(args.root) == HERE
            else "step_determinism_root.json")
    with open(os.path.join(HERE, "chiprun_out", name), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
