"""Where an env step's device time goes, by chain, on the card.

Runs eager ``env_step`` calls of the benchmark cells' tasks at their
widths (Anymal 4,000, Humanoid 4,096, ShadowHand 10,000 from
``shadow_hand_more.yaml``) under ``torch.profiler`` with a range around
each physics call of the task's substep (patched into the task's module
and into ``physics/dynamics.py``), and prints each chain's device ms and
kernel launches a step: forward kinematics, forward dynamics with its
solves (and, inside it, the build of the bias, inertias, mass factors and
CRBA values), the integration, the penalty contacts, ShadowHand's impulse
pass, and the rest of the step. A kernel counts where it was launched;
the profiler leaves some launches of the hand-written kernels (through
ctypes) outside any range, and those count in their chain (``HAND``) by
name.

    python experiments/step_chains.py [--repo DIR] [--steps 10]
        [--out runs/step_chains.json]

``--repo`` runs another checkout's package (a parent commit unpacked in an
ignored directory), so that two versions are measured in one call.
"""

import argparse
import json
import os
import sys

CELLS = [("Anymal", "anymal", 4000), ("Humanoid", "humanoid", 4096),
         ("ShadowHand", "shadow_hand_more", 10000)]
# Chain of each patched function, by the module that calls it.
TASK_CHAINS = {"forward_kinematics": "fk", "forward_dynamics": "dynamics",
               "integrate_and_clamp": "integrate",
               "ground_contact_forces": "contacts",
               "sphere_plane_pairs_forces": "contacts",
               "sphere_box_pairs_forces": "contacts",
               "sphere_sphere_pairs_forces": "contacts",
               "contact_pairs_impulse_prepare": "impulse",
               "contact_pairs_impulse_apply": "impulse",
               "impulse_row_forces": "impulse",
               "impulse_generalized_force": "impulse",
               "external_generalized_force": "impulse"}
BUILD = ("_i10_direct", "_bias_from_i10", "_mass_factors_i10",
         "_crba_matrix", "_tree_pair_values")
# The chain of each hand-written kernel, by a part of its name.
HAND = (("forward_kinematics", "fk"), ("integrate_clamp", "integrate"),
        ("spd_", "dynamics"), ("tree_factor", "dynamics"),
        ("tree_substitute", "dynamics"), ("tree_half", "impulse"))


def _ranged(fn, name):
    import torch

    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


def _kernels(event):
    """The device kernels launched under a profiler event, its own and its
    descendants'."""
    out = list(event.kernels)
    for child in event.cpu_children:
        out += _kernels(child)
    return out


def measure(task, stem, n, steps):
    import numpy as np
    import torch
    import yaml
    from torch.profiler import ProfilerActivity, profile

    from bayes_sim_ig_tpu_torch.distributions import Uniform, to_device_distr
    from bayes_sim_ig_tpu_torch.physics import dynamics
    from bayes_sim_ig_tpu_torch.sim import env_step, make_env
    root = os.path.dirname(os.path.dirname(dynamics.__file__))
    with open(os.path.join(root, "cfg", f"{stem}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = n
    env = make_env(task, cfg, seed=0, device="cuda")
    spec = env.task.params_spec
    distr = to_device_distr(Uniform(spec.lows, spec.highs), device="cuda")
    env.set_distr(distr)
    env.reset()
    module = sys.modules[type(env.task).__module__]
    saved = []
    for name, chain in TASK_CHAINS.items():
        if hasattr(module, name):
            saved.append((module, name, getattr(module, name)))
            setattr(module, name, _ranged(getattr(module, name),
                                          f"chain.{chain}"))
    for name in BUILD:
        saved.append((dynamics, name, getattr(dynamics, name)))
        setattr(dynamics, name, _ranged(getattr(dynamics, name),
                                        "chain.dynamics_build"))
    rs = np.random.RandomState(0)
    acts = [torch.as_tensor(rs.uniform(-1, 1, (n, env.task.act_dim)),
                            dtype=torch.float32, device="cuda")
            for _ in range(steps)]
    state = env.state
    try:
        for a in acts[:2]:  # warm-up
            state = env_step(env.task, distr, state, a, env.gen)[0]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in acts:
                with torch.profiler.record_function("chain.step"):
                    state = env_step(env.task, distr, state, a,
                                     env.gen)[0]
            torch.cuda.synchronize()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    rows, in_step = {}, []
    for e in prof.events():
        if e.name.startswith("chain."):
            ks = _kernels(e)
            in_step += ks if e.name == "chain.step" else []
            row = rows.setdefault(e.name[6:], [0.0, 0])
            row[0] += sum(k.duration for k in ks) / 1e3 / steps
            row[1] += len(ks) / steps
    total = {k.key: (k.self_device_time_total / 1e3 / steps,
                     k.count / steps)
             for k in prof.key_averages() if k.self_device_time_total > 0}
    for part, chain in HAND:
        ms = sum(t for key, (t, _) in total.items() if part in key)
        n = sum(c for key, (_, c) in total.items() if part in key)
        ms -= sum(k.duration for k in in_step if part in k.name) / 1e3 / steps
        n -= sum(1 for k in in_step if part in k.name) / steps
        for row in (chain, "step"):
            rows.setdefault(row, [0.0, 0])
            rows[row][0] += ms
            rows[row][1] += n
    step_ms, step_k = rows.get("step", [0.0, 0])
    named = sum(rows.get(c, [0.0, 0])[0] for c in
                ("fk", "dynamics", "integrate", "contacts", "impulse"))
    named_k = sum(rows.get(c, [0.0, 0])[1] for c in
                  ("fk", "dynamics", "integrate", "contacts", "impulse"))
    rows["rest"] = [step_ms - named, step_k - named_k]
    return {"task": task, "stem": stem, "envs": n, "steps": steps,
            "chains": {k: {"device_ms": v[0], "launches": v[1]}
                       for k, v in rows.items()},
            "device_ms_all_kernels": sum(t for t, _ in total.values()),
            "hand_written": {k: t for k, (t, _) in total.items()
                             if any(part in k for part, _ in HAND)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("step_chains.py needs a CUDA card")
    out = []
    for task, stem, n in CELLS:
        r = measure(task, stem, n, args.steps)
        out.append(r)
        print(f"[chains] {args.repo} {task} {n}: " + "; ".join(
            f"{k} {v['device_ms']:.3f} ms, {v['launches']:.0f}"
            for k, v in r["chains"].items())
            + f" | all kernels {r['device_ms_all_kernels']:.3f} ms | "
            + ", ".join(f"{k[:40]} {v:.4f}"
                        for k, v in r["hand_written"].items()), flush=True)
    print(f"[card] {torch.cuda.get_device_name(0)}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
