"""ADR phases of chip_smoke.py in two checkouts, in turns on one card: a, b,
b, a.

    python experiments/graph_ab.py <checkout a> <checkout b> [--task Ant ...]
    python experiments/graph_ab.py <checkout a> <checkout b> --task all

Each turn is one process in the checkout's root: it builds that
checkout's kernels and runs each task's ADR phase in order: an entry of
its ``ADR_PHASES`` through ``chip_smoke.phase_adr`` (full width, cut in
depth only), or ``Cartpole+MDRFF``, ``Pendulum`` and ``cartpole_more``
through their own phases; ``all`` names every one. Both checkouts are
timed by checkout b's ``chip_smoke._PhaseTimer``, so that the two turns
break their seconds down alike: the seconds of each ADR iteration and of
``ppo.run``, collection, the MDN fits and the posterior, inside them of
the summarizer, the model's and the refit's fits, ``predict_MoGs`` and the
mixtures' sampling, and the collection's breakdown (reset, replays,
extraction, ``gather_envs``, frames, captures, left over; the video and
the loop's ``.cpu()`` copies). Prints and keeps each turn's ``[device]``
line (the card and its power limit) and its ``[adr]`` lines. Two commits
compare only within one such call: the host's speed differs between
machines. Writes chiprun_out/graph_ab_<tasks>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The phases that are not entries of ADR_PHASES: their chip_smoke calls.
_OWN = {"Cartpole+MDRFF": "c.phase_adr_cartpole()",
        "Pendulum": "c.phase_adr_pendulum()",
        "cartpole_more": "c.phase_adr_cartpole_more()"}
ALL = ["Ant", "Cartpole+MDRFF", "Humanoid", "Pendulum", "Anymal",
       "Quadcopter", "Ingenuity", "BallBalance", "FrankaCabinet",
       "ShadowHand", "cartpole_more"]

_RUN = ("import importlib.util, chip_smoke as c; "
        "s = importlib.util.spec_from_file_location('timer', {timer!r}); "
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
        "c._PhaseTimer = m._PhaseTimer; c.phase_device(); c.phase_build()")


def _call(task):
    return _OWN.get(task, "c.phase_adr(*[p for p in c.ADR_PHASES if "
                          f"p[0] == {task!r}][0])")


def _phases(line):
    """{name: seconds} of an [adr] line's phases and collection pieces."""
    return {k: float(v) for k, v in re.findall(
        r"(ppo\.run|collect|bsim\.run_training|bsim\.predict|summarizer|"
        r"mdn\.fit|refit\.fit|predict_MoGs|MoG\.gen|video|loop \.cpu\(\)|"
        r"reset|replays|extract|gather_envs|render|captures|left over) "
        r"(-?[0-9.]+) s", line)}


def _turn(root, tasks, timer):
    code = "; ".join([_RUN.format(timer=timer)] + [_call(t) for t in tasks])
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=2400)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    card = [l for l in lines if l.startswith("[device]")][0]
    adr = [l for l in lines if l.startswith("[adr]")]
    assert len(adr) == len(tasks), (len(adr), tasks)
    out = {}
    for task, line in zip(tasks, adr):
        iters = re.search(r"per iteration: ([^s]*) s", line).group(1)
        out[task] = {"line": line, "phases": _phases(line),
                     "iter_secs": [float(x) for x in iters.split(",")]}
    return {"root": root, "device": card, "tasks": out}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--task", nargs="+", default=["Ant"],
                    help=f"phases, or 'all': {', '.join(ALL)}")
    args = ap.parse_args(argv)
    tasks = ALL if args.task == ["all"] else args.task
    turns = []
    timer = os.path.join(os.path.abspath(args.b), "chip_smoke.py")
    for root in (args.a, args.b, args.b, args.a):
        turn = _turn(os.path.abspath(root), tasks, timer)
        turns.append(turn)
        name = os.path.basename(turn["root"])
        print(f"[ab] {name}: {turn['device']}", flush=True)
        for t in tasks:
            print(f"[ab] {name}: {turn['tasks'][t]['line']}", flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    tag = "all" if args.task == ["all"] else "_".join(tasks)
    with open(os.path.join(HERE, "chiprun_out", f"graph_ab_{tag}.json"),
              "w") as f:
        json.dump({"tasks": tasks, "turns": turns}, f, indent=1)


if __name__ == "__main__":
    main()
