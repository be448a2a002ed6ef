"""One task's ADR phase of chip_smoke.py in two checkouts, in turns on one
card: a, b, b, a.

    python experiments/graph_ab.py <checkout a> <checkout b> [--task Ant]

Each turn is its own process in the checkout's root: it builds that
checkout's kernels and runs ``chip_smoke.phase_adr`` on the task's entry
of its ``ADR_PHASES`` (full width, cut in depth only), timed by checkout
b's ``chip_smoke._PhaseTimer`` in both checkouts, so that the two turns
break their seconds down alike. Prints and keeps each turn's
``[device]`` line (the card and its power limit) and its ``[adr]`` line:
the seconds of each ADR iteration and of ``ppo.run``, collection, the MDN
fits and the posterior, and inside them of the summarizer, the model's
and the refit's fits, ``predict_MoGs`` and the mixtures' sampling. Two
commits compare only within one such call: the host's speed differs
between machines. Writes chiprun_out/graph_ab_<task>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN = ("import importlib.util, chip_smoke as c; "
        "s = importlib.util.spec_from_file_location('timer', {timer!r}); "
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
        "c._PhaseTimer = m._PhaseTimer; c.phase_device(); c.phase_build(); "
        "c.phase_adr(*[p for p in c.ADR_PHASES if p[0] == {task!r}][0])")


def _turn(root, task, timer):
    proc = subprocess.run([sys.executable, "-c",
                           _RUN.format(task=task, timer=timer)],
                          cwd=root, capture_output=True, text=True,
                          timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: exit {proc.returncode}\n"
                           f"{proc.stderr[-3000:]}")
    lines = proc.stdout.splitlines()
    line = [l for l in lines if l.startswith("[adr]")][0]
    card = [l for l in lines if l.startswith("[device]")][0]
    iters = re.search(r"per iteration: ([^s]*) s", line).group(1)
    phases = dict((k, float(v)) for k, v in re.findall(
        r"(ppo\.run|collect|bsim\.run_training|bsim\.predict|summarizer|"
        r"mdn\.fit|refit\.fit|predict_MoGs|MoG\.gen) ([0-9.]+) s", line))
    return {"root": root, "line": line, "device": card,
            "iter_secs": [float(x) for x in iters.split(",")],
            "phases": phases}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--task", default="Ant")
    args = ap.parse_args(argv)
    turns = []
    timer = os.path.join(os.path.abspath(args.b), "chip_smoke.py")
    for root in (args.a, args.b, args.b, args.a):
        turn = _turn(os.path.abspath(root), args.task, timer)
        turns.append(turn)
        print(f"[ab] {os.path.basename(turn['root'])}: {turn['device']}\n"
              f"[ab] {os.path.basename(turn['root'])}: {turn['line']}",
              flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out",
                           f"graph_ab_{args.task}.json"), "w") as f:
        json.dump({"task": args.task, "turns": turns}, f, indent=1)


if __name__ == "__main__":
    main()
