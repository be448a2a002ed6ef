"""The port's grasp-ADR pairs against the JAX package's archived ones, arm
by arm, and what each port arm's record shows of its run.

    python experiments/adr_port_vs_jax.py SEED [SEED ...]

Reads ``experiments/data/torch_shadowhand_{grasp,drctl}_s<SEED>.json``
(written by ``adr_grasp_vs_ctl_torch.py``) and the JAX archive's
``experiments/data/shadowhand_{grasp,drctl}_s<SEED>.json``. For each arm
it pools the seeds' surrogate-real means, each grasp series without its
iteration 0 (that policy trains before any posterior, as
``adr_pooled_analysis.py`` drops it), and prints the two-sided
Mann-Whitney U of the port's values against JAX's (``scipy.stats.
mannwhitneyu``): the two packages' random streams differ, so they are
compared by distribution. Then, per port arm: the card, the seconds of
the arm and of an iteration, the mean seconds an iteration of each timed
phase, peak memory, the fit captures, the live graphs at the end, and
allocated memory over the iterations.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
from scipy.stats import mannwhitneyu

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ARMS = ("grasp", "drctl")


def load(arm, seed, port=True, data=DATA):
    name = f"{'torch_' if port else ''}shadowhand_{arm}_s{seed}.json"
    with open(os.path.join(data, name)) as f:
        return json.load(f)


def pooled(arm, seeds, port=True, data=DATA):
    """The seeds' surrogate-real means of one arm, grasp without its
    iteration 0."""
    skip = 1 if arm == "grasp" else 0
    return np.concatenate([
        np.asarray(load(arm, s, port, data)["real_rewards_mean"][skip:],
                   np.float64) for s in seeds])


def compare(seeds, data=DATA):
    """{arm: (port values, JAX values, two-sided MWU p)}."""
    out = {}
    for arm in ARMS:
        mine = pooled(arm, seeds, data=data)
        ref = pooled(arm, seeds, port=False, data=data)
        out[arm] = (mine, ref,
                    float(mannwhitneyu(mine, ref,
                                       alternative="two-sided").pvalue))
    return out


def record_lines(rec):
    """What an arm's record shows of its run, as lines of text."""
    n = len(rec["real_rewards_mean"])
    gib = 2.0 ** 30
    lines = [f"card {rec['card']}; {n} iterations of {rec['max_iterations']}"
             f" PPO iterations at {rec['num_envs']} envs, realEvals "
             f"{rec['real_evals']}, in {rec['seconds']:.1f} s "
             f"({rec['seconds'] / max(n, 1):.1f} s an iteration); error "
             f"{None if not rec['error'] else rec['error'].splitlines()[-1]}"]
    if rec.get("phase_secs"):
        lines.append("mean s an iteration: " + ", ".join(
            f"{k} {v / max(n, 1):.2f}" for k, v in rec["phase_secs"].items()))
    if rec["iter_secs"]:
        lines.append(f"iter_secs min {min(rec['iter_secs']):.1f}, median "
                     f"{np.median(rec['iter_secs']):.1f}, max "
                     f"{max(rec['iter_secs']):.1f}")
    if rec["peak_allocated"] is not None:
        alloc = [i["allocated"] / gib for i in rec["iterations"]]
        lines.append(f"peak {rec['peak_allocated'] / gib:.2f} GiB allocated,"
                     f" {rec['peak_reserved'] / gib:.2f} reserved; allocated "
                     f"at the evaluations {min(alloc):.2f}-{max(alloc):.2f} "
                     f"GiB (iteration 1 on: "
                     f"{min(alloc[1:] or alloc):.2f}-"
                     f"{max(alloc[1:] or alloc):.2f})")
    stats = rec["graph_stats"]
    live_fits = [i["live_graphs"].get("fit", 0) for i in rec["iterations"]]
    lines.append("captures " + ", ".join(
        f"{k} {v['captures']}" for k, v in stats.items())
        + f"; live fit captures at the evaluations {live_fits}; live graphs"
        f" at the end {rec['live_graphs']}")
    return lines


def main(seeds):
    for arm, (mine, ref, p) in compare(seeds).items():
        print(f"{arm}: port n={len(mine)} mean={mine.mean():.1f} "
              f"med={np.median(mine):.1f} | JAX n={len(ref)} "
              f"mean={ref.mean():.1f} med={np.median(ref):.1f} | MWU "
              f"two-sided p={p:.4f} | port finite "
              f"{bool(np.isfinite(mine).all())}")
    for seed in seeds:
        for arm in ARMS:
            for line in record_lines(load(arm, seed)):
                print(f"  [{arm} s{seed}] {line}")


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]])
