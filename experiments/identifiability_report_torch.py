"""Identifiability report over a grasp-ADR run's checkpointed posteriors,
through the PyTorch port: the counterpart of ``identifiability_report.py``.

    python experiments/identifiability_report_torch.py RUNDIR [TRUTH]

For every ``checkpoints/posterior_<N>.pkl`` under RUNDIR (the logdir given
to ``bayes_sim_main``; the script descends into the run-name subdir), the
same table as the JAX report: log p(truth) under the posterior's mixture
and under the uniform prior, and the marginal mean and std of the first
six ``object``/``T_`` dims. TRUTH defaults to 1.8 on every dim (the
``realParams`` value of ``shadow_hand_grasp.yaml``). The param names come
from the run's own config (``cfg_env.json`` as
``adr_grasp_vs_ctl_torch.py`` writes it, or ``cfg_env.yaml``), else from
the port's ``cfg/shadow_hand_grasp.yaml``: the same DR tree. Host algebra
only (``distributions.pdf``): no card is needed.
"""

from __future__ import annotations

import glob
import os
import pickle
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bayes_sim_ig_tpu_torch.distributions.pdf import MoG, Uniform  # noqa: E402
from bayes_sim_ig_tpu_torch.sim import make_env  # noqa: E402
from bayes_sim_ig_tpu_torch.utils.args import load_config  # noqa: E402


def _iter_id(path):
    return int(os.path.splitext(os.path.basename(path))[0].split("_")[1])


def report(rundir, truth_val=1.8):
    """The table as data: ``names`` (every param), ``watch`` (the ids of
    the reported dims), ``lp_prior`` and ``rows``, one per checkpoint in
    iteration order: ``iter``, ``log_p_truth``, ``mean`` and ``std`` (the
    marginals of the watched dims)."""
    cfgs = [f for ext in ("json", "yaml") for f in glob.glob(
        os.path.join(rundir, "**", f"cfg_env.{ext}"), recursive=True)]
    ckpts = sorted(glob.glob(os.path.join(rundir, "**", "posterior_*.pkl"),
                             recursive=True), key=_iter_id)
    assert ckpts, f"no posterior checkpoints under {rundir}"
    cfg = load_config(cfgs[0] if cfgs else os.path.join(
        ROOT, "bayes_sim_ig_tpu_torch", "cfg", "shadow_hand_grasp.yaml"))
    cfg["env"]["numEnvs"] = 2
    spec = make_env("ShadowHand", cfg, device="cpu").task.params_spec
    names = list(spec.names)
    truth = np.full(spec.dim, truth_val)
    prior = Uniform(np.asarray(spec.lows), np.asarray(spec.highs))
    watch = [i for i, n in enumerate(names)
             if "object" in n or "T_" in n][:6]
    rows = []
    for f in ckpts:
        with open(f, "rb") as fh:
            d = pickle.load(fh)
        mog = MoG(a=d["weights"], ms=list(d["means"]), Ss=list(d["covs"]))
        m, S = mog.calc_mean_and_cov()
        rows.append({"iter": int(d["real_iter_id"]),
                     "log_p_truth": float(mog.eval(truth[None], log=True)[0]),
                     "mean": [float(m[i]) for i in watch],
                     "std": [float(np.sqrt(S[i, i])) for i in watch]})
    return {"names": names, "watch": watch,
            "lp_prior": float(prior.eval(truth[None], log=True)[0]),
            "rows": rows}


def main(rundir, truth_val=1.8):
    rep = report(rundir, truth_val)
    names, watch, rows = rep["names"], rep["watch"], rep["rows"]
    print(f"{len(rows)} posteriors, {len(names)} dims; "
          f"log p(truth) under prior = {rep['lp_prior']:.1f}")
    print("iter | log p(truth) | " + " | ".join(
        f"{names[i]} mean+-std" for i in watch))
    for r in rows:
        cells = " | ".join(f"{m:.2f}+-{s:.2f}"
                           for m, s in zip(r["mean"], r["std"]))
        print(f"{r['iter']:4d} | {r['log_p_truth']:8.1f} | {cells}")
    lps = [r["log_p_truth"] for r in rows]
    print(f"log p(truth) band: {min(lps):.1f} .. {max(lps):.1f} "
          f"(prior {rep['lp_prior']:.1f})")
    return rep


if __name__ == "__main__":
    main(sys.argv[1], float(sys.argv[2]) if len(sys.argv) > 2 else 1.8)
