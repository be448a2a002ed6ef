"""What the metric readers in ``metrics/`` share: each reader is a small
file that picks its quantity and calls one of these with its own
choices. A reader returns None where its run holds nothing to read, and
the harness then leaves the metric out of the line."""

from __future__ import annotations

import math
import statistics
from typing import Optional, Sequence

from . import counts


def peak_mem_gib(run) -> Optional[float]:
    """Peak device memory the port allocated over set-up and window, GiB
    (``torch.cuda.max_memory_allocated``, read by the harness when the
    window closes); None on the CPU."""
    if not run.peak_mem_bytes:
        return None
    return run.peak_mem_bytes / 2 ** 30


def span_mean(run, name: str, loop: str) -> Optional[float]:
    """Mean seconds an ADR iteration of the window spent in span
    ``name`` (traced runs of ``loop`` only)."""
    if run.loop != loop or not run.traced or not run.spans:
        return None
    return statistics.fmean(s.get(name, 0.0) for s in run.spans.values())


def device_share(run, loop: str) -> Optional[float]:
    """Percent of the slice's seconds in which no device operation ran."""
    if run.loop != loop or run.slice is None or run.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)


def _task(run):
    """The frozen reference's task of the run's configuration, one env on
    the CPU: its dof tree and its parameters."""
    task = getattr(run, "_one_env_task", None)
    if task is None:
        from reference.frozen.sim import make_task
        cfg = {**run.env_cfg, "env": {**run.env_cfg["env"], "numEnvs": 1}}
        task = run._one_env_task = make_task(run.config["task"], cfg, "cpu")
    return task


def tree_roofline(run, loop: str, kernels: str) -> Optional[float]:
    """Percent: the least time the slice's env steps' tree solves could
    take on the card (``counts``, the configuration's
    ``tree_solves_per_step``) over the device time of the kernels whose
    names match ``kernels``."""
    s = run.slice
    if run.loop != loop or s is None or s.env_steps <= 0:
        return None
    spent = s.device_seconds(kernels)
    if spent <= 0.0:
        return None
    bound = s.env_steps * counts.tree_step_seconds(
        _task(run).model.dof_anc_chains, int(run.task["num_envs"]),
        run.config["tree_solves_per_step"])
    return 100.0 * bound / spent


def _net(run) -> counts.ActorCritic:
    policy = run.train_cfg.get("policy", {})
    return counts.ActorCritic(
        obs=int(run.task["obs_dim"]), act=int(run.task["act_dim"]),
        pi=list(policy.get("pi_hid_sizes", [64, 64])),
        vf=list(policy.get("vf_hid_sizes", [64, 64])),
        critic_in=int(run.task["critic_in"]))


def _ppo_flops(run, iterations: int) -> float:
    learn = run.train_cfg["learn"]
    return iterations * counts.ppo_iteration_flops(
        _net(run), int(run.task["num_envs"]), int(learn["nsteps"]),
        int(learn["noptepochs"]))


def _summary_dim(run) -> int:
    import torch
    from reference.frozen.summarizers import get_summarizer
    bs = run.env_cfg["bayessim"]
    L = int(bs["trainTrajLen"]) + 1
    x = get_summarizer(bs["summarizerFxn"])(
        torch.zeros(1, L, int(run.task["obs_dim"])),
        torch.zeros(1, L, int(run.task["act_dim"])))
    return int(x.shape[-1])


def adr_iteration_flops(run, iteration: int) -> float:
    """Network FLOPs of ADR iteration ``iteration`` (from 0): the PPO
    iterations, the actor at every collection step (the evaluation's
    round, the training rounds, the surrogate-real rounds), the fits of
    the training chunks and, from the second ADR iteration on, the
    refit's (``BayesSim.predict`` combines one mixture a surrogate-real
    trajectory)."""
    bs = run.env_cfg["bayessim"]
    env = run.env_cfg["env"]
    N = int(run.task["num_envs"])
    actor = _net(run).actor
    flops = _ppo_flops(run, int(run.traffic["ppo_iterations"]))

    def rounds(trajs, steps):
        return -(-int(trajs) // N) * steps
    ep = int(env.get("episodeLength", 0)) or None
    eval_steps = (ep - 1) if ep else 0
    chunk = 1000
    n_train = int(bs["trainTrajs"])
    chunks = [min(chunk, n_train - i) for i in range(0, n_train, chunk)]
    L = int(bs["trainTrajLen"])
    steps = (rounds(bs["realEvals"], eval_steps)
             + sum(rounds(c, L) for c in chunks)
             + rounds(bs["realTrajs"], L))
    flops += counts.forward_flops(actor, N) * steps
    D = int(_task(run).params_spec.dim)
    K, hidden = int(bs["components"]), list(bs["hiddenLayers"])
    width = _summary_dim(run)
    for c in chunks:
        flops += counts.mdn_fit_flops(width, hidden, D, K, 100, 100,
                                      c - int(c * 0.8))
    real = (iteration + 1) * int(bs["realTrajs"])
    flops += counts.mdn_forward_flops(width, hidden, D, K, real)
    if real > 1:
        rows = (10000 // real) * real
        flops += counts.mdn_fit_flops(1, [128, 128], D, K, 100, 500,
                                      rows - int(rows * 0.8))
        flops += counts.mdn_forward_flops(1, [128, 128], D, K, 1)
    return float(flops)


def mfu(run, loop: str) -> Optional[float]:
    """Percent of the card's peak that the window's network FLOPs make
    over the window's seconds less the profiler's own start and stop: the
    float32 peak, or the TF32 one where the run lets cuBLAS use it."""
    seconds = run.window_s - run.trace_overhead_s
    if run.loop != loop or not (seconds > 0) or run.units <= 0:
        return None
    if loop == "ppo":
        flops = _ppo_flops(run, run.units)
    else:
        warm = int(run.traffic["warmup_iterations"])
        flops = sum(adr_iteration_flops(run, warm + i)
                    for i in range(run.units))
    peak = counts.TF32_FLOPS_PER_S if run.tf32 else counts.F32_FLOPS_PER_S
    return 100.0 * flops / (seconds * peak)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics)."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
