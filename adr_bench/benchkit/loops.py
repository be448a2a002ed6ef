"""The general generator: it drives the port's loop as a traffic file
says, over a window of ``seconds``, and returns what the metrics and the
check read.

A traffic file names its ``loop`` and that loop's parameters:

  * ``adr``: the user's ADR loop, ``bayes_sim_main.main`` on the cell's
    configuration, with ``ppo_iterations`` PPO iterations an ADR
    iteration. The first ``warmup_iterations`` ADR iterations are set-up
    (they build the kernels and capture the programs). The window starts
    at the end of the last of them and keeps starting ADR iterations
    while less than ``seconds`` has passed; it closes when the last one
    ends. The loop's end of an iteration is seen through its writer
    (``perf/sec_per_adr_iter``, written after ``predict`` returns numpy).
  * ``ppo``: PPO training at the prior, as the ADR loop's RL call under
    ``ftuneRL``: ``process_ppo`` on ``make_env``, then ``PPO.run`` in calls
    of ``iterations_per_call`` PPO iterations that continue the counter.
    ``warmup_iterations`` PPO iterations in one call are set-up; the window
    runs whole calls while less than ``seconds`` has passed.

Either way, nothing compiles in the window that did not compile in
set-up but what the loop itself captures there (the ADR loop's refit
captures a fit for each new row count), and ``captures`` counts it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .taps import BSimTap, CollectTap, MemWriter, Patches, PPOTap, Spans
from .trace import Slice, Tracer


class StopLoop(Exception):
    """Raised from the writer's hook to end the ADR loop after the window's
    last iteration."""


@dataclass
class Run:
    """One run, as the metric readers and the check see it."""
    cell: str
    loop: str
    seed: int
    seconds: float
    traced: bool
    device: str
    config: dict
    traffic: dict
    process_start: float = 0.0
    setup_s: float = math.nan
    window_s: float = math.nan
    trace_overhead_s: float = 0.0  # profiler start and stop in the window
    units: int = 0                 # ADR or PPO iterations in the window
    failed: int = 0
    env_steps: int = 0             # rollout env steps in the window (ppo)
    ppo_iter_s: List[float] = field(default_factory=list)
    iter_s: List[float] = field(default_factory=list)  # the loop's own
    spans: Dict[int, Dict[str, float]] = field(default_factory=dict)
    captures: int = 0
    peak_mem_bytes: int = 0
    slice: Optional[Slice] = None
    tf32: bool = False
    snapshots: Dict[str, object] = field(default_factory=dict)
    task: Dict[str, object] = field(default_factory=dict)

    @property
    def env_cfg(self) -> dict:
        return self.config["cfg_env"]

    @property
    def train_cfg(self) -> dict:
        return self.config["cfg_train"]


def _draw(run: Run, key: str, lo: int, hi: int) -> int:
    """A whole number in [lo, hi) drawn from the seed (host side)."""
    return random.Random(f"{run.seed}:{key}").randrange(lo, hi)


def _sync(device: str):
    if device.startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def _captures() -> int:
    from bayes_sim_ig_tpu_torch.utils import step_graph
    return int(sum(s["captures"] for s in step_graph.STATS.values()))


def _peak(device: str) -> int:
    if not device.startswith("cuda"):
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())


def drive(run: Run, workdir: str, log) -> None:
    """Runs ``run.traffic``'s loop; fills ``run``."""
    import torch
    run.tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    loop = run.traffic["loop"]
    if loop == "adr":
        _drive_adr(run, workdir, log)
    elif loop == "ppo":
        _drive_ppo(run, workdir, log)
    else:
        raise ValueError(f"traffic loop {loop!r} is not 'adr' or 'ppo'")


def _write_cfgs(run: Run, workdir: str):
    os.makedirs(workdir, exist_ok=True)
    paths = []
    for key in ("cfg_env", "cfg_train"):
        path = os.path.join(workdir, key + ".json")
        with open(path, "w") as f:
            json.dump(run.config[key], f)  # JSON is YAML: the loader reads it
        paths.append(path)
    return paths


def _drive_adr(run: Run, workdir: str, log) -> None:
    import numpy as np
    import torch
    from bayes_sim_ig_tpu_torch import bayes_sim_main as bsm
    from bayes_sim_ig_tpu_torch.utils import collect

    traffic = run.traffic
    warmup = int(traffic["warmup_iterations"])
    env_path, train_path = _write_cfgs(run, workdir)
    argv = ["--task", run.config["task"], "--cfg_env", env_path,
            "--cfg_train", train_path,
            "--max_iterations", str(int(traffic["ppo_iterations"])),
            "--seed", str(run.seed), "--rl_device", run.device,
            "--logdir", os.path.join(workdir, "logs")]
    tracer = Tracer(run.traced)
    state = {"iter": 0, "t0": None, "captures0": 0, "ppo": None}
    spans = Spans(run.traced, tracer, lambda: state["iter"] - warmup)
    patches = Patches()
    first = warmup  # the window's first ADR iteration: checked and traced
    steps = int(run.env_cfg["bayessim"]["trainTrajLen"])

    def on_fit_end(chunks_done):
        if chunks_done == 1 and state["iter"] == first:
            tracer.env_steps = steps
            tracer.stop()

    bsim_tap = BSimTap(patches, spans, on_fit_end)
    collect_tap = CollectTap(
        patches, lambda kind, n: _draw(run, "collect_step " + kind, 0, n))
    rewards: Dict[int, Dict[str, float]] = {}
    losses: Dict[int, float] = {}

    def hook(tag, value, step):
        if tag.startswith("SurrogateReal/real_rewards_"):
            rewards.setdefault(step, {})[tag.rsplit("_", 1)[1]] = value
        elif tag == "BayesSim/train_loss":
            losses[step] = value
        elif tag == "perf/sec_per_adr_iter":
            if step >= warmup:
                run.iter_s.append(value)
            _adr_iteration_end(step)

    def _adr_iteration_end(step):
        state["iter"] = step + 1
        if step == warmup - 1:
            _sync(run.device)
            state["t0"] = time.perf_counter()
            run.setup_s = time.time() - run.process_start
            state["captures0"] = _captures()
            tap = state["ppo"]
            n_ppo = int(traffic["ppo_iterations"])
            nsteps = int(run.train_cfg["learn"]["nsteps"])
            tap.arm(_draw(run, "ppo_iteration", 0, n_ppo),
                    _draw(run, "rollout_step", 0, nsteps))
            n_chunks = -(-int(run.env_cfg["bayessim"]["trainTrajs"])
                         // 1000)
            chunk = _draw(run, "fit_chunk", 0, n_chunks)
            bsim_tap.arm(chunk)
            collect_tap.arm(chunk, run.env_cfg["bayessim"]["collectPolicy"])
        elif step >= warmup:
            bsim_tap.disarm()
            collect_tap.disarm()
            state["ppo"].target = None
            run.units += 1
            if (not math.isfinite(rewards.get(step, {}).get("mean",
                                                             math.nan))
                    or not math.isfinite(losses.get(step, math.nan))):
                run.failed += 1
            if time.perf_counter() - state["t0"] >= run.seconds:
                _close()
                raise StopLoop()

    def _close():
        _sync(run.device)
        run.window_s = time.perf_counter() - state["t0"]
        run.captures = _captures() - state["captures0"]
        run.peak_mem_bytes = _peak(run.device)

    def process_ppo(*args, **kwargs):
        ppo = orig_process_ppo(*args, **kwargs)
        state["ppo"] = PPOTap(ppo, patches, tracer)
        patches.set(ppo, "reinit", spans.wrap("ppo_run", ppo.reinit))
        patches.set(ppo, "run", spans.wrap("ppo_run", ppo.run))
        return ppo

    def render_env0(*args, **kwargs):
        if state["iter"] == first:
            tracer.start("frames to the first training fit")
        with tracer.label("frames"):
            return orig_render(*args, **kwargs)

    orig_process_ppo = bsm.process_ppo
    orig_render = collect._render_env0
    patches.set(bsm, "_make_writer",
                lambda logdir, sub="bsim": MemWriter(hook))
    patches.set(bsm, "process_ppo", process_ppo)
    patches.set(bsm, "collect_trajectories", spans.wrap(
        "collect", collect_tap.trajectories(bsm.collect_trajectories)))
    patches.set(collect, "_render_env0", spans.wrap("frames", render_env0))
    np.random.seed(run.seed % 2 ** 32)
    torch.manual_seed(run.seed)
    out = None
    try:
        with contextlib.redirect_stdout(log):
            out = bsm.main(argv)
        # The loop ran out of iterations before the window closed.
        _close()
    except StopLoop:
        pass
    finally:
        tracer.stop()
        patches.restore()
    run.spans = {k: dict(v) for k, v in spans.seconds.items() if k >= 0}
    run.trace_overhead_s = tracer.overhead_s
    run.slice = tracer.finish()
    tap = state["ppo"]
    run.snapshots = {"step": tap.step, "update": tap.update,
                     "fits": bsim_tap.fits, "predict": bsim_tap.predict,
                     "rounds": collect_tap.rounds,
                     "real_rewards": rewards.get(first),
                     "main_return": out and {
                         k: out[k] for k in ("real_rewards", "posterior")}}
    out = None
    for bsim in bsim_tap.bsims:
        bsim.free_graphs()
    bsim_tap.bsims.clear()
    _free_programs(tap.ppo)
    run.task = _task_shape(tap.ppo)


def _drive_ppo(run: Run, workdir: str, log) -> None:
    import numpy as np
    import torch
    from bayes_sim_ig_tpu_torch.distributions import pdf, to_device_distr
    from bayes_sim_ig_tpu_torch.rl import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env

    traffic = run.traffic
    per_call = int(traffic["iterations_per_call"])
    nsteps = int(run.train_cfg["learn"]["nsteps"])
    tracer = Tracer(run.traced)
    patches = Patches()
    state = {"in_window": False, "k": 0}
    lo, hi = traffic["check_iterations"]
    trace_at = int(traffic["trace_iterations"][0])
    trace_n = int(traffic["trace_iterations"][1])

    def hook(tag, value, step):
        if not state["in_window"]:
            return
        if tag == "rl/env_steps_per_sec":
            run.ppo_iter_s.append(envs * nsteps / value)
        elif tag == "rl/loss":
            # The window's k-th PPO iteration ended (k from 1).
            state["k"] += 1
            k = state["k"]
            if not math.isfinite(value):
                run.failed += 1
            if k == trace_at:
                tracer.start(f"PPO iterations {k + 1}-{k + trace_n} of "
                             f"the window")
            elif k == trace_at + trace_n:
                tracer.env_steps = trace_n * nsteps
                tracer.stop()

    np.random.seed(run.seed % 2 ** 32)
    torch.manual_seed(run.seed)
    with contextlib.redirect_stdout(log):
        env = make_env(run.config["task"], run.env_cfg, seed=run.seed,
                       device=run.device)
        envs = env.task.num_envs
        spec = env.task.params_spec
        env.set_distr(to_device_distr(pdf.Uniform(spec.lows, spec.highs),
                                      spec.lows, spec.highs,
                                      device=run.device))
        writer = MemWriter(hook)
        ppo = process_ppo(env, run.train_cfg, os.path.join(workdir, "logs"),
                          writer=writer, seed=run.seed)
        tap = PPOTap(ppo, patches, tracer)
        try:
            ppo.run(num_learning_iterations=int(
                traffic["warmup_iterations"]), log_interval=1)
            _sync(run.device)
            run.setup_s = time.time() - run.process_start
            captures0 = _captures()
            tap.arm(_draw(run, "ppo_iteration", lo, hi),
                    _draw(run, "rollout_step", 0, nsteps))
            state["in_window"] = True
            t0 = time.perf_counter()
            while True:
                it = ppo.current_learning_iteration
                ppo.run(num_learning_iterations=it + per_call,
                        log_interval=1)
                run.units += per_call
                if time.perf_counter() - t0 >= run.seconds:
                    break
            _sync(run.device)
            run.window_s = time.perf_counter() - t0
            state["in_window"] = False
            run.captures = _captures() - captures0
            run.peak_mem_bytes = _peak(run.device)
        finally:
            tracer.stop()
            patches.restore()
    run.env_steps = run.units * envs * nsteps
    run.trace_overhead_s = tracer.overhead_s
    run.slice = tracer.finish()
    run.snapshots = {"step": tap.step, "update": tap.update}
    run.task = _task_shape(ppo)
    _free_programs(ppo)


def _task_shape(ppo) -> dict:
    task = ppo.task
    return {"obs_dim": int(task.obs_dim), "act_dim": int(task.act_dim),
            "num_envs": int(task.num_envs),
            "critic_in": int(ppo._state_dim or task.obs_dim),
            "asymmetric": bool(ppo.asymmetric)}


def _free_programs(ppo):
    """Drops the loop's captured programs and their memory before the
    reference runs."""
    import gc
    import torch
    ppo.free_update_graphs()
    ppo.vec_env.free_step_graphs()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
