"""Shared set-up of the benchmark's own tests (``python -m pytest
adr_bench/tests``): the harness's modules on the path, one torch thread,
no matplotlib (the card's machine has none, and the loop's posterior
plots of 111 parameters take minutes), and cells cut to a size the CPU
runs in seconds."""

import copy
import io
import os
import sys
import time

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

sys.modules.setdefault("matplotlib", None)

SEED = 3000000019  # above 2**31, as the benchmark's seeds are


def tiny(cell):
    """``cell`` cut to a few envs and steps: the same loop, task and
    check at a size the CPU runs in seconds."""
    cell = copy.copy(cell)
    cfg = copy.deepcopy(cell.config)
    env = cfg["cfg_env"]
    env["env"]["numEnvs"] = 4
    env["env"]["episodeLength"] = 10
    if env["env"].get("observationType") == "full_state":
        # The port's compact layout: the full layout's summaries (105,002
        # features) make each MDN fit on the CPU take a minute.
        env["env"]["observationType"] = "full"
    env["bayessim"].update(trainTrajs=8, trainTrajLen=5, realEvals=2,
                           realIters=3)
    cfg["cfg_train"]["learn"]["nsteps"] = 2
    cell.config = cfg
    traffic = dict(cell.traffic)
    if traffic["loop"] == "adr":
        traffic["ppo_iterations"] = 1
    else:
        traffic.update(iterations_per_call=3, check_iterations=[0, 2],
                       trace_iterations=[1, 1])
    cell.traffic = traffic
    return cell


def run_tiny(cell, seconds=0.0, seed=SEED, tmp_path=None):
    """One run of ``cell`` on the CPU; returns run_cell's output."""
    import torch
    import run as bench_run
    torch.set_num_threads(1)
    workdir = str(tmp_path) if tmp_path is not None else os.path.join(
        BENCH_DIR, "..", "runs", "adr_bench_tests")
    return bench_run.run_cell(cell, seed, seconds, False, "cpu", time.time(),
                              workdir, io.StringIO())


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
