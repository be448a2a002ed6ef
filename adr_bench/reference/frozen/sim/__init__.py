# Frozen copy of bayes_sim_ig_tpu_torch/sim/__init__.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""The tasks of the benchmark's cells, built as ``make_env`` builds them.
A task ``Name`` lives in the module of its snake-case name here
(``ShadowHand`` in ``shadow_hand.py``): a cell on another task adds its
module."""

import importlib
import re

import torch

from .task import (CLIP_ACTIONS, CLIP_OBSERVATIONS, EnvState, Task,
                   env_full_reset, env_step)


def task_module(task_name: str):
    snake = re.sub(r"(?<!^)(?=[A-Z])", "_", task_name).lower()
    return importlib.import_module(f"{__name__}.{snake}")


def make_task(task_name: str, cfg: dict, device) -> Task:
    """The task of ``make_env(task_name, cfg, device=device)``."""
    task = getattr(task_module(task_name), task_name)(
        cfg, device=torch.device(device))
    task.asymmetric_observations = bool(
        cfg.get("env", {}).get("asymmetric_observations", False))
    if task.asymmetric_observations:
        params = torch.as_tensor(task.params_spec.defaults[None],
                                 dtype=torch.float32, device=task.device)
        state = task.init_state(torch.Generator(device=task.device), params)
        task.state_dim = int(task.privileged_state(state, params).shape[1])
    return task
