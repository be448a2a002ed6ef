# Frozen copy of bayes_sim_ig_tpu_torch/dr/__init__.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Domain randomization: flat param specs and obs/action noise."""

from .params_spec import (
    ParamsSpec, TaskNames, build_params_spec, make_name, check_operation,
)
from .noise import NoiseConfig, make_noise_config, apply_noise

__all__ = ["ParamsSpec", "TaskNames", "build_params_spec", "make_name",
           "check_operation", "NoiseConfig", "make_noise_config",
           "apply_noise"]
