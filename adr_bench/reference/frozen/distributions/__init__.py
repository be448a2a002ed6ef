# Frozen copy of bayes_sim_ig_tpu_torch/distributions/__init__.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Device-side samplers of the sampling distributions."""

from .device import DeviceUniform, DeviceMoG, sample_distr

__all__ = ["DeviceUniform", "DeviceMoG", "sample_distr"]
