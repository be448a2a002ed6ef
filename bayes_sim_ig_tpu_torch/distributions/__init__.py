"""Distribution algebra (host) and device-side samplers for BayesSim."""

from .halton import halton_sequence
from .pdf import (
    Uniform, Gaussian, MoG, discrete_sample, fit_mog,
)
from .device import (
    DeviceUniform, DeviceMoG, to_device_distr, sample_distr,
)

__all__ = [
    "halton_sequence", "Uniform", "Gaussian", "MoG", "discrete_sample",
    "fit_mog", "DeviceUniform", "DeviceMoG", "to_device_distr",
    "sample_distr",
]
