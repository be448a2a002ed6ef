"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version (the version CPU tensors take)."""

from .rff_kernel import rff_features, rff_features_reference
from .spd_kernel import (spd_factor_lanes, spd_solve, spd_solve_lanes,
                         spd_substitute_lanes)

__all__ = ["rff_features", "rff_features_reference", "spd_factor_lanes",
           "spd_solve", "spd_solve_lanes", "spd_substitute_lanes"]
