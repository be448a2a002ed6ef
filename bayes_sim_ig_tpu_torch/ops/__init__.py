"""Hand-written CUDA kernels for the port, each beside its plain PyTorch
version (the version CPU tensors take)."""

from .rff_kernel import rff_features, rff_features_reference

__all__ = ["rff_features", "rff_features_reference"]
