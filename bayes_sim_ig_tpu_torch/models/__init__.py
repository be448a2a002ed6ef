"""Density models: mixture density networks and RFF feature maps."""

from .mdnn import MDNN, MDNNNet, mdn_loss, mdn_train_step, init_mdnn_params
from .mdrff import MDRFF
from .rff import RFF

_MODEL_REGISTRY = {"MDNN": MDNN, "MDRFF": MDRFF}


def get_model_class(name: str):
    """Resolves a model class by name."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"Unknown model class '{name}'. "
                       f"Available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name]


__all__ = ["MDNN", "MDNNNet", "MDRFF", "RFF", "mdn_loss", "mdn_train_step",
           "init_mdnn_params", "get_model_class"]
