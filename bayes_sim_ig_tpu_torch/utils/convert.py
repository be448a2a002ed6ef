"""Weights carried across between the JAX package and this one.

The JAX package keeps a dense layer as ``{"w": (in, out), "b": (out,)}``
numpy/jax arrays; ``nn.Linear`` keeps ``weight`` as (out, in). These
functions map whole parameter trees of the JAX layout to ``state_dict``s
of the port's modules and back, as numpy, which is also the layout the
checkpoints of both packages pickle. An RFF ``coeff`` (d, m) goes across
as it is, and so do the fields of the physics' ``DynParams``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _linear_from_jax(prefix: str, layer) -> Dict[str, torch.Tensor]:
    w = np.asarray(layer["w"], np.float32)
    b = np.asarray(layer["b"], np.float32)
    return {f"{prefix}.weight": torch.from_numpy(w.T.copy()),
            f"{prefix}.bias": torch.from_numpy(b.copy())}


def _linear_to_jax(layer) -> Dict[str, np.ndarray]:
    return {"w": layer.weight.detach().cpu().numpy().T.copy(),
            "b": layer.bias.detach().cpu().numpy().copy()}


def mdnn_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX MDNN params {"trunk": [...], "pi", "mu", "diag"[, "lower"]} ->
    a state_dict for ``models.mdnn.MDNNNet``."""
    sd: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["trunk"]):
        sd.update(_linear_from_jax(f"trunk.{i}", layer))
    for head in ("pi", "mu", "diag", "lower"):
        if head in tree:
            sd.update(_linear_from_jax(head, tree[head]))
    return sd


def mdnn_params_to_jax(net) -> Dict:
    """``MDNNNet`` -> the JAX MDNN params tree, as numpy."""
    tree: Dict = {"trunk": [_linear_to_jax(l) for l in net.trunk]}
    for head in ("pi", "mu", "diag", "lower"):
        layer = getattr(net, head)
        if layer is not None:
            tree[head] = _linear_to_jax(layer)
    return tree


def actor_critic_params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX actor-critic params {"actor": [...], "critic": [...],
    "log_std"} -> a state_dict for ``rl.networks.ActorCritic``."""
    sd: Dict[str, torch.Tensor] = {}
    for part in ("actor", "critic"):
        for i, layer in enumerate(tree[part]):
            sd.update(_linear_from_jax(f"{part}.{i}", layer))
    sd["log_std"] = torch.from_numpy(
        np.asarray(tree["log_std"], np.float32).copy())
    return sd


def actor_critic_params_to_jax(net) -> Dict:
    """``ActorCritic`` -> the JAX actor-critic params tree, as numpy."""
    tree: Dict[str, List] = {
        part: [_linear_to_jax(l) for l in getattr(net, part)]
        for part in ("actor", "critic")}
    tree["log_std"] = net.log_std.detach().cpu().numpy().copy()
    return tree


def dynparams_from_jax(dp, device="cpu"):
    """A JAX ``DynParams`` (or any sequence of its 11 fields in order, as
    numpy or jax arrays) -> the port's ``DynParams``: float32 tensors on
    ``device``, shapes unchanged."""
    from ..physics.model import DynParams
    return DynParams(*[torch.as_tensor(np.array(x, np.float32),
                                       device=device) for x in dp])


def dynparams_to_jax(dp) -> Dict[str, np.ndarray]:
    """The port's ``DynParams`` -> its fields as float32 numpy arrays by
    name (``DynParams(**out)`` in the JAX package)."""
    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in dp._asdict().items()}
