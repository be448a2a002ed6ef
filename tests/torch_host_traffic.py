"""The dispatch mode that finds host traffic in a body a CUDA graph
captures. It imports no JAX, so that the card's tests can use it where JAX
is absent."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Ops that stop a capture on a card: a host read of a device value, an
# index whose size depends on the data, and a tensor made from host data
# (its host-to-device copy).
_SYNCING = {"aten._local_scalar_dense.default", "aten.nonzero.default",
            "aten.lift_fresh.default", "aten.lift_fresh_copy.default"}


class NoHostTraffic(TorchDispatchMode):
    """Records every op of _SYNCING and every boolean-mask index run under
    it (in ``hits``)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        mask_index = name.startswith("aten.index") and any(
            isinstance(a, (list, tuple)) and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool
                for t in a) for a in args)
        if name in _SYNCING or mask_index:
            self.hits.append(name)
        return func(*args, **(kwargs or {}))
