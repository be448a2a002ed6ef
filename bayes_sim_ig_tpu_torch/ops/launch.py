"""What the wrappers of the hand-written kernels share: the device pick,
the check of a launch's tensors, and the launch itself with its count;
and the counts of every kernel, and of the work that the programs
register to count beside them (``count_at_replay``), read and set by
name.

A wrapper runs its plain version when every tensor it is given lies on
the CPU (``on_cpu``), and otherwise launches its kernel: ``check_cuda``
refuses tensors that are not float32 on one CUDA device, and ``launch``
raises on a CUDA error, so nothing falls back to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check_cuda(name: str, *tensors, no_grad: bool = False):
    """float32 tensors on one CUDA device; with ``no_grad`` none may
    require a gradient (a kernel without a backward)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name} takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    if no_grad and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} has no backward: its inputs must not "
                         f"require a gradient")


def launch(library: str, fns: Dict[str, Callable], counts: Dict[str, int],
           entry: str, dev, *args):
    """Calls C entry ``fns[entry](*args, stream)`` on ``dev``'s current
    stream; raises on a nonzero CUDA error and counts the launch in
    ``counts[entry]``."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fns[entry](*args, stream)
    if err != 0:
        raise RuntimeError(f"{library} {entry} kernel launch failed: CUDA "
                           f"error {err}")
    counts[entry] += 1


# Module dicts of counts that a CUDA graph adds again at each replay beside
# the kernels' launches, by prefix (``count_at_replay``).
_AT_REPLAY: Dict[str, dict] = {}


def count_at_replay(prefix: str, stats: dict):
    """Registers a module's counter dict: a CUDA graph that captured work
    counted in ``stats`` adds the capture's counts to it at every replay.
    ``replay_counts`` names its keys ``<prefix>.<key>``."""
    _AT_REPLAY[prefix] = stats


def _counters(registered: bool = True) -> Dict[str, Tuple[dict, str]]:
    """Where each count lives, by name: (a dict, its key). The kernels'
    launches by kernel name (the RFF count is a global of its module, so
    its dict is the module's namespace), then, with ``registered``, the
    keys of the dicts registered with ``count_at_replay``."""
    from . import integrate_kernel, rff_kernel, spd_kernel, tree_solve
    counters = {"rff_features": (vars(rff_kernel), "LAUNCHES"),
                **{f"spd_{e}_lanes": (spd_kernel.LAUNCHES, e)
                   for e in spd_kernel.LAUNCHES},
                **{f"tree_ltdl_{e}": (tree_solve.LAUNCHES, e)
                   for e in tree_solve.LAUNCHES},
                "integrate_clamp": (integrate_kernel.LAUNCHES,
                                    "integrate_clamp")}
    if registered:
        counters.update({f"{prefix}.{k}": (d, k)
                         for prefix, d in _AT_REPLAY.items() for k in d})
    return counters


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launches by this process, by kernel
    name: ``rff_features``, ``spd_<entry>_lanes``, ``tree_ltdl_<entry>``,
    ``integrate_clamp``."""
    return {name: d[key] for name, (d, key) in _counters(False).items()}


def replay_counts() -> Dict[str, int]:
    """Every count a CUDA graph adds again at each replay: the kernels'
    launches (``launch_counts``) and the registered counts, such as
    ``physics.<route>_<kind>`` (``physics/dynamics.py::STATS``) and
    ``sim.env_steps`` (``sim/task.py::STATS``)."""
    return {name: d[key] for name, (d, key) in _counters().items()}


def set_launch_counts(counts: Dict[str, int]):
    """Sets the counts named in ``counts`` (from ``launch_counts`` or
    ``replay_counts``): a CUDA graph puts back what its capture counted."""
    for name, (d, key) in _counters().items():
        if name in counts:
            d[key] = counts[name]


def launch_increments(before: Dict[str, int],
                      after: Dict[str, int]) -> Tuple[Tuple[dict, str, int],
                                                      ...]:
    """The counts that rose from ``before`` to ``after`` (two
    ``launch_counts()`` or two ``replay_counts()``), the nonzero ones, as
    (dict, key, count): a CUDA graph adds each ``count`` to ``dict[key]``
    at every replay, in place, building nothing and importing nothing."""
    return tuple((d, key, after[name] - before[name])
                 for name, (d, key) in _counters().items()
                 if name in before and after[name] != before[name])
