"""What the wrappers of the SPD and tree kernels share: the device pick,
the check of a launch's tensors, and the launch itself with its count;
and the counts of every kernel, read and set by name.

A wrapper runs its plain version when every tensor it is given lies on
the CPU (``on_cpu``), and otherwise launches its kernel: ``check_cuda``
refuses tensors that are not float32 on one CUDA device, and ``launch``
raises on a CUDA error, so nothing falls back to the plain version.
"""

from __future__ import annotations

from typing import Callable, Dict

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


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launches by this process, by kernel
    name: ``rff_features``, ``spd_<entry>_lanes``, ``tree_ltdl_<entry>``."""
    from . import rff_kernel, spd_kernel, tree_solve
    return {"rff_features": rff_kernel.LAUNCHES,
            **{f"spd_{e}_lanes": c for e, c in spd_kernel.LAUNCHES.items()},
            **{f"tree_ltdl_{e}": c for e, c in tree_solve.LAUNCHES.items()}}


def set_launch_counts(counts: Dict[str, int]):
    """Sets the counts ``launch_counts`` reads (a CUDA graph puts back
    what its capture counted, and adds it again at every replay)."""
    from . import rff_kernel, spd_kernel, tree_solve
    rff_kernel.LAUNCHES = counts["rff_features"]
    for e in spd_kernel.LAUNCHES:
        spd_kernel.LAUNCHES[e] = counts[f"spd_{e}_lanes"]
    for e in tree_solve.LAUNCHES:
        tree_solve.LAUNCHES[e] = counts[f"tree_ltdl_{e}"]
