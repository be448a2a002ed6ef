"""The port's hand-written CUDA libraries, declared once (``LIBRARIES``),
and what their wrappers share: the device pick, the check of a launch's
tensors, and the launch itself with its count; and the counts of every
kernel, and of the work that the programs register to count beside them
(``count_at_replay``), read and set by name.

A wrapper runs its plain version when every tensor it is given lies on
the CPU (``on_cpu``), and otherwise launches its kernel: ``check_cuda``
refuses tensors that are not float32 on one CUDA device, and ``launch``
raises on a CUDA error, so nothing falls back to the plain version.

A new kernel is one row of ``LIBRARIES`` and a wrapper that calls
``launch`` with the row's entry name.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from . import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class Entry(NamedTuple):
    """A C entry point: its symbol and its ctypes argument types, as its
    ``extern "C"`` prototype in csrc/ declares them. A kernel returns a
    CUDA error, takes the stream last and is counted; a query
    (``kernel=False``) returns nothing and is not counted."""
    symbol: str
    argtypes: Tuple
    kernel: bool = True


class Library(NamedTuple):
    sources: Tuple[str, ...]  # under csrc/
    entries: Dict[str, Entry]


_HALF = (_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P)

# Every library by the name ``build.load_library`` builds it under, its
# entries by the name ``launch_counts`` gives their launches.
LIBRARIES: Dict[str, Library] = {
    "rff_features": Library(("rff_features.cu",), {
        "rff_features": Entry("rff_features_f32",
                              (_P, _P, _P, _I, _I, _I, _F, _P))}),
    "spd_lanes": Library(("spd_lanes.cu",), {
        "spd_factor_lanes": Entry("spd_factor_lanes_f32",
                                  (_P, _P, _I, _I, _P)),
        "spd_substitute_lanes": Entry("spd_substitute_lanes_f32",
                                      (_P, _P, _P, _I, _I, _I, _P)),
        "spd_solve_lanes": Entry("spd_solve_lanes_f32",
                                 (_P, _P, _P, _I, _I, _P))}),
    "tree_ltdl": Library(("tree_ltdl.cu",), {
        "tree_ltdl_factor": Entry("tree_ltdl_factor_f32",
                                  (_P, *[_I] * 5, _P, _P, _P, _I, _P)),
        "tree_ltdl_substitute": Entry("tree_ltdl_substitute_f32",
                                      (_P, *[_I] * 5, *[_P] * 4, _I, _I,
                                       _P))}),
    "tree_half": Library(("tree_half.cu",), {
        "tree_ltdl_upsolve": Entry("tree_ltdl_upsolve_f32", _HALF),
        "tree_ltdl_downsolve": Entry("tree_ltdl_downsolve_f32", _HALF),
        "tree_half_plan": Entry("tree_half_plan",
                                (*[_I] * 4, *[ctypes.POINTER(_I)] * 4),
                                kernel=False)}),
    "integrate": Library(("integrate.cu",), {
        "integrate_clamp": Entry("integrate_clamp_f32",
                                 (*[_P] * 7, *[_I] * 5, *[_F] * 3, _P))}),
}

_LIBRARY_OF = {name: lib for lib, spec in LIBRARIES.items()
               for name in spec.entries}
# Kernel launches made by this process, by entry name, in table order.
COUNTS: Dict[str, int] = {name: 0 for spec in LIBRARIES.values()
                          for name, e in spec.entries.items() if e.kernel}
_BOUND: Dict[str, Dict[str, Callable]] = {}


def bind(library: str, lib: ctypes.CDLL, names=None) -> Dict[str, Callable]:
    """Sets on ``lib`` (a build of ``library``'s sources, or of another
    source with the same C interface) the signatures the table gives the
    entries ``names`` (default: all of them); returns them by name."""
    entries = LIBRARIES[library].entries
    fns = {}
    for name in entries if names is None else names:
        e = entries[name]
        fn = getattr(lib, e.symbol)
        fn.argtypes = list(e.argtypes)
        fn.restype = ctypes.c_int if e.kernel else None
        fns[name] = fn
    return fns


def load(library: str) -> Dict[str, Callable]:
    """``library``'s entries by name: built at first use
    (``build.load_library``; threads asking for one library wait for one
    build) and bound once."""
    if library not in _BOUND:
        lib = build.load_library(library, LIBRARIES[library].sources)
        _BOUND[library] = bind(library, lib)
    return _BOUND[library]


def entry_fn(name: str) -> Callable:
    """The bound C function of entry ``name``, its library loaded."""
    return load(_LIBRARY_OF[name])[name]


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


def launch(name: str, dev, *args):
    """Calls kernel entry ``name`` with ``*args`` and ``dev``'s current
    stream; raises on a nonzero CUDA error and counts the launch in
    ``COUNTS[name]``."""
    fn = entry_fn(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{_LIBRARY_OF[name]} {name} kernel launch "
                           f"failed: CUDA error {err}")
    COUNTS[name] += 1


# Module dicts of counts that a CUDA graph adds again at each replay beside
# the kernels' launches, by prefix (``count_at_replay``).
_AT_REPLAY: Dict[str, dict] = {}


def count_at_replay(prefix: str, stats: dict):
    """Registers a module's counter dict: a CUDA graph that captured work
    counted in ``stats`` adds the capture's counts to it at every replay.
    ``replay_counts`` names its keys ``<prefix>.<key>``."""
    _AT_REPLAY[prefix] = stats


def _counters() -> Dict[str, Tuple[dict, str]]:
    """Where each count lives, by name: (a dict, its key). The kernels'
    launches (``COUNTS``), then the keys of the dicts registered with
    ``count_at_replay``."""
    return {**{name: (COUNTS, name) for name in COUNTS},
            **{f"{prefix}.{k}": (d, k)
               for prefix, d in _AT_REPLAY.items() for k in d}}


def launch_counts() -> Dict[str, int]:
    """Every hand-written kernel's launches by this process, by entry
    name, in ``LIBRARIES`` order: ``rff_features``, ``spd_<kind>_lanes``,
    ``tree_ltdl_<kind>``, ``integrate_clamp``."""
    return dict(COUNTS)


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
