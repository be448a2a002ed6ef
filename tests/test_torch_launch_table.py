"""``ops/launch.py``'s table of the hand-written CUDA libraries against
the sources it builds, on the CPU: each library declares every
``extern "C"`` entry of its sources, with the prototype's arguments one
for one (a pointer as a pointer, an ``int`` as ``c_int``, a ``float`` as
``c_float``), and nothing else; every source under csrc/ is some
library's; and ``launch_counts`` names the nine kernels in the table's
order. A wrong signature would otherwise show only on a card."""

import ctypes
import glob
import os
import re

import pytest

from bayes_sim_ig_tpu_torch.ops import build, launch
from bayes_sim_ig_tpu_torch.ops.launch import LIBRARIES, launch_counts

_PROTO = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)')


def _prototypes(sources):
    """{symbol: (return type, [parameter declarations])} of the sources."""
    out = {}
    for src in sources:
        with open(os.path.join(build.CSRC_DIR, src)) as f:
            text = f.read()
        for ret, symbol, params in _PROTO.findall(text):
            out[symbol] = (ret, [p.strip() for p in params.split(",")])
    return out


def _ctype(param):
    if "*" in param:
        return "pointer"
    return {"int": "int", "float": "float"}[param.split()[0]]


def _kind(argtype):
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float"}[argtype]


@pytest.mark.parametrize("library", list(LIBRARIES))
def test_the_table_declares_each_prototype(library):
    spec = LIBRARIES[library]
    protos = _prototypes(spec.sources)
    assert protos, f"no extern \"C\" entry in {spec.sources}"
    assert {e.symbol for e in spec.entries.values()} == set(protos)
    for name, e in spec.entries.items():
        ret, params = protos[e.symbol]
        assert [_kind(t) for t in e.argtypes] == [_ctype(p) for p in params], \
            name
        assert ret == ("int" if e.kernel else "void"), name
        if e.kernel:  # the stream, last
            assert params[-1] == "void* stream", name


def test_every_source_is_a_library():
    sources = {os.path.basename(p)
               for p in glob.glob(os.path.join(build.CSRC_DIR, "*.cu"))}
    assert sources == {s for spec in LIBRARIES.values()
                       for s in spec.sources}


def test_launch_counts_names_the_nine_kernels_in_order():
    assert list(launch_counts()) == [
        "rff_features", "spd_factor_lanes", "spd_substitute_lanes",
        "spd_solve_lanes", "tree_ltdl_factor", "tree_ltdl_substitute",
        "tree_ltdl_upsolve", "tree_ltdl_downsolve", "integrate_clamp"]
    assert "tree_half_plan" not in launch.COUNTS  # a query, not counted
