"""The port's Halton C extension (``bayes_sim_ig_tpu_torch/ops/native/
halton.c``): built here from the ``Extension`` that ``setup.py`` names,
into this test's temporary directory (so it never touches the tree another
test builds in), then held bit for bit to the port's numpy path and to the
JAX package's ``halton_sequence``."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "bayes_sim_ig_tpu_torch.ops.native._halton_native"

_BUILD = """
import sys
from setuptools import Distribution, Extension
ext = Extension({name!r}, sources=[{src!r}], extra_compile_args=["-O3"])
dist = Distribution({{"name": "halton_native", "ext_modules": [ext]}})
cmd = dist.get_command_obj("build_ext")
cmd.build_temp = sys.argv[1]
cmd.build_lib = sys.argv[2]
cmd.ensure_finalized()
cmd.run()
print(cmd.get_ext_fullpath({name!r}))
"""


@pytest.fixture(scope="module")
def native_halton(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halton_build")
    src = os.path.join(REPO, "bayes_sim_ig_tpu_torch", "ops", "native",
                       "halton.c")
    out = subprocess.run(
        [sys.executable, "-c", _BUILD.format(name=NAME, src=src),
         str(tmp / "temp"), str(tmp / "lib")],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    so = out.stdout.strip().splitlines()[-1]
    assert os.path.isfile(so) and so.startswith(str(tmp)), so
    spec = importlib.util.spec_from_file_location(NAME, so)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both_paths(native, **kw):
    import bayes_sim_ig_tpu_torch.distributions.halton as H
    old = H._halton_native
    try:
        H._halton_native = native
        got = H.halton_sequence(**kw)
        H._halton_native = None
        want = H.halton_sequence(**kw)
    finally:
        H._halton_native = old
    return got, want


@pytest.mark.parametrize("kw", [
    dict(n_samples=4096, dim=7, skip=1, scramble=True),
    dict(n_samples=100, dim=3, skip=5, scramble=False),
    dict(n_samples=1000, dim=100, skip=1, scramble=True),
])
def test_native_matches_the_ports_numpy_path(native_halton, kw):
    got, want = _both_paths(native_halton, **kw)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == (kw["n_samples"], kw["dim"])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scramble", [True, False])
def test_native_matches_the_jax_package(native_halton, scramble):
    from bayes_sim_ig_tpu.distributions.halton import halton_sequence
    got, _ = _both_paths(native_halton, n_samples=2000, dim=13, skip=1,
                         scramble=scramble)
    np.testing.assert_array_equal(got, halton_sequence(2000, 13, skip=1,
                                                       scramble=scramble))


def test_setup_names_the_ports_extension():
    with open(os.path.join(REPO, "setup.py")) as f:
        text = f.read()
    assert NAME in text
    assert "bayes_sim_ig_tpu_torch/ops/native/halton.c" in text
