"""The port's RFF projection: its plain version against the JAX Pallas
kernel (interpret mode, as tests/test_ops.py runs it) and the JAX
reference, the wrapper's dispatch on CPU tensors, and, on a CUDA card
only, the hand-written kernel against the plain version."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayes_sim_ig_tpu.ops.rff_kernel import (
    rff_features_pallas, rff_features_reference as jax_reference,
)
from bayes_sim_ig_tpu_torch.ops import rff_kernel

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5  # tests/test_ops.py:31-32


def _inputs(b, d, m, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, d).astype(np.float32),
            (rs.randn(d, m) * 0.3).astype(np.float32))


@pytest.mark.parametrize("b,d,m", [(100, 40, 100), (17, 3, 64),
                                   (50, 302, 100)])
def test_reference_matches_jax_pallas_and_reference(b, d, m):
    x, coeff = _inputs(b, d, m)
    a = 0.1
    got = rff_kernel.rff_features_reference(torch.from_numpy(x),
                                            torch.from_numpy(coeff), a)
    assert got.shape == (b, 2 * m)
    pallas = rff_features_pallas(jnp.asarray(x), jnp.asarray(coeff), a,
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_reference(x, coeff, a)),
                               rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    x, coeff = _inputs(8, 5, 6)
    before = rff_kernel.LAUNCHES
    got = rff_kernel.rff_features(torch.from_numpy(x),
                                  torch.from_numpy(coeff), 0.5)
    want = rff_kernel.rff_features_reference(torch.from_numpy(x),
                                             torch.from_numpy(coeff), 0.5)
    assert torch.equal(got, want)
    assert rff_kernel.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, coeff = _inputs(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rff_kernel.rff_features_cuda(torch.from_numpy(x),
                                     torch.from_numpy(coeff), 1.0)


def test_rff_module_features_match_jax():
    from bayes_sim_ig_tpu.models.rff import RFF as JaxRFF
    from bayes_sim_ig_tpu_torch.models.rff import RFF
    jrff = JaxRFF(20, 6, 2.0, quasi_random=True, kernel="Matern32")
    trff = RFF(20, 6, 2.0, quasi_random=True, kernel="Matern32")
    # Halton draws are deterministic: the two packages draw one coeff.
    np.testing.assert_array_equal(trff.coeff.numpy(), jrff.coeff)
    assert trff.coeff.is_contiguous()  # the CUDA wrapper takes only these
    x, _ = _inputs(9, 6, 1)
    np.testing.assert_allclose(trff(torch.from_numpy(x)).numpy(),
                               np.asarray(jrff.to_features(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m", [(100, 302, 100), (1, 302, 100),
                                   (17, 3, 64)])
def test_kernel_matches_plain_on_card(b, d, m):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, coeff = _inputs(b, d, m)
    xc, cc = torch.from_numpy(x).cuda(), torch.from_numpy(coeff).cuda()
    before = rff_kernel.LAUNCHES
    got = rff_kernel.rff_features(xc, cc, 0.1)
    want = rff_kernel.rff_features_reference(xc, cc, 0.1)
    torch.cuda.synchronize()
    assert rff_kernel.LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
