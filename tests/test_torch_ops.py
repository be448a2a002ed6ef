"""The port's RFF projection: its plain version against the JAX Pallas
kernel (interpret mode, as tests/test_ops.py runs it) and the JAX
reference, both against float64 at large phases, the wrapper's dispatch
on CPU tensors, the bound counts, and, on a CUDA card only, the
hand-written kernel against the plain version (every row tile, vector
width and a misaligned base)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bayes_sim_ig_tpu.ops.rff_kernel import (
    rff_features_pallas, rff_features_reference as jax_reference,
)
from bayes_sim_ig_tpu_torch.ops import bounds, rff_kernel
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-5  # tests/test_ops.py:31-32


@pytest.mark.parametrize("b", [1, 100, 1000])
def test_bound_hand_counts(b):
    """x (B, 302) and coeff (302, 100) read once, (B, 200) written once;
    2 B d m FLOPs of the product and 4 B m of the epilogue."""
    f = bounds.rff_features(b, 302, 100)
    assert f.bytes == 4 * (b * 302 + 302 * 100 + b * 200)
    assert f.flops == 2 * b * 302 * 100 + 4 * b * 100
    assert f.ms == pytest.approx(1e3 * max(f.bytes / 3.35e12,
                                           f.flops / 67e12))
    assert f.by == ("bytes" if b < 1000 else "operations")


def _inputs(b, d, m, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, d).astype(np.float32),
            (rs.randn(d, m) * 0.3).astype(np.float32))


def _large_phase_inputs(b, d, m, phase=500.0):
    """x scaled so that max |x @ coeff| is ``phase`` radians."""
    x, coeff = _inputs(b, d, m, seed=1)
    scale = phase / np.abs(x.astype(np.float64) @ coeff).max()
    return (x * scale).astype(np.float32), coeff


def _float64_features_and_bound(x, coeff, a):
    """a [cos, sin](x @ coeff) in float64, and the float32 bound
    a d 2^-23 sum_k |x_k coeff_k| + ATOL: a sum of d float32 products
    taken in any order stays within it, and at phases of hundreds of
    radians no fixed rtol tells a reordered sum from a wrong one."""
    x64, c64 = x.astype(np.float64), coeff.astype(np.float64)
    inner = x64 @ c64
    want = a * np.concatenate([np.cos(inner), np.sin(inner)], axis=-1)
    mag = a * x.shape[1] * 2.0 ** -23 * (np.abs(x64) @ np.abs(c64)) + ATOL
    return want, np.concatenate([mag, mag], axis=-1), np.abs(inner).max()


def _assert_within(got, want, bound):
    excess = np.abs(np.asarray(got, np.float64) - want) - bound
    assert excess.max() <= 0.0, f"exceeds the float64 bound by {excess.max()}"


@pytest.mark.parametrize("b,d,m", [(100, 40, 100), (17, 3, 64),
                                   (50, 302, 100), (1, 302, 100),
                                   (100, 302, 100), (200, 302, 100)])
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


@pytest.mark.parametrize("b,d,m", [(1, 302, 100), (100, 302, 100)])
def test_large_phases_within_float64_bound(b, d, m):
    x, coeff = _large_phase_inputs(b, d, m)
    a = 0.1
    want, bound, max_phase = _float64_features_and_bound(x, coeff, a)
    assert 400.0 < max_phase < 600.0
    got = rff_kernel.rff_features_reference(torch.from_numpy(x),
                                            torch.from_numpy(coeff), a)
    _assert_within(got.numpy(), want, bound)
    _assert_within(jax_reference(x, coeff, a), want, bound)


def test_cpu_tensors_take_the_plain_version_without_launching():
    x, coeff = _inputs(8, 5, 6)
    before = launch_counts()
    got = rff_kernel.rff_features(torch.from_numpy(x),
                                  torch.from_numpy(coeff), 0.5)
    want = rff_kernel.rff_features_reference(torch.from_numpy(x),
                                             torch.from_numpy(coeff), 0.5)
    assert torch.equal(got, want)
    assert launch_counts() == before


def test_kernel_wrapper_refuses_cpu_tensors():
    x, coeff = _inputs(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rff_kernel.rff_features_cuda(torch.from_numpy(x),
                                     torch.from_numpy(coeff), 1.0)


def test_rff_module_features_match_jax():
    from bayes_sim_ig_tpu.models.rff import RFF as JaxRFF
    from bayes_sim_ig_tpu_torch.models.rff import RFF
    jrff = JaxRFF(20, 6, 2.0, quasi_random=True, kernel="Matern32")
    trff = RFF(20, 6, 2.0, quasi_random=True, kernel="Matern32",
               device="cpu")
    # Halton draws are deterministic: the two packages draw one coeff.
    np.testing.assert_array_equal(trff.coeff.numpy(), jrff.coeff)
    assert trff.coeff.is_contiguous()  # the CUDA wrapper takes only these
    x, _ = _inputs(9, 6, 1)
    np.testing.assert_allclose(trff(torch.from_numpy(x)).numpy(),
                               np.asarray(jrff.to_features(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


# B spans the four row tiles (1, 8, 16 and 32 rows; on 132 SMs at m = 100
# 1 row up to B = 33, 32 rows from B = 529) and their ragged edges;
# d = 302 takes 8-B copies of x, 301 4-B copies, 3 a slice shorter than
# one warp's share of K.
@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m", [(17, 3, 64)] + [
    (b, d, 100) for b in (1, 7, 33, 34, 100, 200, 300, 1000, 1025)
    for d in (302, 301, 3)])
def test_kernel_matches_plain_on_card(b, d, m):
    _needs_card()
    x, coeff = _inputs(b, d, m)
    xc, cc = torch.from_numpy(x).cuda(), torch.from_numpy(coeff).cuda()
    before = launch_counts()["rff_features"]
    got = rff_kernel.rff_features(xc, cc, 0.1)
    want = rff_kernel.rff_features_reference(xc, cc, 0.1)
    torch.cuda.synchronize()
    assert launch_counts()["rff_features"] == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


# x one row into a larger tensor, as the test split x_data[n_train:] is:
# a base offset of 1,208 B (d = 302, 8-B aligned) or 1,204 B (d = 301,
# 4-B aligned).
@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 100, 200])
@pytest.mark.parametrize("d", [302, 301])
def test_kernel_takes_a_misaligned_base_on_card(b, d):
    _needs_card()
    big, coeff = _inputs(b + 1, d, 100)
    bigc = torch.from_numpy(big).cuda()
    xc, cc = bigc[1:], torch.from_numpy(coeff).cuda()
    assert xc.is_contiguous() and xc.data_ptr() - bigc.data_ptr() == 4 * d
    got = rff_kernel.rff_features(xc, cc, 0.1)
    want = rff_kernel.rff_features_reference(xc.clone(), cc, 0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 100, 200, 1000])
def test_kernel_large_phases_within_float64_bound_on_card(b):
    _needs_card()
    x, coeff = _large_phase_inputs(b, 302, 100)
    want, bound, _ = _float64_features_and_bound(x, coeff, 0.1)
    xc, cc = torch.from_numpy(x).cuda(), torch.from_numpy(coeff).cuda()
    got = rff_kernel.rff_features(xc, cc, 0.1)
    plain = rff_kernel.rff_features_reference(xc, cc, 0.1)
    _assert_within(got.cpu().numpy(), want, bound)
    _assert_within(plain.cpu().numpy(), want, bound)
