"""Random-Fourier-feature projection ``a * [cos(x @ coeff), sin(x @ coeff)]``.

``rff_features`` launches the hand-written CUDA kernel
(``csrc/rff_features.cu``) on a CUDA tensor and runs the plain PyTorch
version, ``rff_features_reference``, on a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import torch

from .launch import check_cuda, launch, on_cpu

# Frequency tiles of 32 lie on gridDim.y (row tiles on gridDim.x bound
# nothing an int32 B can reach).
_MAX_FREQS = 65535 * 32


def rff_features_reference(x: torch.Tensor, coeff: torch.Tensor,
                           a: float) -> torch.Tensor:
    """Plain PyTorch version (the same math as models/rff.py)."""
    inner = x @ coeff
    return a * torch.cat([torch.cos(inner), torch.sin(inner)], dim=-1)


def rff_features_cuda(x: torch.Tensor, coeff: torch.Tensor,
                      a: float) -> torch.Tensor:
    """Launches the CUDA kernel; raises on any input it does not take."""
    check_cuda("rff_features_cuda", x, coeff)
    if x.ndim != 2 or coeff.ndim != 2 or x.shape[1] != coeff.shape[0]:
        raise ValueError(f"rff_features_cuda needs x (B, d) and coeff (d, m),"
                         f" got {tuple(x.shape)} and {tuple(coeff.shape)}")
    if not (x.is_contiguous() and coeff.is_contiguous()):
        raise ValueError("rff_features_cuda needs contiguous x and coeff")
    b, d = x.shape
    m = coeff.shape[1]
    if m > _MAX_FREQS:
        raise ValueError(f"rff_features_cuda takes at most {_MAX_FREQS} "
                         f"frequencies (the grid's y limit), got {m}")
    out = torch.empty((b, 2 * m), dtype=torch.float32, device=x.device)
    launch("rff_features", x.device, x.data_ptr(), coeff.data_ptr(),
           out.data_ptr(), b, d, m, float(a))
    return out


def rff_features(x: torch.Tensor, coeff: torch.Tensor,
                 a: float) -> torch.Tensor:
    """x (B, d) @ coeff (d, m) -> (B, 2m): the kernel on CUDA, the plain
    version on the CPU."""
    if on_cpu(x, coeff):
        return rff_features_reference(x, coeff, a)
    return rff_features_cuda(x, coeff, a)
