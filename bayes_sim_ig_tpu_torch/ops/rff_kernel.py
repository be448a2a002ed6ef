"""Random-Fourier-feature projection ``a * [cos(x @ coeff), sin(x @ coeff)]``.

``rff_features`` launches the hand-written CUDA kernel
(``csrc/rff_features.cu``) on a CUDA tensor and runs the plain PyTorch
version, ``rff_features_reference``, on a CPU tensor. There is no
fallback: a CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches made by this process; read and reset by callers that
# must show a run went through the kernel.
LAUNCHES = 0

_FN = None
# Frequency tiles of 32 lie on gridDim.y (row tiles on gridDim.x bound
# nothing an int32 B can reach).
_MAX_FREQS = 65535 * 32


def rff_features_reference(x: torch.Tensor, coeff: torch.Tensor,
                           a: float) -> torch.Tensor:
    """Plain PyTorch version (the same math as models/rff.py)."""
    inner = x @ coeff
    return a * torch.cat([torch.cos(inner), torch.sin(inner)], dim=-1)


def _kernel_fn():
    global _FN
    if _FN is None:
        from .build import load_library
        lib = load_library("rff_features", ["rff_features.cu"])
        fn = lib.rff_features_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def rff_features_cuda(x: torch.Tensor, coeff: torch.Tensor,
                      a: float) -> torch.Tensor:
    """Launches the CUDA kernel; raises on any input it does not take."""
    global LAUNCHES
    if x.device.type != "cuda" or coeff.device != x.device:
        raise ValueError(f"rff_features_cuda needs x and coeff on one CUDA "
                         f"device, got {x.device} and {coeff.device}")
    if x.dtype != torch.float32 or coeff.dtype != torch.float32:
        raise TypeError(f"rff_features_cuda takes float32, got {x.dtype} "
                        f"and {coeff.dtype}")
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
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), coeff.data_ptr(), out.data_ptr(), b, d, m,
                 float(a), stream)
    if err != 0:
        raise RuntimeError(f"rff_features kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)}, coeff "
                           f"{tuple(coeff.shape)}")
    LAUNCHES += 1
    return out


def rff_features(x: torch.Tensor, coeff: torch.Tensor,
                 a: float) -> torch.Tensor:
    """x (B, d) @ coeff (d, m) -> (B, 2m): the kernel on CUDA, the plain
    version on the CPU."""
    if x.device.type == "cpu" and coeff.device.type == "cpu":
        return rff_features_reference(x, coeff, a)
    return rff_features_cuda(x, coeff, a)
