"""One physics substep's integration and joint-limit clamp in one launch.

``integrate_clamp_cuda`` launches the hand-written kernel of
``csrc/integrate.cu`` on env-first (N, nq) positions and (N, nv)
velocities and accelerations. Its plain version is the PyTorch chain it
replaces, ``physics/dynamics.py::integrate`` followed by
``clamp_limits``: ``dynamics.integrate_and_clamp`` runs that chain on CPU
tensors, and this kernel on the card, with the model's tables from
``dynamics._structure``. There is no fallback: a CUDA tensor the kernel
does not take raises, and so does a failed build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from .launch import check_cuda, launch

# Kernel launches made by this process; read and reset by callers that
# must show a run went through the kernel.
LAUNCHES = {"integrate_clamp": 0}

_FNS = None


def _kernel_fns():
    global _FNS
    if _FNS is None:
        from .build import load_library
        lib = load_library("integrate", ["integrate.cu"])
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = lib.integrate_clamp_f32
        fn.argtypes = [ptr] * 7 + [i32] * 5 + [ctypes.c_float] * 3 + [ptr]
        fn.restype = ctypes.c_int
        _FNS = {"integrate_clamp": fn}
    return _FNS


def integrate_clamp_cuda(q: torch.Tensor, v: torch.Tensor, qdd: torch.Tensor,
                         dt: float, table: torch.Tensor,
                         limits: torch.Tensor, n_free: int, max_lin: float,
                         max_ang: float):
    """Launches the kernel: q (N, nq), v and qdd (N, nv), the step ``dt``;
    ``table`` int32 (n_free + n_j1, 2), the (q, v) offsets of the free
    joints and then of the 1-dof joints, ``limits`` (n_j1, 3), each 1-dof
    joint's max velocity, lower and upper limit, and the free bodies'
    linear and angular speed caps. Returns fresh (q_new, v_new). An env's
    rows past the kernel's shared memory (nq + 2 nv > 384 floats) fail the
    launch."""
    check_cuda("integrate_clamp_cuda", q, v, qdd, limits, no_grad=True)
    if q.ndim != 2 or v.ndim != 2 or qdd.shape != v.shape \
            or q.shape[0] != v.shape[0]:
        raise ValueError(f"integrate_clamp_cuda needs q (N, nq), v and qdd "
                         f"(N, nv), got {tuple(q.shape)}, {tuple(v.shape)}, "
                         f"{tuple(qdd.shape)}")
    n_j1 = limits.shape[0]
    if table.dtype != torch.int32 or table.device != q.device \
            or tuple(table.shape) != (n_free + n_j1, 2) \
            or tuple(limits.shape) != (n_j1, 3):
        raise ValueError(f"integrate_clamp_cuda needs an int32 table "
                         f"({n_free} + {n_j1}, 2) and limits ({n_j1}, 3) "
                         f"on {q.device}, got {table.dtype} "
                         f"{tuple(table.shape)} on {table.device} and "
                         f"{tuple(limits.shape)}")
    q, v, qdd = q.contiguous(), v.contiguous(), qdd.contiguous()
    table, limits = table.contiguous(), limits.contiguous()
    (N, nq), nv = q.shape, v.shape[1]
    q_out, v_out = torch.empty_like(q), torch.empty_like(v)
    launch("integrate", _kernel_fns(), LAUNCHES, "integrate_clamp", q.device,
           q.data_ptr(), v.data_ptr(), qdd.data_ptr(), q_out.data_ptr(),
           v_out.data_ptr(), table.data_ptr(), limits.data_ptr(), n_free,
           n_j1, nq, nv, N, float(dt), float(max_lin), float(max_ang))
    return q_out, v_out
