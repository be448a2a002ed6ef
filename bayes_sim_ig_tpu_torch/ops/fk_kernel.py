"""One physics substep's forward kinematics in one launch.

``forward_kinematics_cuda`` launches the hand-written kernel of
``csrc/forward_kinematics.cu`` on env-first (N, nq) positions, (N, nv)
velocities and the (N,) geometry scale, and returns the ``Kinematics``
fields env-last. Its plain version is the PyTorch chain it replaces,
``physics/dynamics.py::forward_kinematics`` on CPU tensors, which runs this
kernel on the card with the model's tables from ``dynamics._structure``.
There is no fallback: a CUDA tensor the kernel does not take raises, and
so does a failed build or launch.
"""

from __future__ import annotations

import torch

from .launch import check_cuda, launch

# The kernel's limits: a lane an env's link (and the virtual root), 1-dof
# joint and dof.
MAX_LANES = 32


def forward_kinematics_cuda(q: torch.Tensor, v: torch.Tensor,
                            scale: torch.Tensor, itab: torch.Tensor,
                            ftab: torch.Tensor, nb: int, nj: int,
                            n_free: int, n_jump: int, chain_max: int):
    """Launches the kernel: q (N, nq), v (N, nv), ``scale`` (N,) (an
    expanded view is read as it is); ``itab`` int32 and ``ftab`` float32,
    the model's tables (see the source); nb links, nj 1-dof joints, n_free
    free joints, ``n_jump`` pointer-jumping rounds and ``chain_max`` chain
    rounds. Returns fresh (R_w, p_w, v, S_o, Sv_o, V_o, o), env-last, views
    of one buffer. A model past the kernel's lanes (nb + 1, nj or nv above
    32) raises."""
    check_cuda("forward_kinematics_cuda", q, v, scale, ftab, no_grad=True)
    if q.ndim != 2 or v.ndim != 2 or v.shape[0] != q.shape[0] \
            or scale.shape != q.shape[:1]:
        raise ValueError(f"forward_kinematics_cuda needs q (N, nq), v (N, "
                         f"nv) and scale (N,), got {tuple(q.shape)}, "
                         f"{tuple(v.shape)}, {tuple(scale.shape)}")
    (N, nq), nv = q.shape, v.shape[1]
    if max(nb + 1, nj, nv) > MAX_LANES:
        raise ValueError(f"forward_kinematics_cuda takes nb + 1, nj and nv "
                         f"up to {MAX_LANES}, got {nb + 1}, {nj}, {nv}")
    if itab.dtype != torch.int32 or itab.device != q.device:
        raise ValueError(f"forward_kinematics_cuda needs an int32 table on "
                         f"{q.device}, got {itab.dtype} on {itab.device}")
    q, v = q.contiguous(), v.contiguous()
    out = torch.empty(24 * nb + 12 * nv, N, dtype=q.dtype, device=q.device)
    launch("forward_kinematics", q.device, q.data_ptr(), v.data_ptr(),
           scale.data_ptr(), out.data_ptr(), itab.data_ptr(),
           ftab.data_ptr(), scale.stride(0), nb, nj, nv, nq, n_free, n_jump,
           chain_max, N)
    rows = (9 * nb, 3 * nb, 6 * nb, 6 * nv, 6 * nv, 6 * nb)
    shapes = ((nb, 3, 3), (nb, 3), (nb, 6), (nv, 6), (nv, 6), (nb, 6))
    fields = [f.view(*s, N) for f, s in zip(out.split(rows), shapes)]
    return (*fields, fields[1][0])
