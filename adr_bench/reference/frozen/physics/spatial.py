# Frozen copy of bayes_sim_ig_tpu_torch/physics/spatial.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Spatial (Plücker) vector algebra for articulated rigid-body dynamics.

Port of ``bayes_sim_ig_tpu/physics/spatial.py``. Conventions follow
Featherstone's "Rigid Body Dynamics Algorithms": motion vectors are
[angular; linear] 6-vectors expressed in body coordinates; a coordinate
transform ``X = (E, r)`` maps vectors from frame A to frame B where ``E``
rotates A-coordinates into B-coordinates and ``r`` is the position of B's
origin expressed in A.

Functions take single vectors unless their docstring says they broadcast
over leading batch dims.
"""

from __future__ import annotations

import torch


def hat(v):
    """3-vector -> skew-symmetric matrix (cross-product operator); a
    (3, ...) input gives (3, 3, ...)."""
    x, y, z = v[0], v[1], v[2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y]),
                        torch.stack([z, zero, -x]),
                        torch.stack([-y, x, zero])])


# ----------------------------------------------------------------------- #
# Quaternions (w, x, y, z)
# ----------------------------------------------------------------------- #
def quat_to_rot(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3) (maps body
    coords to world). Works on single quaternions and batches alike."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, -2)


def rot_to_quat(R):
    """Rotation matrix (3, 3, ...) -> unit quaternion (4, ...) in
    (w, x, y, z), leading-axes layout (pass an env-last (3, 3, N) rotation,
    get (4, N)). Branchless max-pivot Shepperd construction: all four pivot
    candidates are computed and the numerically largest is selected per
    element; the result is canonical (w >= 0)."""
    r00, r01, r02 = R[0, 0], R[0, 1], R[0, 2]
    r10, r11, r12 = R[1, 0], R[1, 1], R[1, 2]
    r20, r21, r22 = R[2, 0], R[2, 1], R[2, 2]
    qw2 = torch.clamp(1.0 + r00 + r11 + r22, min=0.0)
    qx2 = torch.clamp(1.0 + r00 - r11 - r22, min=0.0)
    qy2 = torch.clamp(1.0 - r00 + r11 - r22, min=0.0)
    qz2 = torch.clamp(1.0 - r00 - r11 + r22, min=0.0)
    cand = torch.stack([
        torch.stack([qw2, r21 - r12, r02 - r20, r10 - r01]),
        torch.stack([r21 - r12, qx2, r01 + r10, r02 + r20]),
        torch.stack([r02 - r20, r01 + r10, qy2, r12 + r21]),
        torch.stack([r10 - r01, r02 + r20, r12 + r21, qz2]),
    ])                                                    # (4, 4, ...)
    mags = torch.stack([qw2, qx2, qy2, qz2])              # (4, ...)
    # One-hot by comparison (F.one_hot syncs with the host on the CPU).
    arange4 = torch.arange(4, device=R.device).reshape(
        (4,) + (1,) * (mags.ndim - 1))
    pick = (torch.argmax(mags, 0, keepdim=True) == arange4).to(R.dtype)
    q = (cand * pick[:, None]).sum(0)                     # (4, ...)
    q = q / (torch.sqrt((q * q).sum(0, keepdim=True)) + 1e-12)
    return torch.where(q[0] < 0, -q, q)


def quat_mul(a, b):
    """Hamilton product; broadcasts over leading dims of (..., 4) inputs."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_integrate(q, omega_world, dt):
    """Integrates a unit quaternion by a world-frame angular velocity."""
    omega4 = torch.cat([torch.zeros_like(omega_world[..., :1]), omega_world],
                       -1)
    dq = 0.5 * quat_mul(omega4, q)
    q = q + dt * dq
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)


def quat_rotate(q, v):
    return quat_to_rot(q) @ v


def quat_rotate_inv(q, v):
    return quat_to_rot(q).mT @ v


def quat_from_axis_angle(axis, angle):
    half = 0.5 * torch.as_tensor(angle, dtype=axis.dtype)
    return torch.cat([torch.cos(half)[None], torch.sin(half) * axis])


# ----------------------------------------------------------------------- #
# Spatial transforms: represented as (E, r) pairs.
# ----------------------------------------------------------------------- #
def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def xform_motion(E, r, v):
    """Applies X = (E, r) to a motion vector [w; vl]."""
    w, vl = v[:3], v[3:]
    return torch.cat([E @ w, E @ (vl - _cross(r, w))])


def xform_force(E, r, f):
    """Applies the force transform X* to a force vector [n; f]."""
    n, fl = f[:3], f[3:]
    return torch.cat([E @ (n - _cross(r, fl)), E @ fl])


def inv_xform_motion(E, r, v):
    """Applies X^{-1} to a motion vector."""
    w, vl = v[:3], v[3:]
    w_p = E.T @ w
    return torch.cat([w_p, E.T @ vl + _cross(r, w_p)])


def inv_xform_force(E, r, f):
    """Applies (X*)^{-1}: brings a force from child coords back to parent."""
    n, fl = f[:3], f[3:]
    fl_p = E.T @ fl
    return torch.cat([E.T @ n + _cross(r, fl_p), fl_p])


def xform_compose(E1, r1, E2, r2):
    """(E2, r2) after (E1, r1): first A->B via 1, then B->C via 2; returns
    the A->C transform."""
    return E2 @ E1, r1 + E1.T @ r2


# ----------------------------------------------------------------------- #
# Spatial cross products and inertia.
# ----------------------------------------------------------------------- #
def crm(v, m):
    """Motion-cross-motion: v x m."""
    w, vl = v[:3], v[3:]
    mw, ml = m[:3], m[3:]
    return torch.cat([_cross(w, mw), _cross(w, ml) + _cross(vl, mw)])


def crf(v, f):
    """Motion-cross-force: v x* f."""
    w, vl = v[:3], v[3:]
    n, fl = f[:3], f[3:]
    return torch.cat([_cross(w, n) + _cross(vl, fl), _cross(w, fl)])


def spatial_inertia(mass, com, inertia_com):
    """6x6 spatial inertia of a body about its frame origin, given mass,
    COM offset (3,) and rotational inertia about the COM (3,3)."""
    c = hat(com)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    top_left = inertia_com + mass * c @ c.T
    return torch.cat([torch.cat([top_left, mass * c], 1),
                      torch.cat([mass * c.T, mass * eye], 1)], 0)


def mul_inertia(I, v):
    return I @ v
