"""Forward dynamics for articulated trees: FK, RNEA bias, CRBA mass matrix,
dense SPD solve, semi-implicit integration.

Port of ``bayes_sim_ig_tpu/physics/dynamics.py``, the same math in the same
layout:

  * ENV-LAST layout: inside the engine every tensor carries the env batch
    on the LAST axis — R_w is (nb, 3, 3, N), joint subspaces are
    (nv, 6, N) — and public functions take env-first (N, nq) state (or
    single-env (nq,)), transposing once at the boundary;
  * small fixed-size contractions (3x3, 6x6) are broadcast products summed
    over the contraction axis, a couple of kernels each;
  * tree-structure contractions (ancestor masks, one-hot gathers and
    scatters) are ``_fold``: one float32 ``tensordot`` of a static
    0/1 matrix with the leading axis;
  * spatial inertias ride in the packed 10-parameter form of
    ``_i10_direct`` on the hot path;
  * spatial quantities live in world Plücker coordinates about a floating
    reference point (the first root's position);
  * FK composes transforms by pointer jumping: ceil(log2(depth + 1))
    rounds of one-hot gather + compose;
  * joint damping and PD derivative gains are implicit (``dt * d`` on the
    left-hand side);
  * the (M + diag) qdd = rhs solve factors with the column Cholesky of
    ``ops/spd_kernel.py`` when the dof tree's ancestor pairs fill more
    than 0.66 of the lower triangle, as Ant's and Anymal's do, and with
    the branch-sparse L^T D L of ``ops/tree_solve.py`` over the ancestor
    pairs alone for sparser trees (Humanoid, ShadowHand). Each is a CUDA
    kernel on the card. ``STATS`` counts the solves by route and kind,
    and the calls of ``forward_kinematics``.

Everything is a function of (q, v, tau, params), so domain randomization is
batched parameter tensors. Static tables of a model are built once per
device and cached on the model.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .model import ArticulatedModel, DynParams
from ..ops.fk_kernel import forward_kinematics_cuda
from ..ops.integrate_kernel import integrate_clamp_cuda
from ..ops.launch import count_at_replay, on_cpu
from ..ops.spd_kernel import spd_factor_lanes, spd_substitute_lanes
from ..ops.tree_solve import (
    ancestor_pairs, tree_factor, tree_substitute, tree_tables,
)

# The JAX package picks its branch-sparse LTDL over the dense Cholesky
# when the dof tree's ancestor pairs fill at most this share of the
# lower triangle (a crossover measured on its accelerator).
TREE_SOLVE_MAX_FILL = 0.66
# ... and the LTDL's left-looking form for the plain version when the mean
# proper-ancestor chain depth is at least this (Humanoid 8.0, ShadowHand
# 3.3; fewer, larger ops on deep chains). The kernel has one form.
TREE_LL_MIN_MEAN_DEPTH = 5.0

# Mass-matrix solve calls of this process, by route ("dense": the SPD
# kernels; "tree": the L^T D L ones) and kind: a factor, or a substitute
# of one or more right-hand sides against a factor; and ``kinematics``,
# the calls of ``forward_kinematics`` (the kernel or the chain). Counted
# on the host as the calls are made; a CUDA graph adds what its capture
# counted at every replay (``count_at_replay``), so the counts stay those
# of the work the card ran.
STATS = {"dense_factor": 0, "dense_substitute": 0, "tree_factor": 0,
         "tree_substitute": 0, "kinematics": 0}
count_at_replay("physics", STATS)


# --------------------------------------------------------------------- #
# Env-last helpers: tensors are (.., structure dims .., N).
# --------------------------------------------------------------------- #
def _mm(A, B):
    """Matmul over two structure axes: (.., n, n, N) x (.., n, n, N)."""
    return (A[..., :, :, None, :] * B[..., None, :, :, :]).sum(-3)


def _mmT(A, B):
    """A^T @ B over two structure axes."""
    return (A[..., :, :, None, :] * B[..., :, None, :, :]).sum(-4)


def _mv(A, x):
    """Matvec: (.., n, n, N) x (.., n, N) -> (.., n, N)."""
    return (A * x[..., None, :, :]).sum(-2)


def _mvT(A, x):
    """A^T x."""
    return (A * x[..., :, None, :]).sum(-3)


def _cross(a, b):
    """Cross product over the second-to-last (3-sized) axis: (.., 3, N)."""
    return torch.linalg.cross(a, b, dim=-2)


def _fold(mat, x):
    """Static-mask contraction over the leading axis: mat (r, s), x
    (s, d1, .., N) -> (r, d1, .., N), in float32."""
    return torch.tensordot(mat, x, dims=1)


def _quat_to_rot_rows(q4):
    """(4, N) quaternion rows -> (3, 3, N) rotation (body->world)."""
    w, x, y, z = q4[0], q4[1], q4[2], q4[3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], 0),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], 0),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], 0),
    ]
    return torch.stack(rows, 0)


def _quat_mul_rows(a, b):
    """(4, N) x (4, N) Hamilton product."""
    aw, ax, ay, az = a[0], a[1], a[2], a[3]
    bw, bx, by, bz = b[0], b[1], b[2], b[3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], 0)


def _hat_rows(c):
    """(.., 3, N) -> (.., 3, 3, N) skew matrices (env-last)."""
    cx, cy, cz = c[..., 0, :], c[..., 1, :], c[..., 2, :]
    zero = torch.zeros_like(cx)
    return torch.stack([torch.stack([zero, -cz, cy], -2),
                        torch.stack([cz, zero, -cx], -2),
                        torch.stack([-cy, cx, zero], -2)], -3)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


class Kinematics(NamedTuple):
    """Per-link world poses and world-Plücker velocity-level quantities,
    ENV-LAST (trailing N; squeezed away for single-env calls)."""
    R_w: torch.Tensor   # (nb, 3, 3, N) link->world rotations
    p_w: torch.Tensor   # (nb, 3, N) link origins in world
    v: torch.Tensor     # (nb, 6, N) link spatial velocities [w; vl], BODY
    #                     coords at the link origin (contacts/tasks read it)
    S_o: torch.Tensor   # (nv, 6, N) world-Plücker dof motion subspaces
    Sv_o: torch.Tensor  # (nv, 6, N) S_o rows scaled by the dof velocities
    V_o: torch.Tensor   # (nb, 6, N) world-Plücker link velocities
    o: torch.Tensor     # (3, N) floating reference point (first root)


def _promote(params: DynParams) -> DynParams:
    return DynParams(*[torch.as_tensor(a)[None] for a in params])


def _squeeze_last(kin: Kinematics) -> Kinematics:
    return Kinematics(*[a[..., 0] for a in kin])


def _promote_kin(kin: Kinematics) -> Kinematics:
    return Kinematics(*[a[..., None] for a in kin])


def _structure(model: ArticulatedModel, device) -> dict:
    """Static one-hot matrices, masks and index tensors of ``model`` on
    ``device``, built once and cached on the model."""
    device = torch.device(device)
    cache = model.__dict__.setdefault("_torch_structure", {})
    s = cache.get(device)
    if s is not None:
        return s
    nb, nv = model.nb, model.nv
    nj = model.j1_links.size
    # Pointer-jumping FK: after round k every link's accumulated transform
    # covers 2^k ancestors, so the tree composes in ceil(log2(depth+1))
    # rounds, each one one-hot gather + one transform composition.
    depth_max = int(model.depth.max())
    ptr = np.append(model.parent_pad, nb)  # virtual root nb -> itself
    jump_gathers = []
    covered = 1
    while covered < depth_max + 1:
        g = np.zeros((nb + 1, nb + 1), np.float32)
        g[np.arange(nb + 1), ptr] = 1.0
        jump_gathers.append(g)
        ptr = ptr[ptr]
        covered *= 2
    # Only the LAST dof of each joint chain scatters its composed (G, u)
    # to its owning link row (chains of length 1 without phantom links).
    j1_to_links = np.zeros((nb, nj), np.float32)
    last = np.flatnonzero(model.j1_last)
    j1_to_links[model.j1_links[last], last] = 1.0
    j1_to_v = np.zeros((nv, nj), np.float32)
    j1_to_v[model.j1_v, np.arange(nj)] = 1.0
    j1_prev_gather = np.zeros((nj, nj), np.float32)
    j1_prev_gather[np.arange(nj), np.maximum(model.j1_prev, 0)] = 1.0
    chain_masks = [(model.j1_chain_pos == p).astype(np.float32)
                   for p in range(model.j1_chain_maxpos + 1)]
    # Parent-link gather for the dof anchors/axes (row nb of the padded
    # pose arrays is the identity virtual root).
    j1_par_gather = np.zeros((nj, nb + 1), np.float32)
    j1_par_gather[np.arange(nj),
                  np.append(model.parent_pad, nb)[model.j1_links]] = 1.0
    free = model.free_list
    free_to_links = np.zeros((nb, len(free)), np.float32)
    free_to_v = np.zeros((nv, 6 * len(free)), np.float32)
    for f_i, (i, qi, vi) in enumerate(free):
        free_to_links[i, f_i] = 1.0
        free_to_v[vi:vi + 6, 6 * f_i:6 * (f_i + 1)] = np.eye(6)
    fixed_rows = np.ones(nb, np.float32)                 # neither j1 nor free
    fixed_rows[model.j1_links] = 0.0
    for (i, qi, vi) in free:
        fixed_rows[i] = 0.0
    # Rodrigues terms of each 1-dof axis: R(a, q) = cos I + sin K + (1-cos)
    # a a^T with K = hat(a).
    ax = model.j1_axis.astype(np.float32)
    K = np.zeros((nj, 3, 3), np.float32)
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -ax[:, 2], ax[:, 1], -ax[:, 0]
    K[:, 1, 0], K[:, 2, 0], K[:, 2, 1] = ax[:, 2], -ax[:, 1], ax[:, 0]
    aaT = ax[:, :, None] * ax[:, None, :]
    ax_par = np.einsum("jik,jk->ji", model.j1_E, model.j1_axis)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    s = dict(
        jump_gathers=[f32(g) for g in jump_gathers],
        j1_to_links=f32(j1_to_links), j1_to_v=f32(j1_to_v),
        j1_prev_gather=f32(j1_prev_gather),
        chain_masks=[f32(m) for m in chain_masks],
        j1_par_gather=f32(j1_par_gather),
        free_to_links=f32(free_to_links), free_to_v=f32(free_to_v),
        fixed_rot_T=f32(model.joint_rot_T * fixed_rows[:, None, None]),
        fixed_pos=f32(model.joint_pos * fixed_rows[:, None]),
        j1_K=f32(K), j1_aaT=f32(aaT), j1_E=f32(model.j1_E),
        j1_t=f32(model.j1_t), j1_ax_par=f32(ax_par),
        j1_axis=f32(model.j1_axis), j1_rev=f32(model.j1_rev),
        j1_maxv=f32(model.j1_maxv), j1_lo=f32(model.j1_lo),
        j1_hi=f32(model.j1_hi),
        j1_q=idx(model.j1_q), j1_v=idx(model.j1_v),
        anc_dof=f32(model.anc_dof), anc_dof_T=f32(model.anc_dof.T),
        dof_vd_mask=f32(model.dof_vd_mask),
        crba_mask=f32(model.crba_mask), eye_nv=f32(np.eye(nv)),
    )
    # The tree solve's CRBA pair build: one gather of F rows and S rows per
    # ancestor pair (k, i), in ancestor_pairs order, and the diagonal pairs.
    pairs = np.asarray(ancestor_pairs(model.dof_anc_chains), np.int64)
    s.update(tree_k=idx(pairs[:, 0]), tree_i=idx(pairs[:, 1]),
             tree_diag=idx(tree_tables(model.dof_anc_chains).diag))
    # The integration kernel's tables: the (q, v) offsets of the free
    # joints, then of the 1-dof joints, and each 1-dof joint's limits.
    offsets = [(qi, vi) for (_, qi, vi) in free] \
        + list(zip(model.j1_q.tolist(), model.j1_v.tolist()))
    s.update(integ_table=torch.as_tensor(
        np.asarray(offsets, np.int32).reshape(-1, 2), device=device),
        integ_limits=torch.stack([s["j1_maxv"], s["j1_lo"], s["j1_hi"]], 1))
    # The FK kernel's tables (csrc/forward_kinematics.cu): int32 rows by
    # link (parent, the joint whose chain ends there, its free joint, its
    # ancestor dofs' bit mask), by 1-dof joint (q and v columns, chain
    # position and predecessor, the parent link), by dof (6 f + k of a free
    # joint's dofs) and by free joint (link, q column); float rows by link
    # and by joint, copied from the chain's own tables.
    link_j1 = np.full(nb, -1, np.int64)
    link_j1[model.j1_links[last]] = last
    link_free = np.full(nb, -1, np.int64)
    dof_free = np.full(nv, -1, np.int64)
    for f_i, (i, qi, vi) in enumerate(free):
        link_free[i] = f_i
        dof_free[vi:vi + 6] = 6 * f_i + np.arange(6)
    anc_mask = (model.anc_dof != 0).astype(np.uint64) @ (
        np.uint64(1) << np.arange(nv, dtype=np.uint64))
    links = np.stack([model.parent_pad, link_j1, link_free,
                      anc_mask.astype(np.uint32).view(np.int32)], 1)
    joints = np.stack([model.j1_q, model.j1_v, model.j1_chain_pos,
                       np.maximum(model.j1_prev, 0),
                       np.append(model.parent_pad, nb)[model.j1_links]], 1)
    frees = np.asarray([(i, qi) for (i, qi, vi) in free], np.int64)
    s["fk_itab"] = torch.as_tensor(np.concatenate(
        [links.ravel(), joints.ravel(), dof_free, frees.ravel()])
        .astype(np.int32), device=device)
    s["fk_ftab"] = torch.cat([
        torch.cat([s["fixed_rot_T"].reshape(nb, 9), s["fixed_pos"]],
                  1).ravel(),
        torch.cat([s["j1_E"].reshape(nj, 9), s["j1_K"].reshape(nj, 9),
                   s["j1_aaT"].reshape(nj, 9), s["j1_t"], s["j1_ax_par"],
                   s["j1_axis"], s["j1_rev"][:, None]], 1).ravel()])
    cache[device] = s
    return s


def forward_kinematics(model: ArticulatedModel, q, v_dof,
                       params: DynParams) -> Kinematics:
    """Per-link world poses, world-Plücker joint subspaces and link
    velocities; env-last throughout.

    Link translations scale with ``params.scale`` (uniform geometry scale —
    the 'scale' DR operation changes limb lengths, not just collision
    radii). On the card it is one launch of ``csrc/forward_kinematics.cu``,
    equal to ``kinematics_chain`` on a batch there bit for bit (a single
    env gives its row of a batch); CPU tensors run ``kinematics_chain``,
    its plain version."""
    if on_cpu(q, v_dof):
        STATS["kinematics"] += 1
        return kinematics_chain(model, q, v_dof, params)
    if q.ndim == 1:
        return _squeeze_last(forward_kinematics(
            model, q[None], v_dof[None], _promote(params)))
    STATS["kinematics"] += 1
    st = _structure(model, q.device)
    return Kinematics(*forward_kinematics_cuda(
        q, v_dof, params.scale.expand(q.shape[0]), st["fk_itab"],
        st["fk_ftab"], model.nb, model.j1_links.size, len(model.free_list),
        len(st["jump_gathers"]), model.j1_chain_maxpos))


def kinematics_chain(model: ArticulatedModel, q, v_dof,
                     params: DynParams) -> Kinematics:
    """``forward_kinematics`` in plain torch, by pointer jumping: the
    kernel's plain version, on any device."""
    if q.ndim == 1:
        return _squeeze_last(kinematics_chain(
            model, q[None], v_dof[None], _promote(params)))
    n = q.shape[0]
    nb, nv = model.nb, model.nv
    st = _structure(model, q.device)
    qT = q.T                                              # (nq, N)
    vT = v_dof.T                                          # (nv, N)
    scale = params.scale.expand(n)                        # (N,)

    # --- local child->parent transforms (R_loc = E^T, r_loc): static rows
    # plus fold-adds of the 1-dof and free rows. ------------------------ #
    R_loc = st["fixed_rot_T"][..., None]                  # (nb, 3, 3, 1)
    r_loc = st["fixed_pos"][..., None] * scale            # (nb, 3, N)
    G = u = None
    if model.j1_links.size:
        q1 = qT[st["j1_q"]]                               # (nj, N)
        rev = st["j1_rev"][:, None]                       # (nj, 1)
        ang = q1 * rev
        sin, cos = torch.sin(ang)[:, None, None], torch.cos(ang)[:, None, None]
        Rj = (cos * _eye3(q)[None, :, :, None]
              + sin * st["j1_K"][..., None]
              + (1.0 - cos) * st["j1_aaT"][..., None])    # (nj, 3, 3, N)
        # Per-dof local transform within its joint chain: rotation
        # G = E^T R(a, q) and translation u = t * scale (+ E^T a q for
        # prismatic rows; the revolute mask zeroes it).
        G = _mm(st["j1_E"][..., None], Rj)
        pris = q1 * (1.0 - rev)                           # (nj, N)
        u = (st["j1_t"][..., None] * scale
             + st["j1_ax_par"][..., None] * pris[:, None, :])  # (nj, 3, N)
        # Joint-chain compose (phantom-collapsed multi-dof joints): round p
        # folds every chain dof at position p onto its predecessor's
        # accumulated (G, u). Models without phantom links skip it.
        for p in range(1, model.j1_chain_maxpos + 1):
            Gp = _fold(st["j1_prev_gather"], G)
            up = _fold(st["j1_prev_gather"], u)
            m_p = st["chain_masks"][p]
            G = torch.where(m_p[:, None, None, None] > 0, _mm(Gp, G), G)
            u = torch.where(m_p[:, None, None] > 0, up + _mv(Gp, u), u)
        R_loc = R_loc + _fold(st["j1_to_links"], G)
        r_loc = r_loc + _fold(st["j1_to_links"], u)
    if model.free_list:
        R_free = torch.stack([_quat_to_rot_rows(qT[qi + 3:qi + 7])
                              for (i, qi, vi) in model.free_list])
        r_free = torch.stack([qT[qi:qi + 3]
                              for (i, qi, vi) in model.free_list])
        R_loc = R_loc + _fold(st["free_to_links"], R_free)
        r_loc = r_loc + _fold(st["free_to_links"], r_free)
    R_loc = R_loc.expand(nb, 3, 3, n)

    # --- pointer-jumping propagation: (R1, p1) o (R2, p2) = (R1 R2,
    # p1 + R1 p2) is associative; virtual root nb = identity. ----------- #
    Rc = torch.cat([R_loc, _eye3(q)[None, :, :, None].expand(1, 3, 3, n)])
    pc = torch.cat([r_loc, r_loc.new_zeros(1, 3, n)])
    for g in st["jump_gathers"]:
        A_R = _fold(g, Rc)
        A_p = _fold(g, pc)
        Rc = _mm(A_R, Rc)
        pc = A_p + _mv(A_R, pc)
    R_w, p_w = Rc[:nb], pc[:nb]

    # --- world-Plücker dof subspaces about o = first root position. ----- #
    o = p_w[0]                                            # (3, N)
    rel = p_w - o[None]                                   # (nb, 3, N)
    S_o = q.new_zeros(nv, 6, n)
    if model.j1_links.size:
        # Axis and anchor of every chain dof, via the owning link's parent
        # pose: world axis = R_par (G a), anchor = p_par + R_par u.
        A = _mv(G, st["j1_axis"][..., None])              # (nj, 3, N)
        R_par = _fold(st["j1_par_gather"], Rc)            # (nj, 3, 3, N)
        p_par = _fold(st["j1_par_gather"], pc)            # (nj, 3, N)
        aw = _mv(R_par, A)
        anchor = p_par + _mv(R_par, u)
        mom = _cross(anchor - o[None], aw)
        rev = st["j1_rev"][:, None, None]
        rows = torch.cat([aw * rev, mom * rev + aw * (1.0 - rev)], 1)
        S_o = _fold(st["j1_to_v"], rows)
    if model.free_list:
        free_rows = []
        for (i, qi, vi) in model.free_list:
            # Angular dof k: [R e_k; (p-o) x R e_k]; linear: [0; R e_k].
            RT = R_w[i].transpose(0, 1)                   # rows e_k (3,3,N)
            momf = _cross(rel[i][None].expand(3, 3, n), RT)
            free_rows.append(torch.cat([RT, momf], 1))
            free_rows.append(torch.cat([torch.zeros_like(RT), RT], 1))
        S_o = S_o + _fold(st["free_to_v"], torch.cat(free_rows, 0))

    # --- link velocities: V_b = sum_m anc[b, m] S_o[m] v[m]. ------------ #
    Sv_o = S_o * vT[:, None, :]
    V_o = _fold(st["anc_dof"], Sv_o)

    # Body-frame [w; vl] at each link origin for contacts/tasks.
    w_w = V_o[:, :3]
    v_pt = V_o[:, 3:] + _cross(w_w, rel)
    v_body = torch.cat([_mvT(R_w, w_w), _mvT(R_w, v_pt)], 1)
    return Kinematics(R_w=R_w, p_w=p_w, v=v_body, S_o=S_o, Sv_o=Sv_o,
                      V_o=V_o, o=o)


def _link_inertias(model: ArticulatedModel, params: DynParams):
    """(nb, 6, 6, N) body-frame spatial inertias at the link origins,
    env-last (COM offsets and inertias scale with the geometry scale).
    Accepts single-env or (N, ..)-batched params; single-env params give
    (nb, 6, 6)."""
    single = params.mass.ndim == 1
    if single:
        params = _promote(params)
    n = params.mass.shape[0]
    nb = model.nb
    s = params.scale.expand(n)
    com = torch.movedim(params.com, 0, -1) * s             # (nb, 3, N)
    diag = torch.movedim(params.inertia, 0, -1) * s ** 2
    m = params.mass.T[:, None, None, :]                    # (nb, 1, 1, N)
    c = _hat_rows(com)                                     # (nb, 3, 3, N)
    cT = c.transpose(1, 2)
    ccT = _mm(c, cT)
    eye = _eye3(com)[None, :, :, None]
    tl = eye * diag[:, None, :, :] + m * ccT
    top = torch.cat([tl, m * c], 2)
    bot = torch.cat([m * cT, (m * eye).expand(nb, 3, 3, n)], 2)
    out = torch.cat([top, bot], 1)                         # (nb, 6, 6, N)
    return out[..., 0] if single else out


def _plucker_inertia_direct(kin: Kinematics, params: DynParams):
    """(nb, 6, 6, N) spatial inertias about the reference point o, built
    directly from world quantities: for COM position c = p_w + R com - o
    and world rotational inertia I_c = R diag(inertia s^2) R^T,

        I_o = [[I_c + m c^ c^T, m c^], [m c^T, m 1]]."""
    R = kin.R_w                                            # (nb, 3, 3, N)
    nb, n = R.shape[0], R.shape[-1]
    s = params.scale.expand(n)
    com_l = torch.movedim(params.com, 0, -1) * s           # (nb, 3, N)
    c = kin.p_w + _mv(R, com_l) - kin.o[None]
    diag = torch.movedim(params.inertia, 0, -1) * s ** 2   # (nb, 3, N)
    m = params.mass.T[:, None, None, :]
    RIcR = _mm(R * diag[:, None, :, :], R.transpose(1, 2))
    ch = _hat_rows(c)
    chT = ch.transpose(1, 2)
    tl = RIcR + m * _mm(ch, chT)
    eye = _eye3(R)[None, :, :, None]
    top = torch.cat([tl, m * ch], 2)
    bot = torch.cat([m * chT, (m * eye).expand(nb, 3, 3, n)], 2)
    return torch.cat([top, bot], 1)


# --------------------------------------------------------------------- #
# 10-parameter symmetric spatial inertia (the hot-path representation):
# I_o = [[A, hat(h)], [hat(h)^T, m 1]] with A the symmetric rotational
# block about o (6), h = m c the first moment (3) and m the mass (1).
# Row layout: [Axx, Ayy, Azz, Axy, Axz, Ayz, hx, hy, hz, m].
# --------------------------------------------------------------------- #
def _i10_direct(kin: Kinematics, params: DynParams):
    """(nb, 10, N) spatial inertias about o from world COM/world-rotated
    inertia diagonals (same math as ``_plucker_inertia_direct``, packed),
    in float32."""
    R = kin.R_w                                            # (nb, 3, 3, N)
    n = R.shape[-1]
    s = params.scale.expand(n)
    com_l = torch.movedim(params.com, 0, -1) * s           # (nb, 3, N)
    c = kin.p_w + _mv(R, com_l) - kin.o[None]              # (nb, 3, N)
    diag = torch.movedim(params.inertia, 0, -1) * s ** 2
    mass = params.mass.T                                   # (nb, N)
    RIcR = _mm(R * diag[:, None, :, :], R.transpose(1, 2))  # R diag R^T
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    c2 = cx * cx + cy * cy + cz * cz
    rows = [RIcR[:, 0, 0] + mass * (c2 - cx * cx),
            RIcR[:, 1, 1] + mass * (c2 - cy * cy),
            RIcR[:, 2, 2] + mass * (c2 - cz * cz),
            RIcR[:, 0, 1] - mass * cx * cy,
            RIcR[:, 0, 2] - mass * cx * cz,
            RIcR[:, 1, 2] - mass * cy * cz,
            mass * cx, mass * cy, mass * cz,
            mass.expand(c2.shape)]
    return torch.stack(rows, 1)                            # (nb, 10, N)


def _i10_mv(I10, V):
    """I_o @ V for packed inertias: I10 (.., 10, N), V (.., 6, N) motion
    [w; u] -> force [A w + h x u; -h x w + m u], (.., 6, N)."""
    axx, ayy, azz = I10[..., 0, :], I10[..., 1, :], I10[..., 2, :]
    axy, axz, ayz = I10[..., 3, :], I10[..., 4, :], I10[..., 5, :]
    h = I10[..., 6:9, :]
    m = I10[..., 9, :]
    w, u = V[..., :3, :], V[..., 3:, :]
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    aw = torch.stack([axx * wx + axy * wy + axz * wz,
                      axy * wx + ayy * wy + ayz * wz,
                      axz * wx + ayz * wy + azz * wz], -2)
    top = aw + _cross(h, u)
    bot = m[..., None, :] * u - _cross(h, w)
    return torch.cat([top, bot], -2)


def _gravity_rows(params: DynParams, n):
    """(3, N) gravity from batched (N, 3) or shared (3,) params."""
    return params.gravity.reshape(-1, 3).T.expand(3, n)


def _spatial_bias_forces(st, kin: Kinematics, I_mv, params: DynParams,
                         f_ext_world):
    """Shared RNEA body of the two bias functions: per-body forces
    f_b = I a_b + V x* (I V) - f_ext with ``I_mv`` applying the inertias,
    projected onto the dof subspaces. Returns (nv, N)."""
    n = kin.V_o.shape[-1]
    # Velocity of each dof's OWN joint frame (its subspace is fixed there).
    Vd = _fold(st["dof_vd_mask"], kin.Sv_o)
    Sv = kin.Sv_o
    dSa = _cross(Vd[:, :3], Sv[:, :3])
    dSl = _cross(Vd[:, :3], Sv[:, 3:]) + _cross(Vd[:, 3:], Sv[:, :3])
    Sdot_v = torch.cat([dSa, dSl], 1)                     # (nv, 6, N)
    a = _fold(st["anc_dof"], Sdot_v)
    a = torch.cat([a[:, :3], a[:, 3:] - _gravity_rows(params, n)[None]], 1)
    IV = I_mv(kin.V_o)
    Ia = I_mv(a)
    w, vl = kin.V_o[:, :3], kin.V_o[:, 3:]
    vxf = torch.cat([_cross(w, IV[:, :3]) + _cross(vl, IV[:, 3:]),
                     _cross(w, IV[:, 3:])], 1)
    f = Ia + vxf                                          # (nb, 6, N)
    if f_ext_world is not None:
        rel = kin.p_w - kin.o[None]
        n_o = f_ext_world[:, :3] + _cross(rel, f_ext_world[:, 3:])
        f = f - torch.cat([n_o, f_ext_world[:, 3:]], 1)
    F = _fold(st["anc_dof_T"], f)
    return (F * kin.S_o).sum(1)                           # (nv, N)


def _bias_from_i10(model: ArticulatedModel, kin: Kinematics, I10,
                   params: DynParams, f_ext_world=None):
    """RNEA bias (qdd = 0) on packed inertias; optional world wrenches
    (nb, 6, N) [torque@link-origin; force]. Returns (nv, N)."""
    st = _structure(model, I10.device)
    return _spatial_bias_forces(st, kin, lambda V: _i10_mv(I10, V), params,
                                f_ext_world)


def external_generalized_force(model: ArticulatedModel, kin: Kinematics,
                               f_ext_world):
    """Generalized force tau = J^T f from per-link world wrenches, (nv, N).
    ``f_ext_world`` is env-last (nb, 6, N) with rows [torque@link-origin;
    force] — the contact functions' output convention."""
    st = _structure(model, f_ext_world.device)
    rel = kin.p_w - kin.o[None]
    n_o = f_ext_world[:, :3] + _cross(rel, f_ext_world[:, 3:])
    f = torch.cat([n_o, f_ext_world[:, 3:]], 1)
    F = _fold(st["anc_dof_T"], f)
    return (F * kin.S_o).sum(1)                           # (nv, N)


def _mass_factors_i10(model: ArticulatedModel, kin: Kinematics, I10):
    """CRBA left factor F[m] = IC_m S_m from packed composite inertias
    (IC_m = subtree sum of I10). Returns (nv, 6, N)."""
    st = _structure(model, I10.device)
    IC = _fold(st["anc_dof_T"], I10)
    return _i10_mv(IC, kin.S_o)


def _inertia_to_plucker(kin: Kinematics, I_sp):
    """Re-expresses body-frame spatial inertias (at link origins) in the
    shared world-Plücker frame about o: I_o = X^{-T} I X^{-1} with
    X = [[R, 0], [hat(p-o) R, R]]. All (nb, 6, 6, N), env-last."""
    RT = kin.R_w.transpose(1, 2)                          # (nb, 3, 3, N)
    rel_hat = _hat_rows(kin.p_w - kin.o[None])
    G = -_mm(RT, rel_hat)
    Z = torch.zeros_like(RT)
    Xi = torch.cat([torch.cat([RT, Z], 2), torch.cat([G, RT], 2)], 1)
    return _mmT(Xi, _mm(I_sp, Xi))


def _bias_from_plucker(model: ArticulatedModel, kin: Kinematics, I_o,
                       params: DynParams, f_ext_world=None):
    """RNEA with qdd = 0 on full (nb, 6, 6, N) world-Plücker inertias.
    Returns (nv, N)."""
    st = _structure(model, I_o.device)
    return _spatial_bias_forces(st, kin, lambda V: _mv(I_o, V), params,
                                f_ext_world)


def _mass_factors_plucker(model: ArticulatedModel, kin: Kinematics, I_o):
    """CRBA left factor F[m] = IC_dof[m] S_m. Returns (nv, 6, N)."""
    st = _structure(model, I_o.device)
    return _mv(_fold(st["anc_dof_T"], I_o), kin.S_o)


def _crba_matrix(st, F, S):
    """M[m, l] = F_m . S_l on the ancestor pairs, symmetrized: (nv, nv, N)."""
    Ml = (F[:, None] * S[None]).sum(2) * st["crba_mask"][:, :, None]
    diag = Ml * st["eye_nv"][:, :, None]
    return Ml + Ml.transpose(0, 1) - diag


def _mass_from_plucker(model: ArticulatedModel, kin: Kinematics, I_o):
    """CRBA in env-last world-Plücker form. Returns (nv, nv, N)."""
    st = _structure(model, I_o.device)
    return _crba_matrix(st, _mass_factors_plucker(model, kin, I_o), kin.S_o)


def bias_forces(model: ArticulatedModel, kin: Kinematics, I_sp,
                params: DynParams, f_ext_world=None):
    """RNEA with qdd = 0: C(q, v) - tau_ext, including gravity and optional
    world-frame external forces per link. Returns env-first (N, nv) /
    single-env (nv,)."""
    single = kin.p_w.ndim == 2
    if single:
        kin = _promote_kin(kin)
        I_sp = I_sp[..., None]
        params = _promote(params)
        if f_ext_world is not None:
            f_ext_world = f_ext_world[..., None]
    C = _bias_from_plucker(model, kin, _inertia_to_plucker(kin, I_sp),
                           params, f_ext_world)
    return C[:, 0] if single else C.T


def mass_matrix(model: ArticulatedModel, kin: Kinematics, I_sp):
    """CRBA composite-rigid-body mass matrix: (nv, nv) single-env or
    (N, nv, nv) batched."""
    single = kin.p_w.ndim == 2
    if single:
        kin = _promote_kin(kin)
        I_sp = I_sp[..., None]
    M = _mass_from_plucker(model, kin, _inertia_to_plucker(kin, I_sp))
    return M[..., 0] if single else torch.movedim(M, -1, 0)


def joint_passive_torque(model: ArticulatedModel, params: DynParams, q_dof,
                         v_dof):
    """Parallel joint springs toward 0 and smooth dry friction (viscous
    damping is implicit elsewhere). Layout follows the inputs."""
    tau = -params.stiffness * q_dof
    return tau - params.friction * torch.tanh(v_dof / 0.05)


def dof_positions(model: ArticulatedModel, q):
    """The 1-dof joint positions as an (.., nv) vector (zeros on free-joint
    dof slots)."""
    out = q.new_zeros(q.shape[:-1] + (model.nv,))
    if model.j1_links.size:
        st = _structure(model, q.device)
        out[..., st["j1_v"]] = q[..., st["j1_q"]]
    return out


def _uses_tree_solve(model: ArticulatedModel) -> bool:
    n_pairs = sum(1 + len(c) for c in model.dof_anc_chains)
    n_tri = model.nv * (model.nv + 1) // 2
    return n_pairs <= TREE_SOLVE_MAX_FILL * n_tri


def _tree_pair_values(st, F, S, diag_extra):
    """CRBA values at the ancestor pairs: M[(k, i)] = F_k . S_i, plus
    ``diag_extra`` on the diagonal pairs, all pairs at once: (E, N)."""
    Mp = (F[st["tree_k"]] * S[st["tree_i"]]).sum(1)
    return Mp.index_add(0, st["tree_diag"], diag_extra)


def forward_dynamics(model: ArticulatedModel, q, v, tau,
                     params: DynParams, f_ext_world=None, dt=None,
                     kin: Optional[Kinematics] = None,
                     factor=None, return_factor: bool = False,
                     drive_kp=None, drive_kd=None, drive_target=None,
                     drive_effort=None):
    """qdd = (M + diag(armature) + dt*diag(damping))^-1 (tau - C - d v).

    Viscous joint damping is integrated implicitly: the damping torque at
    the NEW velocity is -d (v + dt qdd), which moves ``dt*d`` onto the LHS
    and ``-d v`` into the RHS. Pass a precomputed ``kin`` (e.g. the one the
    contact forces used) to skip FK. ``f_ext_world`` is env-last
    (nb, 6, N) for batched calls, (nb, 6) for single-env ones.

    ``drive_kp``/``drive_kd``/``drive_target`` (broadcastable to ``v``'s
    (N, nv) shape; zero kp on undriven dofs) add a PD position drive solved
    implicitly about the new state: ``kp (target - q) - (kd + h kp) v``
    joins the RHS and ``h (kd + h kp)`` the LHS diagonal. ``drive_effort``
    clamps the proportional term.

    ``factor``/``return_factor`` reuse the mass-matrix factorization across
    a step's substeps (the frozen-mass scheme): ``return_factor=True``
    returns ``(qdd, kin, factor)``; feeding that ``factor`` back skips the
    CRBA build and the factorization. The payload is opaque."""
    if q.ndim == 1:
        out = forward_dynamics(
            model, q[None], v[None], tau[None], _promote(params),
            None if f_ext_world is None else f_ext_world[..., None], dt,
            None if kin is None else _promote_kin(kin),
            factor=factor, return_factor=return_factor,
            drive_kp=drive_kp, drive_kd=drive_kd,
            drive_target=drive_target, drive_effort=drive_effort)
        if return_factor:
            qdd, kin1, factor = out
            return qdd[0], _squeeze_last(kin1), factor
        qdd, kin1 = out
        return qdd[0], _squeeze_last(kin1)
    st = _structure(model, q.device)
    if kin is None:
        kin = forward_kinematics(model, q, v, params)
    I10 = _i10_direct(kin, params)
    C = _bias_from_i10(model, kin, I10, params, f_ext_world)  # (nv, N)
    vT = v.T
    q_dofT = dof_positions(model, q).T

    def el(x):
        return torch.as_tensor(x, dtype=v.dtype, device=v.device) \
            .expand(v.shape).T

    stiffT, fricT = el(params.stiffness), el(params.friction)
    dampT, armT = el(params.damping), el(params.armature)
    passive = -stiffT * q_dofT - fricT * torch.tanh(vT / 0.05)
    rhs = tau.T + passive - C - dampT * vT                # (nv, N)
    diag_extra = armT + 1e-6
    if dt is not None:
        diag_extra = diag_extra + dt * dampT
    if drive_kp is not None:
        kpT = el(drive_kp)
        kdT = el(drive_kd) if drive_kd is not None else torch.zeros_like(kpT)
        p_term = kpT * (el(drive_target) - q_dofT)
        if drive_effort is not None:
            # A float limit stays a scalar argument (no host copy a step).
            p_term = torch.clamp(p_term, -drive_effort, drive_effort)
        h_drv = dt if dt is not None else 0.0
        gain = kdT + h_drv * kpT
        rhs = rhs + p_term - gain * vT
        diag_extra = diag_extra + h_drv * gain
    chains = model.dof_anc_chains
    if factor is None:
        F = _mass_factors_i10(model, kin, I10)
        if _uses_tree_solve(model):
            left_looking = (tree_tables(chains).mean_depth
                            >= TREE_LL_MIN_MEAN_DEPTH)
            Mp = _tree_pair_values(st, F, kin.S_o, diag_extra)
            factor = ("tree", tree_factor(chains, Mp, left_looking))
            STATS["tree_factor"] += 1
        else:
            Ml = _crba_matrix(st, F, kin.S_o)
            lhs = Ml + st["eye_nv"][:, :, None] * diag_extra[None, :, :]
            factor = ("dense", spd_factor_lanes(lhs))
            STATS["dense_factor"] += 1
    kind, payload = factor
    STATS[kind + "_substitute"] += 1
    if kind == "tree":
        qdd = tree_substitute(chains, payload, rhs).T
    else:
        qdd = spd_substitute_lanes(payload, rhs).T
    if return_factor:
        return qdd, kin, factor
    return qdd, kin


def mass_factor_solve(model: ArticulatedModel, factor, rhs):
    """Solves (M + diag_extra) X = rhs against a ``forward_dynamics``
    factor (``return_factor=True``) for K extra right-hand sides in lanes
    layout: rhs (K, nv, N) -> X (K, nv, N), in float32. Works for both
    factor kinds."""
    kind, payload = factor
    STATS[kind + "_substitute"] += 1
    if kind == "tree":
        return tree_substitute(model.dof_anc_chains, payload, rhs.float())
    return spd_substitute_lanes(payload, rhs.float())


# Rigid-body velocity caps (PhysX defaults the reference's engine runs
# with: maxLinearVelocity 1e2-class, maxAngularVelocity 64 rad/s).
MAX_LIN_VEL = 100.0
MAX_ANG_VEL = 64.0


def _clamp_norm_rows(vec, vmax):
    """(3, N): rescales so the norm over axis 0 is at most vmax."""
    nrm = torch.sqrt((vec * vec).sum(0, keepdim=True))
    return vec * (vmax / torch.clamp(nrm, min=vmax))


def integrate(model: ArticulatedModel, q, v, qdd, dt):
    """Semi-implicit Euler; free-joint velocities are advanced in the WORLD
    frame and re-expressed in the rotated body frame (the body-frame
    transport term integrated explicitly would pump energy into spinning
    free bodies). Velocities are clamped after the advance (per-dof
    ``max_velocity``, and the rigid-body MAX_LIN_VEL / MAX_ANG_VEL), as the
    reference's engine limits do."""
    if q.ndim == 1:
        qn, vn = integrate(model, q[None], v[None], qdd[None], dt)
        return qn[0], vn[0]
    qT, vT, qddT = q.T, v.T, qdd.T
    # Env-last views of fresh env-first tensors: the row writes below
    # land in tensors whose .T is contiguous again.
    v_new = (v + dt * qdd).T
    q_new = q.clone().T
    if model.j1_links.size:
        st = _structure(model, q.device)
        maxv = st["j1_maxv"][:, None]
        v1 = torch.clamp(v_new[st["j1_v"]], -maxv, maxv)
        v_new[st["j1_v"]] = v1
        q_new[st["j1_q"]] = qT[st["j1_q"]] + dt * v1
    for (i, qi, vi) in model.free_list:
        w_body = vT[vi:vi + 3]
        vl_body = vT[vi + 3:vi + 6]
        quat = qT[qi + 3:qi + 7]                          # (4, N)
        R = _quat_to_rot_rows(quat)                       # (3, 3, N)
        # Classical (world-frame) accelerations of the link origin: the
        # spatial qdd is the body-coords derivative of v, so add back the
        # transport terms before rotating to world.
        aw_lin = _mv(R, qddT[vi + 3:vi + 6] + _cross(w_body, vl_body))
        aw_ang = _mv(R, qddT[vi:vi + 3])
        vw = _clamp_norm_rows(_mv(R, vl_body) + dt * aw_lin, MAX_LIN_VEL)
        ww = _clamp_norm_rows(_mv(R, w_body) + dt * aw_ang, MAX_ANG_VEL)
        pos = qT[qi:qi + 3] + dt * vw
        # Quaternion integration by the world angular velocity.
        omega4 = torch.cat([torch.zeros_like(ww[:1]), ww], 0)
        quat_n = quat + dt * (0.5 * _quat_mul_rows(omega4, quat))
        quat_n = quat_n / (torch.sqrt((quat_n ** 2).sum(0, keepdim=True))
                           + 1e-12)
        R_n = _quat_to_rot_rows(quat_n)
        q_new[qi:qi + 3] = pos
        q_new[qi + 3:qi + 7] = quat_n
        v_new[vi:vi + 3] = _mvT(R_n, ww)
        v_new[vi + 3:vi + 6] = _mvT(R_n, vw)
    return q_new.T, v_new.T


def integrate_and_clamp(model: ArticulatedModel, q, v, qdd, dt: float):
    """One substep's ``integrate`` followed by ``clamp_limits``. On the card
    it is one launch of ``csrc/integrate.cu``, equal to the two functions
    on a batch there bit for bit (a single env gives its row of a batch);
    CPU tensors run the two functions, its plain version."""
    if on_cpu(q, v, qdd):
        return clamp_limits(model, *integrate(model, q, v, qdd, dt))
    if q.ndim == 1:
        qn, vn = integrate_and_clamp(model, q[None], v[None], qdd[None], dt)
        return qn[0], vn[0]
    st = _structure(model, q.device)
    return integrate_clamp_cuda(q, v, qdd, dt, st["integ_table"],
                                st["integ_limits"], len(model.free_list),
                                MAX_LIN_VEL, MAX_ANG_VEL)


def clamp_limits(model: ArticulatedModel, q, v):
    """Hard-clamps 1-dof joints to their limits, zeroing inward velocity."""
    if not model.j1_links.size:
        return q, v
    if q.ndim == 1:
        qn, vn = clamp_limits(model, q[None], v[None])
        return qn[0], vn[0]
    st = _structure(model, q.device)
    lo, hi = st["j1_lo"][:, None], st["j1_hi"][:, None]
    qT, vT = q.T.clone(), v.T.clone()
    q1 = qT[st["j1_q"]]
    v1 = vT[st["j1_v"]]
    v1n = torch.where(q1 < lo, torch.clamp(v1, min=0.0),
                      torch.where(q1 > hi, torch.clamp(v1, max=0.0), v1))
    qT[st["j1_q"]] = torch.clamp(q1, lo, hi)
    vT[st["j1_v"]] = v1n
    return qT.T, vT.T
