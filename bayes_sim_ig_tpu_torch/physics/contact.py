"""Contacts: penalty forces against the ground plane (z = 0) and between
spheres, plane patches and boxes on two bodies, and the velocity-level
impulse pass that backs them.

Port of ``bayes_sim_ig_tpu/physics/contact.py``. Contact points are
derived from per-link geoms (spheres, capsule endpoints, box corners), and
each penetrating point contributes a normal spring-damper force plus a
smooth Coulomb-capped tangential friction force, accumulated as
world-frame spatial forces about each link origin and fed to RNEA as
external forces. The multi-pair functions (``sphere_plane_pairs_forces``,
``sphere_box_pairs_forces``, ``sphere_sphere_pairs_forces``) compute P
pairs in one set of tensor ops and can return the pairs' geometry for the
impulse pass (``contact_pairs_impulse_prepare``/``_apply``), a projected
mass-splitting Jacobi solve of the contact rows against the substep's own
mass factor.

ENV-LAST layout like the rest of the engine: per-point tensors are
(P, 3, N); the per-point wrench accumulation is a static one-hot (nb, P)
fold. Single-env calls (squeezed Kinematics) work too and return (nb, 6).
``STATS`` counts the pair functions' calls by kind.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..ops.launch import count_at_replay
from ..ops.tree_solve import tree_downsolve, tree_upsolve
from .dynamics import (Kinematics, _cross, _fold, _mv, _mvT, _promote,
                       _promote_kin, mass_factor_solve)
from .model import ArticulatedModel, DynParams

# Pair-contact evaluations of this process, by kind: a call of
# ``sphere_plane_pair_forces`` (one pair) or of a multi-pair function (P
# pairs in one set of ops). Counted on the host as the calls are made; a
# CUDA graph adds what its capture counted at every replay.
STATS = {"sphere_plane_pair": 0, "sphere_plane_pairs": 0,
         "sphere_box_pairs": 0, "sphere_sphere_pairs": 0}
count_at_replay("contact", STATS)


def contact_points(model: ArticulatedModel) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray, np.ndarray]:
    """Static contact-point table: (link_idx (P,), offsets (P, 3),
    radii (P,), geom_idx (P,)). Boxes contribute 4 bottom + 4 top corners;
    capsules their two endpoint spheres."""
    links, offsets, radii, geom_ids = [], [], [], []
    for g_idx, g in enumerate(model.geoms):
        off = np.asarray(g.offset, np.float64)
        if g.kind == "sphere":
            links.append(g.link)
            offsets.append(off)
            radii.append(g.size[0])
            geom_ids.append(g_idx)
        elif g.kind == "point":
            links.append(g.link)
            offsets.append(off)
            radii.append(0.0)
            geom_ids.append(g_idx)
        elif g.kind == "capsule":
            r, hl = g.size
            ax = np.asarray(g.axis, np.float64)
            ax = ax / np.linalg.norm(ax)
            for s in (-1.0, 1.0):
                links.append(g.link)
                offsets.append(off + s * hl * ax)
                radii.append(r)
                geom_ids.append(g_idx)
        elif g.kind == "box":
            hx, hy, hz = g.size
            for sx in (-1.0, 1.0):
                for sy in (-1.0, 1.0):
                    for sz in (-1.0, 1.0):
                        links.append(g.link)
                        offsets.append(off + np.array(
                            [sx * hx, sy * hy, sz * hz]))
                        radii.append(0.0)
                        geom_ids.append(g_idx)
        else:
            raise ValueError(f"Unknown geom kind {g.kind}")
    if not links:
        return (np.zeros(0, np.int32), np.zeros((0, 3)), np.zeros(0),
                np.zeros(0, np.int32))
    return (np.asarray(links, np.int32), np.asarray(offsets),
            np.asarray(radii), np.asarray(geom_ids, np.int32))


def _rows(x, device=None):
    """Normalizes a per-env 3-vector argument to (3, N): accepts a static
    (3,) vector or an env-last (3, N) tensor. Env-first (N, 3) input is
    REJECTED rather than inferred: a (3, 3) array is ambiguous between the
    two layouts. A host vector is made a tensor once (``_const``)."""
    x = _const(x, device)
    if x.ndim == 1:
        return x[:, None]
    if x.shape[0] != 3:
        raise ValueError(
            f"per-env contact vectors must be env-last (3, N); got "
            f"{tuple(x.shape)}: transpose env-first inputs at the call site")
    return x


def _ground_tables(model: ArticulatedModel, device):
    """Contact-point tables of ``model`` on ``device``, cached on it."""
    device = torch.device(device)
    cache = model.__dict__.setdefault("_torch_ground_contacts", {})
    t = cache.get(device)
    if t is None:
        links, offsets, radii, geom_ids = contact_points(model)
        gather = np.zeros((links.shape[0], model.nb), np.float32)
        gather[np.arange(links.shape[0]), links] = 1.0

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        def idx(x):
            return torch.as_tensor(np.asarray(x, np.int64), device=device)
        t = dict(P=int(links.shape[0]), links=idx(links),
                 offsets=f32(offsets), radii=f32(radii),
                 geom_ids=idx(geom_ids), gather=f32(gather),
                 scatter=f32(gather.T))
        cache[device] = t
    return t


def ground_contact_forces(model: ArticulatedModel, kin: Kinematics,
                          params: DynParams, dt=1.0 / 60.0, tau=0.02,
                          zeta=1.0):
    """World-frame external spatial forces (nb, 6, N) from plane contacts
    (env-last; single-env kinematics give (nb, 6)).

    Mass-adaptive penalty model (stable under 100x mass randomization):

      normal:     f_n = m_eff (depth / tau^2 + 2 zeta depth_dot / tau),
                  clamped >= 0 — a critically damped spring whose rest
                  penetration g*tau^2 is mass-independent;
      tangential: Coulomb cone mu*f_n, additionally capped by the
                  slip-stopping impulse m_eff_t |v_t| / dt so one step can
                  null the slip but never reverse it.
    """
    single = kin.p_w.ndim == 2
    if single:
        kin = Kinematics(*[a[..., None] for a in kin])
        params = _promote(params)
    n = kin.p_w.shape[-1]
    t = _ground_tables(model, kin.p_w.device)
    if t["P"] == 0:
        out = kin.p_w.new_zeros(model.nb, 6, n)
        return out[..., 0] if single else out
    links = t["links"]
    scale = params.scale.expand(n)
    offsets = t["offsets"][:, :, None] * scale             # (P, 3, N)
    radii = t["radii"][:, None] * scale                    # (P, N)
    mu = params.contact_friction.T[t["geom_ids"]]          # (P, N)

    R = _fold(t["gather"], kin.R_w)
    p0 = _fold(t["gather"], kin.p_w)
    v_link = _fold(t["gather"], kin.v)
    centers = p0 + _mv(R, offsets)
    # Forces act at the sphere surface touching the plane, not the center:
    # the lever arm below the COM is what converts sliding into rolling.
    pts = torch.cat([centers[:, :2], centers[:, 2:] - radii[:, None]], 1)
    # Point velocity: v_link is [w; vl] in body coords at the link origin.
    w_world = _mv(R, v_link[:, :3])
    v_world = _mv(R, v_link[:, 3:])
    arm = pts - p0
    v_pt = v_world + _cross(w_world, arm)

    # Per-point effective masses (link-local approximation).
    m_link = params.mass.T[links]                          # (P, N)
    inertia = torch.movedim(params.inertia, 0, -1)         # (nb, 3, N)
    i_mean = inertia[links].mean(1) * scale ** 2           # (P, N)
    arm_sq = (arm * arm).sum(1)
    m_eff_t = 1.0 / (1.0 / m_link + arm_sq / (i_mean + 1e-8))

    depth = radii - centers[:, 2]
    depth_dot = -v_pt[:, 2]
    f_n = m_link * (depth / tau ** 2 + 2.0 * zeta * depth_dot / tau)
    f_n = torch.where(depth > 0, torch.clamp(f_n, min=0.0),
                      torch.zeros_like(f_n))
    v_t = torch.cat([v_pt[:, :2], torch.zeros_like(v_pt[:, 2:])], 1)
    v_t_norm = torch.sqrt((v_t * v_t).sum(1)) + 1e-8
    cap = torch.minimum(mu * f_n, m_eff_t * v_t_norm / dt)
    f_t = -v_t / v_t_norm[:, None] * cap[:, None]
    force = torch.cat([f_t[:, :2], f_n[:, None]], 1)       # (P, 3, N)
    torque = _cross(arm, force)        # about the link origin, world frame
    out = _fold(t["scatter"], torch.cat([torque, force], 1))
    return out[..., 0] if single else out


def sphere_plane_pair_forces(model: ArticulatedModel, kin: Kinematics,
                             params: DynParams, sphere_link: int,
                             sphere_offset, radius: float,
                             plane_link: int, plane_point, plane_normal,
                             mu=1.0, dt=1.0 / 60.0, tau=0.02,
                             zeta=1.0, plane_halfsize=None):
    """Contact between a sphere on one body and a plane patch attached to
    another body (a ball on a tilting tray, a handle between finger pads).
    Same mass-adaptive penalty model as the ground contacts; equal and
    opposite world-frame spatial forces are returned env-last as
    (nb, 6, N) (or (nb, 6) for single-env kinematics).

    ``plane_point``/``plane_normal`` are in the plane body's frame;
    ``sphere_offset``/``plane_point`` accept static 3-vectors or per-env
    ENV-LAST (3, N) tensors (env-first (N, 3) is rejected by ``_rows``);
    ``plane_halfsize`` optionally deactivates the contact when the sphere
    center leaves a square patch of that half-extent around plane_point,
    measured along the plane (the components orthogonal to its normal)."""
    STATS["sphere_plane_pair"] += 1
    single = kin.p_w.ndim == 2
    if single:
        kin = Kinematics(*[a[..., None] for a in kin])
        params = _promote(params)
    dev = kin.p_w.device
    n = kin.p_w.shape[-1]
    scale = params.scale.expand(n)                             # (N,)
    off_s = _rows(sphere_offset, dev) * scale[None]            # (3, N)
    pp = _rows(plane_point, dev) * scale[None]
    nrm = _rows(plane_normal, dev).expand(3, n)

    R_s, p_s = kin.R_w[sphere_link], kin.p_w[sphere_link]
    R_p, p_p = kin.R_w[plane_link], kin.p_w[plane_link]
    center = p_s + _mv(R_s, off_s)
    n_w = _mv(R_p, nrm)
    pp_w = p_p + _mv(R_p, pp)
    dist = ((center - pp_w) * n_w).sum(0)                      # (N,)
    r_scaled = radius * scale
    depth = r_scaled - dist
    contact_pt = center - n_w * r_scaled[None]

    def point_vel(link, pt):
        R = kin.R_w[link]
        w = _mv(R, kin.v[link, :3])
        vl = _mv(R, kin.v[link, 3:])
        return vl + _cross(w, pt - kin.p_w[link])

    v_rel = point_vel(sphere_link, contact_pt) - \
        point_vel(plane_link, contact_pt)
    v_n = (v_rel * n_w).sum(0)
    mass = params.mass.T                                       # (nb, N)
    m_s = mass[sphere_link]
    m_p = mass[plane_link]
    m_eff = 1.0 / (1.0 / m_s + 1.0 / torch.clamp(m_p, min=1e-6))
    f_n_mag = m_eff * (depth / tau ** 2 + 2.0 * zeta * (-v_n) / tau)
    active = depth > 0
    if plane_halfsize is not None:
        # Gate on the TANGENTIAL extent of the plane-frame offset, so a
        # patch of any normal direction is bounded along both of its axes.
        local = _mvT(R_p, center - pp_w)                       # (3, N)
        l_t = torch.abs(local - (local * nrm).sum(0, keepdim=True) * nrm)
        active = active & (l_t.amax(0) < plane_halfsize)
    f_n_mag = torch.where(active, torch.clamp(f_n_mag, min=0.0),
                          torch.zeros_like(f_n_mag))
    v_t = v_rel - v_n[None] * n_w
    v_t_norm = torch.sqrt((v_t * v_t).sum(0)) + 1e-8
    inertia = torch.movedim(params.inertia, 0, -1)             # (nb, 3, N)
    i_mean = inertia[sphere_link].mean(0) + 1e-8
    # The rotational lever of the slip-stopping cap is the true moment arm
    # |contact_pt - link origin| (as in ground_contact_forces), not the
    # sphere radius: for a sphere mounted far from its link origin the
    # radius-based cap would overshoot and reverse the slip each step.
    arm_sq = ((contact_pt - p_s) ** 2).sum(0)
    m_eff_t = 1.0 / (1.0 / m_s + arm_sq / i_mean)
    mu_n = _const(mu, dev).expand(n)
    cap = torch.minimum(mu_n * f_n_mag, m_eff_t * v_t_norm / dt)
    f_t = -v_t / v_t_norm[None] * cap[None]
    force = n_w * f_n_mag[None] + f_t                          # on sphere
    f_ext = kin.p_w.new_zeros(model.nb, 6, n)
    f_ext[sphere_link] += torch.cat([_cross(contact_pt - p_s, force),
                                     force])
    f_ext[plane_link] += torch.cat([_cross(contact_pt - p_p, -force),
                                    -force])
    return f_ext[..., 0] if single else f_ext


# --------------------------------------------------------------------- #
# Multi-pair penalty contacts.
# --------------------------------------------------------------------- #
# Static host tables (link indices, offsets, radii) turned into tensors,
# by value and device: the tasks pass the same few arrays every substep.
_CONSTS: dict = {}


def _const(x, device, dtype=torch.float32) -> torch.Tensor:
    """A tensor on ``device`` of ``x``: tensors are moved, host arrays and
    lists are copied once and cached by value."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    a = np.asarray(x)
    key = (a.dtype.str, a.shape, a.tobytes(), str(dtype), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return t


def _links(x, device) -> torch.Tensor:
    return _const(np.asarray(x, np.int64), device, torch.int64)


def _scatter(links, nb: int, device) -> torch.Tensor:
    """One-hot (nb, P) fold of per-pair wrenches onto their links."""
    g = np.zeros((nb, len(links)), np.float32)
    g[np.asarray(links, np.int64), np.arange(len(links))] = 1.0
    return _const(g, device)


def _per_pair_vec(x, P, n, dev):
    """(P, 3) static or (P, 3, N) env-last -> (P, 3, N)."""
    x = _const(x, dev)
    if x.ndim == 2:
        x = x[:, :, None]
    return x.expand(P, 3, n)


def _per_pair(x, P, n, dev):
    """Scalar, (P,) or (P, N) -> (P, N)."""
    return _const(x, dev).reshape(P, -1).expand(P, n)


def _mu_rows(mu, P, n, dev):
    """Friction: scalar or (P,) broadcast over envs, or (P, N) as is."""
    mu = _const(mu, dev)
    return mu.reshape(-1, 1).expand(P, n) if mu.ndim <= 1 else mu


def _batched(kin, params):
    """(kin, params, single): single-env kinematics promoted to N = 1."""
    single = kin.p_w.ndim == 2
    if single:
        kin, params = _promote_kin(kin), _promote(params)
    return kin, params, single


def _point_vel(R, p, v6, pt):
    """World velocity of points pt on links with rotation R, origin p and
    body-coordinate spatial velocity v6 = [w; vl] at the origin."""
    w = _mv(R, v6[:, :3])
    vl = _mv(R, v6[:, 3:])
    return vl + _cross(w, pt - p)


def _penalty_force(v_rel, n_w, depth, active, m_eff, m_eff_t, mu, dt, tau,
                   zeta):
    """The mass-adaptive penalty model on P pairs: normal spring-damper
    m_eff (depth / tau^2 - 2 zeta v_n / tau), clamped >= 0 where
    ``active``, and Coulomb friction capped by the slip-stopping impulse
    m_eff_t |v_t| / dt. Returns the force on body a, (P, 3, N)."""
    v_n = (v_rel * n_w).sum(1)
    f_n_mag = m_eff * (depth / tau ** 2 + 2.0 * zeta * (-v_n) / tau)
    f_n_mag = torch.where(active, torch.clamp(f_n_mag, min=0.0),
                          torch.zeros_like(f_n_mag))
    v_t = v_rel - v_n[:, None, :] * n_w
    v_t_norm = torch.sqrt((v_t * v_t).sum(1)) + 1e-8
    cap = torch.minimum(mu * f_n_mag, m_eff_t * v_t_norm / dt)
    f_t = -v_t / v_t_norm[:, None, :] * cap[:, None, :]
    return n_w * f_n_mag[:, None, :] + f_t


def sphere_plane_pairs_forces(model: ArticulatedModel, kin: Kinematics,
                              params: DynParams, sphere_links,
                              sphere_offsets, radii, plane_links,
                              plane_points, plane_normals, mu,
                              dt=1.0 / 60.0, tau=0.02, zeta=1.0,
                              plane_halfsizes=None,
                              return_geometry=False, forces=True):
    """Vectorized form of ``sphere_plane_pair_forces`` over P pairs at
    once: one set of tensor ops instead of P calls.

    sphere_links/plane_links: static (P,) ints. sphere_offsets/
    plane_points: (P, 3) static or (P, 3, N) env-last (in the sphere/plane
    body frames; multiplied by params.scale). plane_normals: (P, 3) static
    or (P, 3, N) env-last unit normals (not scaled). radii: (P,) or
    (P, N). mu: scalar, (P,), or (P, N). plane_halfsizes: None, (P,), or
    (P, N): the tangential half-extent of each patch. Returns env-last
    (nb, 6, N) ((nb, 6) for single-env kin); with ``return_geometry``
    also (n_w, depth, contact_pt) for the impulse pass, pairs outside
    their patch at depth -1; with ``forces=False`` only (None, geometry)
    (the impulse pass owns these contacts)."""
    STATS["sphere_plane_pairs"] += 1
    kin, params, single = _batched(kin, params)
    dev = kin.p_w.device
    n = kin.p_w.shape[-1]
    P = len(sphere_links)
    scale = params.scale.expand(n)
    s_idx, p_idx = _links(sphere_links, dev), _links(plane_links, dev)

    off_s = _per_pair_vec(sphere_offsets, P, n, dev) * scale
    pp = _per_pair_vec(plane_points, P, n, dev) * scale
    nrm = _per_pair_vec(plane_normals, P, n, dev)
    radii_j = _per_pair(radii, P, n, dev) * scale

    R_s, p_s = kin.R_w[s_idx], kin.p_w[s_idx]
    R_p, p_p = kin.R_w[p_idx], kin.p_w[p_idx]
    center = p_s + _mv(R_s, off_s)
    n_w = _mv(R_p, nrm)
    pp_w = p_p + _mv(R_p, pp)
    dist = ((center - pp_w) * n_w).sum(1)                      # (P, N)
    depth = radii_j - dist
    contact_pt = center - n_w * radii_j[:, None, :]
    patch_ok = None
    if plane_halfsizes is not None:
        hs = _per_pair(plane_halfsizes, P, n, dev)
        # Gate on the tangential extent: project out the normal component,
        # so both in-plane axes are bounded whatever the normal's
        # plane-frame direction.
        local = _mvT(R_p, center - pp_w)                       # (P, 3, N)
        l_t = torch.abs(local - (local * nrm).sum(1, keepdim=True) * nrm)
        patch_ok = l_t.amax(1) < hs
    depth_eff = depth if patch_ok is None else torch.where(
        patch_ok, depth, torch.full_like(depth, -1.0))
    if not forces:
        assert return_geometry and not single
        return None, (n_w, depth_eff, contact_pt)

    v_rel = (_point_vel(R_s, p_s, kin.v[s_idx], contact_pt)
             - _point_vel(R_p, p_p, kin.v[p_idx], contact_pt))
    mass = params.mass.T                                       # (nb, N)
    m_s, m_p = mass[s_idx], mass[p_idx]
    m_eff = 1.0 / (1.0 / m_s + 1.0 / torch.clamp(m_p, min=1e-6))
    active = depth > 0 if patch_ok is None else (depth > 0) & patch_ok
    i_mean = torch.movedim(params.inertia, 0, -1).mean(1)[s_idx] + 1e-8
    # True moment arm, not the sphere radius (see sphere_plane_pair_forces).
    arm_sq = ((contact_pt - p_s) ** 2).sum(1)
    m_eff_t = 1.0 / (1.0 / m_s + arm_sq / i_mean)
    force = _penalty_force(v_rel, n_w, depth, active, m_eff, m_eff_t,
                           _mu_rows(mu, P, n, dev), dt, tau, zeta)
    wr_s = torch.cat([_cross(contact_pt - p_s, force), force], 1)
    wr_p = torch.cat([_cross(contact_pt - p_p, -force), -force], 1)
    out = (_fold(_scatter(sphere_links, model.nb, dev), wr_s)
           + _fold(_scatter(plane_links, model.nb, dev), wr_p))
    if return_geometry:
        return out, (n_w, depth_eff, contact_pt)
    return out[..., 0] if single else out


def sphere_box_pairs_forces(model: ArticulatedModel, kin: Kinematics,
                            params: DynParams, sphere_links,
                            sphere_offsets, radii, box_link, box_half,
                            mu, dt=1.0 / 60.0, tau=0.02, zeta=1.0,
                            return_geometry=False, forces=True):
    """Penalty contacts between P spheres on an articulated body and one
    box-shaped link, with exact closest-point geometry: the contact point
    is the sphere center clamped to the box (faces, edges and corners
    alike); for a center inside the box the least-penetrated face is
    used.

    Same penalty model and batching as ``sphere_plane_pairs_forces``.
    sphere_links: static (P,) ints. sphere_offsets: (P, 3) static or
    (P, 3, N) env-last (sphere-link frame, scaled by params.scale). radii:
    (P,) or (P, N) (scaled). box_half: half-extents in the box frame, not
    scaled by params.scale: scalar, (N,), (3,) or (3, N) (a length-3
    vector is read as the three axes; pass (3, N) at 3 envs). mu: scalar,
    (P,) or (P, N). Returns env-last (nb, 6, N), or with
    ``return_geometry`` also (n_w, depth, contact_pt)."""
    STATS["sphere_box_pairs"] += 1
    kin, params, single = _batched(kin, params)
    dev = kin.p_w.device
    n = kin.p_w.shape[-1]
    P = len(sphere_links)
    scale = params.scale.expand(n)
    s_idx = _links(sphere_links, dev)

    off = _per_pair_vec(sphere_offsets, P, n, dev) * scale
    r_j = _per_pair(radii, P, n, dev) * scale
    half_a = _const(box_half, dev)
    if half_a.ndim <= 1 and tuple(half_a.shape) != (3,):
        half = half_a.reshape(1, -1).expand(3, n)
    else:
        half = half_a.reshape(3, -1).expand(3, n)

    R_s, p_s = kin.R_w[s_idx], kin.p_w[s_idx]
    R_b, p_b, v_b = kin.R_w[box_link], kin.p_w[box_link], kin.v[box_link]
    center = p_s + _mv(R_s, off)                               # (P, 3, N)
    local = _mvT(R_b[None], center - p_b[None])                # box frame
    clamped = torch.maximum(torch.minimum(local, half[None]), -half[None])
    delta = local - clamped
    dist_out = torch.sqrt((delta * delta).sum(1))              # (P, N)
    inside = dist_out <= 0.0
    # Outside: normal along center - closest; contact point = closest.
    n_out = delta / torch.clamp(dist_out, min=1e-9)[:, None, :]
    # Inside: the least-penetrated face (one-hot over the 3 axes).
    s_in = half[None] - torch.abs(local)                       # (P, 3, N)
    # One-hot by comparison: F.one_hot checks its classes with a host sync
    # on the CPU.
    sel = (torch.argmin(s_in, dim=1, keepdim=True)
           == torch.arange(3, device=dev)[None, :, None]).to(local.dtype)
    sgn = torch.sign(local)
    n_in = sel * sgn
    pt_in = local * (1.0 - sel) + sel * sgn * half[None]
    depth = torch.where(inside, r_j + (sel * s_in).sum(1), r_j - dist_out)
    n_loc = torch.where(inside[:, None, :], n_in, n_out)
    pt_loc = torch.where(inside[:, None, :], pt_in, clamped)
    n_w = _mv(R_b[None], n_loc)
    contact_pt = p_b[None] + _mv(R_b[None], pt_loc)
    if not forces:
        assert return_geometry and not single
        return None, (n_w, depth, contact_pt)

    w_b = _mv(R_b, v_b[:3])                                    # (3, N)
    vl_b = _mv(R_b, v_b[3:])
    v_box = vl_b[None] + _cross(w_b[None].expand_as(contact_pt),
                                contact_pt - p_b[None])
    v_rel = _point_vel(R_s, p_s, kin.v[s_idx], contact_pt) - v_box
    mass = params.mass.T                                       # (nb, N)
    m_s = mass[s_idx]
    m_b = mass[box_link][None]
    m_eff = 1.0 / (1.0 / m_s + 1.0 / torch.clamp(m_b, min=1e-6))
    i_mean = torch.movedim(params.inertia, 0, -1).mean(1)[s_idx] + 1e-8
    arm_sq = ((contact_pt - p_s) ** 2).sum(1)
    m_eff_t = 1.0 / (1.0 / m_s + arm_sq / i_mean)
    force = _penalty_force(v_rel, n_w, depth, depth > 0, m_eff, m_eff_t,
                           _mu_rows(mu, P, n, dev), dt, tau, zeta)
    wr_s = torch.cat([_cross(contact_pt - p_s, force), force], 1)
    wr_b = torch.cat([_cross(contact_pt - p_b[None], -force), -force], 1)
    out = _fold(_scatter(sphere_links, model.nb, dev), wr_s)
    out[box_link] += wr_b.sum(0)
    if return_geometry:
        return out, (n_w, depth, contact_pt)
    return out[..., 0] if single else out


def _sphere_pair_geometry(model: ArticulatedModel, kin: Kinematics,
                          params: DynParams, links_a, offsets_a, radii_a,
                          links_b, offsets_b, radii_b):
    """Env-last sphere-pair contact geometry of P sphere-sphere pairs: link
    gathers, world sphere centers, center-line normals (b -> a),
    penetration depth and contact points. Expects env-last (promoted)
    ``kin``/``params``. Coincident centers are guarded to a fixed
    direction (the depth clamp makes the force zero there). Returns
    (idx_a, idx_b, R_a, p_a, v_a, R_b, p_b, v_b, r_a, r_b, n_w, depth,
    contact_pt)."""
    dev = kin.p_w.device
    n = kin.p_w.shape[-1]
    P = len(links_a)
    scale = params.scale.expand(n)
    idx_a, idx_b = _links(links_a, dev), _links(links_b, dev)
    off_a = _per_pair_vec(offsets_a, P, n, dev) * scale
    off_b = _per_pair_vec(offsets_b, P, n, dev) * scale
    r_a = _per_pair(radii_a, P, n, dev) * scale
    r_b = _per_pair(radii_b, P, n, dev) * scale
    R_a, p_a, v_a = kin.R_w[idx_a], kin.p_w[idx_a], kin.v[idx_a]
    R_b, p_b, v_b = kin.R_w[idx_b], kin.p_w[idx_b], kin.v[idx_b]
    c_a = p_a + _mv(R_a, off_a)
    c_b = p_b + _mv(R_b, off_b)
    d = c_a - c_b                                              # (P, 3, N)
    dist = torch.sqrt((d * d).sum(1))                          # (P, N)
    n_w = d / torch.clamp(dist, min=1e-9)[:, None, :]          # b -> a
    depth = (r_a + r_b) - dist
    contact_pt = c_a - n_w * r_a[:, None, :]
    return (idx_a, idx_b, R_a, p_a, v_a, R_b, p_b, v_b, r_a, r_b,
            n_w, depth, contact_pt)


def sphere_sphere_pairs_forces(model: ArticulatedModel, kin: Kinematics,
                               params: DynParams, links_a, offsets_a,
                               radii_a, links_b, offsets_b, radii_b,
                               mu=1.0, dt=1.0 / 60.0, tau=0.02,
                               zeta=1.0, return_geometry=False,
                               forces=True):
    """Penalty contacts between P pairs of spheres on (possibly the same)
    articulated body, e.g. finger-finger collisions. Same penalty model
    and batching as ``sphere_plane_pairs_forces``, with the center-center
    direction as the normal and both bodies' moment arms in the
    tangential cap.

    links_a/links_b: static (P,) ints. offsets_a/offsets_b: (P, 3) static
    or (P, 3, N) env-last, in each link's frame (scaled by params.scale).
    radii: (P,) or (P, N). mu: scalar, (P,) or (P, N). Returns env-last
    (nb, 6, N) ((nb, 6) for single-env kin)."""
    STATS["sphere_sphere_pairs"] += 1
    kin, params, single = _batched(kin, params)
    dev = kin.p_w.device
    n = kin.p_w.shape[-1]
    P = len(links_a)
    (idx_a, idx_b, R_a, p_a, v_a, R_b, p_b, v_b, _r_a, _r_b,
     n_w, depth, contact_pt) = _sphere_pair_geometry(
        model, kin, params, links_a, offsets_a, radii_a,
        links_b, offsets_b, radii_b)
    if not forces:
        assert return_geometry and not single
        return None, (n_w, depth, contact_pt)
    v_rel = (_point_vel(R_a, p_a, v_a, contact_pt)
             - _point_vel(R_b, p_b, v_b, contact_pt))
    mass = params.mass.T                                       # (nb, N)
    m_a, m_b = mass[idx_a], mass[idx_b]
    m_eff = 1.0 / (1.0 / m_a + 1.0 / torch.clamp(m_b, min=1e-6))
    i_link = torch.movedim(params.inertia, 0, -1).mean(1)     # (nb, N)
    i_mean, i_mean_b = i_link[idx_a] + 1e-8, i_link[idx_b] + 1e-8
    arm_a = ((contact_pt - p_a) ** 2).sum(1)
    arm_b = ((contact_pt - p_b) ** 2).sum(1)
    m_eff_t = 1.0 / (1.0 / m_a + 1.0 / m_b + arm_a / i_mean
                     + arm_b / i_mean_b)
    force = _penalty_force(v_rel, n_w, depth, depth > 0, m_eff, m_eff_t,
                           _mu_rows(mu, P, n, dev), dt, tau, zeta)
    wr_a = torch.cat([_cross(contact_pt - p_a, force), force], 1)
    wr_b = torch.cat([_cross(contact_pt - p_b, -force), -force], 1)
    out = (_fold(_scatter(links_a, model.nb, dev), wr_a)
           + _fold(_scatter(links_b, model.nb, dev), wr_b))
    if return_geometry:
        return out, (n_w, depth, contact_pt)
    return out[..., 0] if single else out


# --------------------------------------------------------------------- #
# The velocity-level impulse pass.
# --------------------------------------------------------------------- #
def contact_pairs_impulse(model: ArticulatedModel, kin: Kinematics, factor,
                          v, links_a, links_b, n_w, depth, contact_pt, dt,
                          beta=0.2, max_bias=1.0, iters=4, slop=0.0):
    """Velocity-level resolution of P contact pairs with precomputed
    geometry: returns the generalized velocity ``v`` (N, nv) with
    non-penetration impulses applied.

    A position drive can press two light links together harder than any
    explicitly stable penalty spring on their effective mass can resist
    (k <= 4 m_eff / h^2 caps the static force), so driven fingers would
    cross each other and the cube. The impulse pass is the velocity-level
    construction a PhysX-style solver uses, on the engine's own machinery:

    * contact Jacobian rows come from the FK's world-Plücker dof
      subspaces: J[c, m] = (anc[a_c, m] - anc[b_c, m])
      n_c . (S_lin[m] + S_ang[m] x (pt_c - o));
    * the Delassus operator J M^-1 J^T reuses the substep's own mass
      factorization (``forward_dynamics(..., return_factor=True)``),
      implicit-drive diagonal included, so the impulse works against the
      servo impedance;
    * a fixed number of projected mass-splitting Jacobi sweeps solves the
      contact LCP with a clamped Baumgarte bias beta (depth - slop) / dt
      (at most ``max_bias``).

    ``slop`` (scalar, (P,) or (P, N)) is the allowed rest penetration:
    the impulse engages only at depth > slop. Geometry is env-last:
    n_w/contact_pt (P, 3, N), n from body b toward body a, depth (P, N)
    positive in penetration (-1 for a pair gated off). Normal rows only.

    For multi-substep steps call ``contact_pairs_impulse_prepare`` once a
    control step (the Jacobian and its factors) and
    ``contact_pairs_impulse_apply`` every substep."""
    payload = contact_pairs_impulse_prepare(
        model, kin, factor, links_a, links_b, n_w, contact_pt)
    return contact_pairs_impulse_apply(payload, v, depth, dt, beta=beta,
                                       max_bias=max_bias, iters=iters,
                                       slop=slop)


def _closure_groups(chains, d_anc):
    """Static row grouping of the JAX package's compact route: each
    constraint row's L^-T fill stays inside the ancestor closure of its
    Jacobian support, and rows whose closures nest (at most 2 dofs of
    padding a row) share a group. Returns [(rows (g,) int32 asc, dofs
    tuple asc)] covering all rows exactly once. The port's route holds
    every row on its own closure (``_impulse_tables``) and does not need
    the groups; they are kept for parity."""
    R = d_anc.shape[0]
    clos = []
    for r in range(R):
        s = set(np.nonzero(d_anc[r])[0].tolist())
        c = set(s)
        for d in s:
            c |= set(chains[d])
        clos.append(frozenset(c))
    uniq = {}
    for r, c in enumerate(clos):
        uniq.setdefault(c, []).append(r)
    merged = []                                 # [closure, rows]
    for c in sorted(uniq, key=len, reverse=True):
        target = None
        for m in merged:
            if c <= m[0] and len(m[0]) - len(c) <= 2:
                target = m
                break
        if target is None:
            merged.append([c, list(uniq[c])])
        else:
            target[1].extend(uniq[c])
    return [(np.asarray(sorted(rows), np.int32), tuple(sorted(c)))
            for c, rows in merged]


def _padded_rows(sets: Sequence[Sequence[int]], nv: int) -> np.ndarray:
    """Each row's dof set, ascending, padded to the longest with dofs
    outside the set (where that row's entries are zero): (R, K) int64."""
    K = max((len(s) for s in sets), default=0)
    idx = np.zeros((len(sets), K), np.int64)
    for r, s in enumerate(sets):
        s = sorted(s)
        outside = [d for d in range(nv) if d not in set(s)]
        idx[r] = s + outside[:K - len(s)]
    return idx


def _scatter_table(flat: np.ndarray, nv: int) -> np.ndarray:
    """The inverse of a flat (F,) dof index: row d lists, ascending, the
    positions p with flat[p] == d, padded with F (``_scatter_sum``'s zero
    row): (nv, max count) int64."""
    pos = [np.flatnonzero(flat == d) for d in range(nv)]
    width = max((len(p) for p in pos), default=0)
    out = np.full((nv, max(width, 1)), len(flat), np.int64)
    for d, p in enumerate(pos):
        out[d, :len(p)] = p
    return out


def _scatter_sum(vals: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(F, N) rows summed into (nv, N) by ``_scatter_table``: each dof's
    rows in ascending position, the same sum at every run. (index_add_
    adds with atomics on a card, in an order that changes between runs.)"""
    padded = torch.cat([vals, vals.new_zeros(1, vals.shape[1])])
    return padded[table].sum(1)


def _impulse_tables(model: ArticulatedModel, row_links_a, row_links_b,
                    links_a, links_b, device) -> dict:
    """Static tables of one row layout, built once per model and device:
    d_anc (R, nv) = anc[a] - anc[b], the pair-sharing mask (P, P), each
    row's ancestor closure and each row's support, padded ((R, Kc) and
    (R, Ks) dof indices: ``_padded_rows``)."""
    key = (tuple(row_links_a), tuple(row_links_b), tuple(links_a),
           tuple(links_b), str(torch.device(device)))
    cache = model.__dict__.setdefault("_torch_impulse_tables", {})
    t = cache.get(key)
    if t is None:
        anc = np.asarray(model.anc_dof)
        d_anc = (anc[np.asarray(row_links_a)]
                 - anc[np.asarray(row_links_b)]).astype(np.float32)
        la, lb = np.asarray(links_a), np.asarray(links_b)
        share = ((la[:, None] == la[None]) | (la[:, None] == lb[None])
                 | (lb[:, None] == la[None]) | (lb[:, None] == lb[None]))
        chains = model.dof_anc_chains
        support = [np.nonzero(row)[0].tolist() for row in d_anc]
        closure = [sorted(set(s).union(*[chains[d] for d in s]))
                   for s in support]

        def idx(x):
            return torch.as_tensor(x, device=device)
        clos = _padded_rows(closure, model.nv)
        sup = _padded_rows(support, model.nv)
        t = dict(d_anc=d_anc, d_anc_t=idx(d_anc),
                 share=idx(share.astype(np.float32)),
                 clos=idx(clos),
                 clos_scatter=idx(_scatter_table(clos.reshape(-1),
                                                 model.nv)),
                 sup=idx(sup),
                 sup_scatter=idx(_scatter_table(sup.reshape(-1),
                                                model.nv)),
                 sup_max=sup.shape[1])
        cache[key] = t
    return t


def _impulse_rows(model: ArticulatedModel, kin: Kinematics, links_a,
                  links_b, n_w, contact_pt, mu=None, fric_pairs=None):
    """The constraint rows of ``contact_pairs_impulse_prepare``, before the
    mass factor: directions, contact points, link pairs, the dense masked
    Jacobian J (R, nv, N) and the static tables."""
    dev = n_w.device
    n = n_w.shape[-1]
    P = len(links_a)
    fidx = mu_j = None
    if mu is not None:
        fidx = (np.arange(P, dtype=np.int64) if fric_pairs is None
                else np.asarray(fric_pairs, np.int64))
        f_t = _links(fidx, dev)
        n_f = n_w[f_t]                                         # (F, 3, N)
        # Branchless orthonormal tangent basis from each normal: the
        # helper axis is x-hat where the normal is mostly not along x,
        # else y-hat (never parallel).
        one = torch.ones_like(n_f[:, :1])
        zero = torch.zeros_like(one)
        e = torch.where(torch.abs(n_f[:, 0:1]) < 0.9,
                        torch.cat([one, zero, zero], 1),
                        torch.cat([zero, one, zero], 1))
        t1 = _cross(n_f, e)
        t1 = t1 / (torch.sqrt((t1 * t1).sum(1, keepdim=True)) + 1e-9)
        t2 = _cross(n_f, t1)
        dirs = torch.cat([n_w, t1, t2], 0)                     # (P+2F, 3, N)
        cpt_f = contact_pt[f_t]
        cpt = torch.cat([contact_pt, cpt_f, cpt_f], 0)
        la_f = [links_a[i] for i in fidx]
        lb_f = [links_b[i] for i in fidx]
        row_links_a = list(links_a) + la_f * 2
        row_links_b = list(links_b) + lb_f * 2
        mu_j = _mu_rows(mu, len(fidx), n, dev)
    else:
        dirs, cpt = n_w, contact_pt
        row_links_a, row_links_b = list(links_a), list(links_b)
    tables = _impulse_tables(model, row_links_a, row_links_b, links_a,
                             links_b, dev)
    S_ang, S_lin = kin.S_o[:, :3], kin.S_o[:, 3:]              # (nv, 3, N)
    # n . (S_lin + S_ang x (pt - o)) = n . S_lin + S_ang . ((pt - o) x n)
    rxn = _cross(cpt - kin.o[None], dirs)                      # (R, 3, N)
    J = ((dirs[:, None] * S_lin[None]).sum(2)
         + (rxn[:, None] * S_ang[None]).sum(2))                # (R, nv, N)
    J = J * tables["d_anc_t"][:, :, None]
    return dict(J=J, dirs=dirs, cpt=cpt, tables=tables, P=P, fidx=fidx,
                mu=mu_j, row_links_a=tuple(row_links_a),
                row_links_b=tuple(row_links_b), nv=model.nv)


def _prepare_y(model: ArticulatedModel, factor, rows) -> dict:
    """The tree factor's route ("Y"): M^-1 = L^-1 D^-1 L^-T, split after
    the up pass. Y = L^-T J^T keeps each row on its ancestor closure (at
    most 13 of ShadowHand's 30 dofs), so the Delassus application in the
    sweeps is u = sum_r lam_r Y_r, (J M^-1 J^T lam)_r = Y_r . D^-1 u on
    closure-compact (R, K, N) tensors, and the one down-solve L^-1 D^-1 u
    runs once per apply call. One up-solve launch takes all R rows: a row
    that is zero outside its closure stays so."""
    t = rows["tables"]
    chains = model.dof_anc_chains
    H, D = factor[1]
    J = rows["J"]
    R, nv, n = J.shape
    clos = t["clos"]
    gather = clos[:, :, None].expand(R, clos.shape[1], n)
    Y = tree_upsolve(chains, H, J).gather(1, gather)           # (R, K, N)
    Jc = J.gather(1, gather)
    invD = 1.0 / D                                             # (nv, N)
    diag = (Y * Y * invD[clos]).sum(1) + 1e-9                  # (R, N)
    return dict(mode="Y", Y=Y, J_c=Jc, clos=clos,
                clos_scatter=t["clos_scatter"], invD=invD, diag=diag,
                share=t["share"], mu=rows["mu"], P=rows["P"],
                fidx=rows["fidx"], chains=chains, H=H, nv=nv,
                dirs=rows["dirs"], cpt=rows["cpt"],
                row_links_a=rows["row_links_a"],
                row_links_b=rows["row_links_b"])


def _prepare_x(model: ArticulatedModel, factor, rows) -> dict:
    """The dense route ("X"): the columns X = M^-1 J^T (R, nv, N) from the
    factor (``mass_factor_solve``, any factor kind), and J compacted to
    each row's support (the symmetric difference of the two links'
    ancestor dofs) when that is under 3/4 of nv."""
    t = rows["tables"]
    J = rows["J"]
    R, nv, n = J.shape
    X = mass_factor_solve(model, factor, J)                    # (R, nv, N)
    diag = (J * X).sum(1) + 1e-9                               # (R, N)
    if t["sup_max"] < 0.75 * nv:
        sup = t["sup"]
        J_c = J.gather(1, sup[:, :, None].expand(R, sup.shape[1], n))
        sup_scatter = t["sup_scatter"]
    else:
        sup, J_c, sup_scatter = None, J, None
    return dict(mode="X", J_c=J_c, sup=sup, sup_scatter=sup_scatter, X=X,
                diag=diag, share=t["share"], mu=rows["mu"], P=rows["P"],
                fidx=rows["fidx"], nv=nv, dirs=rows["dirs"],
                cpt=rows["cpt"], row_links_a=rows["row_links_a"],
                row_links_b=rows["row_links_b"])


def contact_pairs_impulse_prepare(model: ArticulatedModel, kin: Kinematics,
                                  factor, links_a, links_b, n_w, contact_pt,
                                  mu=None, fric_pairs=None) -> dict:
    """The geometry-slow half of ``contact_pairs_impulse``: the contact
    Jacobian rows and their factors against the substep's mass
    factorization, reusable across a control step's substeps.

    With ``mu`` each friction pair (``fric_pairs``, default all pairs)
    gains two tangential rows on an orthonormal basis of its normal, and
    the apply sweeps box-project them to |lam_t| <= mu lam_n: Coulomb
    friction at the velocity level in the same projected Jacobi. ``mu``
    (scalar, (F,) or (F, N)) aligns with ``fric_pairs``. Row layout:
    [P normals, F t1, F t2].

    The route follows the factor: a tree factor takes the compact
    half-solve route (``_prepare_y``), a dense one the M^-1 J^T columns
    (``_prepare_x``). The payload describes its rows (``dirs``, ``cpt``,
    ``row_links_a``/``row_links_b``) for force-sensor readers
    (``impulse_row_forces``)."""
    rows = _impulse_rows(model, kin, links_a, links_b, n_w, contact_pt,
                         mu=mu, fric_pairs=fric_pairs)
    if factor[0] == "tree":
        return _prepare_y(model, factor, rows)
    return _prepare_x(model, factor, rows)


def _rows_dot(G, idx, x):
    """(G_r . x[idx_r]) for every row: G (R, K, N), idx (R, K), x (nv, N)
    -> (R, N)."""
    return (G * x[idx]).sum(1)


def contact_pairs_impulse_apply(payload, v, depth, dt, beta=0.2,
                                max_bias=1.0, iters=4, slop=0.0,
                                warm=None, return_warm=False):
    """The per-substep half of ``contact_pairs_impulse``: speculative
    targets from the current depth, projected mass-splitting Jacobi sweeps
    against the prepared rows, applied to the current (predicted
    post-substep) velocity v (N, nv).

    ``warm`` carries the previous substep's ``(lam, w)`` (returned with
    ``return_warm=True``): within a control step the payload is shared and
    depth and velocity move O(h), so the previous solution is a good first
    iterate."""
    mode = payload["mode"]
    diag = payload["diag"]
    mu, fidx = payload["mu"], payload["fidx"]
    P = payload["P"]
    R, n = diag.shape
    vT = v.T                                                   # (nv, N)
    if mode == "Y":
        Y, clos, invD = payload["Y"], payload["clos"], payload["invD"]
        v_n0 = _rows_dot(payload["J_c"], clos, vT)
    else:
        J_c, sup, X = payload["J_c"], payload["sup"], payload["X"]

        def J_dot(x):
            if sup is None:
                return (J_c * x[None]).sum(1)
            return _rows_dot(J_c, sup, x)
        v_n0 = J_dot(vT)

    slop_t = _const(slop, depth.device)
    over = depth - (slop_t.reshape(-1, 1) if slop_t.ndim <= 1 else slop_t)
    # Speculative targets: pairs not yet touching may approach, but only
    # fast enough to reach the slop by the end of the substep (v_n >=
    # (depth - slop) / dt); pairs already past it push out at the
    # Baumgarte rate. A gated-off pair (depth -1) gets a target that never
    # binds, so the lam >= 0 projection keeps it at zero.
    v_tgt = torch.where(over > 0.0,
                        torch.clamp(beta * over / dt, max=max_bias),
                        over / dt)
    if mu is not None:
        # Tangential rows target zero slip velocity, no bias.
        v_tgt = torch.cat([v_tgt, v_tgt.new_zeros(R - P, n)], 0)
    rhs = v_tgt - v_n0                                         # (R, N)
    if warm is None:
        lam, w = torch.zeros_like(rhs), None
    else:
        lam, w = warm
    # Mass-splitting relaxation: each pair's correction is divided by the
    # number of currently binding pairs that share a body with it (plain
    # Jacobi diverges on redundant sets, e.g. 8 cube corners on one
    # plane). A normal row binds when it wants impulse or carries a
    # warm-started one (which must be free to decay); friction rows take
    # their pair's state.
    bind = ((rhs[:P] > 0.0) | (lam[:P] > 0.0)).to(rhs.dtype)
    deg = _fold(payload["share"], bind)                        # (P, N)
    omega = bind / torch.clamp(deg, min=1.0)
    if mu is not None:
        f_t = _links(fidx, rhs.device)
        om_f = omega[f_t]
        omega = torch.cat([omega, om_f, om_f], 0)
    # Each iteration updates lam from the residual at the current w (w =
    # X lam, or u = L^-T J^T lam on the Y route), then refreshes w; the
    # last w is the velocity correction, and a cold start's first residual
    # is rhs itself.
    for _ in range(iters):
        if w is None:
            resid = rhs
        elif mode == "Y":
            resid = rhs - _rows_dot(Y, clos, w * invD)
        else:
            resid = rhs - J_dot(w)
        lam = lam + omega * resid / diag
        if mu is None:
            lam = torch.clamp(lam, min=0.0)
        else:
            # Normals to the positive cone, tangentials to the Coulomb box
            # |lam_t| <= mu lam_n (per friction pair, both axes).
            lam_n = torch.clamp(lam[:P], min=0.0)
            cap2 = (mu * lam_n[f_t]).repeat(2, 1)
            lam = torch.cat([lam_n, torch.clamp(lam[P:], -cap2, cap2)], 0)
        if mode == "Y":
            w = _scatter_sum((Y * lam[:, None]).reshape(-1, n),
                             payload["clos_scatter"])
        else:
            w = (X * lam[:, None]).sum(0)                      # (nv, N)
    if mode == "Y":
        # dv = M^-1 J^T lam = L^-1 (D^-1 u): one down-solve a call. The
        # payload's H is the factor of the substep that prepared it.
        dv = tree_downsolve(payload["chains"], payload["H"], w * invD)
        v_out = (vT + dv).T
    else:
        v_out = (vT + w).T
    return (v_out, (lam, w)) if return_warm else v_out


def impulse_row_forces(payload, lam, dt):
    """World-frame contact force of every prepared row, (R, 3, N):
    ``dirs * lam / dt``. Row r's force acts on ``payload['row_links_a'][r]``
    and its reaction on ``payload['row_links_b'][r]``, at
    ``payload['cpt'][r]``."""
    return payload["dirs"] * (lam / dt)[:, None]


def impulse_generalized_force(payload, lam, dt):
    """Generalized contact force of the solved rows, (nv, N): tau =
    J^T lam / dt, from the payload's own compact Jacobian (both routes)."""
    n = lam.shape[-1]
    if payload["mode"] == "Y":
        J_c, table = payload["J_c"], payload["clos_scatter"]
    else:
        J_c, table = payload["J_c"], payload["sup_scatter"]
        if table is None:
            return (J_c * lam[:, None]).sum(0) / dt
    return _scatter_sum((J_c * lam[:, None]).reshape(-1, n), table) / dt


def sphere_sphere_impulse(model: ArticulatedModel, kin: Kinematics, factor,
                          v, params: DynParams, links_a, offsets_a, radii_a,
                          links_b, offsets_b, radii_b, dt, beta=0.2,
                          max_bias=1.0, iters=4, slop=0.0):
    """``contact_pairs_impulse`` over P sphere-sphere pairs, with the
    center-line geometry of ``_sphere_pair_geometry`` (the input
    conventions of ``sphere_sphere_pairs_forces``)."""
    *_, n_w, depth, contact_pt = _sphere_pair_geometry(
        model, kin, params, links_a, offsets_a, radii_a,
        links_b, offsets_b, radii_b)
    return contact_pairs_impulse(model, kin, factor, v, links_a, links_b,
                                 n_w, depth, contact_pt, dt, beta=beta,
                                 max_bias=max_bias, iters=iters, slop=slop)
