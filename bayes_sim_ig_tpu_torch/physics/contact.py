"""Penalty-based contacts against the ground plane (z = 0) and between a
sphere and a plane patch on two bodies.

Port of ``bayes_sim_ig_tpu/physics/contact.py`` up to its impulse
contacts (``contact_points``, ``_rows``, ``ground_contact_forces``,
``sphere_plane_pair_forces``); the multi-pair and impulse functions are
not ported yet. Contact points are derived from per-link geoms (spheres,
capsule endpoints, box corners), and each penetrating point contributes a
normal spring-damper force plus a smooth Coulomb-capped tangential
friction force, accumulated as world-frame spatial forces about each link
origin and fed to RNEA as external forces.

ENV-LAST layout like the rest of the engine: per-point tensors are
(P, 3, N); the per-point wrench accumulation is a static one-hot (nb, P)
fold. Single-env calls (squeezed Kinematics) work too and return (nb, 6).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .dynamics import Kinematics, _cross, _fold, _mv, _mvT, _promote
from .model import ArticulatedModel, DynParams


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
    two layouts."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
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
    mu_n = torch.as_tensor(mu, dtype=torch.float32, device=dev).expand(n)
    cap = torch.minimum(mu_n * f_n_mag, m_eff_t * v_t_norm / dt)
    f_t = -v_t / v_t_norm[None] * cap[None]
    force = n_w * f_n_mag[None] + f_t                          # on sphere
    f_ext = kin.p_w.new_zeros(model.nb, 6, n)
    f_ext[sphere_link] += torch.cat([_cross(contact_pt - p_s, force),
                                     force])
    f_ext[plane_link] += torch.cat([_cross(contact_pt - p_p, -force),
                                    -force])
    return f_ext[..., 0] if single else f_ext
