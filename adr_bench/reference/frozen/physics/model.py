# Frozen copy of bayes_sim_ig_tpu_torch/physics/model.py (commit 57f9c0d); see frozen/__init__.py for what changed.
"""Articulated-model description: static topology + per-env dynamic params.

Port of ``bayes_sim_ig_tpu/physics/model.py``. A model is declared in code
as a kinematic tree with static topology (numpy tables, the same as the
JAX package's, phantom-link collapse included) and *parameters as data*:
masses, inertias, joint stiffness/damping/friction/armature and geometry
scales are leading-axis-batched tensors (``DynParams``), so domain
randomization never rebuilds a scene.

Joint types: 'free' (6 dof; q = [pos(3), quat(4)]), 'revolute',
'prismatic' (1 dof each), 'fixed' (0 dof). Geoms attach to links for
penalty contacts (see contact.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

JOINT_DOF = {"free": 6, "revolute": 1, "prismatic": 1, "fixed": 0}
JOINT_NQ = {"free": 7, "revolute": 1, "prismatic": 1, "fixed": 0}


@dataclass
class Geom:
    """Collision geometry attached to a link (contact.py consumes these)."""
    link: int
    kind: str                  # 'sphere' | 'capsule' | 'box' | 'point'
    size: Tuple[float, ...]    # sphere: (r,); capsule: (r, half_len);
    #                            box: (hx, hy, hz); point: ()
    offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)  # capsule axis


@dataclass
class LinkSpec:
    name: str
    parent: int                       # -1 for root
    joint_type: str
    joint_axis: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    # Fixed transform from the parent link frame to this joint's frame:
    joint_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    joint_rot: Optional[np.ndarray] = None  # 3x3; None = identity
    mass: float = 1.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inertia: Tuple[float, float, float] = (0.01, 0.01, 0.01)  # diag, @COM
    # Joint dynamics defaults (overridable per env via DynParams):
    stiffness: float = 0.0
    damping: float = 0.0
    friction: float = 0.0
    armature: float = 0.0
    limit_lower: float = -1e9
    limit_upper: float = 1e9
    effort: float = 1e9               # actuator torque/force limit
    # PhysX-style joint velocity limit (maxJointVelocity). Keeps the
    # integrator bounded under extreme DR (e.g. 0.01x link masses give
    # huge qdd; without a clamp velocities diverge exponentially to NaN).
    max_velocity: float = 100.0
    # Marks a near-massless connector link that only exists to realize
    # one dof of a multi-dof joint (the engine is one joint per link).
    # Phantom links are COLLAPSED out of the link-axis tensors at model
    # build: their dofs become a rotation CHAIN on the nearest real
    # descendant link, so FK/composite-inertia/bias folds stream ~40%
    # fewer link rows on Humanoid and the tree depth (and with it the
    # pointer-jumping round count) drops. The dof/q/v layout is
    # unchanged. Requires: revolute/prismatic, exactly one child, no
    # geoms attached. Mass/inertia are folded into the chain's end link
    # (approximation bounded by the phantom mass itself, 0.01 kg here).
    phantom: bool = False


class ArticulatedModel:
    """Static description of one articulated mechanism."""

    def __init__(self, links: Sequence[LinkSpec],
                 geoms: Sequence[Geom] = (),
                 fixed_base: bool = True):
        self.links = list(links)
        self.geoms = list(geoms)
        self.fixed_base = fixed_base
        self.nb = len(self.links)
        self.parent = [l.parent for l in self.links]
        self.joint_types = [l.joint_type for l in self.links]
        # dof/q bookkeeping
        self.q_off: List[int] = []
        self.v_off: List[int] = []
        nq = nv = 0
        for l in self.links:
            self.q_off.append(nq)
            self.v_off.append(nv)
            nq += JOINT_NQ[l.joint_type]
            nv += JOINT_DOF[l.joint_type]
        self.nq, self.nv = nq, nv
        self.joint_axis = np.array([l.joint_axis for l in self.links],
                                   np.float64)
        self.joint_pos = np.array([l.joint_pos for l in self.links],
                                  np.float64)
        self.joint_rot = np.stack([
            np.eye(3) if l.joint_rot is None else np.asarray(l.joint_rot)
            for l in self.links])
        self.mass0 = np.array([l.mass for l in self.links])
        self.com0 = np.array([l.com for l in self.links])
        self.inertia0 = np.array([l.inertia for l in self.links])
        # Per-dof defaults (1-dof joints only; free joints get zeros).
        def dof_vec(attr):
            out = np.zeros(self.nv)
            for i, l in enumerate(self.links):
                if JOINT_DOF[l.joint_type] == 1:
                    out[self.v_off[i]] = getattr(l, attr)
            return out
        self.stiffness0 = dof_vec("stiffness")
        self.damping0 = dof_vec("damping")
        self.friction0 = dof_vec("friction")
        self.armature0 = dof_vec("armature")
        self.limit_lower = dof_vec("limit_lower")
        self.limit_upper = dof_vec("limit_upper")
        self.effort = dof_vec("effort")
        self.max_velocity = dof_vec("max_velocity")
        self.link_index = {l.name: i for i, l in enumerate(self.links)}
        self.dof_names = [l.name for l in self.links
                          if JOINT_DOF[l.joint_type] == 1]
        self.body_names = [l.name for l in self.links]
        self._build_structure()

    def _build_structure(self):
        """Static topology tables consumed by the batched (level/ancestor
        -masked) dynamics in dynamics.py. Everything here is numpy and baked
        into the trace as constants; none of it depends on q/v/params."""
        nb, nv = self.nb, self.nv
        # Tree depth and level partition (links at equal depth have no
        # dependency between them, so FK propagates one level at a time).
        depth = np.zeros(nb, np.int64)
        for i in range(nb):
            depth[i] = 0 if self.parent[i] < 0 else depth[self.parent[i]] + 1
        self.depth = depth
        self.levels = [np.flatnonzero(depth == d).astype(np.int32)
                       for d in range(int(depth.max()) + 1)]
        # anc_bb[b, a] = 1 iff a is an ancestor of b or a == b.
        anc_bb = np.zeros((nb, nb), bool)
        for b in range(nb):
            a = b
            while a >= 0:
                anc_bb[b, a] = True
                a = self.parent[a]
        self.anc_bb = anc_bb
        # Per-dof tables: the link carrying each dof, and the
        # ancestor-or-self mask anc_dof[b, m] = anc_bb[b, link(m)].
        dof_link = np.zeros(nv, np.int32)
        for i, l in enumerate(self.links):
            for k in range(JOINT_DOF[l.joint_type]):
                dof_link[self.v_off[i] + k] = i
        self.dof_link = dof_link
        self.anc_dof = anc_bb[:, dof_link].astype(np.float32)
        # CRBA pair mask: keep (m, n) where M[m, n] = S_m^T IC_{link(m)} S_n
        # is the "deeper uses its composite inertia" entry — link(n) is a
        # strict ancestor of link(m), or same link with m >= n (the lower
        # triangle of a multi-dof joint's own block, diagonal included).
        lm, ln = dof_link[:, None], dof_link[None, :]
        strict_anc = anc_bb[lm, ln] & (depth[lm] > depth[ln])
        same = (lm == ln) & (np.arange(nv)[:, None] >= np.arange(nv)[None])
        self.crba_mask = (strict_anc | same).astype(np.float32)
        # 1-dof joint tables (gather/scatter indices for the batched FK,
        # integrate and limit clamps).
        j1 = [i for i in range(nb)
              if self.joint_types[i] in ("revolute", "prismatic")]
        self.j1_links = np.asarray(j1, np.int32)
        self.j1_q = np.asarray([self.q_off[i] for i in j1], np.int32)
        self.j1_v = np.asarray([self.v_off[i] for i in j1], np.int32)
        self.j1_axis = self.joint_axis[j1].astype(np.float32) \
            if j1 else np.zeros((0, 3), np.float32)
        self.j1_rev = np.asarray(
            [1.0 if self.joint_types[i] == "revolute" else 0.0
             for i in j1], np.float32)
        self.j1_maxv = self.max_velocity[self.j1_v].astype(np.float32) \
            if j1 else np.zeros(0, np.float32)
        self.j1_lo = self.limit_lower[self.j1_v].astype(np.float32) \
            if j1 else np.zeros(0, np.float32)
        self.j1_hi = self.limit_upper[self.j1_v].astype(np.float32) \
            if j1 else np.zeros(0, np.float32)
        self.free_list = [(i, self.q_off[i], self.v_off[i])
                          for i in range(nb)
                          if self.joint_types[i] == "free"]
        # Expanded dof tree: parent dof of each dof (-1 at roots). Dofs of
        # a multi-dof (free) joint chain sequentially, so its 6x6 mass
        # block is dense in ancestor pairs; across links the parent is the
        # last dof of the nearest ancestor link that has dofs. This is the
        # elimination tree of the CRBA mass matrix: its Cholesky/LTDL
        # factor fills in ONLY at ancestor pairs (Featherstone's
        # branch-induced sparsity), which ops/tree_solve.py exploits.
        last_dof = np.full(nb, -1, np.int64)
        dof_parent = np.full(nv, -1, np.int64)
        for i in range(nb):
            p = self.parent[i]
            inherited = last_dof[p] if p >= 0 else -1
            nd = JOINT_DOF[self.joint_types[i]]
            for k in range(nd):
                dof_parent[self.v_off[i] + k] = \
                    inherited if k == 0 else self.v_off[i] + k - 1
            last_dof[i] = self.v_off[i] + nd - 1 if nd else inherited
        self.dof_parent = dof_parent
        # Ancestor chains (excluding self), leaf-to-root order per dof.
        chains = []
        for k in range(nv):
            ch, j = [], dof_parent[k]
            while j >= 0:
                ch.append(int(j))
                j = dof_parent[j]
            chains.append(ch)
        self.dof_anc_chains = chains
        # E_t^T per link (child->parent rotation at q = 0).
        self.joint_rot_T = np.ascontiguousarray(
            self.joint_rot.transpose(0, 2, 1)).astype(np.float32)
        self.parent_pad = np.asarray(
            [p if p >= 0 else nb for p in self.parent], np.int32)
        # Per-dof Vd mask: Vd[i] = sum_m dof_vd_mask[i, m] S_m v_m is the
        # spatial velocity of dof i's OWN (possibly phantom) link — the
        # frame its joint subspace is fixed in, which Sdot = V x S needs.
        # Built from the ORIGINAL (pre-collapse) ancestry so it stays
        # exact when phantom links are collapsed away below.
        self.dof_vd_mask = self.anc_dof[dof_link].astype(np.float32)
        self._build_dof_chains()
        self.collapsed = any(l.phantom for l in self.links)
        if self.collapsed:
            self._collapse_phantoms()

    def _build_dof_chains(self):
        """Per-dof joint-frame tables for the FK's chain-compose stage
        (dynamics.forward_kinematics). Chains only form above phantom
        links, which are collapsed; without them every chain has length 1
        and the tables reduce to the plain one-joint-per-link case."""
        j1 = self.j1_links
        nj = j1.size
        is_ph = np.array([l.phantom for l in self.links], bool)
        row_of = {int(i): r for r, i in enumerate(j1)}
        self.j1_E = self.joint_rot_T[j1].astype(np.float32) \
            if nj else np.zeros((0, 3, 3), np.float32)
        self.j1_t = self.joint_pos[j1].astype(np.float32) \
            if nj else np.zeros((0, 3), np.float32)
        pos = np.zeros(nj, np.int32)
        prev = np.full(nj, -1, np.int32)
        for r, i in enumerate(j1):
            p = self.parent[i]
            if p >= 0 and is_ph[p]:
                pos[r] = pos[row_of[p]] + 1
                prev[r] = row_of[p]
        self.j1_chain_pos = pos
        self.j1_prev = prev
        self.j1_chain_maxpos = int(pos.max()) if nj else 0
        # Last dof of each chain (scatters the composed product to its
        # owning link row): exactly the non-phantom 1-dof links.
        self.j1_last = ~is_ph[j1] if nj else np.zeros(0, bool)

    def _collapse_phantoms(self):
        """Rewrites the LINK-AXIS tables so phantom links disappear:
        their dofs stay (same q/v layout, same dof tree, same LTDL
        elimination order) but attach to the nearest real descendant as
        a joint chain. ``links``/``q_off``/``v_off``/``joint_types`` and
        every per-dof array keep the ORIGINAL indexing; ``nb``,
        ``parent``, ``depth``, ``anc_*``, ``mass0/com0/inertia0``,
        ``joint_pos/joint_rot(_T)``, ``body_names``, ``link_index``,
        ``geoms`` and ``j1_links``/``dof_link`` switch to the collapsed
        (effective) link set."""
        links, parent = self.links, self.parent
        nb0 = len(links)
        children = [[] for _ in range(nb0)]
        for i, p in enumerate(parent):
            if p >= 0:
                children[p].append(i)
        for i, l in enumerate(links):
            if not l.phantom:
                continue
            if l.joint_type not in ("revolute", "prismatic"):
                raise ValueError(f"phantom link {l.name} must be 1-dof")
            if len(children[i]) != 1:
                raise ValueError(f"phantom link {l.name} needs exactly "
                                 f"one child, has {len(children[i])}")
            if any(g.link == i for g in self.geoms):
                raise ValueError(f"phantom link {l.name} carries a geom")
        eff = np.full(nb0, -1, np.int64)   # orig link -> orig target link
        def target(i):
            while links[i].phantom:
                i = children[i][0]
            return i
        for i in range(nb0):
            eff[i] = target(i)
        for i, l in enumerate(links):
            if l.phantom and JOINT_DOF[links[eff[i]].joint_type] != 1:
                raise ValueError(
                    f"phantom chain above {links[eff[i]].name} must end "
                    "in a revolute/prismatic link")
        real = [i for i in range(nb0) if not links[i].phantom]
        new_ix = {i: r for r, i in enumerate(real)}
        nb = len(real)
        # Effective parent: first non-phantom strict ancestor.
        par_eff = []
        for i in real:
            p = parent[i]
            while p >= 0 and links[p].phantom:
                p = parent[p]
            par_eff.append(new_ix[p] if p >= 0 else -1)
        # Fold phantom mass/inertia into the chain's end link (COM
        # mass-weighted, inertia diagonals summed; the chain shares one
        # origin up to the collapsed translations, so the error is
        # bounded by the phantom mass/inertia themselves).
        mass = self.mass0.copy()
        com_m = self.com0 * self.mass0[:, None]
        inert = self.inertia0.copy()
        for i in range(nb0):
            if links[i].phantom:
                t = eff[i]
                mass[t] += self.mass0[i]
                com_m[t] += com_m[i]
                inert[t] += self.inertia0[i]
        self.mass0 = mass[real]
        self.com0 = com_m[real] / np.maximum(self.mass0[:, None], 1e-12)
        self.inertia0 = inert[real]
        # Link-axis static transforms: 1-dof-owning rows route their
        # translation through the per-dof chain tables (j1_t), so their
        # base joint_pos must be zero; fixed/free rows keep theirs.
        jpos = self.joint_pos[real].copy()
        for r, i in enumerate(real):
            if JOINT_DOF[links[i].joint_type] == 1:
                jpos[r] = 0.0
        self.joint_pos = jpos
        self.joint_rot = self.joint_rot[real]
        self.joint_rot_T = np.ascontiguousarray(
            self.joint_rot.transpose(0, 2, 1)).astype(np.float32)
        # Topology tables over effective links.
        self.nb = nb
        self.parent = par_eff
        depth = np.zeros(nb, np.int64)
        for r in range(nb):
            depth[r] = 0 if par_eff[r] < 0 else depth[par_eff[r]] + 1
        self.depth = depth
        self.levels = [np.flatnonzero(depth == d).astype(np.int32)
                       for d in range(int(depth.max()) + 1)]
        self.parent_pad = np.asarray(
            [p if p >= 0 else nb for p in par_eff], np.int32)
        self.anc_bb = self.anc_bb[np.ix_(real, real)]
        self.anc_dof = self.anc_dof[real]
        self.dof_link = np.asarray(
            [new_ix[int(eff[i])] for i in self.dof_link], np.int32)
        self.j1_links = np.asarray(
            [new_ix[int(eff[i])] for i in self.j1_links], np.int32)
        self.free_list = [(new_ix[i], qi, vi)
                          for (i, qi, vi) in self.free_list]
        self.geoms = [Geom(link=new_ix[g.link], kind=g.kind, size=g.size,
                           offset=g.offset, axis=g.axis)
                      for g in self.geoms]
        self.body_names = [links[i].name for i in real]
        self.link_index = {l.name: new_ix[int(eff[i])]
                           for i, l in enumerate(links)}

    def neutral_q(self) -> np.ndarray:
        """q with identity free-joint quaternions and zero joint angles."""
        q = np.zeros(self.nq)
        for i, l in enumerate(self.links):
            if l.joint_type == "free":
                q[self.q_off[i] + 3] = 1.0  # quat w
        return q


class DynParams(NamedTuple):
    """Per-env dynamic parameters, torch tensors on one device (single-env
    shapes documented; a batch of envs adds a leading N axis)."""
    mass: torch.Tensor        # (nb,)
    com: torch.Tensor         # (nb, 3)
    inertia: torch.Tensor     # (nb, 3) diagonal @ COM
    stiffness: torch.Tensor   # (nv,)
    damping: torch.Tensor     # (nv,)
    friction: torch.Tensor    # (nv,) dry joint friction torque
    armature: torch.Tensor    # (nv,)
    gravity: torch.Tensor     # (3,)
    # Contact material / geometry scaling:
    contact_friction: torch.Tensor    # (ngeom,) tangential mu per geom
    restitution: torch.Tensor         # (ngeom,)
    scale: torch.Tensor               # () uniform geometry/length scale

    def rows(self, n: int, **fields) -> "DynParams":
        """A batch of ``n`` envs: every field with a leading N axis
        (expanded views of single-env fields), ``fields`` replacing some of
        them."""
        out = {k: v.expand((n,) + v.shape) for k, v in self._asdict().items()}
        out.update(fields)
        return DynParams(**out)

    @staticmethod
    def defaults(model: ArticulatedModel, gravity=(0.0, 0.0, -9.81),
                 device="cpu"):
        ng = max(len(model.geoms), 1)

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return DynParams(
            mass=f32(model.mass0),
            com=f32(model.com0),
            inertia=f32(model.inertia0),
            stiffness=f32(model.stiffness0),
            damping=f32(model.damping0),
            friction=f32(model.friction0),
            armature=f32(model.armature0),
            gravity=f32(gravity),
            contact_friction=f32(np.ones(ng)),
            restitution=f32(np.zeros(ng)),
            scale=f32(1.0))
