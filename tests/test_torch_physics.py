"""The port's articulated physics against the JAX package on the CPU, on
the same numpy q, v, tau and params (DynParams carried across by
utils/convert.dynparams_from_jax), for the Ant model with up to 8 envs:
spatial algebra, forward kinematics, the packed inertias, RNEA bias, the
CRBA mass matrix, forward dynamics fresh and with a carried factor, ground
contacts, integration and joint limits. Then the oracles of
tests/test_physics.py that this slice reaches (mass matrix symmetric PD,
free fall, frozen vs fresh substeps), and a sparse dof tree that takes
the branch-sparse tree solve.

The JAX functions run eagerly (op by op), which on the CPU costs far less
than compiling the whole Ant step. Tolerances: float32 on both sides with
sums in another order; kinematics and inertias atol 1e-5 (values O(1-10)),
forces and accelerations rtol 1e-4 / atol 1e-4."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bayes_sim_ig_tpu.physics.dynamics as jdyn
from bayes_sim_ig_tpu.physics import DynParams as JaxDynParams
from bayes_sim_ig_tpu.physics import spatial as jspatial
from bayes_sim_ig_tpu.physics.contact import (
    ground_contact_forces as jax_ground_contact_forces,
)
from bayes_sim_ig_tpu.sim.ant import build_ant_model as jax_build_ant_model
from bayes_sim_ig_tpu_torch.physics import (
    ArticulatedModel, DynParams, Geom, LinkSpec, contact_points,
    forward_dynamics, forward_kinematics, ground_contact_forces, integrate,
    mass_matrix,
)
import bayes_sim_ig_tpu_torch.physics.dynamics as tdyn
from bayes_sim_ig_tpu_torch.physics import spatial
from bayes_sim_ig_tpu_torch.sim.ant import build_ant_model
from bayes_sim_ig_tpu_torch.utils.convert import (
    dynparams_from_jax, dynparams_to_jax,
)

torch.set_num_threads(1)

N = 6
KIN = dict(rtol=0, atol=1e-5)
FORCE = dict(rtol=1e-4, atol=1e-4)

JMODEL = jax_build_ant_model()
TMODEL = build_ant_model()


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _j(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _state(seed, z=0.42):
    """Ant q, v, tau, JAX DynParams and the port's, for N envs: the torso
    low enough (z 0.42) that the feet penetrate the ground."""
    rs = np.random.RandomState(seed)
    q = np.tile(TMODEL.neutral_q(), (N, 1))
    q[:, 2] = z + rs.uniform(-0.03, 0.03, N)
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rs.uniform(-0.1, 0.1, (N, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:] = rs.uniform(-0.5, 0.5, (N, 8))
    v = rs.uniform(-0.5, 0.5, (N, TMODEL.nv))
    tau = rs.uniform(-5.0, 5.0, (N, TMODEL.nv))
    base = JaxDynParams.defaults(JMODEL)
    mult = rs.uniform(0.3, 3.0, (N, TMODEL.nb))
    jp = JaxDynParams(
        mass=_j(np.asarray(base.mass) * mult),
        com=_j(np.broadcast_to(np.asarray(base.com), (N, TMODEL.nb, 3))),
        inertia=_j(np.asarray(base.inertia) * mult[:, :, None]),
        stiffness=_j(rs.uniform(0.0, 20.0, (N, TMODEL.nv))),
        damping=_j(np.broadcast_to(np.asarray(base.damping),
                                   (N, TMODEL.nv))),
        friction=_j(rs.uniform(0.0, 0.5, (N, TMODEL.nv))),
        armature=_j(rs.uniform(0.0, 0.1, (N, TMODEL.nv))),
        gravity=_j(np.tile([0.0, 0.0, -9.81], (N, 1))),
        contact_friction=_j(rs.uniform(0.5, 1.5, (N, len(TMODEL.geoms)))),
        restitution=_j(np.zeros((N, len(TMODEL.geoms)))),
        scale=_j(rs.uniform(0.9, 1.1, N)))
    tp = dynparams_from_jax(jp)
    return q.astype(np.float32), v.astype(np.float32), \
        tau.astype(np.float32), jp, tp


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


# ------------------------------------------------------------------ #
# Spatial algebra and conversion.
# ------------------------------------------------------------------ #
def test_spatial_algebra_matches_jax():
    rs = np.random.RandomState(0)
    q4 = rs.randn(5, 4)
    q4 /= np.linalg.norm(q4, axis=1, keepdims=True)
    v3 = rs.randn(3)
    w3 = rs.randn(5, 3)
    E = np.asarray(jspatial.quat_to_rot(_j(q4[0])))
    r, m6, f6 = rs.randn(3), rs.randn(6), rs.randn(6)
    R_el = np.moveaxis(np.asarray(jspatial.quat_to_rot(_j(q4))), 0, -1)
    pairs = [
        (spatial.hat(_t(v3)), jspatial.hat(_j(v3))),
        (spatial.quat_to_rot(_t(q4)), jspatial.quat_to_rot(_j(q4))),
        (spatial.rot_to_quat(_t(R_el)), jspatial.rot_to_quat(_j(R_el))),
        (spatial.quat_mul(_t(q4), _t(q4[::-1])),
         jspatial.quat_mul(_j(q4), _j(q4[::-1]))),
        (spatial.quat_integrate(_t(q4), _t(w3), 0.01),
         jspatial.quat_integrate(_j(q4), _j(w3), 0.01)),
        (spatial.quat_rotate(_t(q4[1]), _t(v3)),
         jspatial.quat_rotate(_j(q4[1]), _j(v3))),
        (spatial.quat_rotate_inv(_t(q4[1]), _t(v3)),
         jspatial.quat_rotate_inv(_j(q4[1]), _j(v3))),
        (spatial.quat_from_axis_angle(_t(v3), 0.7),
         jspatial.quat_from_axis_angle(_j(v3), jnp.asarray(0.7))),
        (spatial.xform_motion(_t(E), _t(r), _t(m6)),
         jspatial.xform_motion(_j(E), _j(r), _j(m6))),
        (spatial.xform_force(_t(E), _t(r), _t(f6)),
         jspatial.xform_force(_j(E), _j(r), _j(f6))),
        (spatial.inv_xform_motion(_t(E), _t(r), _t(m6)),
         jspatial.inv_xform_motion(_j(E), _j(r), _j(m6))),
        (spatial.inv_xform_force(_t(E), _t(r), _t(f6)),
         jspatial.inv_xform_force(_j(E), _j(r), _j(f6))),
        (spatial.xform_compose(_t(E), _t(r), _t(E.T), _t(v3))[1],
         jspatial.xform_compose(_j(E), _j(r), _j(E.T), _j(v3))[1]),
        (spatial.crm(_t(m6), _t(f6)), jspatial.crm(_j(m6), _j(f6))),
        (spatial.crf(_t(m6), _t(f6)), jspatial.crf(_j(m6), _j(f6))),
        (spatial.spatial_inertia(2.0, _t(v3), _t(np.diag([1.0, 2.0, 3.0]))),
         jspatial.spatial_inertia(2.0, _j(v3), _j(np.diag([1.0, 2, 3])))),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=f"pair {i}")


def test_dynparams_round_trip():
    _, _, _, jp, tp = _state(1)
    assert all(t.dtype == torch.float32 for t in tp)
    back = JaxDynParams(**dynparams_to_jax(tp))
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    single = dynparams_from_jax(JaxDynParams.defaults(JMODEL))
    assert tuple(single.mass.shape) == (TMODEL.nb,)
    assert single.scale.ndim == 0


def test_static_tables_match_jax():
    assert TMODEL.nq == 15 and TMODEL.nv == 14 and TMODEL.nb == 9
    for name in ("anc_dof", "crba_mask", "dof_vd_mask", "j1_q", "j1_v",
                 "joint_rot_T", "parent_pad", "mass0", "inertia0"):
        np.testing.assert_array_equal(getattr(TMODEL, name),
                                      getattr(JMODEL, name), err_msg=name)
    assert TMODEL.dof_anc_chains == JMODEL.dof_anc_chains
    links, offsets, radii, geom_ids = contact_points(TMODEL)
    assert links.shape == (21,)  # torso, 8 capsules x 2, 4 feet


# ------------------------------------------------------------------ #
# Engine pieces against JAX.
# ------------------------------------------------------------------ #
def test_forward_kinematics_matches_jax():
    q, v, _, jp, tp = _state(2)
    want = jdyn.forward_kinematics(JMODEL, _j(q), _j(v), jp)
    got = forward_kinematics(TMODEL, _t(q), _t(v), tp)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), KIN)


def test_inertias_bias_and_mass_matrix_match_jax():
    q, v, _, jp, tp = _state(3)
    jkin = jdyn.forward_kinematics(JMODEL, _j(q), _j(v), jp)
    tkin = forward_kinematics(TMODEL, _t(q), _t(v), tp)
    ji10, ti10 = jdyn._i10_direct(jkin, jp), tdyn._i10_direct(tkin, tp)
    _close(ti10, ji10, KIN)
    f_ext = np.random.RandomState(4).randn(TMODEL.nb, 6, N)
    for f in (None, f_ext):
        _close(tdyn._bias_from_i10(TMODEL, tkin, ti10, tp,
                                   None if f is None else _t(f)),
               jdyn._bias_from_i10(JMODEL, jkin, ji10, jp,
                                   None if f is None else _j(f)), FORCE)
    _close(tdyn._mass_factors_i10(TMODEL, tkin, ti10),
           jdyn._mass_factors_i10(JMODEL, jkin, ji10), FORCE)
    _close(tdyn.external_generalized_force(TMODEL, tkin, _t(f_ext)),
           jdyn.external_generalized_force(JMODEL, jkin, _j(f_ext)), FORCE)
    # The oracle API: body-frame inertias -> Plücker -> CRBA and RNEA.
    tI, jI = tdyn._link_inertias(TMODEL, tp), jdyn._link_inertias(JMODEL, jp)
    _close(tI, jI, KIN)
    _close(tdyn._inertia_to_plucker(tkin, tI),
           jdyn._inertia_to_plucker(jkin, jI), FORCE)
    _close(tdyn._plucker_inertia_direct(tkin, tp),
           jdyn._plucker_inertia_direct(jkin, jp), FORCE)
    _close(mass_matrix(TMODEL, tkin, tI), jdyn.mass_matrix(JMODEL, jkin, jI),
           FORCE)
    _close(tdyn.bias_forces(TMODEL, tkin, tI, tp),
           jdyn.bias_forces(JMODEL, jkin, jI, jp), FORCE)


@pytest.mark.parametrize("case", ["fresh", "carried", "drives"])
def test_forward_dynamics_matches_jax(case):
    """qdd from a fresh factorization, from the factor carried from
    another state (the frozen-mass substep), and with implicit PD drives
    (clamped by an effort limit), against JAX's."""
    q, v, tau, jp, tp = _state(5)
    f_ext = np.random.RandomState(6).randn(TMODEL.nb, 6, N)
    jkw, tkw = {}, {}
    if case == "carried":
        q0, v0, _, _, _ = _state(7)
        jkw["factor"] = jdyn.forward_dynamics(
            JMODEL, _j(q0), _j(v0), _j(tau), jp, dt=1 / 120,
            return_factor=True)[2]
        tkw["factor"] = forward_dynamics(
            TMODEL, _t(q0), _t(v0), _t(tau), tp, dt=1 / 120,
            return_factor=True)[2]
    if case == "drives":
        rs = np.random.RandomState(15)
        drives = dict(drive_kp=rs.uniform(0, 50, (N, TMODEL.nv)),
                      drive_kd=rs.uniform(0, 2, (N, TMODEL.nv)),
                      drive_target=rs.uniform(-0.5, 0.5, (N, TMODEL.nv)))
        jkw = {k: _j(x) for k, x in drives.items()}
        tkw = {k: _t(x) for k, x in drives.items()}
        jkw["drive_effort"] = tkw["drive_effort"] = 8.0
    want, _ = jdyn.forward_dynamics(JMODEL, _j(q), _j(v), _j(tau), jp,
                                    _j(f_ext), dt=1 / 120, **jkw)
    got, _ = forward_dynamics(TMODEL, _t(q), _t(v), _t(tau), tp,
                              _t(f_ext), dt=1 / 120, **tkw)
    assert got.shape == (N, TMODEL.nv)
    _close(got, want, FORCE)


def test_ground_contact_forces_match_jax():
    q, v, _, jp, tp = _state(8)
    jkin = jdyn.forward_kinematics(JMODEL, _j(q), _j(v), jp)
    tkin = forward_kinematics(TMODEL, _t(q), _t(v), tp)
    want = jax_ground_contact_forces(JMODEL, jkin, jp, dt=1 / 120)
    got = ground_contact_forces(TMODEL, tkin, tp, dt=1 / 120)
    assert got.shape == (TMODEL.nb, 6, N)
    assert float(got[:, 5].abs().max()) > 1.0  # some feet are in contact
    _close(got, want, FORCE)


def test_integrate_and_clamp_limits_match_jax():
    q, v, _, _, _ = _state(9)
    rs = np.random.RandomState(10)
    qdd = rs.uniform(-50, 50, (N, TMODEL.nv)).astype(np.float32)
    q[:, 7:] = rs.uniform(-1.5, 1.5, (N, 8))  # some joints past limits
    want = jdyn.integrate(JMODEL, _j(q), _j(v), _j(qdd), 1 / 120)
    got = integrate(TMODEL, _t(q), _t(v), _t(qdd), 1 / 120)
    for g, w in zip(got, want):
        assert g.is_contiguous()
        _close(g, w, KIN)
    want = jdyn.clamp_limits(JMODEL, _j(q), _j(v))
    got = tdyn.clamp_limits(TMODEL, _t(q), _t(v))
    for g, w in zip(got, want):
        _close(g, w, dict(rtol=0, atol=0))


# ------------------------------------------------------------------ #
# Oracles of tests/test_physics.py.
# ------------------------------------------------------------------ #
def _double_pendulum():
    return ArticulatedModel([
        LinkSpec("l1", parent=-1, joint_type="revolute",
                 joint_axis=(0, 1, 0), mass=1.0, com=(0, 0, -0.5),
                 inertia=(1 / 12, 1 / 12, 1e-9)),
        LinkSpec("l2", parent=0, joint_type="revolute",
                 joint_axis=(0, 1, 0), joint_pos=(0, 0, -1.0),
                 mass=1.0, com=(0, 0, -0.5),
                 inertia=(1 / 12, 1 / 12, 1e-9))])


def test_mass_matrix_symmetric_pd():
    dbl = _double_pendulum()
    params = DynParams.defaults(dbl)
    kin = forward_kinematics(dbl, torch.tensor([1.2, 0.4]), torch.zeros(2),
                             params)
    M = mass_matrix(dbl, kin, tdyn._link_inertias(dbl, params)).numpy()
    np.testing.assert_allclose(M, M.T, atol=1e-5)
    assert np.linalg.eigvalsh(M).min() > 0


def test_free_fall():
    ball = ArticulatedModel(
        [LinkSpec("ball", parent=-1, joint_type="free", mass=1.0,
                  inertia=(0.004,) * 3)], fixed_base=False)
    params = DynParams.defaults(ball)
    q = torch.as_tensor(ball.neutral_q(), dtype=torch.float32)
    qdd, _ = forward_dynamics(ball, q, torch.zeros(6), torch.zeros(6),
                              params)
    np.testing.assert_allclose(qdd.numpy(), [0, 0, 0, 0, 0, -9.81],
                               atol=1e-5)


def test_frozen_vs_fresh_single_step(monkeypatch):
    """Ant's frozen-mass substep scheme (factor from the first substep
    reused by the second) perturbs one physics step by O(h^2 |qd| dM)
    against a fresh factor on each substep: well under 1% of the state
    scale."""
    import os
    import yaml
    from bayes_sim_ig_tpu_torch.sim import ant, make_env
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "bayes_sim_ig_tpu_torch", "cfg", "ant.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"]["numEnvs"] = 8
    task = make_env("Ant", cfg, device="cpu").task
    spec = task.params_spec
    gen = torch.Generator().manual_seed(0)
    lows, highs = _t(spec.lows), _t(spec.highs)
    params = lows + torch.rand((8, spec.dim), generator=gen) * (highs - lows)
    state = task.init_state(gen, params)
    act = torch.linspace(-0.5, 0.5, task.act_dim)[None].repeat(8, 1)
    frozen = task.physics_step(state, act, params, gen)
    fd = ant.forward_dynamics
    # Fresh: every substep's call drops the carried factor.
    monkeypatch.setattr(ant, "forward_dynamics",
                        lambda *a, factor=None, **k: fd(*a, **k))
    fresh = task.physics_step(state, act, params, gen)
    fresh2 = task.physics_step(state, act, params, gen)
    assert torch.equal(fresh.q, fresh2.q)
    scale = float(fresh.q.abs().max())
    dev = float((frozen.q - fresh.q).abs().max())
    assert torch.isfinite(frozen.q).all() and torch.isfinite(frozen.v).all()
    # dev == 0 would mean the frozen path never engaged.
    assert 0.0 < dev < 0.01 * scale, (dev, scale)


def test_sparse_dof_tree_needs_the_unported_tree_solve():
    """A fixed base with six independent single-dof arms fills 6 of the
    21 lower-triangle pairs, below the 0.66 dense threshold: the port
    takes the branch-sparse LTDL, as the JAX package does, and solves as
    it does."""
    import bayes_sim_ig_tpu.physics as jphys
    import bayes_sim_ig_tpu_torch.physics as tphys

    def star(P):
        return P.ArticulatedModel(
            [P.LinkSpec("base", parent=-1, joint_type="fixed")]
            + [P.LinkSpec(f"arm{i}", parent=0, joint_type="revolute",
                          joint_axis=(0, 1, 0), com=(0, 0, -0.3))
               for i in range(6)],
            geoms=[P.Geom(link=1, kind="sphere", size=(0.1,))])
    jm, tm = star(jphys), star(tphys)
    assert tdyn._uses_tree_solve(tm)
    rs = np.random.RandomState(10)
    q, v, tau = rs.uniform(-1.0, 1.0, (3, 6)).astype(np.float32)
    qdd, _, factor = forward_dynamics(
        tm, _t(q), _t(v), _t(tau), DynParams.defaults(tm),
        return_factor=True)
    assert factor[0] == "tree"
    want, _ = jdyn.forward_dynamics(jm, _j(q), _j(v), _j(tau),
                                    jphys.DynParams.defaults(jm))
    _close(qdd, want, FORCE)


def test_mass_factor_solve_k_rhs_matches_jax():
    """K extra right-hand sides against the factor forward_dynamics
    returns (the Delassus columns of the contact impulse pass)."""
    q, v, tau, jp, tp = _state(11)
    jfac = jdyn.forward_dynamics(JMODEL, _j(q), _j(v), _j(tau), jp,
                                 dt=1 / 120, return_factor=True)[2]
    tfac = forward_dynamics(TMODEL, _t(q), _t(v), _t(tau), tp,
                            dt=1 / 120, return_factor=True)[2]
    rhs = np.random.RandomState(12).randn(3, TMODEL.nv, N)
    got = tdyn.mass_factor_solve(TMODEL, tfac, _t(rhs))
    assert got.shape == (3, TMODEL.nv, N)
    _close(got, jdyn.mass_factor_solve(JMODEL, jfac, _j(rhs)), FORCE)


def test_joint_passive_torque_matches_jax():
    q, v, _, jp, tp = _state(13)
    qd = tdyn.dof_positions(TMODEL, _t(q))
    _close(qd, jdyn.dof_positions(JMODEL, _j(q)), dict(rtol=0, atol=0))
    _close(tdyn.joint_passive_torque(TMODEL, tp, qd, _t(v)),
           jdyn.joint_passive_torque(JMODEL, jp, _j(qd.numpy()), _j(v)),
           KIN)


def test_contact_rows_take_env_last_vectors_only():
    from bayes_sim_ig_tpu_torch.physics.contact import _rows
    assert tuple(_rows([0.0, 0.0, 1.0]).shape) == (3, 1)
    assert tuple(_rows(torch.zeros(3, 5)).shape) == (3, 5)
    with pytest.raises(ValueError, match="env-last"):
        _rows(torch.zeros(5, 3))


def _phantom_leg(pkg):
    """A free torso with a 2-dof hip realized by a phantom link (x then
    y), a knee, and a foot sphere: the FK's joint-chain compose path."""
    P = pkg
    links = [
        P.LinkSpec("torso", parent=-1, joint_type="free", mass=5.0),
        P.LinkSpec("hip_x", parent=0, joint_type="revolute",
                   joint_axis=(1, 0, 0), joint_pos=(0.1, 0.0, -0.1),
                   mass=0.01, inertia=(1e-4,) * 3, phantom=True),
        P.LinkSpec("thigh", parent=1, joint_type="revolute",
                   joint_axis=(0, 1, 0), joint_pos=(0.0, 0.02, 0.0),
                   mass=1.0, com=(0, 0, -0.2), damping=0.5),
        P.LinkSpec("shin", parent=2, joint_type="revolute",
                   joint_axis=(0, 1, 0), joint_pos=(0.0, 0.0, -0.4),
                   mass=0.5, com=(0, 0, -0.2), damping=0.5),
    ]
    geoms = [P.Geom(link=3, kind="sphere", size=(0.05,),
                    offset=(0, 0, -0.4))]
    return P.ArticulatedModel(links, geoms, fixed_base=False)


def test_phantom_chain_kinematics_match_jax():
    import bayes_sim_ig_tpu.physics as jphys
    import bayes_sim_ig_tpu_torch.physics as tphys
    jm, tm = _phantom_leg(jphys), _phantom_leg(tphys)
    assert tm.collapsed and tm.nb == 3 and tm.j1_chain_maxpos == 1
    rs = np.random.RandomState(14)
    n = 4
    q = np.tile(tm.neutral_q(), (n, 1))
    q[:, 2] = 1.0
    q[:, 7:] = rs.uniform(-1.0, 1.0, (n, 3))
    q = q.astype(np.float32)
    v = rs.uniform(-1.0, 1.0, (n, tm.nv)).astype(np.float32)
    jp = jphys.DynParams(*[jnp.broadcast_to(a, (n,) + a.shape)
                           for a in jphys.DynParams.defaults(jm)])
    tp = dynparams_from_jax(jp)
    want = jdyn.forward_kinematics(jm, _j(q), _j(v), jp)
    got = forward_kinematics(tm, _t(q), _t(v), tp)
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name), KIN)
    _close(ground_contact_forces(tm, got, tp),
           jax_ground_contact_forces(jm, want, jp), FORCE)


# ------------------------------------------------------------------ #
# The models of Anymal, Quadcopter, Ingenuity, BallBalance and
# FrankaCabinet: one and two free roots, fixed roots, prismatic joints.
# ------------------------------------------------------------------ #
def _task_models():
    import yaml
    from bayes_sim_ig_tpu.sim import anymal, ball_balance, flyers
    from bayes_sim_ig_tpu.sim import franka_cabinet
    from bayes_sim_ig_tpu_torch.sim import anymal as t_anymal
    from bayes_sim_ig_tpu_torch.sim import ball_balance as t_ball_balance
    from bayes_sim_ig_tpu_torch.sim import flyers as t_flyers
    from bayes_sim_ig_tpu_torch.sim import franka_cabinet as t_franka

    def flyer(name):
        with open(os.path.join(os.path.dirname(__file__), "..",
                               "bayes_sim_ig_tpu_torch", "cfg",
                               f"{name.lower()}.yaml")) as f:
            cfg = yaml.safe_load(f)
        return (getattr(flyers, name)(cfg).model,
                getattr(t_flyers, name)(cfg, device="cpu").model)
    return {
        "anymal": (anymal.build_anymal_model(),
                   t_anymal.build_anymal_model()),
        "quadcopter": flyer("Quadcopter"),
        "ingenuity": flyer("Ingenuity"),
        "ball_balance": (ball_balance.build_bbot_model(),
                         t_ball_balance.build_bbot_model()),
        "franka_cabinet": (franka_cabinet.build_model(),
                           t_franka.build_model()),
    }


TASK_MODELS = _task_models()


def _model_state(jm, tm, seed, n=N):
    """Random q (free roots: positions and unit quaternions; 1-dof joints
    within +-0.5), v, tau, and per-env masses/inertias (0.5-2x) and
    geometry scales, as JAX's DynParams and the port's."""
    rs = np.random.RandomState(seed)
    q = np.tile(tm.neutral_q(), (n, 1))
    for (_, qi, _) in tm.free_list:
        q[:, qi:qi + 3] = rs.uniform(-0.5, 0.5, (n, 3))
        quat = rs.randn(n, 4)
        q[:, qi + 3:qi + 7] = quat / np.linalg.norm(quat, axis=1,
                                                    keepdims=True)
    q[:, tm.j1_q] = rs.uniform(-0.5, 0.5, (n, tm.j1_q.size))
    v = rs.uniform(-0.5, 0.5, (n, tm.nv))
    tau = rs.uniform(-2.0, 2.0, (n, tm.nv))
    base = JaxDynParams.defaults(jm)
    mult = rs.uniform(0.5, 2.0, (n, tm.nb))

    def rows(x):
        x = np.asarray(x)
        return _j(np.broadcast_to(x, (n,) + x.shape))
    jp = JaxDynParams(
        mass=_j(np.asarray(base.mass) * mult), com=rows(base.com),
        inertia=_j(np.asarray(base.inertia) * mult[:, :, None]),
        stiffness=rows(base.stiffness), damping=rows(base.damping),
        friction=_j(rs.uniform(0.0, 0.2, (n, tm.nv))),
        armature=rows(base.armature), gravity=rows(base.gravity),
        contact_friction=rows(base.contact_friction),
        restitution=rows(base.restitution),
        scale=_j(rs.uniform(0.9, 1.1, n)))
    return (q.astype(np.float32), v.astype(np.float32),
            tau.astype(np.float32), jp, dynparams_from_jax(jp))


@pytest.mark.parametrize("name", list(TASK_MODELS))
def test_task_model_tables_kinematics_and_mass_matrix_match_jax(name):
    """Static tables, forward kinematics and the CRBA mass matrix (the
    oracle API: body-frame inertias -> Plücker -> CRBA) on each model."""
    jm, tm = TASK_MODELS[name]
    assert (tm.nq, tm.nv, tm.nb) == (jm.nq, jm.nv, jm.nb)
    assert tm.free_list == jm.free_list
    assert tm.dof_anc_chains == jm.dof_anc_chains
    for attr in ("anc_dof", "crba_mask", "dof_vd_mask", "j1_q", "j1_v",
                 "j1_rev", "joint_rot_T", "parent_pad", "mass0",
                 "inertia0"):
        np.testing.assert_array_equal(getattr(tm, attr), getattr(jm, attr),
                                      err_msg=attr)
    q, v, _, jp, tp = _model_state(jm, tm, 20)
    jkin = jdyn.forward_kinematics(jm, _j(q), _j(v), jp)
    tkin = forward_kinematics(tm, _t(q), _t(v), tp)
    for field in jkin._fields:
        _close(getattr(tkin, field), getattr(jkin, field), KIN)
    jI, tI = jdyn._link_inertias(jm, jp), tdyn._link_inertias(tm, tp)
    M = mass_matrix(tm, tkin, tI)
    _close(M, jdyn.mass_matrix(jm, jkin, jI), FORCE)
    assert (np.linalg.eigvalsh(M.double().numpy()) > 0).all()


@pytest.mark.parametrize("name", list(TASK_MODELS))
def test_task_model_forward_dynamics_matches_jax(name):
    """qdd with external wrenches, then with implicit PD drives on every
    1-dof joint (effort-clamped), held to 1e-4 of its largest magnitude;
    BallBalance's two-root forest takes the tree solve in both packages,
    the other four the dense one."""
    jm, tm = TASK_MODELS[name]
    assert tdyn._uses_tree_solve(tm) == (name == "ball_balance")
    q, v, tau, jp, tp = _model_state(jm, tm, 21)
    rs = np.random.RandomState(22)
    f_ext = rs.randn(tm.nb, 6, N)
    drives = dict(drive_kp=rs.uniform(0, 80, (N, tm.nv)),
                  drive_kd=rs.uniform(0, 2, (N, tm.nv)),
                  drive_target=rs.uniform(-0.5, 0.5, (N, tm.nv)))
    for kw in ({}, drives):
        jkw = {k: _j(x) for k, x in kw.items()}
        tkw = {k: _t(x) for k, x in kw.items()}
        if kw:
            jkw["drive_effort"] = tkw["drive_effort"] = 40.0
        want, _ = jdyn.forward_dynamics(jm, _j(q), _j(v), _j(tau), jp,
                                        _j(f_ext), dt=1 / 120, **jkw)
        got, _, factor = forward_dynamics(tm, _t(q), _t(v), _t(tau), tp,
                                          _t(f_ext), dt=1 / 120,
                                          return_factor=True, **tkw)
        assert factor[0] == ("tree" if name == "ball_balance" else "dense")
        got, want = got.numpy(), np.asarray(want)
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


# ------------------------------------------------------------------ #
# The sphere-vs-body-plane pair contact.
# ------------------------------------------------------------------ #
def _pair_case(normal, seed):
    """BallBalance's model with the ball placed against a plane patch on
    the tilted tray, per env: active (1 cm into the plane, inside the
    patch), inactive (5 cm off it) and outside the patch (1 cm in, 0.6 m
    along it past the 0.5 half-size), 3 envs each; per-env env-last
    sphere offsets and plane points; small random velocities."""
    jm, tm = TASK_MODELS["ball_balance"]
    rs = np.random.RandomState(seed)
    n = 9
    nrm = np.asarray(normal, np.float64)
    tangents = np.eye(3)[np.abs(nrm) < 0.5]              # the two others
    q = np.tile(tm.neutral_q(), (n, 1))
    q[:, 0:3] = [0.0, 0.0, 0.7]
    quat = np.array([1.0, 0.0, 0.0, 0.0]) + rs.uniform(-0.1, 0.1, (n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 3:7] = quat
    scale = rs.uniform(0.9, 1.1, n)
    off = rs.uniform(-0.01, 0.01, (3, n))
    pp = np.array([0.0, 0.0, 0.02])[:, None] + rs.uniform(-0.01, 0.01, (3, n))
    dist = np.array([0.09, 0.15, 0.09] * 3) * scale       # radius 0.1
    along = np.array([[0.1, -0.15], [0.1, -0.15], [0.6, 0.1]] * 3)
    R = np.asarray(jspatial.quat_to_rot(_j(quat)), np.float64)
    local = (pp * scale).T + nrm * dist[:, None] + along @ tangents * scale[
        :, None]
    center = q[:, 0:3] + np.einsum("nij,nj->ni", R, local)
    bq = tm.q_off[7]
    q[:, bq:bq + 3] = center - (off * scale).T           # ball unrotated
    # Slow enough that no active env separates faster than its spring
    # pushes (a normal force clamped to 0 would zero the env).
    v = rs.uniform(-0.05, 0.05, (n, tm.nv))
    base = JaxDynParams.defaults(jm)
    mult = rs.uniform(0.5, 2.0, (n, tm.nb))

    def rows(x):
        x = np.asarray(x)
        return _j(np.broadcast_to(x, (n,) + x.shape))
    jp = JaxDynParams(
        mass=_j(np.asarray(base.mass) * mult), com=rows(base.com),
        inertia=_j(np.asarray(base.inertia) * mult[:, :, None]),
        stiffness=rows(base.stiffness), damping=rows(base.damping),
        friction=rows(base.friction), armature=rows(base.armature),
        gravity=rows(base.gravity),
        contact_friction=rows(base.contact_friction),
        restitution=rows(base.restitution), scale=_j(scale))
    return (jm, tm, q.astype(np.float32), v.astype(np.float32), jp,
            dynparams_from_jax(jp), off.astype(np.float32),
            pp.astype(np.float32))


@pytest.mark.parametrize("normal", [(0.0, 0.0, 1.0), (0.0, 1.0, 0.0)])
def test_sphere_plane_pair_forces_match_jax(normal):
    """Value for value within rtol 1e-5 / atol 1e-5 (float32, the same
    operations): active, inactive and outside-the-patch envs, on a
    z-normal patch (the tray) and a y-normal one (a finger pad), where the
    tangential half-size gate bounds the two in-plane axes."""
    from bayes_sim_ig_tpu.physics.contact import (
        sphere_plane_pair_forces as jax_pair,
    )
    from bayes_sim_ig_tpu_torch.physics import sphere_plane_pair_forces
    jm, tm, q, v, jp, tp, off, pp = _pair_case(normal, 23)
    jkin = jdyn.forward_kinematics(jm, _j(q), _j(v), jp)
    tkin = forward_kinematics(tm, _t(q), _t(v), tp)
    kw = dict(sphere_link=7, radius=0.1, plane_link=0,
              plane_normal=normal, mu=1.2, dt=1 / 120, plane_halfsize=0.5)
    want = jax_pair(jm, jkin, jp, sphere_offset=_j(off),
                    plane_point=_j(pp), **kw)
    got = sphere_plane_pair_forces(tm, tkin, tp, sphere_offset=_t(off),
                                   plane_point=_t(pp), **kw)
    assert tuple(got.shape) == (tm.nb, 6, 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    loaded = got.abs().amax((0, 1)) > 0
    assert loaded.tolist() == [True, False, False] * 3
    # Equal and opposite forces on the ball and the tray; nothing else.
    torch.testing.assert_close(got[7, 3:], -got[0, 3:])
    assert (got[1:7] == 0).all() and (got[8:] == 0).all()


def test_sphere_plane_pair_forces_single_env_and_static_vectors():
    """A single env's squeezed kinematics give (nb, 6), and static (3,)
    offsets broadcast: equal to that env's column of the batched call."""
    from bayes_sim_ig_tpu_torch.physics import sphere_plane_pair_forces
    _, tm, q, v, jp, tp, _, _ = _pair_case((0.0, 0.0, 1.0), 24)
    kw = dict(sphere_link=7, sphere_offset=(0.0, 0.0, 0.0), radius=0.1,
              plane_link=0, plane_point=(0.0, 0.0, 0.02),
              plane_normal=(0.0, 0.0, 1.0), dt=1 / 120, plane_halfsize=0.5)
    batched = sphere_plane_pair_forces(
        tm, forward_kinematics(tm, _t(q), _t(v), tp), tp, **kw)
    one = dynparams_from_jax(JaxDynParams(*[a[0] for a in jp]))
    single = sphere_plane_pair_forces(
        tm, forward_kinematics(tm, _t(q[0]), _t(v[0]), one), one, **kw)
    assert tuple(single.shape) == (tm.nb, 6)
    torch.testing.assert_close(single, batched[..., 0], rtol=1e-6,
                               atol=1e-6)
