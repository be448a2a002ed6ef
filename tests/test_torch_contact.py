"""The port's multi-pair and impulse contacts against the JAX package on
the CPU, on seeded numpy inputs: the sphere-plane, sphere-box and
sphere-sphere pair forces with their geometry, the closure groups, and
the velocity-level impulse pass on both routes (the half-solve route of a
tree factor against JAX's default; the M^-1 J^T route with a dense factor
and with a tree factor against JAX with BSIM_IMPULSE_COMPACT=0), with
friction rows, a warm start across two apply calls, the returned lam and
the payload's row forces and generalized force. Then the JAX package's
compact-equals-dense and sphere-sphere impulse tests on the port.

Tolerances: forces and geometry within rtol 1e-5 / atol 1e-5 (float32 on
both sides, sums in another order); the impulse pass's velocities, lam
and forces within atol 1e-5 of JAX's on the same route."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bayes_sim_ig_tpu.physics as jphys
import bayes_sim_ig_tpu.physics.contact as jc
import bayes_sim_ig_tpu_torch.physics as tphys
import bayes_sim_ig_tpu_torch.physics.contact as tc
import bayes_sim_ig_tpu_torch.physics.dynamics as tdyn
from bayes_sim_ig_tpu_torch.ops.launch import launch_counts
from bayes_sim_ig_tpu_torch.utils.convert import dynparams_from_jax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _two_bodies():
    spec = [("a", 2.0, 0.02), ("b", 0.5, 0.002)]
    links = [jphys.LinkSpec(nm, parent=-1, joint_type="free", mass=m,
                            inertia=(i,) * 3) for nm, m, i in spec]
    tlinks = [tphys.LinkSpec(nm, parent=-1, joint_type="free", mass=m,
                             inertia=(i,) * 3) for nm, m, i in spec]
    return (jphys.ArticulatedModel(links, fixed_base=False),
            tphys.ArticulatedModel(tlinks, fixed_base=False))


def _kin_pair(jm, tm, q, v, n):
    """Both packages' kinematics and batched default params."""
    jp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a),
                                   (n,) + jnp.asarray(a).shape),
        jphys.DynParams.defaults(jm))
    tp = dynparams_from_jax(jp)
    jk = jphys.forward_kinematics(jm, jnp.asarray(q), jnp.asarray(v), jp)
    tk = tphys.forward_kinematics(tm, torch.from_numpy(q),
                                  torch.from_numpy(v), tp)
    return jk, tk, jp, tp


def _close(got, want, what="", **tol):
    np.testing.assert_allclose(
        got.numpy() if torch.is_tensor(got) else got, np.asarray(want),
        err_msg=what, **(tol or TOL))


def _geometry_close(tgeo, jgeo):
    for i, (g, w) in enumerate(zip(tgeo, jgeo)):
        _close(g, w, f"geometry {i}")


def _bodies_state(n, seed, spread):
    jm, tm = _two_bodies()
    rs = np.random.RandomState(seed)
    q = np.tile(jm.neutral_q(), (n, 1)).astype(np.float32)
    q[:, 0:3] = [0.0, 0.0, 0.5]
    q[:, 7:10] = rs.uniform(-spread, spread, (n, 3)) + [0.15, 0.0, 0.5]
    v = (rs.randn(n, jm.nv) * 0.5).astype(np.float32)
    return jm, tm, q, v


def test_sphere_plane_pairs_forces_match_jax():
    n = 5
    jm, tm, q, v = _bodies_state(n, 0, 0.05)
    q[:, 7:10] = np.random.RandomState(3).uniform(-0.05, 0.05, (n, 3)) \
        + [0, 0, 0.62]
    jk, tk, jp, tp = _kin_pair(jm, tm, q, v, n)
    rs = np.random.RandomState(4)
    kw = dict(sphere_links=[1, 1, 1, 0], plane_links=[0, 0, 0, 1],
              sphere_offsets=rs.uniform(-0.05, 0.05, (4, 3)),
              radii=np.asarray([0.1, 0.08, 0.02, 0.05]),
              plane_points=rs.uniform(-0.02, 0.02, (4, 3)),
              plane_normals=np.asarray([(0, 0, 1), (0, 0, 1), (1, 0, 0),
                                        (0, 0, -1)], np.float32),
              mu=np.asarray([1.0, 0.7, 1.2, 0.5]), dt=1 / 120.0,
              plane_halfsizes=np.asarray([0.5, 0.5, 0.03, 0.3]))
    want, jgeo = jc.sphere_plane_pairs_forces(jm, jk, jp, **kw,
                                              return_geometry=True)
    got, tgeo = tc.sphere_plane_pairs_forces(tm, tk, tp, **kw,
                                             return_geometry=True)
    assert float(jnp.abs(want).max()) > 0.0, "no active contact"
    _close(got, want, "forces")
    _geometry_close(tgeo, jgeo)
    _, tgeo2 = tc.sphere_plane_pairs_forces(tm, tk, tp, **kw,
                                            return_geometry=True,
                                            forces=False)
    for a, b in zip(tgeo2, tgeo):
        assert torch.equal(a, b)
    # Per-env (P, 3, N) offsets and normals, and one env unbatched.
    per_env = dict(kw, sphere_offsets=np.repeat(
        kw["sphere_offsets"][:, :, None], n, 2))
    _close(tc.sphere_plane_pairs_forces(tm, tk, tp, **per_env), want)
    k1 = tdyn.Kinematics(*[a[..., 0] for a in tk])
    p1 = tphys.DynParams(*[a[0] for a in tp])
    _close(tc.sphere_plane_pairs_forces(tm, k1, p1, **kw),
           np.asarray(want)[..., 0])


def test_sphere_box_pairs_forces_match_jax():
    """Spheres on body a around a box on body b: outside a face, an edge
    and a corner, and inside (the least-penetrated face)."""
    n = 4
    jm, tm, q, v = _bodies_state(n, 1, 0.01)
    jk, tk, jp, tp = _kin_pair(jm, tm, q, v, n)
    # Sphere centers in body a's frame: b sits ~(0.15, 0, 0) away.
    offs = np.asarray([(0.15 - 0.06, 0.0, 0.0), (0.15 - 0.052, 0.05, 0.0),
                       (0.15 - 0.05, 0.047, 0.048), (0.15, 0.01, 0.0),
                       (0.15 - 0.09, 0.0, 0.0)], np.float32)
    half = np.full(n, 0.045, np.float32)
    kw = dict(sphere_links=[0] * 5, sphere_offsets=offs,
              radii=np.asarray([0.02, 0.01, 0.012, 0.01, 0.01]),
              box_link=1, mu=np.asarray([1.0, 0.5, 0.8, 1.0, 0.3]),
              dt=1 / 120.0)
    want, jgeo = jc.sphere_box_pairs_forces(jm, jk, jp, box_half=half, **kw,
                                            return_geometry=True)
    got, tgeo = tc.sphere_box_pairs_forces(tm, tk, tp, box_half=half, **kw,
                                           return_geometry=True)
    assert float(jnp.abs(want).max()) > 0.0, "no active contact"
    depth = np.asarray(jgeo[1])
    assert (depth > 0).any() and (depth < 0).any()
    _close(got, want, "forces")
    _geometry_close(tgeo, jgeo)
    # Half-extents per axis (3, N) give the same as the per-env scalar.
    _close(tc.sphere_box_pairs_forces(
        tm, tk, tp, box_half=np.tile(half, (3, 1)), **kw), want)


def test_sphere_sphere_pairs_forces_and_geometry_match_jax():
    n = 3
    jm, tm, q, v = _bodies_state(n, 1, 0.02)
    jk, tk, jp, tp = _kin_pair(jm, tm, q, v, n)
    kw = dict(links_a=[0, 0, 1], offsets_a=[(0.05, 0., 0.), (0., 0., 0.),
                                            (0., 0.02, 0.)],
              radii_a=[0.08, 0.1, 0.03], links_b=[1, 1, 0],
              offsets_b=[(0., 0., 0.), (0.01, 0., 0.), (0., 0., 0.)],
              radii_b=[0.06, 0.05, 0.02])
    want = jc.sphere_sphere_pairs_forces(jm, jk, jp, **kw,
                                         mu=np.asarray([1.0, 0.7, 0.4]),
                                         dt=1 / 120.0, return_geometry=True)
    got = tc.sphere_sphere_pairs_forces(tm, tk, tp, **kw,
                                        mu=np.asarray([1.0, 0.7, 0.4]),
                                        dt=1 / 120.0, return_geometry=True)
    assert float(jnp.abs(want[0]).max()) > 0.0, "no active contact"
    _close(got[0], want[0], "forces")
    _geometry_close(got[1], want[1])
    jg = jc._sphere_pair_geometry(jm, jk, jp, **kw)
    tg = tc._sphere_pair_geometry(tm, tk, tp, **kw)
    for i in range(2, len(jg)):
        _close(tg[i], jg[i], f"geometry field {i}")


def test_closure_groups_match_jax():
    from bayes_sim_ig_tpu_torch.sim.shadow_hand import build_hand_model
    model, idx, *_ = build_hand_model()
    rs = np.random.RandomState(0)
    links = rs.randint(0, model.nb, (2, 20))
    d_anc = model.anc_dof[links[0]] - model.anc_dof[links[1]]
    got = tc._closure_groups(model.dof_anc_chains, d_anc)
    want = jc._closure_groups(model.dof_anc_chains, d_anc)
    assert len(got) == len(want)
    for (r1, d1), (r2, d2) in zip(got, want):
        np.testing.assert_array_equal(r1, r2)
        assert d1 == d2


def _hand_like(pkg):
    """Two 3-link fingers and a free cube (test_physics.py's model)."""
    links = [pkg.LinkSpec("palm", parent=-1, joint_type="fixed", mass=0.5,
                          inertia=(1e-3,) * 3)]
    for f in range(2):
        parent = 0
        for s in range(3):
            links.append(pkg.LinkSpec(
                f"f{f}s{s}", parent=parent, joint_type="revolute",
                joint_axis=(0, 1, 0), joint_pos=(0.03, 0.02 * f, 0.0),
                mass=0.05, inertia=(2e-5,) * 3, damping=0.05))
            parent = len(links) - 1
    links.append(pkg.LinkSpec("cube", parent=-1, joint_type="free",
                              mass=0.1, inertia=(6e-5,) * 3))
    return pkg.ArticulatedModel(links, fixed_base=True)


N_IMP = 16
P_IMP = 4


@pytest.fixture(scope="module")
def impulse_case():
    """The hand-like model at 16 random states, 4 contact pairs (cube on
    the palm, two tips on the cube, a tip on the palm) with random
    geometry, friction rows on pairs 0 and 2."""
    jm, tm = _hand_like(jphys), _hand_like(tphys)
    rng = np.random.default_rng(0)
    q = np.tile(jm.neutral_q(), (N_IMP, 1)).astype(np.float32)
    q += rng.normal(0, 0.05, q.shape).astype(np.float32)
    v = rng.normal(0, 0.3, (N_IMP, jm.nv)).astype(np.float32)
    cube = len(jm.joint_types) - 1
    geo = dict(
        links_a=[cube, 3, 6, 3], links_b=[0, cube, cube, 0],
        n_w=rng.normal(0, 1, (P_IMP, 3, N_IMP)).astype(np.float32),
        contact_pt=rng.normal(0, 0.05, (P_IMP, 3, N_IMP)).astype(
            np.float32),
        depth=rng.normal(0.002, 0.004, (P_IMP, N_IMP)).astype(np.float32),
        mu=np.asarray([0.8, 0.5], np.float32), fric=[0, 2])
    geo["n_w"] /= np.linalg.norm(geo["n_w"], axis=1, keepdims=True)
    return jm, tm, q, v, geo


def _jax_impulse(jm, q, v, geo, monkeypatch, tree, compact):
    """JAX's prepare and two warm-started applies (BSIM_PHYS_BF16=0; the
    tree or the dense solve; the compact or the dense route)."""
    monkeypatch.setenv("BSIM_PHYS_BF16", "0")
    monkeypatch.setenv("BSIM_TREE_SOLVE", "1" if tree else "0")
    monkeypatch.setenv("BSIM_IMPULSE_COMPACT", "1" if compact else "0")
    n = q.shape[0]
    jp = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(jnp.asarray(a),
                                   (n,) + jnp.asarray(a).shape),
        jphys.DynParams.defaults(jm))
    qj, vj = jnp.asarray(q), jnp.asarray(v)
    kin = jphys.forward_kinematics(jm, qj, vj, jp)
    _, _, factor = jphys.forward_dynamics(
        jm, qj, vj, jnp.zeros((n, jm.nv)), jp, dt=1 / 120.0, kin=kin,
        return_factor=True)
    assert (factor[0] == "tree") == tree
    payload = jc.contact_pairs_impulse_prepare(
        jm, kin, factor, geo["links_a"], geo["links_b"],
        jnp.asarray(geo["n_w"]), jnp.asarray(geo["contact_pt"]),
        mu=jnp.asarray(geo["mu"]), fric_pairs=geo["fric"])
    v1, warm = jc.contact_pairs_impulse_apply(
        payload, vj, jnp.asarray(geo["depth"]), dt=1 / 120.0, iters=4,
        return_warm=True)
    v2, warm2 = jc.contact_pairs_impulse_apply(
        payload, v1, jnp.asarray(geo["depth"]) * 0.9, dt=1 / 120.0,
        iters=2, warm=warm, return_warm=True)
    lam = warm2[0]
    return dict(v1=v1, v2=v2, lam1=warm[0], lam=lam, diag=payload["diag"],
                rows=jc.impulse_row_forces(payload, lam, 1 / 120.0),
                tau=jc.impulse_generalized_force(payload, lam, 1 / 120.0))


def _port_impulse(tm, q, v, geo, monkeypatch, tree, x_route=False):
    """The port's prepare (the route its factor picks, or the X helper)
    and the same two applies."""
    monkeypatch.setattr(tdyn, "TREE_SOLVE_MAX_FILL", 1.0 if tree else -1.0)
    n = q.shape[0]
    tp = tphys.DynParams.defaults(tm).rows(n)
    qt, vt = torch.from_numpy(q), torch.from_numpy(v)
    kin = tphys.forward_kinematics(tm, qt, vt, tp)
    _, _, factor = tphys.forward_dynamics(
        tm, qt, vt, torch.zeros(n, tm.nv), tp, dt=1 / 120.0, kin=kin,
        return_factor=True)
    assert (factor[0] == "tree") == tree
    args = (tm, kin, geo["links_a"], geo["links_b"],
            torch.from_numpy(geo["n_w"]), torch.from_numpy(geo["contact_pt"]))
    kw = dict(mu=torch.from_numpy(geo["mu"]), fric_pairs=geo["fric"])
    if x_route:
        payload = tc._prepare_x(tm, factor, tc._impulse_rows(*args, **kw))
    else:
        payload = tc.contact_pairs_impulse_prepare(
            tm, kin, factor, *args[2:], **kw)
    depth = torch.from_numpy(geo["depth"])
    v1, warm = tc.contact_pairs_impulse_apply(
        payload, vt, depth, dt=1 / 120.0, iters=4, return_warm=True)
    v2, warm2 = tc.contact_pairs_impulse_apply(
        payload, v1, depth * 0.9, dt=1 / 120.0, iters=2, warm=warm,
        return_warm=True)
    lam = warm2[0]
    return payload, dict(
        v1=v1, v2=v2, lam1=warm[0], lam=lam, diag=payload["diag"],
        rows=tc.impulse_row_forces(payload, lam, 1 / 120.0),
        tau=tc.impulse_generalized_force(payload, lam, 1 / 120.0))


def _impulse_close(got, want):
    for k in want:
        _close(got[k], want[k], k, atol=1e-5, rtol=1e-5)


def test_impulse_y_route_with_a_tree_factor_matches_jax(impulse_case,
                                                        monkeypatch):
    jm, tm, q, v, geo = impulse_case
    want = _jax_impulse(jm, q, v, geo, monkeypatch, tree=True, compact=True)
    payload, got = _port_impulse(tm, q, v, geo, monkeypatch, tree=True)
    assert payload["mode"] == "Y"
    # 4 normals + 2 x 2 friction rows, each on its own ancestor closure.
    assert tuple(payload["Y"].shape[:1]) == (P_IMP + 4,)
    _impulse_close(got, want)
    # Friction rows carried impulse, inside the Coulomb box.
    lam = got["lam"].numpy()
    assert np.abs(lam[P_IMP:]).max() > 0.0
    cap = np.tile(geo["mu"][:, None] * lam[[0, 2]], (2, 1))
    assert (np.abs(lam[P_IMP:]) <= cap + 1e-7).all()
    assert np.abs(got["v1"].numpy() - v).max() > 1e-3


def test_impulse_x_route_with_a_dense_factor_matches_jax(impulse_case,
                                                         monkeypatch):
    jm, tm, q, v, geo = impulse_case
    want = _jax_impulse(jm, q, v, geo, monkeypatch, tree=False,
                        compact=False)
    payload, got = _port_impulse(tm, q, v, geo, monkeypatch, tree=False)
    assert payload["mode"] == "X"
    _impulse_close(got, want)


def test_impulse_x_helper_with_a_tree_factor_matches_jax(impulse_case,
                                                         monkeypatch):
    jm, tm, q, v, geo = impulse_case
    want = _jax_impulse(jm, q, v, geo, monkeypatch, tree=True, compact=False)
    payload, got = _port_impulse(tm, q, v, geo, monkeypatch, tree=True,
                                 x_route=True)
    assert payload["mode"] == "X"
    _impulse_close(got, want)


def test_compact_matches_dense(impulse_case, monkeypatch):
    """tests/test_physics.py::test_compact_matches_dense on the port: the
    Y route and the X helper on one tree factor agree to the sweeps'
    tolerance (rtol 2e-4, atol 2e-5), and the solve binds."""
    jm, tm, q, v, geo = impulse_case
    _, y = _port_impulse(tm, q, v, geo, monkeypatch, tree=True)
    _, x = _port_impulse(tm, q, v, geo, monkeypatch, tree=True,
                         x_route=True)
    for k in ("v1", "v2", "lam"):
        np.testing.assert_allclose(y[k].numpy(), x[k].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert np.abs(x["v1"].numpy() - v).max() > 1e-3


def test_impulse_leaves_kernel_counts_on_cpu(impulse_case, monkeypatch):
    jm, tm, q, v, geo = impulse_case
    before = launch_counts()
    _port_impulse(tm, q, v, geo, monkeypatch, tree=True)
    assert launch_counts() == before


def _sphere_impulse(pkg, c_mod, model, gap, vx_b=-1.0):
    r_a, r_b = 0.1, 0.08
    dt = 1 / 120.0
    q = np.tile(model.neutral_q(), (1, 1)).astype(np.float32)
    q[:, 0:3] = [0.0, 0.0, 0.5]
    q[:, 7:10] = [r_a + r_b + gap, 0.0, 0.5]
    v = np.zeros((1, model.nv), np.float32)
    v[0, 9] = vx_b  # b toward a
    if pkg is jphys:
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a)[None], jphys.DynParams.defaults(model))
        qq, vv, tau = jnp.asarray(q), jnp.asarray(v), jnp.zeros((1, 12))
    else:
        params = tphys.DynParams.defaults(model).rows(1)
        qq, vv, tau = torch.from_numpy(q), torch.from_numpy(v), \
            torch.zeros(1, 12)
    kin = pkg.forward_kinematics(model, qq, vv, params)
    _, _, factor = pkg.forward_dynamics(model, qq, vv, tau, params, dt=dt,
                                        kin=kin, return_factor=True)
    v_new = c_mod.sphere_sphere_impulse(
        model, kin, factor, vv, params, links_a=[0],
        offsets_a=[(0., 0., 0.)], radii_a=[r_a], links_b=[1],
        offsets_b=[(0., 0., 0.)], radii_b=[r_b], dt=dt)
    return v, np.asarray(v_new)


def test_sphere_sphere_impulse_stops_approach():
    """tests/test_physics.py::test_sphere_sphere_impulse_stops_approach on
    the port: overlapping balls approaching head-on leave with a
    non-negative relative normal velocity and conserved momentum, no
    angular impulse; separated, the velocity is untouched. The same
    velocities as JAX's."""
    jm, tm = _two_bodies()
    v0, v1 = _sphere_impulse(tphys, tc, tm, -0.005)
    v_n_new = -(v1[0, 3] - v1[0, 9])
    assert v_n_new >= -1e-5, v1
    assert 2.0 * (v1[0, 3] - v0[0, 3]) + 0.5 * (v1[0, 9] - v0[0, 9]) \
        == pytest.approx(0.0, abs=1e-5)
    np.testing.assert_allclose(v1[0, [0, 1, 2, 6, 7, 8]], 0.0, atol=1e-6)
    _close(v1, _sphere_impulse(jphys, jc, jm, -0.005)[1])
    v0, v1 = _sphere_impulse(tphys, tc, tm, +0.02)
    np.testing.assert_allclose(v1, v0, atol=1e-7)
