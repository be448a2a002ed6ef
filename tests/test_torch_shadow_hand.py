"""The port's ShadowHand task against the JAX package on the CPU: the
config copies, the DR specs (32 dims in shadow_hand.yaml, 111 in
shadow_hand_more.yaml), the model and its tree solve, DynParams (carried
across with utils/convert.py) and the contact frictions, 5 physics steps
with obs, reward and termination from one numpy state for the 89-, 107-
and 211-dim layouts, the nearest-cube-face contract, the scale-neutral
DynParams, the observationType check and the render.

Tolerances: state, obs and rewards within atol 1e-4 over the 5 steps at
|a| <= 0.3 (float32 on both sides; the contacts amplify rounding), DR
quantities within rtol 1e-6. The JAX tasks are shared per module: their
first eager steps compile many ops."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.sim.shadow_hand import (
    ShadowHand as JaxShadowHand, nearest_cube_faces as jax_nearest_faces,
)
from bayes_sim_ig_tpu_torch.physics.dynamics import _uses_tree_solve
from bayes_sim_ig_tpu_torch.sim.shadow_hand import (
    ShadowHand, nearest_cube_faces,
)
from bayes_sim_ig_tpu_torch.utils.convert import dynparams_from_jax

from . import torch_task_checks as tc

torch.set_num_threads(1)

STEM = "shadow_hand"
N = 2
LAYOUTS = {"full": ({}, 89), "force_sensors": ({"forceSensorObs": True}, 107),
           "full_state": ({"observationType": "full_state"}, 211)}


@pytest.fixture(scope="module")
def tasks():
    out = {}
    for name, (edits, _) in LAYOUTS.items():
        cfg = tc.load_cfg(STEM, N)
        cfg["env"].update(edits)
        out[name] = JaxShadowHand(cfg), ShadowHand(cfg, device="cpu")
    return out


@pytest.mark.parametrize("stem", ["shadow_hand", "shadow_hand_more",
                                  "shadow_hand_grasp",
                                  "shadow_hand_grasp_full"])
def test_config_copies_match_the_jax_package(stem):
    tc.config_copies_match(stem, with_train=stem == STEM)


@pytest.mark.parametrize("stem,dim", [("shadow_hand", 32),
                                      ("shadow_hand_more", 111)])
def test_spec_matches_jax(stem, dim):
    cfg = tc.load_cfg(stem, N)
    jt, tt = JaxShadowHand(cfg), ShadowHand(cfg, device="cpu")
    tc.spec_matches(tt, jt, dim)
    for attr in ("_tendon_dims", "_tendon_damp_dims", "_dof_stiff_dims",
                 "_dof_damp_dims", "_hand_fric_dims", "_obj_fric_dims",
                 "_hand_mass_dims", "_scale_dim", "_obj_mass_dim"):
        assert getattr(tt, attr) == getattr(jt, attr), attr


def test_model_takes_the_right_looking_tree_solve(tasks):
    _, tt = tasks["full"]
    m = tt.model
    assert (m.nb, m.nv) == (27, 30)
    assert _uses_tree_solve(m)
    assert len(tt._imp_links_a) == 35 and len(tt._box_pts) == 28
    assert tt.grasp_excitation_dims == JaxShadowHand.grasp_excitation_dims


@pytest.mark.parametrize("stem", ["shadow_hand", "shadow_hand_more"])
def test_dyn_params_and_frictions_match_jax(stem):
    cfg = tc.load_cfg(stem, 3)
    jt, tt = JaxShadowHand(cfg), ShadowHand(cfg, device="cpu")
    params = tc.params_in_box(tt, 3, 1)
    gdz = np.asarray([0.0, 0.3, -0.2], np.float32)
    want = dynparams_from_jax(jax.vmap(jt._dyn_params)(
        jnp.asarray(params), jnp.asarray(gdz)))
    got = tt._dyn_params(torch.from_numpy(params), torch.from_numpy(gdz))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.expand_as(w).numpy(), w.numpy(),
                                   rtol=1e-6, err_msg=name)
    jmu = jax.vmap(jt._contact_frictions)(jnp.asarray(params))
    for g, w in zip(tt._contact_frictions(torch.from_numpy(params)), jmu):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_physics_obs_and_reward_match_jax_over_5_steps(tasks, layout):
    jt, tt = tasks[layout]
    assert tt.obs_dim == jt.obs_dim == LAYOUTS[layout][1]
    params = tc.params_in_box(tt, N, 0)
    st = tt.init_state(torch.Generator().manual_seed(0),
                       torch.from_numpy(params))
    ts = tc.steps_match_jax(jt, tt, tuple(x.numpy() for x in st), params,
                            seed=1, amp=0.3)
    assert ts.q.shape == (N, 31)
    if layout != "full":
        assert ts.tip_force.abs().max() > 0.0


def test_nearest_cube_face_selection():
    """tests/test_tasks.py::test_nearest_cube_face_selection on the port:
    spheres just outside each of the 6 faces, and one inside near +y,
    select that face, with the plane point on it; as JAX's."""
    from types import SimpleNamespace
    h = 0.03
    faces = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                      [0, -1, 0], [0, 0, 1], [0, 0, -1]], np.float32)
    centers = np.concatenate([faces * (h + 0.004),
                              [[0.0, h - 0.002, 0.0]]], 0)
    expected = np.concatenate([faces, [[0, 1, 0]]], 0)
    nb = len(centers) + 1                       # + cube link 0
    R_w = np.broadcast_to(np.eye(3, dtype=np.float32)[None, :, :, None],
                          (nb, 3, 3, 1)).copy()
    p_w = np.zeros((nb, 3, 1), np.float32)
    p_w[1:, :, 0] = centers
    kw = dict(cube_link=0, sph_links=list(range(1, nb)),
              sph_offsets=np.zeros((nb - 1, 3), np.float32), n_env=1)
    nrm, pt = nearest_cube_faces(
        SimpleNamespace(R_w=torch.from_numpy(R_w), p_w=torch.from_numpy(p_w)),
        cube_half=torch.full((1,), h), **kw)
    np.testing.assert_allclose(nrm.numpy()[..., 0], expected, atol=1e-6)
    np.testing.assert_allclose(pt.numpy()[..., 0], expected * h, atol=1e-6)
    jn, jp = jax_nearest_faces(
        SimpleNamespace(R_w=jnp.asarray(R_w), p_w=jnp.asarray(p_w)),
        cube_half=jnp.full((1,), h), **kw)
    np.testing.assert_array_equal(nrm.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jp), atol=1e-7)


def test_dyn_params_leave_scale_neutral(tasks):
    """tests/test_tasks.py::test_shadow_hand_dyn_params_leaves_scale_
    neutral on the port: the task applies the object scale to the cube
    geometry itself, so DynParams.scale stays 1."""
    _, tt = tasks["full"]
    params = torch.full((2, tt.params_spec.dim), 1.7)
    dp = tt._dyn_params(params, torch.zeros(2))
    assert float(dp.scale.max()) == float(dp.scale.min()) == 1.0


def test_unknown_observation_type_raises():
    cfg = tc.load_cfg(STEM, N)
    cfg["env"]["observationType"] = "openai"
    with pytest.raises(ValueError, match="observationType"):
        ShadowHand(cfg, device="cpu")
    cfg["env"].pop("observationType")
    assert ShadowHand(cfg, device="cpu").obs_dim == 89


def test_render_obs_frame(tasks):
    tc.render_matches_jax("ShadowHand", STEM, tasks["full"][0])


def _episode_rows(tt, envs=40, steps=14, seed=0):
    """(envs * (steps + 1), obs_dim) float32 observation rows of the port's
    CPU env (each env's reset, then ``steps`` steps at random actions),
    with the renderer's edge cases written over the first rows: the cube
    a sub-pixel off the centre, far off the image, its height at and
    beyond +-0.25, an all-zero quaternion, unnormalised quaternions."""
    params = torch.from_numpy(tc.params_in_box(tt, envs, seed))
    st = tt.init_state(torch.Generator().manual_seed(seed), params)
    rows = [tt.observe(st, params)]
    rs = np.random.RandomState(seed + 1)
    for _ in range(steps):
        act = rs.uniform(-1, 1, (envs, tt.act_dim)).astype(np.float32)
        st = tt.physics_step(st, torch.from_numpy(act), params, None)
        rows.append(tt.observe(st, params))
    obs = torch.cat(rows).numpy()
    edges = [(48, [1e-4, -2e-4, 0.0]), (48, [3.0, -2.0, 0.1]),
             (48, [-0.31, 0.27, 0.0]), (48, [0.0, 0.0, 0.25]),
             (48, [0.0, 0.0, -0.25]), (48, [0.01, 0.0, 0.7]),
             (48, [0.0, 0.01, -0.7]), (51, [0.0, 0.0, 0.0, 0.0]),
             (61, [0.0, 0.0, 0.0, 0.0]), (51, [3.1, -0.4, 2.2, 5.0]),
             (61, [0.02, 0.1, -0.05, 0.03])]
    for row, (col, vals) in enumerate(edges):
        obs[row, col:col + len(vals)] = vals
    return obs


@pytest.mark.parametrize("layout", ["full", "full_state"])
def test_render_obs_frames_equal_the_jax_frames_row_by_row(tasks, layout):
    """A 600-row episode drawn as one batch is, frame for frame and bit for
    bit, the JAX package's ``render_obs_frame`` of each row."""
    jt, tt = tasks[layout]
    obs = _episode_rows(tt)
    assert obs.shape == (600, LAYOUTS[layout][1])
    got = tt.render_obs_frames(obs)
    assert got.shape == (600, 200, 200, 3) and got.dtype == np.uint8
    want = np.stack([jt.render_obs_frame(row) for row in obs])
    assert np.array_equal(got, want)
    # Far off the image, the cube's outline is clipped into the corner.
    assert got[1, 199, 199].tolist() == [204, 77, 77]
