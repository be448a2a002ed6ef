"""The port's ShadowHand under shadow_hand_more.yaml (111 DR dims: tendon
damping, drive stiffness and damping scales and shape frictions on top
of the 32) against the JAX package on the CPU: 5 physics steps with obs,
reward and termination from one numpy state within atol 1e-4 at
|a| <= 0.3, with the more config's drive gains, tendon damping and
frictions in the step."""

import torch

from bayes_sim_ig_tpu.sim.shadow_hand import ShadowHand as JaxShadowHand
from bayes_sim_ig_tpu_torch.sim.shadow_hand import ShadowHand

from . import torch_task_checks as tc

torch.set_num_threads(1)


def test_physics_obs_and_reward_match_jax_over_5_steps():
    cfg = tc.load_cfg("shadow_hand_more", 2)
    jt, tt = JaxShadowHand(cfg), ShadowHand(cfg, device="cpu")
    assert tt.params_spec.dim == 111
    assert tt._stiff_cols is not None and tt._hand_fric_dims
    assert tt._tendon_damp_dims and tt._dof_damp_dims
    params = tc.params_in_box(tt, 2, 3)
    st = tt.init_state(torch.Generator().manual_seed(1),
                       torch.from_numpy(params))
    ts = tc.steps_match_jax(jt, tt, tuple(x.numpy() for x in st), params,
                            seed=2, amp=0.3)
    assert torch.isfinite(ts.q).all()
