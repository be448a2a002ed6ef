"""How far does ShadowHand's crush-through margin depend on the initial
state, and do the two packages agree on it?

    JAX_PLATFORMS=cpu python experiments/shadow_hand_crush_margin.py [--seeds 0 1 2 3 4 5]

The scenario of tests/test_task_behaviors.py::test_squeeze_cannot_crush_
through_cube: 2 envs with every DR param at 1, 50 steps of the max-effort
squeeze (every action 1 but the FF and MF abductions), the deepest
penetration of a hand contact sphere into the cube over the run (the
gate's bound is 16 mm). Runs the port from its own reset for each seed
(its torch generator), then the port and the JAX package side by side
from JAX's own reset of the same env, printing each one's worst
penetration and the largest |q| difference between them over the run.
CPU only.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import jax.numpy as jnp  # noqa: E402

from bayes_sim_ig_tpu.distributions import (  # noqa: E402
    MoG as JaxMoG, to_device_distr as jax_to_device_distr,
)
from bayes_sim_ig_tpu.sim import make_env as jax_make_env  # noqa: E402
from bayes_sim_ig_tpu_torch.distributions import (  # noqa: E402
    MoG, to_device_distr,
)
from bayes_sim_ig_tpu_torch.physics import (  # noqa: E402
    DynParams, forward_kinematics,
)
from bayes_sim_ig_tpu_torch.physics.dynamics import _mv  # noqa: E402
from bayes_sim_ig_tpu_torch.physics.spatial import quat_to_rot  # noqa: E402
from bayes_sim_ig_tpu_torch.sim import make_env  # noqa: E402
from bayes_sim_ig_tpu_torch.sim.shadow_hand import (  # noqa: E402
    CUBE_HALF, HandState,
)
from bayes_sim_ig_tpu_torch.utils.args import load_config  # noqa: E402

N = 2
STEPS = 50


def _cfg():
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "shadow_hand.yaml"))
    cfg["env"]["numEnvs"] = N
    return cfg


def _delta(spec):
    return dict(a=[1.0], ms=[np.ones(spec.dim)],
                Ss=[np.eye(spec.dim) * 1e-12])


def _port_env(seed):
    env = make_env("ShadowHand", _cfg(), seed=seed, device="cpu")
    spec = env.task.params_spec
    env.set_distr(to_device_distr(MoG(**_delta(spec)), spec.lows,
                                  spec.highs, device="cpu"))
    env.reset()
    return env


def _worst_penetration(task, q, v):
    """Deepest penetration of the hand contact spheres into the cube."""
    pts = [(l, g.offset, g.size[0]) for (l, g, _n) in task._hand_spheres]
    links = torch.as_tensor([p[0] for p in pts])
    offs = torch.as_tensor(np.asarray([p[1] for p in pts], np.float32))
    radii = torch.as_tensor([p[2] for p in pts], dtype=torch.float32)
    kin = forward_kinematics(task.model, q, v,
                             DynParams.defaults(task.model).rows(N))
    c = kin.p_w[links] + _mv(kin.R_w[links], offs[:, :, None].expand(
        -1, 3, N))
    cq = task._cube_q
    Rc = quat_to_rot(q[:, cq + 3:cq + 7])
    local = torch.einsum("nji,sjn->sin", Rc, c - kin.p_w[task._cube][None])
    pen = radii[:, None] - (local.abs().amax(1) - CUBE_HALF)
    inside = (local.abs() < CUBE_HALF + radii[:, None, None]).all(1)
    return float(torch.where(inside, pen, torch.zeros_like(pen)).max())


def _squeeze():
    act = np.ones((N, 20), np.float32)
    act[:, [2, 5]] = 0.0
    return act


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    act = torch.from_numpy(_squeeze())
    for seed in args.seeds:
        env = _port_env(seed)
        worst = 0.0
        for _ in range(STEPS):
            env.step(act)
            st = env.state.task_state
            worst = max(worst, _worst_penetration(env.task, st.q, st.v))
        print(f"port reset, seed {seed}: worst penetration "
              f"{worst * 1e3:.1f} mm", flush=True)
    jenv = jax_make_env("ShadowHand", _cfg())
    jspec = jenv.task.params_spec
    jenv.set_distr(jax_to_device_distr(JaxMoG(**_delta(jspec)), jspec.lows,
                                       jspec.highs))
    jenv.reset()
    env = _port_env(0)
    env.state = env.state._replace(task_state=HandState(*[
        torch.from_numpy(np.array(x)) for x in jenv.state.task_state]))
    worst_j = worst_t = drift = 0.0
    for _ in range(STEPS):
        jenv.step(jnp.asarray(act.numpy()))
        env.step(act)
        jq = torch.from_numpy(np.array(jenv.state.task_state.q))
        jv = torch.from_numpy(np.array(jenv.state.task_state.v))
        st = env.state.task_state
        worst_j = max(worst_j, _worst_penetration(env.task, jq, jv))
        worst_t = max(worst_t, _worst_penetration(env.task, st.q, st.v))
        drift = max(drift, float((jq - st.q).abs().max()))
    print(f"JAX's reset: worst penetration JAX {worst_j * 1e3:.1f} mm, port "
          f"{worst_t * 1e3:.1f} mm; max |q_jax - q_port| {drift:.2e}")


if __name__ == "__main__":
    main()
