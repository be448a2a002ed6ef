"""The asymmetric actor-critic on the port (the env config's
``asymmetric_observations``): the critic reads the privileged simulator
state (``Task.privileged_state``, ``VecEnv.get_state``), the actor the
observations. The port of tests/test_ppo.py::test_asymmetric_actor_critic,
the privileged state's width against the JAX package's, and the critic's
value and the actor's mean on seeded inputs against JAX's with the weights
carried across (utils/convert.py), within 1e-5."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from bayes_sim_ig_tpu.rl import networks as jnet
from bayes_sim_ig_tpu.sim import make_env as jax_make_env
from bayes_sim_ig_tpu_torch.distributions import MoG, to_device_distr
from bayes_sim_ig_tpu_torch.rl import networks
from bayes_sim_ig_tpu_torch.rl.ppo import process_ppo
from bayes_sim_ig_tpu_torch.sim import make_env
from bayes_sim_ig_tpu_torch.utils.convert import actor_critic_params_from_jax

from . import torch_task_checks as tc
from .test_sim import pendulum_cfg

torch.set_num_threads(1)


def test_asymmetric_actor_critic(tmp_path):
    """The critic's first layer reads the privileged width, the actor's
    the obs width; two train iterations run; get_state() has the declared
    width and act(obs, states) the reference's call shape."""
    cfg = pendulum_cfg(num_envs=16, episode_len=20)
    cfg["env"]["asymmetric_observations"] = True
    env = make_env("Pendulum", cfg, device="cpu")
    task = env.task
    assert task.asymmetric_observations
    # (th, thdot): 2 dims against the 3-dim [cos th, sin th, thdot] obs.
    assert task.state_dim == 2 and task.obs_dim == 3
    spec = task.params_spec
    mog = MoG(a=[1.0], ms=[np.ones(2)], Ss=[np.eye(2) * 1e-10])
    env.set_distr(to_device_distr(mog, spec.lows, spec.highs, device="cpu"))
    cfg_train = {"seed": 0, "learn": {
        "nsteps": 8, "noptepochs": 2, "nminibatches": 2,
        "save_interval": 1000}, "policy": {
        "pi_hid_sizes": [16], "vf_hid_sizes": [16]}}
    ppo = process_ppo(env, cfg_train, logdir=str(tmp_path))
    assert ppo.asymmetric
    assert ppo.net.critic[0].in_features == task.state_dim
    assert ppo.net.actor[0].in_features == task.obs_dim
    ppo.run(num_learning_iterations=2, log_interval=1000)
    obs = env.reset()
    states = env.get_state()
    assert states.shape == (task.num_envs, task.state_dim)
    act, _ = ppo.actor_critic.act(obs, states)
    assert act.shape == (task.num_envs, task.act_dim)
    assert torch.isfinite(act).all()


def test_symmetric_default_keeps_the_obs_critic(tmp_path):
    env = make_env("Pendulum", pendulum_cfg(num_envs=4), device="cpu")
    assert not env.task.asymmetric_observations and env.task.state_dim == 0
    ppo = process_ppo(env, {"seed": 0, "learn": {"nsteps": 4},
                            "policy": {"vf_hid_sizes": [8]}},
                      logdir=str(tmp_path))
    assert not ppo.asymmetric
    assert ppo.net.critic[0].in_features == env.task.obs_dim


def test_privileged_state_width_matches_jax():
    """ShadowHand's privileged state: every HandState field per env (q 31,
    v 30, goal 4, actions 20, gravity 1, sensors 18 + 15 + 65 + 24), as
    the JAX package's make_env counts it."""
    cfg = tc.load_cfg("shadow_hand", 2)
    cfg["env"]["asymmetric_observations"] = True
    env = make_env("ShadowHand", cfg, device="cpu")
    jenv = jax_make_env("ShadowHand", cfg)
    assert env.task.state_dim == jenv.task.state_dim == 208
    spec = env.task.params_spec
    env.set_distr(to_device_distr(MoG(a=[1.0], ms=[np.ones(spec.dim)],
                                      Ss=[np.eye(spec.dim) * 1e-12]),
                                  spec.lows, spec.highs, device="cpu"))
    env.reset()
    st = env.get_state()
    assert st.shape == (2, 208) and torch.isfinite(st).all()
    q = env.state.task_state.q
    assert torch.equal(st[:, :31], q)


def test_critic_and_actor_match_jax_on_seeded_inputs():
    obs_dim, act_dim, state_dim = 7, 3, 11
    jparams = jnet.init_actor_critic(jax.random.PRNGKey(3), obs_dim,
                                     act_dim, [32, 16], [24, 12],
                                     init_noise_std=0.8, state_dim=state_dim)
    net = networks.ActorCritic(torch.Generator().manual_seed(0), obs_dim,
                               act_dim, [32, 16], [24, 12], 0.8, "elu",
                               state_dim=state_dim)
    net.load_state_dict(actor_critic_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    rs = np.random.RandomState(0)
    obs = rs.randn(9, obs_dim).astype(np.float32)
    states = rs.randn(9, state_dim).astype(np.float32)
    with torch.no_grad():
        v = networks.value(net, torch.from_numpy(states)).numpy()
        mean = networks.policy_mean(net, torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(
        v, np.asarray(jnet.value(jparams, jnp.asarray(states), "elu")),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        mean, np.asarray(jnet.policy_mean(jparams, jnp.asarray(obs), "elu")),
        rtol=1e-5, atol=1e-5)
