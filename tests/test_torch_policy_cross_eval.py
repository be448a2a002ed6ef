"""``experiments/policy_cross_eval.py`` on the CPU at a tiny size: one
policy, saved by the port's PPO in the JAX package's layout, evaluated in
both packages' ShadowHand grasp envs (4 envs, 20-step episodes)."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

import policy_cross_eval  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def policy(tmp_path_factory):
    """A fresh policy of the grasp config's widths, saved by the port."""
    from bayes_sim_ig_tpu_torch.rl import process_ppo
    from bayes_sim_ig_tpu_torch.sim import make_env
    cfg, cfg_train = policy_cross_eval.grasp_configs(
        "bayes_sim_ig_tpu_torch", 2, 20)
    env = make_env("ShadowHand", cfg, device="cpu")
    path = str(tmp_path_factory.mktemp("policy") / "model_0.ckpt")
    process_ppo(env, cfg_train, os.path.dirname(path), seed=3).save(path)
    return path


@pytest.mark.parametrize("distr", ["real", "prior"])
def test_both_packages_score_the_policy(policy, distr, tmp_path):
    out = str(tmp_path / "rewards.json")
    results = policy_cross_eval.main([policy, "--envs", "4",
                                      "--episode_length", "20",
                                      "--distr", distr, "--out", out])
    assert sorted(results) == ["jax", "torch"]
    for pkg in ("torch", "jax"):
        rewards = results[pkg][policy]
        assert rewards.shape == (4,) and np.isfinite(rewards).all(), pkg
    assert os.path.exists(out)
    again = policy_cross_eval.eval_torch([policy], 4, prior=distr == "prior",
                                         episode_length=20)
    np.testing.assert_array_equal(again[policy], results["torch"][policy])

